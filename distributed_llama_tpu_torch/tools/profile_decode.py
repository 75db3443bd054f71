"""Decode-path profiler: the weight-read routes of a Q40 model, A/B on the
card.

Counterpart of the JAX repository's tools/profile_decode.py: for the chosen
model, bytes a token reads (weights, and the whole cache as the JAX tool
counts it) and the measured ms/token of Engine.decode_greedy_device (one
captured graph replayed a token, one host read at the end), hence the rate
reached and its share of 3.35 TB/s. Modes, chosen by PROF_MODE:

  q40_kernel  K1 (ops/cuda_q40.py, q40_gemv1_kernel) with the Q80 round
              trip of its input fused in: the route the CLI runs for a Q40
              model (`q40_pallas`, the JAX tool's name, is the same mode)
  q40_xla     the dequantize route: every Q40 weight dequantized to bf16,
              then torch.matmul (ops/matmul.dequantize_route)
  dense_bf16  the weights dequantized once to bf16 tensors, then
              torch.matmul

    PROF_MODE=q40_kernel PROF_LAYERS=32 PROF_TOKENS=32 \\
        python -m distributed_llama_tpu_torch.tools.profile_decode [--device cuda|cpu]

PROF_MODEL picks the bench spec (models/bench_specs.py; LLAMA2_7B). With
--device cpu the plain versions run on the host clock: the numbers say
nothing of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import torch

from ..models import bench_specs
from ..models.loader import param_bytes
from ..models.params import synthetic_q40_params
from ..ops.matmul import dequantize_route
from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from ..runtime.engine import Engine
from ..utils.device import resolve_device
from .timing import HBM_BYTES_PER_S, card_label

MODES = ("q40_kernel", "q40_xla", "dense_bf16")
ALIASES = {"q40_pallas": "q40_kernel"}


def dense_params(params: dict, dtype=torch.bfloat16) -> dict:
    """A copy of params with every Q40 weight dequantized to `dtype`."""
    def dq(w):
        return dequantize_q40_torch(w, dtype) if isinstance(w, QuantizedTensor) else w
    out = {k: dq(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: dq(v) for k, v in lw.items()} for lw in params["layers"]]
    return out


def run(mode: str, *, spec=None, params=None, n_tokens: int = 32,
        seq_len: int = 2048, device: str = "cuda", card: str | None = None) -> dict:
    """One mode's line (the JAX tool's keys, plus the share of 3.35 TB/s,
    the device and the card)."""
    mode = ALIASES.get(mode, mode)
    if mode not in MODES:
        raise ValueError(f"unknown PROF_MODE {mode!r} ({', '.join(MODES)})")
    dev = resolve_device(device)
    card = card or card_label(dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    spec = spec or bench_specs.LLAMA2_7B
    if params is None:
        params = synthetic_q40_params(spec, seed=0, device=dev, dtype=dtype)
    if mode == "dense_bf16":
        params = dense_params(params, dtype)
    seq_len = min(seq_len, spec.seq_len)
    engine = Engine(spec, params, device=dev, compute_dtype=dtype, cache_dtype=dtype,
                    max_seq_len=seq_len, activation_q80=(mode == "q40_kernel"))
    route = dequantize_route() if mode == "q40_xla" else contextlib.nullcontext()
    with route:
        engine.decode_greedy_device(1, n_tokens)     # capture, off the clock
        engine.reset()
        _, dt = engine.decode_greedy_device(1, n_tokens)
    ms = dt / n_tokens * 1e3
    wbytes = param_bytes(engine.params)
    cache_bytes = sum(k.numel() * k.element_size() for k in engine.cache.k) * 2
    eff = (wbytes + cache_bytes) / (ms / 1e3)
    out = {"mode": mode, "layers": spec.n_layers, "tokens": n_tokens,
           "ms_per_token": round(ms, 4), "weight_gb": round(wbytes / 1e9, 3),
           "cache_gb": round(cache_bytes / 1e9, 3),
           "eff_bw_gbps": round(eff / 1e9, 1),
           "hbm_share": round(eff / HBM_BYTES_PER_S, 4),
           "bound_ms_per_token": round((wbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3, 4),
           "device": dev.type, "card": card}
    engine.release()
    del engine, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = getattr(bench_specs, os.environ.get("PROF_MODEL", "LLAMA2_7B"))
    spec = dataclasses.replace(spec, n_layers=int(os.environ.get("PROF_LAYERS",
                                                                 spec.n_layers)))
    return run(os.environ.get("PROF_MODE", "q40_xla"), spec=spec,
               n_tokens=int(os.environ.get("PROF_TOKENS", "32")),
               seq_len=int(os.environ.get("PROF_SEQ", "2048")), device=args.device)


if __name__ == "__main__":
    main()
