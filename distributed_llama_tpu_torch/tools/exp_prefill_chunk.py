"""Prefill chunk-size ladder on the card: K1's chunks against the
dequantize path's longer segments.

Counterpart of the JAX repository's tools/exp_prefill_chunk.py:39 run. A
2048-token prompt is prefilled at chunks of 128, 256, 512, 1024 and 2048
tokens; up to ops/cuda_q40.MAX_T (256) every Q40 product runs K1, above it
each weight is dequantized to bf16 and multiplied by torch.matmul (the
dequantize path re-reads the weight per product but amortizes it over more
tokens). Each chunk size gives tokens a second (the best of REPS timed
prompts between CUDA events, after one warm prompt), and the logits after
the prompt, which must agree across chunk sizes: the script reports the
largest difference from the 256-token chunks' logits as a share of their
largest magnitude. The engine is the CLI's for a Q40 model (bf16, Q80
activations).

    python -m distributed_llama_tpu_torch.tools.exp_prefill_chunk [7b|tiny] [--device cuda|cpu]

With --device cpu the plain versions run on the host clock: the rates say
nothing of the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import bench_specs
from ..models.params import synthetic_q40_params
from ..ops.cuda_q40 import MAX_T
from ..runtime.engine import Engine
from ..utils.device import resolve_device
from .timing import card_label, event_ms

PROMPT_LEN = 2048
CHUNKS = (128, 256, 512, 1024, 2048)
REFERENCE_CHUNK = 256
REPS = 2


def run(model: str = "7b", *, spec=None, params=None, device: str = "cuda",
        card: str | None = None, prompt_len: int = PROMPT_LEN,
        chunks=CHUNKS) -> dict:
    dev = resolve_device(device)
    card = card or card_label(dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    spec = spec or (bench_specs.LLAMA2_7B if model == "7b" else bench_specs.TINY)
    if params is None:
        params = synthetic_q40_params(spec, seed=0, device=dev, dtype=dtype)
    prompt_len = min(prompt_len, spec.seq_len)
    # a varied prompt: the logits then depend on every position
    tokens = np.random.default_rng(0).integers(1, spec.vocab_size,
                                                  prompt_len).tolist()
    rows, logits = {}, {}
    for chunk in chunks:
        engine = Engine(spec, params, device=dev, compute_dtype=dtype, cache_dtype=dtype,
                        max_seq_len=prompt_len, prefill_chunk=chunk, activation_q80=True)
        out = {}

        def prefill():
            engine.reset()
            out["logits"] = engine.prefill(tokens)
        ms = event_ms(prefill, reps=REPS)
        logits[chunk] = engine.fetch_logits(out["logits"])[0].astype(np.float64)
        rows[chunk] = dict(chunk=chunk, ms=ms, tok_per_s=prompt_len / (ms / 1e3),
                           kernel_path=chunk <= MAX_T)
        print(f"[exp_prefill_chunk] chunk={chunk:5d}: {rows[chunk]['tok_per_s']:8.1f} tok/s "
              f"({ms:7.1f} ms; {'K1' if rows[chunk]['kernel_path'] else 'dequantize'} "
              f"path) [{card}]", flush=True)
        engine.release()
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ref = logits[REFERENCE_CHUNK if REFERENCE_CHUNK in logits else chunks[0]]
    scale = float(np.abs(ref).max())
    for chunk, lg in logits.items():
        rows[chunk]["logits_max_diff"] = float(np.abs(lg - ref).max())
        rows[chunk]["logits_rel_diff"] = rows[chunk]["logits_max_diff"] / scale
        rows[chunk]["argmax"] = int(np.argmax(lg))
    best = max(rows.values(), key=lambda r: r["tok_per_s"])
    worst_rel = max(r["logits_rel_diff"] for r in rows.values())
    print(f"[exp_prefill_chunk] fastest chunk {best['chunk']} ({best['tok_per_s']:.1f} "
          f"tok/s); logits after the prompt agree across chunks within {worst_rel:.2e} of "
          f"max |logit| ({scale:.3f}) [{card}]", flush=True)
    return {"rows": [rows[c] for c in chunks], "prompt_len": prompt_len,
            "fastest_chunk": best["chunk"], "logits_max_rel_diff": worst_rel,
            "logits": logits, "device": dev.type, "card": card}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model", nargs="?", default="7b", choices=["7b", "tiny"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.model, device=args.device)


if __name__ == "__main__":
    main()
