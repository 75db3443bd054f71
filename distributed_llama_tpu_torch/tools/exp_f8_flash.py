"""fp8-cache flash decode: four ways of reading the cache, head to head.

Counterpart of the JAX repository's tools/exp_f8_flash.py, at its shape:
B = 1, KVH = 32, S = 8192, hs = 128, fill 7680, t = 1 (one query row per kv
head). The same flash-decode kernel (ops/cuda_probes.py f8_flash_decode,
csrc/f8_flash_probe.cu) reads

  bf16          a bf16 cache (`plain`, the baseline)
  astype-f8     an e4m3 cache converted by the hardware (`astype`, K3's way)
  bits-f8       e4m3 bits rebuilt with integer ops, exact subnormals (`bits`)
  bitsflush-f8  the same with subnormals flushed to zero (`bitsflush`)

A line gives ms per call, the bytes a call really moves (q, the output and
K and V up to the fill) and the rate; then the TPU tool's lines: whether
bits equals astype bit for bit, and ms per call of each.

    python -m distributed_llama_tpu_torch.tools.exp_f8_flash [--device cuda|cpu]

With --device cpu the plain versions run each call once, untimed.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import cuda_probes
from ..utils.device import resolve_device
from .timing import pass_rows

B, KVH, S, HS, FILL = 1, 32, 8192, 128, 7680
VARIANTS = (("bf16", "plain"), ("astype-f8", "astype"), ("bits-f8", "bits"),
            ("bitsflush-f8", "bitsflush"))


def build(mode: str, b: int, kvh: int, s: int, hs: int, sb: int = 512):
    """run(pos, q, k, v) -> (b*kvh, 1, hs) bf16 for one mode. sb is the TPU
    tool's block of slots; the card's kernel splits S by its own plan
    (cuda_probes.f8_split_plan) across the SMs, so sb does not change it."""
    if hs != cuda_probes.F8_HS:
        raise ValueError(f"the kernel takes hs = {cuda_probes.F8_HS}, got {hs}")

    def run(pos, q, k, v):
        return cuda_probes.f8_flash_decode(mode, pos, q, k, v)
    return run


def make_inputs(dev: torch.device, seed: int = 0) -> dict:
    """q and a bf16 K/V cache from `seed` on `dev`, the cache also as e4m3
    and as its uint8 bits, and pos = FILL for every row of the batch."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = B * KVH
    q = torch.randn((rows, 1, HS), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((rows, S, HS), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((rows, S, HS), generator=gen, device=dev).to(torch.bfloat16)
    k8, v8 = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    return {"pos": torch.full((B,), FILL, dtype=torch.int32, device=dev), "q": q,
            "plain": (k, v), "astype": (k8, v8),
            "bits": (k8.view(torch.uint8), v8.view(torch.uint8))}


def call_bytes(mode: str) -> int:
    """Bytes one call moves: K and V up to the fill, q and the output."""
    csize = 2 if mode == "plain" else 1
    return B * KVH * (2 * (min(FILL, S - 1) + 1) * HS * csize + 2 * HS * 2) + B * 4


def passes(dev: torch.device, inputs: dict | None = None) -> list[tuple]:
    """(label, one call of the mode's kernel, bytes it moves) per variant."""
    a = inputs or make_inputs(dev)
    out = []
    for label, mode in VARIANTS:
        k, v = a["bits" if mode == "bitsflush" else mode]
        run = build(mode, B, KVH, S, HS)
        out.append((label, lambda run=run, k=k, v=v: run(a["pos"], a["q"], k, v),
                    call_bytes(mode)))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    ps = passes(dev)
    rows = pass_rows(ps, dev)
    outs = {label: one() for label, one, _ in ps}
    same = torch.equal(outs["bits-f8"], outs["astype-f8"])
    print(f"bits == astype exact: {'ok' if same else 'DIFFERS'}")
    for r in rows:
        ms = "not measured (cpu)" if r["ms"] is None else f"{r['ms']:.4f} ms/call"
        print(f"{r['name']:14s} {ms}")
    return rows


if __name__ == "__main__":
    main()
