"""The Q40 prefill chunk on the tensor cores: does overlapping the
dequantize with the MMAs pay?

Counterpart of the JAX repository's tools/exp_unpack_overlap.py, at its
shape: D = 11008, N = 4096 (EXP_D, EXP_N override them as in that tool),
T = 256 tokens, random packed bytes and f16 scales in [0, 0.004), x from
N(0, 1) in bf16. Variants, each one launch per call:

  landed           the port's production path: K1 (ops/cuda_q40.py
                   q40_matmul, bf16 in and out) at t = 256, its
                   tensor-core path (wgmma with the weight dequantized
                   into registers)
  td=T n_sub=S     ops/cuda_probes.py q40_matmul_sub (csrc/
                   q40_prefill_probe.cu): CTAs of T weight rows x 256
                   tokens, a dequantize warpgroup writing each 128-value
                   chunk of N as bf16 in S sub-tiles that MMA warpgroups
                   consume with wgmma from shared memory; the dequantize
                   of sub-tile i+1 overlapped with the MMAs of sub-tile i
                   when S > 1

The TPU tool's (td, n_sub) list followed VMEM and Mosaic's 128-lane rule.
Here td is 64 or 128 (one or two MMA warpgroups of 64 rows, 128 f32 sums
a thread) and must divide D; n_sub is 1, 2, 4 or 8 (sub-tiles of 128, 64,
32 or 16 values of N, the last half a Q40 block).
"whole-tile" is td=128 n_sub=1. A line gives ms per call, bytes and rate;
then the TPU tool's lines, with TFLOP/s and the ratio to whole-tile, and
its DECISION against the landed path.

    python -m distributed_llama_tpu_torch.tools.exp_unpack_overlap [--device cuda|cpu]

With --device cpu the plain versions run each call once, untimed.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ops import cuda_probes, cuda_q40
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .timing import pass_rows, rotating

D = int(os.environ.get("EXP_D", "11008"))
N = int(os.environ.get("EXP_N", "4096"))
T = 256
WHOLE_TILE = "td=128 n_sub=1"


def combos() -> list[tuple[int, int]]:
    """(td, n_sub) pairs that fit D: td divides it."""
    return [(td, ns) for td in cuda_probes.SUB_TDS for ns in cuda_probes.SUB_NS
            if D % td == 0]


def matmul_sub(x: torch.Tensor, w: QuantizedTensor, n_sub: int, td: int) -> torch.Tensor:
    """y (T, D) bf16 for x (T, N) bf16 against w, sub-tiled n_sub ways."""
    return cuda_probes.q40_matmul_sub(x, w, n_sub, td)


def make_weight(dev: torch.device, gen: torch.Generator) -> QuantizedTensor:
    packed = torch.randint(0, 256, (D, N // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    scales = (torch.rand((D, N // 32), generator=gen, device=dev) * 0.004).to(torch.float16)
    return QuantizedTensor(packed, scales)


def call_bytes() -> int:
    """Bytes one call moves: packed bytes, f16 scales, x and out in bf16."""
    return D * N // 2 + D * (N // 32) * 2 + T * N * 2 + T * D * 2


def flops() -> float:
    return 2.0 * T * D * N


def passes(dev: torch.device, seed: int = 0) -> list[tuple]:
    """(label, one call, bytes it moves): landed, then every combo; the
    weight rotates through copies that together exceed the L2 cache."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((T, N), generator=gen, device=dev).to(torch.bfloat16)
    ws = rotating(lambda: make_weight(dev, gen), D * N // 2 + D * (N // 32) * 2)
    out = [("landed", lambda: cuda_q40.q40_matmul(x, ws(), torch.bfloat16), call_bytes())]
    out += [(f"td={td} n_sub={ns}", lambda td=td, ns=ns: matmul_sub(x, ws(), ns, td),
             call_bytes()) for td, ns in combos()]
    return out


def decision(best: dict) -> str:
    """The TPU tool's verdict on ms per call by variant, against landed."""
    winner = min(best, key=best.get)
    if winner == "landed" or best["landed"] <= best[winner] * 1.02:
        return ("DECISION: the landed path (K1's wgmma path) is within 2% of the "
                "best variant — keep it")
    if winner.endswith("n_sub=1"):
        return (f"DECISION: {winner} (no overlap) beats the landed path by "
                f"{best['landed'] / best[winner]:.2f}x — the chunk shape, not the "
                "overlap, is the gain")
    return (f"DECISION: {winner} beats the landed path by "
            f"{best['landed'] / best[winner]:.2f}x — overlapping the dequantize "
            "with the MMAs pays on the tensor cores")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rows = pass_rows(passes(dev), dev)
    if dev.type != "cuda":
        print("ms per call, rates and DECISION: not measured (cpu)")
        return rows
    best = {r["name"]: r["ms"] for r in rows}
    base = best.get(WHOLE_TILE, best["landed"])
    for name, ms in best.items():
        print(f"{name}: {ms:.4f} ms/call, {flops() / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
              f"{base / ms:.2f}x vs whole-tile")
    print(decision(best))
    return rows


if __name__ == "__main__":
    main()
