"""Q40 GEMV variants in bf16 arithmetic, measured head to head with K1.

Counterpart of the JAX repository's tools/kernel_experiments.py, at its
shape: L = 32 weights of 11008 x 4096 (d x n), t = 1, bf16 x, f32 out.

  A  the weight dequantized as bf16(bf16(nib - 8) * bf16(s))
     (ops/cuda_probes.py q40_matmul_a)
  B  unsigned nibbles, bf16(nib * bf16(s)), and -8 sum_b s xsum added as a
     correction (q40_matmul_b)
  K1 the port's Q40 matmul (ops/cuda_q40.py q40_matmul, bf16 in and out) on
     the same packed bytes with f16 scales

A and B read the weights with f32 scales, as the TPU variants' kernels
did. One pass runs a variant over all L weights; a line gives ms per pass,
the bytes a pass really moves and the rate.

    python -m distributed_llama_tpu_torch.tools.kernel_experiments
        [--device cuda|cpu]

With --device cpu the plain versions run each pass once, untimed.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import cuda_probes, cuda_q40
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .kernel_ladder import random_weights
from .timing import pass_rows

L, D, H = 32, 4096, 11008   # layers, n (model dim), d (FFN hidden dim)


def k1_pass(ws: list[QuantizedTensor], dev: torch.device, rotate: bool = False) -> tuple:
    """("K1", one pass of K1 over `ws` with their scales narrowed to f16
    (K1's scale type), bf16 x (ones) and out, t = 1, bytes it moves).
    rotate: each call launches K1 once, on the next of `ws` in turn (copies
    of one weight that pass the L2 cache), and moves one launch's bytes."""
    d, n = ws[0].packed.shape[0], ws[0].packed.shape[1] * 2
    wk = [QuantizedTensor(w.packed, w.scales.to(torch.float16)) for w in ws]
    x = torch.ones((1, n), dtype=torch.bfloat16, device=dev)
    launch = d * n // 2 + d * (n // 32) * 2 + n * 2 + d * 2
    turn = {"i": 0}

    def one_call():
        turn["i"] = (turn["i"] + 1) % len(wk)
        cuda_q40.q40_matmul(x, wk[turn["i"]], torch.bfloat16)

    def one_pass():
        for w in wk:
            cuda_q40.q40_matmul(x, w, torch.bfloat16)
    return ("K1", one_call, launch) if rotate else ("K1", one_pass, len(wk) * launch)


def passes(dev: torch.device) -> list[tuple]:
    """(label, one pass over the L weights, bytes it moves) for A, B and K1:
    one launch of the variant's kernel per weight."""
    ws = random_weights(L, H, D, 0, dev)
    x = torch.ones((1, D), dtype=torch.bfloat16, device=dev)
    nbytes = L * (H * D // 2 + H * (D // 32) * 4 + D * 2 + H * 4)

    def variant(fn):
        def one_pass():
            for w in ws:
                fn(x, w)
        return one_pass
    return [("A bf16", variant(cuda_probes.q40_matmul_a), nbytes),
            ("B bf16+corr", variant(cuda_probes.q40_matmul_b), nbytes),
            k1_pass(ws, dev)]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    return pass_rows(passes(dev), dev)


if __name__ == "__main__":
    main()
