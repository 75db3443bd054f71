"""int8 grouped-scale GEMV against the port's Q40 matmul.

Counterpart of the JAX repository's tools/exp_int8_dot.py, at its shape:
L = 24 weights of D x K = 11008 x 4096 int4 values, t = 1. The weight keeps
that tool's column-split packing (byte j holds column j in its low nibble
and column K/2 + j in its high nibble) and one f32 scale per row; the
activation is int8. The int4 values widen to int8 in registers and meet x
in an integer dot (ops/cuda_probes.py int8_gemv, csrc/q40_probes.cu). K1
(ops/cuda_q40.py q40_matmul, bf16, t = 1) runs on L Q40 weights of the same
shape beside it. A line gives ms per pass over the L weights, the bytes a
pass really moves and the rate.

    python -m distributed_llama_tpu_torch.tools.exp_int8_dot [--device cuda|cpu]

With --device cpu the plain versions run each pass once, untimed.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import cuda_probes
from ..utils.device import resolve_device
from .kernel_experiments import k1_pass
from .kernel_ladder import random_weights
from .timing import pass_rows

D, K = 11008, 4096
L = 24          # distinct weights per pass: every launch reads device memory


def random_int8_weights(layers: int, d: int, k: int, seed: int, device):
    """[(pk (d, k/2) u8, sc (d, 1) f32 in [0, 1))] * layers and xq (1, k)
    int8 in [-8, 8), made on `device` from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ws = [(torch.randint(0, 256, (d, k // 2), generator=gen, device=device,
                         dtype=torch.uint8),
           torch.rand((d, 1), generator=gen, device=device))
          for _ in range(layers)]
    xq = torch.randint(-8, 8, (1, k), generator=gen, device=device,
                       dtype=torch.int8)
    return ws, xq


def passes(dev: torch.device) -> list[tuple]:
    """(label, one pass over the L weights, bytes it moves) for the int8
    GEMV and K1: one launch of each kernel per weight."""
    ws, xq = random_int8_weights(L, D, K, 0, dev)

    def one_pass():
        for pk, sc in ws:
            cuda_probes.int8_gemv(xq, pk, sc)
    return [("int8 dp4a", one_pass, L * (D * K // 2 + D * 4 + K + D * 4)),
            k1_pass(random_weights(L, D, K, 1, dev), dev)]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    return pass_rows(passes(dev), dev)


if __name__ == "__main__":
    main()
