"""Cost ladder of the Q40 decode GEMV: add one stage at a time, measure each.

Counterpart of the JAX repository's tools/kernel_ladder.py, at its shape:
L = 32 weights of 11008 x 4096 (d x n) in Q40 with f32 scales, t = 1. The
stages (ops/cuda_probes.py q40_ladder, csrc/q40_probes.cu) each read every
byte of the weight: read -> unpack -> convert -> mul -> dot. One pass runs
a stage over all L weights, so every launch reads its weight from device
memory; a line gives ms per pass, the bytes a pass really moves (packed
bytes, f32 scales, the output and, for dot, x) and the rate.

    python -m distributed_llama_tpu_torch.tools.kernel_ladder [stage ...]
        [--device cuda|cpu]

With --device cpu the plain versions run each pass once, untimed.
"""

from __future__ import annotations

import argparse
import functools

import torch

from ..ops import cuda_probes
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .timing import pass_rows

L, D, H = 32, 4096, 11008   # layers, n (model dim), d (FFN hidden dim)


def random_weights(layers: int, d: int, n: int, seed: int,
                   device) -> list[QuantizedTensor]:
    """`layers` random (d, n) Q40 weights made on `device` from `seed`:
    uniform packed bytes (block-major) and f32 scales in [0, 0.004)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [QuantizedTensor(
        torch.randint(0, 256, (d, n // 2), generator=gen, device=device,
                      dtype=torch.uint8),
        torch.rand((d, n // 32), generator=gen, device=device) * 0.004)
        for _ in range(layers)]


def pass_bytes(stage: str) -> int:
    """Bytes one pass of `stage` moves: each weight's packed bytes and f32
    scales, its (d,) int32/f32 output, and x (f32) for dot."""
    per = H * D // 2 + H * (D // 32) * 4 + H * 4
    return L * (per + (D * 4 if stage == "dot" else 0))


def passes(dev: torch.device, stages=cuda_probes.STAGES) -> list[tuple]:
    """(stage, one pass of it over the L weights, bytes it moves) per stage:
    one q40_ladder launch per weight."""
    ws = random_weights(L, H, D, 0, dev)
    x = torch.ones((1, D), device=dev)

    def one_pass(stage):
        for w in ws:
            cuda_probes.q40_ladder(stage, x, w)
    return [(s, functools.partial(one_pass, s), pass_bytes(s)) for s in stages]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stages", nargs="*",
                    help=f"stages to run, of {' '.join(cuda_probes.STAGES)} (all)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    unknown = set(a.stages) - set(cuda_probes.STAGES)
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")
    dev = resolve_device(a.device)
    return pass_rows(passes(dev, a.stages or cuda_probes.STAGES), dev)


if __name__ == "__main__":
    main()
