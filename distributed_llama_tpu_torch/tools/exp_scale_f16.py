"""f16-bit scales decoded in the kernel against f32 scales, in the Q40 GEMV.

Counterpart of the JAX repository's tools/exp_scale_f16.py, at its shape:
L = 32 weights of 22016 x 4096 (w13-sized, d x n), t = 1, f32 x and out,
random packed bytes and scales in [0.001, 0.005). The same GEMV (ops/
cuda_probes.py q40_matmul_scales, csrc/q40_gemv1_probes.cu, on the design
of K1's t = 1 GEMV) reads the scales as

  u16 scales  2-byte f16 bits, decoded by integer ops in the kernel
  f32 scales  4-byte f32, read as they are (about 10% more bytes a pass)

and K1 (ops/cuda_q40.py q40_matmul, bf16, t = 1) runs on the same bytes
with f16 scales beside them. A line gives ms per pass over the L weights,
the bytes a pass really moves and the rate; then the TPU tool's lines: the
relative difference of u16 from f32 scales (the f16 rounding of the
scales), each pass's ms and GB/s, and the speedup of u16 over f32; then a
DECISION line.

    python -m distributed_llama_tpu_torch.tools.exp_scale_f16 [--device cuda|cpu]

With --device cpu the plain versions run each pass once, untimed.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import cuda_probes
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .kernel_experiments import k1_pass
from .timing import pass_rows

L, T = 32, 1
D_OUT, D_IN = 11008 * 2, 4096   # w13-sized


def q40_matmul_u16(x: torch.Tensor, packed: torch.Tensor,
                   scales_u16: torch.Tensor) -> torch.Tensor:
    """y (1, d) f32 = x (1, n) f32 . W, W's scales as uint16 f16 bits."""
    return cuda_probes.q40_matmul_scales(x, QuantizedTensor(packed, scales_u16))


def make_layers(dev: torch.device, seed: int = 0):
    """[(packed (d, n/2) u8, scales f32, the same scales as u16 f16 bits)]
    * L and x (1, D_IN) f32, made on `dev` from `seed`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = []
    for _ in range(L):
        packed = torch.randint(0, 256, (D_OUT, D_IN // 2), generator=gen, device=dev,
                               dtype=torch.uint8)
        sc = torch.rand((D_OUT, D_IN // 32), generator=gen, device=dev) * 0.004 + 0.001
        layers.append((packed, sc, sc.to(torch.float16).view(torch.uint16)))
    x = torch.randn((T, D_IN), generator=gen, device=dev)
    return layers, x


def pass_bytes(scale_bytes: int) -> int:
    """Bytes one pass moves: each weight's packed bytes and scales, x, out."""
    return L * (D_OUT * D_IN // 2 + D_OUT * (D_IN // 32) * scale_bytes
                + D_IN * 4 + D_OUT * 4)


def passes(dev: torch.device, made=None) -> list[tuple]:
    """(label, one pass over the L weights, bytes it moves) for u16 and f32
    scales and K1: one launch of the kernel per weight."""
    layers, x = made or make_layers(dev)

    def u16_pass():
        for p, _, su in layers:
            q40_matmul_u16(x, p, su)

    def f32_pass():
        for p, sc, _ in layers:
            cuda_probes.q40_matmul_scales(x, QuantizedTensor(p, sc))
    return [("u16 scales", u16_pass, pass_bytes(2)),
            ("f32 scales", f32_pass, pass_bytes(4)),
            k1_pass([QuantizedTensor(p, sc) for p, sc, _ in layers], dev)]


def decision(ms: dict) -> str:
    """The DECISION line from ms per pass by label: the integer decode's
    cost against K1 (the hardware convert of f16 scales, the same weight
    bytes; bf16 x), and whether f32 over u16 tracks the f32 scales' extra
    bytes: bytes-bound at >= 1.08, issue-bound at <= 1.03, else mixed."""
    u16, f32, k1 = ms["u16 scales"], ms["f32 scales"], ms["K1"]
    r = f32 / u16
    kind = "bytes-bound" if r >= 1.08 else "issue-bound" if r <= 1.03 else "mixed"
    return (f"DECISION: u16 takes {u16 / k1:.3f}x K1's time (integer decode and f32 x against "
            f"the hardware convert and bf16 x); f32/u16 {r:.3f} for "
            f"{pass_bytes(4) / pass_bytes(2):.3f}x the bytes: {kind} at this shape")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    layers, x = made = make_layers(dev)
    p, sc, su = layers[0]
    a = cuda_probes.q40_matmul_scales(x, QuantizedTensor(p, sc))
    b = q40_matmul_u16(x, p, su)
    err = ((a - b).abs().max() / a.abs().max().clamp_min(1e-9)).item()
    print(f"rel err u16 vs f32 scales: {err:.2e}")
    rows = pass_rows(passes(dev, made), dev)
    r = {row["name"]: row for row in rows}
    if dev.type == "cuda":
        t32, t16 = r["f32 scales"]["ms"], r["u16 scales"]["ms"]
        print(f"f32 scales: {t32:7.4f} ms  ({r['f32 scales']['gbps']:6.1f} GB/s total)")
        print(f"u16 scales: {t16:7.4f} ms  ({r['u16 scales']['gbps']:6.1f} GB/s total)")
        print(f"speedup: {t32 / t16:.3f}x")
        print(decision({name: row["ms"] for name, row in r.items()}))
    return rows


if __name__ == "__main__":
    main()
