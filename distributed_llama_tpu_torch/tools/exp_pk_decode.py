"""The packed-byte substitution in the Q40 GEMV: the `& 0xF` dropped.

Counterpart of the JAX repository's tools/exp_pk_decode.py, at its shapes:
w1 22016 x 4096 and attn 4096 x 4096 (d x n), t = 1, weights quantized
from N(0, 0.05) with f16 scales, x from N(0, 1). Substituting lo = pk -
16 hi into the product,

    y = x_lo . (lo s) + x_hi . (hi s) = x_lo . (pk s) + (x_hi - 16 x_lo) . (hi s),

drops the mask from the unpack; the activation combination is made outside
the kernel. Both modes run the same GEMV (ops/cuda_probes.py q40_pk_gemv,
csrc/q40_gemv1_probes.cu, on the design of K1's t = 1 GEMV): base puts lo
and hi into the f32 magic constant, pk the byte and hi. K1 (ops/cuda_q40.py
q40_matmul, bf16, t = 1) runs on the same weight beside them. A line gives
ms per call, the bytes a call really moves and the rate; then the TPU
tool's lines: base and pk ms, their ratio, and pk's largest difference from
base relative to base's largest value; on the card, a DECISION line.

    python -m distributed_llama_tpu_torch.tools.exp_pk_decode [--device cuda|cpu]

With --device cpu the plain versions run each call once, untimed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import cuda_probes
from ..quants.numpy_codec import quantize_q40
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .kernel_experiments import k1_pass
from .timing import pass_rows, rotating

# (name, d, n, td): td is the TPU tool's row tile, kept for build()'s
# signature; the card's GEMV gives each row a warp
SHAPES = (("w1", 22016, 4096, 256), ("attn", 4096, 4096, 1024))


def build(mode: str, d: int, m: int, td: int):
    """run(x1, x2, xs, w) -> (1, d) f32 for one mode, m = n/2 packed bytes
    per row. td (the TPU tool's row tile) does not change the card's kernel."""
    def run(x1, x2, xs, w):
        if w.packed.shape != (d, m):
            raise ValueError(f"weight {tuple(w.packed.shape)} is not ({d}, {m})")
        return cuda_probes.q40_pk_gemv(mode, x1, x2, xs, w)
    return run


def make_case(d: int, n: int, seed: int, dev: torch.device) -> dict:
    """The TPU tool's inputs, in the port's layout: the weight from
    quantize_q40 (block-major bytes, f16 scales) and x1, x2 (base and pk),
    xs in the weight's byte order."""
    rng = np.random.default_rng(seed)
    scales, packed = quantize_q40(rng.standard_normal((d, n)).astype(np.float32) * 0.05)
    w = QuantizedTensor.from_host(scales, packed, dev)
    xr = rng.standard_normal((n // 32, 32)).astype(np.float32)
    x_lo, x_hi = xr[:, :16], xr[:, 16:]

    def row(a):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(1, -1)).to(dev)
    return {"w": w, "x1": row(x_lo), "xs": row(xr.sum(axis=1)),
            "x2": {"base": row(x_hi), "pk": row(x_hi - 16.0 * x_lo)}}


def call_bytes(d: int, n: int) -> int:
    """Bytes one call moves: packed bytes, f16 scales, x1, x2, xs, out."""
    return d * n // 2 + d * (n // 32) * 2 + n * 4 + (n // 32) * 4 + d * 4


def passes(dev: torch.device, cases: dict | None = None) -> list[tuple]:
    """(label, one call, bytes it moves) per shape and mode, and K1 at each
    shape on the same copies; a weight that fits the L2 cache rotates
    through copies."""
    cases = cases or {name: make_case(d, n, 0, dev) for name, d, n, _ in SHAPES}
    out = []
    for name, d, n, td in SHAPES:
        c = cases[name]
        nbytes = call_bytes(d, n)
        ws = rotating(lambda c=c: QuantizedTensor(c["w"].packed.clone(),
                                                  c["w"].scales.clone()), nbytes)
        for mode in cuda_probes.PK_MODES:
            run = build(mode, d, n // 2, td)
            out.append((f"{name} {mode}",
                        lambda run=run, c=c, ws=ws, mode=mode:
                        run(c["x1"], c["x2"][mode], c["xs"], ws()), nbytes))
        _, k1_call, k1_bytes = k1_pass(ws.copies, dev, rotate=True)
        out.append((f"{name} K1", k1_call, k1_bytes))
    return out


def decision(ms: dict) -> str:
    """The DECISION line from ms per call by label: does pk beat base by
    more than 3% at each shape, and each mode against K1 there."""
    ratios = {name: ms[f"{name} base"] / ms[f"{name} pk"] for name, *_ in SHAPES}
    wins = [name for name, r in ratios.items() if r > 1.03]
    verdict = (f"pk beats base by more than 3% at {', '.join(wins)}: a design for K1's next "
               "GEMV" if wins else "pk does not beat base by more than 3% at any shape: the "
               "nibble unpack stays")
    detail = "; ".join(
        f"{name} base/pk {ratios[name]:.3f}, base/K1 {ms[f'{name} base'] / ms[f'{name} K1']:.3f}, "
        f"pk/K1 {ms[f'{name} pk'] / ms[f'{name} K1']:.3f}" for name, *_ in SHAPES)
    return f"DECISION: {verdict} ({detail})"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cases = {name: make_case(d, n, 0, dev) for name, d, n, _ in SHAPES}
    rows = pass_rows(passes(dev, cases), dev)
    ms = {r["name"]: r["ms"] for r in rows}
    for name, d, n, td in SHAPES:
        c = cases[name]
        y = {mode: build(mode, d, n // 2, td)(c["x1"], c["x2"][mode], c["xs"], c["w"])
             for mode in cuda_probes.PK_MODES}
        err = ((y["pk"] - y["base"]).abs().max() / (y["base"].abs().max() + 1e-9)).item()
        base, pk = ms[f"{name} base"], ms[f"{name} pk"]
        times = ("not measured (cpu)" if base is None else
                 f"base {base:.4f} ms  pk {pk:.4f} ms  -> {base / pk:.3f}x")
        print(f"{name}: {times}  max-rel-err {err:.2e}")
    if dev.type == "cuda":
        print(decision(ms))
    return rows


if __name__ == "__main__":
    main()
