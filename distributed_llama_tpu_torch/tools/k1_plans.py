"""Every tile plan of K1's tensor-core path, checked and timed on the card.

The plan (ops/cuda_q40.py tc_plan: tokens a CTA, 64/128/256, and the
2-CTA cluster split of n, 1/2) is a cost model fitted to these timings. At
the Llama-2-7B projection shapes (wqkv, wo, w13, w2) and Mixtral 8x7B's
dense-expert shapes, for t in 44, 128 and 256, each plan runs through the
kernel's plan entry (csrc/q40_matmul.cu q40_matmul_tc_launch), is held
against q40_matmul_reference within one bf16 ulp of the largest output,
and is timed; beside it the library call (the dequantized bf16 weight
through torch.matmul) and the bound. One line per (shape, t): the planned
choice, then every plan fastest first.

    python -m distributed_llama_tpu_torch.tools.k1_plans

It needs the card: the plans exist only in the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import cuda_build, cuda_q40
from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from ..utils.device import resolve_device
from .timing import PEAK_OPS, rotating, time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w13": (22016, 4096),
          "w2": (4096, 11008), "moe_gate_up": (14336, 4096),
          "moe_down": (4096, 14336)}
TS = (44, 128, 256)
PLANS = [(bn, split) for split in (1, 2) for bn in cuda_q40.TC_TOKENS]


def _entry():
    fn = cuda_build.load("q40_matmul").q40_matmul_tc_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _random_q40(gen: torch.Generator, d: int, n: int) -> QuantizedTensor:
    return QuantizedTensor(
        torch.randint(0, 256, (d, n // 2), generator=gen, device="cuda", dtype=torch.uint8),
        (torch.rand((d, n // 32), generator=gen, device="cuda") * 0.004 + 0.001).half())


def main(argv: list[str] | None = None) -> list[dict]:
    del argv
    resolve_device("cuda")
    fn = _entry()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, (d, n) in SHAPES.items():
        ws = rotating(lambda: _random_q40(gen, d, n), d * n // 2 + d * n // 16)
        w0 = ws()
        wd = rotating(lambda: dequantize_q40_torch(_random_q40(gen, d, n), torch.bfloat16),
                      d * n * 2)
        for t in TS:
            x = torch.randn((t, n), generator=gen, device="cuda").bfloat16()
            out = torch.empty((t, d), device="cuda", dtype=torch.bfloat16)
            want = cuda_q40.q40_matmul_reference(x, w0, torch.bfloat16).float()
            tol = 2.0 ** -7 * want.abs().max().item()
            us = {}
            for bn, split in PLANS:
                def run(w=None, bn=bn, split=split):
                    w = w or ws()
                    cuda_build.check(fn(x.data_ptr(), w.packed.data_ptr(), w.scales.data_ptr(),
                                        out.data_ptr(), t, n, d, bn, split,
                                        torch.cuda.current_stream().cuda_stream),
                                     "q40_matmul_tc_launch")
                run(w0)
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                if not (err <= tol and bool(torch.isfinite(out).all())):
                    raise SystemExit(f"k1_plans: {name} t={t} plan {bn}/{split}: max err "
                                     f"{err:.3g} > tol {tol:.3g}")
                us[f"{bn}/{split}"] = time_ms(run) * 1e3
            lib = time_ms(lambda: torch.matmul(x, wd().t())) * 1e3
            bound = 2.0 * t * d * n / PEAK_OPS[torch.bfloat16] * 1e6
            plan = "{}/{}".format(*cuda_q40.tc_plan(t, n, d))
            rows.append(dict(shape=name, d=d, n=n, t=t, plan=plan, us=us, library_us=lib,
                             bound_us=bound))
            print(f"{name} t={t}: plan {plan} {us[plan]:.1f} us, library {lib:.1f}, bound "
                  f"{bound:.1f}; " + ", ".join(f"{k} {v:.1f}" for k, v in
                                             sorted(us.items(), key=lambda kv: kv[1])),
                  flush=True)
        del ws, w0, wd
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
