#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (distributed_llama_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

 1. print the card (nvidia-smi name and power limit); build the kernels
    from csrc/ with nvcc for sm_90a, one process per source, in parallel.
 2. K1, the Q40 matmul, against its plain PyTorch version at the Llama-2-7B
    projection shapes (wqkv, wo, w13, w2, wcls) for t in {1, 16, 256} in
    bf16 and t = 1 in f32: error against tolerance, kernel / plain / library
    (dequantized weight through torch.matmul) times and the bound. Then
    K1's two bf16 paths, GEMV and tensor-core, each checked and timed at
    t from 4 to 128 on the per-layer shapes: where their times cross is
    where cuda_q40.TC_MIN_T belongs.
 3. K2, the expert-indexed Q40 matmul, against its plain version at the
    Mixtral 8x7B and Grok-1 expert shapes (gate/up and down; 8 experts, 2
    active), t in {1, 4}, bf16 and f32; library time is index_select of the
    two experts' bytes, dequantize to the dtype, torch.matmul.
 4. K3, flash attention, against its plain version at B = 1, hs = 128,
    S = 2048, (H, KVH) in {(32, 32), (32, 8)}, T in {1, 256}, pos0 in
    {0, 511, 2048 - T}, plus B = 2 with a different pos0 per row, with a
    bf16 cache and with an fp8 (e4m3) cache; library time is
    scaled_dot_product_attention over the filled prefix (in bf16).
 5. The main paths at full width, each an Engine on cuda from seeded
    synthetic Q40 weights, greedy generate after a prompt. Launch counts
    are zeroed just before each generate and read just after; every
    prefill chunk and decode step must launch exactly its kernels' counts.
    Logits must be finite, and the prompt's logits and one decode step's
    logits after it must match the same engine run on the plain versions
    (MoE routing replayed from the kernel run, so a near-tie cannot pick
    other experts; the script prints how many decisions would differ):
      * Llama-2-7B, 300-token prompt, 32 tokens: per step K1 129, K3 32;
      * Mixtral 8x7B, 32 layers, the same prompt and count: per step K1 65,
        K2 96, K3 32, per 256-token chunk K1 833, K2 0, K3 32; its MoE
        block must run under torch.cuda.set_sync_debug_mode("error"); then
        the same with an fp8 (e4m3) KV cache;
      * Grok-1 widths cut to 2 layers, 40-token prompt, 8 tokens: per step
        K1 5, K2 6, K3 2.
 6. The file path: tiny fixtures' .m/.t through the port's CLI on cuda
    (Llama and Mixtral: f32 tokens equal to the CLI on the CPU; the
    kernels launched; one --cache-dtype f8 run).

The line before the last holds the per-kernel JSON; the last line is
{"ok": true, "device": {...}}. Library calls are timed as yardsticks only:
the port never calls them.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50e6
F8 = torch.float8_e4m3fn
# Llama-2-7B widths (bench.py:101 LLAMA2_7B): dim 4096, hidden 11008,
# 32 layers, 32/32 heads, vocab 32000, seq 2048
K1_SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096),
             "w13": (22016, 4096), "w2": (4096, 11008),
             "wcls": (32000, 4096)}
K1_PER_STEP = {"wqkv": 32, "wo": 32, "w13": 32, "w2": 32, "wcls": 1}
# expert (d, n) shapes: Mixtral 8x7B (mistralai/Mixtral-8x7B-v0.1
# config.json; bench.py:121 MIXTRAL_MOE) and Grok-1 (bench.py:139
# GROK1_TRUNC); gate and up share a shape
K2_SHAPES = {"mixtral_gate_up": (14336, 4096), "mixtral_down": (4096, 14336),
             "grok1_gate_up": (32768, 6144), "grok1_down": (6144, 32768)}
N_EXPERTS, N_ACTIVE = 8, 2
# tolerances on max |kernel - plain|, as a share of max |plain|:
# bf16 outputs may differ by one bf16 ulp (2^-7 relative at the largest
# value; both sides round an f32 sum); f32 outputs only by summation order
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}
# logits of a 32-layer bf16 forward, kernels vs plain versions: one-ulp
# differences in every bf16 activation compound through the layers
LOGITS_TOL = 5e-2
# and their relative L2 distance (observed ~1e-3 on the prompt's logits)
LOGITS_REL_L2_TOL = 1e-2
# token counts at which K1's two bf16 paths (GEMV, tensor-core) are timed
# side by side to place cuda_q40.TC_MIN_T; the GEMV path's cost steps every
# 4 then 8 tokens, the tensor-core path's every 64
K1_PATH_TS = (4, 8, 9, 12, 16, 24, 32, 48, 64, 128)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, budget_ms: float = 60.0, max_iters: int = 100) -> float:
    """Mean device ms per call. The calls are captured in a CUDA graph and
    the graph is replayed between CUDA events, so the host's per-launch
    cost (Python, ctypes, argument checks) does not pad short kernels. An
    eager call first warms up and sizes the count to fill about budget_ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = int(min(max_iters, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def rotating(make, nbytes: int):
    """Enough copies of an operand that cycling through them exceeds the L2
    cache, so every timed call reads its operand from device memory, as the
    main path does."""
    copies = [make() for _ in range(max(1, min(8, math.ceil(2 * L2_BYTES / nbytes))))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / PEAK_OPS[dtype] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def random_q40(gen, *shape: int):
    from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor

    *lead, n = shape
    packed = torch.randint(0, 256, (*lead, n // 2), generator=gen,
                           device="cuda", dtype=torch.uint8)
    scales = (torch.rand((*lead, n // 32), generator=gen, device="cuda")
              * 0.004 + 0.001).to(torch.float16)
    return QuantizedTensor(packed, scales)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build() -> float:
    from distributed_llama_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(p.name for p in libs.values())} in {dt:.1f} s")
    return dt


def phase_k1(gen) -> dict:
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    rows, paths = [], []
    for name, (d, n) in K1_SHAPES.items():
        wbytes = d * n // 2 + d * n // 32 * 2
        ws = rotating(lambda: random_q40(gen, d, n), wbytes)
        w0 = ws()
        for t, dt in ((1, torch.bfloat16), (16, torch.bfloat16),
                      (256, torch.bfloat16), (1, torch.float32)):
            x = torch.randn((t, n), generator=gen, device="cuda").to(dt)
            got = cuda_q40.q40_matmul(x, w0, dt)
            want = cuda_q40.q40_matmul_reference(x, w0, dt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = TOL[dt] * scale
            ok = err <= tol and bool(torch.isfinite(got).all())
            ms = time_ms(lambda: cuda_q40.q40_matmul(x, ws(), dt))
            plain = time_ms(lambda: cuda_q40.q40_matmul_reference(x, ws(), dt))
            wd = rotating(lambda: dequantize_q40_torch(random_q40(gen, d, n), dt),
                          d * n * x.element_size())
            lib = time_ms(lambda: torch.matmul(x, wd().t()))
            del wd
            nbytes = wbytes + t * n * x.element_size() + t * d * x.element_size()
            bms, by = bound_ms(nbytes, 2.0 * t * d * n, dt)
            row = dict(shape=name, d=d, n=n, t=t, dtype=str(dt).split(".")[-1],
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bms, bound_by=by)
            rows.append(row)
            print("[K1] " + json.dumps(row))
            if not ok:
                fail(f"K1 {name} t={t} {dt}: max err {err:.3g} > tol {tol:.3g}")
        if name != "wcls":       # wcls runs at t = 1 only (the last position)
            paths += k1_paths(gen, name, d, n, ws, w0)
        del ws, w0
        torch.cuda.empty_cache()
    # per layer: wqkv + wo + w13 + w2, each path's time summed at each t
    per_layer = {t: {p: sum(r[p + "_ms"] for r in paths if r["t"] == t)
                     for p in ("gemv", "tc")} for t in K1_PATH_TS}
    cross = next((t for t in K1_PATH_TS
                  if per_layer[t]["tc"] <= per_layer[t]["gemv"]), None)
    print("[K1-path] per-layer ms (gemv / tc): " + ", ".join(
        f"t={t}: {v['gemv']:.4f} / {v['tc']:.4f}" for t, v in per_layer.items()))
    print(f"[K1-path] first t where the tensor-core path is no slower: {cross}; "
          f"TC_MIN_T = {cuda_q40.TC_MIN_T}")
    return {"rows": rows, "paths": paths, "tc_from": cross}


def k1_paths(gen, name: str, d: int, n: int, ws, w0) -> list[dict]:
    """K1's GEMV and tensor-core paths side by side in bf16: each checked
    against the plain version and timed, at every t of K1_PATH_TS."""
    from distributed_llama_tpu_torch.ops import cuda_q40

    dt = torch.bfloat16
    force = {"gemv": cuda_q40.MAX_T + 1, "tc": 1}   # tc_min_t per path
    rows = []
    for t in K1_PATH_TS:
        x = torch.randn((t, n), generator=gen, device="cuda").to(dt)
        want = cuda_q40.q40_matmul_reference(x, w0, dt).float()
        tol = TOL[dt] * want.abs().max().item()
        row = dict(shape=name, d=d, n=n, t=t)
        for path, tc_min_t in force.items():
            got = cuda_q40._launch(x, w0, dt, tc_min_t=tc_min_t).float()
            err = (got - want).abs().max().item()
            if not (err <= tol and bool(torch.isfinite(got).all())):
                fail(f"K1 {path} path {name} t={t}: max err {err:.3g} > tol {tol:.3g}")
            row[path + "_ms"] = time_ms(
                lambda: cuda_q40._launch(x, ws(), dt, tc_min_t=tc_min_t), budget_ms=20.0)
            row[path + "_err"] = err
        rows.append(row)
        print("[K1-path] " + json.dumps(row))
    return rows


def phase_k2(gen) -> dict:
    """K2 at the MoE expert shapes: an (8, d, n) stack, 2 active experts.
    The timed calls cycle the active pair through all 8 experts, so the
    stack's bytes (264 MB at Mixtral) keep each call's reads out of L2."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import (
        QuantizedTensor, dequantize_q40_torch)

    rows = []
    pairs = [torch.tensor([2 * i + 1, 2 * i], dtype=torch.int32, device="cuda")
             for i in range(N_EXPERTS // 2)]
    for name, (d, n) in K2_SHAPES.items():
        w = random_q40(gen, N_EXPERTS, d, n)
        state = {"i": 0}

        def idx():
            state["i"] = (state["i"] + 1) % len(pairs)
            return pairs[state["i"]]
        per_expert = name.endswith("down")   # down takes one x per expert
        for t in (1, 4):
            for dt in (torch.bfloat16, torch.float32):
                shape = (N_ACTIVE, t, n) if per_expert else (t, n)
                x = torch.randn(shape, generator=gen, device="cuda").to(dt)
                got = cuda_q40.q40_expert_matmul(x, w, pairs[0], dt)
                want = cuda_q40.q40_expert_matmul_reference(x, w, pairs[0], dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[dt] * want.float().abs().max().item()
                ok = err <= tol and bool(torch.isfinite(got).all()) and \
                    tuple(got.shape) == (N_ACTIVE, t, d)

                def library():
                    sel = idx().long()
                    wd = dequantize_q40_torch(QuantizedTensor(
                        w.packed.index_select(0, sel),
                        w.scales.index_select(0, sel)), dt)
                    return torch.matmul(x, wd.transpose(-1, -2))

                ms = time_ms(lambda: cuda_q40.q40_expert_matmul(x, w, idx(), dt))
                plain = time_ms(lambda: cuda_q40.q40_expert_matmul_reference(
                    x, w, idx(), dt))
                lib = time_ms(library)
                nbytes = (N_ACTIVE * (d * n // 2 + d * n // 32 * 2)
                          + x.numel() * x.element_size()
                          + N_ACTIVE * t * d * x.element_size())
                bms, by = bound_ms(nbytes, 2.0 * N_ACTIVE * t * d * n, dt)
                row = dict(shape=name, e=N_EXPERTS, k=N_ACTIVE, d=d, n=n, t=t,
                           dtype=str(dt).split(".")[-1], max_abs_err=err,
                           tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                rows.append(row)
                print("[K2] " + json.dumps(row))
                if not ok:
                    fail(f"K2 {name} t={t} {dt}: max err {err:.3g} > tol "
                         f"{tol:.3g}, shape {tuple(got.shape)}")
        del w
        torch.cuda.empty_cache()
    return {"rows": rows}


def phase_k3(gen) -> dict:
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention

    cases = []
    for h, kvh in ((32, 32), (32, 8)):
        for t in (1, 256):
            for p0 in (0, 511, 2048 - t):
                cases.append((1, h, kvh, t, [p0]))
    cases += [(2, 32, 8, 1, [100, 1500]), (2, 32, 8, 16, [100, 1500])]
    rows = []
    hs, s = 128, 2048
    dt = torch.bfloat16              # q and the output
    for cdt in (torch.bfloat16, F8):  # the cache
        for b, h, kvh, t, pos0 in cases:
            g = h // kvh
            csize = torch.tensor([], dtype=cdt).element_size()
            cache_bytes = 2 * b * kvh * s * hs * csize
            kvs = rotating(lambda: (
                torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(cdt),
                torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(cdt)),
                cache_bytes)
            k, v = kvs()
            q = torch.randn((b, t, h, hs), generator=gen, device="cuda").to(dt)
            q_pos = (torch.tensor(pos0, device="cuda", dtype=torch.int32)[:, None]
                     + torch.arange(t, device="cuda", dtype=torch.int32)[None, :])
            got = cuda_attention.flash_attention(q, k, v, q_pos)
            want = cuda_attention.flash_attention_reference(q, k, v, q_pos)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dt] * want.float().abs().max().item()
            ok = err <= tol and bool(torch.isfinite(got).all()) and got.dtype == dt

            def run_kernel():
                kk, vv = kvs()
                cuda_attention.flash_attention(q, kk, vv, q_pos)

            def run_plain():
                kk, vv = kvs()
                cuda_attention.flash_attention_reference(q, kk, vv, q_pos)

            ms = time_ms(run_kernel)
            plain = time_ms(run_plain)
            fill = max(pos0) + t
            qs = q.transpose(1, 2)                                  # (B, H, T, hs)
            ks = k[:, :, :fill].to(dt).repeat_interleave(g, dim=1)
            vs = v[:, :, :fill].to(dt).repeat_interleave(g, dim=1)
            sl = torch.arange(fill, device="cuda")
            mask = sl[None, None, :] <= q_pos[:, :, None]           # (B, T, fill)
            mask = mask[:, None]
            lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
            # this run's work: query token tt of row b sees pos0[b] + tt + 1
            # slots, for each of its H heads a q.k and a p.v of hs multiply-adds;
            # bytes: q and out once, K and V up to each row's last position
            seen = sum(p + tt + 1 for p in pos0 for tt in range(t))
            nbytes = (2 * q.numel() * 2
                      + sum(2 * kvh * min(p + t, s) * hs * csize for p in pos0))
            ops = 4.0 * hs * h * seen
            bms, by = bound_ms(nbytes, ops, dt)
            row = dict(b=b, h=h, kvh=kvh, t=t, pos0=pos0, hs=hs, s=s,
                       dtype="bfloat16", cache=str(cdt).split(".")[-1],
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bms, bound_by=by)
            rows.append(row)
            print("[K3] " + json.dumps(row))
            if not ok:
                fail(f"K3 {cdt} cache b={b} h={h}/{kvh} t={t} pos0={pos0}: max err "
                     f"{err:.3g} > tol {tol:.3g}")
            del kvs, k, v, ks, vs
    torch.cuda.empty_cache()
    return {"rows": rows}


def _spec(name: str):
    from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec

    if name == "llama2_7b":      # bench.py:101 LLAMA2_7B
        return ModelSpec(arch=ArchType.LLAMA, dim=4096, hidden_dim=11008,
                         n_layers=32, n_heads=32, n_kv_heads=32, vocab_size=32000,
                         seq_len=2048, hidden_act=HiddenAct.SILU)
    if name == "mixtral_8x7b":   # mistralai/Mixtral-8x7B-v0.1, all 32 layers
        return ModelSpec(arch=ArchType.MIXTRAL, dim=4096, hidden_dim=14336,
                         n_layers=32, n_heads=32, n_kv_heads=8, vocab_size=32000,
                         seq_len=2048, hidden_act=HiddenAct.SILU,
                         rope_theta=1000000.0, n_experts=N_EXPERTS,
                         n_active_experts=N_ACTIVE)
    # Grok-1 widths cut to 2 of 64 layers (bench.py:139 GROK1_TRUNC)
    return ModelSpec(arch=ArchType.GROK1, dim=6144, hidden_dim=32768,
                     n_layers=2, n_heads=48, n_kv_heads=8, vocab_size=131072,
                     seq_len=2048, hidden_act=HiddenAct.GELU, rope_theta=10000.0,
                     n_experts=N_EXPERTS, n_active_experts=N_ACTIVE)


def _counters() -> dict:
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40

    return {"K1": cuda_q40.q40_matmul, "K2": cuda_q40.q40_expert_matmul,
            "K3": cuda_attention.flash_attention}


def zero_counts() -> None:
    for f in _counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {k: f.launches for k, f in _counters().items()}


def decode_weight_bytes(spec, params) -> int:
    """Q40 bytes one decode step reads: every dense projection, the active
    share of every expert stack, and wcls."""
    def nbytes(w):
        return w.packed.numel() + 2 * w.scales.numel()

    total = nbytes(params["wcls"])
    for lw in params["layers"]:
        for key, w in lw.items():
            if key.startswith("moe_") and key != "moe_router":
                total += nbytes(w) * spec.n_active_experts // spec.n_experts
            elif key.startswith("w"):
                total += nbytes(w)
    return total


def profile_decode(engine, token: int, steps: int = 4) -> dict:
    """Device time per decode step by kernel name, from torch.profiler over
    a few steps (each ends in its logits copy, as in generate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.fetch_logits(engine.step(np.asarray([[token]], np.int32), engine.pos))
        torch.cuda.synchronize()

    # kernel events only: a CPU op's row repeats the device time of the
    # kernels it launched
    rows = sorted(((e.key, e.count / steps, e.self_device_time_total / 1e3 / steps)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    # the host side: CUDA runtime calls per step (launches, copies, syncs;
    # the logits copy ends each step with one)
    runtime = sorted(((e.key, e.count / steps) for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU and e.key.startswith("cuda")),
                     key=lambda r: -r[1])
    print("[profile] CUDA runtime calls per decode step: "
          + ", ".join(f"{k} {c:.1f}" for k, c in runtime[:6]))
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return {"device_ms_per_step": None, "top": [], "runtime_calls": runtime}
    print(f"[profile] kernel time per decode step {total:.3f} ms; top kernels:")
    for name, count, ms in rows[:10]:
        print(f"[profile]   {ms:8.4f} ms  x{count:6.1f}  {name[:90]}")
    return {"device_ms_per_step": total, "runtime_calls": runtime,
            "device_ops_per_step": sum(r[1] for r in rows),
            "top": [dict(name=n[:120], per_step=c, ms=m) for n, c, m in rows[:20]]}


@contextlib.contextmanager
def plain_versions():
    """Route the forward through the kernels' plain versions (on the card)
    — the comparison runs of phase 5; launches there are not counted."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40

    with mock.patch.object(cuda_q40, "q40_matmul", cuda_q40.q40_matmul_reference), \
            mock.patch.object(cuda_q40, "q40_expert_matmul",
                              cuda_q40.q40_expert_matmul_reference), \
            mock.patch.object(cuda_attention, "flash_attention",
                              cuda_attention.flash_attention_reference):
        yield


@contextlib.contextmanager
def recorded_routes():
    """Record the expert indices of every moe_route call, in order."""
    from distributed_llama_tpu_torch.models import transformer

    route, rec = transformer.moe_route, []

    def record(logits, k):
        weights, idx = route(logits, k)
        rec.append(idx)
        return weights, idx
    with mock.patch.object(transformer, "moe_route", record):
        yield rec


@contextlib.contextmanager
def replayed_routes(rec: list):
    """Give each moe_route call the recorded run's expert indices, weighted
    by this run's own probabilities; count the decisions (token x layer)
    whose own top-k set would have differed."""
    from distributed_llama_tpu_torch.models import transformer

    route, state = transformer.moe_route, {"i": 0, "differ": [], "decisions": 0}

    def replay(logits, k):
        idx = rec[state["i"]]
        state["i"] += 1
        _, own = route(logits, k)
        state["differ"].append(
            (own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
        state["decisions"] += idx[..., 0].numel()
        top = torch.softmax(logits.float(), dim=-1).gather(-1, idx)
        return top / top.sum(dim=-1, keepdim=True), idx
    with mock.patch.object(transformer, "moe_route", replay):
        yield state


def compare_with_plain(engine, prompt: list[int]) -> dict:
    """The prompt, then one decode step, through the kernels and through
    the plain versions on the same engine (routing replayed); both logits
    held to LOGITS_TOL and LOGITS_REL_L2_TOL."""
    def prompt_then_step(token=None):
        engine.reset()
        lpre = engine.prefill(prompt).float()
        tok = int(lpre.argmax()) if token is None else token
        ldec = engine.step(np.asarray([[tok]], np.int32), engine.pos).float()
        return (lpre, ldec), tok

    with recorded_routes() as rec:
        kern, tok = prompt_then_step()
    with plain_versions(), replayed_routes(rec) as rep:
        plain, _ = prompt_then_step(tok)
    torch.cuda.synchronize()
    differ = int(sum(int(x) for x in rep["differ"]))
    out = {"routing_decisions": rep["decisions"], "routing_would_differ": differ,
           "logits": [t.cpu() for t in kern]}
    if rec:
        print(f"[main]   routing replayed: {differ} of {rep['decisions']} "
              f"decisions (token x layer) would have picked other experts")
    for what, lk, lp in zip(("prompt", "decode"), kern, plain):
        if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
            fail(f"{what} logits not finite")
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        rel_l2 = ((lk - lp).norm() / lp.norm()).item()
        same_top = int(lk.argmax()) == int(lp.argmax())
        print(f"[main]   {what} logits kernels vs plain: max abs err {err:.4g} "
              f"(max |logit| {scale:.4g}, tol {LOGITS_TOL * scale:.4g}), rel L2 "
              f"{rel_l2:.3g} (tol {LOGITS_REL_L2_TOL}), same argmax {same_top}")
        if err > LOGITS_TOL * scale or rel_l2 > LOGITS_REL_L2_TOL:
            fail(f"{what} logits differ: max abs {err:.4g} (tol "
                 f"{LOGITS_TOL * scale:.4g}), rel L2 {rel_l2:.3g}")
        out[what] = dict(max_abs_err=err, rel_l2=rel_l2, same_argmax=same_top)
    return out


def check_moe_block_sync_free(engine) -> None:
    """One decode layer's MoE block under set_sync_debug_mode("error"): a
    host sync (.item(), .tolist(), a host read of the routing) raises."""
    from distributed_llama_tpu_torch.models import transformer

    spec = engine.spec
    xb = torch.randn((1, 1, spec.dim), device="cuda").to(engine.compute_dtype)
    torch.cuda.synchronize()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = transformer._moe_ffn(xb, engine.params["layers"][0], spec,
                                       engine.compute_dtype)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("MoE block output not finite")
    print("[main]   the MoE decode block ran under set_sync_debug_mode('error')")


def drive_path(label: str, engine, prompt: list[int], n_decode: int,
               per_chunk: dict, per_step: dict, weight_bytes: int) -> dict:
    """One main path: greedy generate with exact launch counts, one more
    decode step, profile, and the comparison with the plain versions."""
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = engine.spec.vocab_size
    engine.generate(prompt[:40], 3, Sampler(vocab, 0.0, 0.9, 1))  # warm-up
    engine.reset()
    torch.cuda.synchronize()

    zero_counts()
    res = engine.generate(prompt, n_decode, Sampler(vocab, 0.0, 0.9, 1))
    counts = read_counts()

    n_chunks = math.ceil(len(prompt) / engine.prefill_chunk)
    n_steps = len(res.tokens) - 1
    want = {k: n_chunks * per_chunk[k] + n_steps * per_step[k] for k in counts}
    print(f"[main] {label}: generated {len(res.tokens)} tokens; launches "
          f"{counts} over {n_chunks} prefill chunks + {n_steps} decode steps")
    if len(res.tokens) != n_decode:
        fail(f"{label}: generate returned {len(res.tokens)} tokens, wanted {n_decode}")
    if counts != want:
        fail(f"{label}: launch counts {counts}, wanted {want}")
    c0 = read_counts()
    logits = engine.step(np.asarray([[res.tokens[-1]]], np.int32), engine.pos)
    torch.cuda.synchronize()
    step = {k: v - c0[k] for k, v in read_counts().items()}
    print(f"[main] {label}: one decode step launches {step}")
    if step != per_step:
        fail(f"{label}: per-step launches {step}, wanted {per_step}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: decode logits not finite")

    profile = profile_decode(engine, res.tokens[-1])
    prefill_ms = res.stats.steps[0].generation_ms
    avg = res.stats.averages()
    decode_ms = avg.generation_ms
    gbps = weight_bytes / (avg.device_ms / 1e3)
    print(f"[main] {label}: prefill {len(prompt)} tokens in {prefill_ms:.1f} ms = "
          f"{len(prompt) / (prefill_ms / 1e3):.1f} tok/s; decode "
          f"{decode_ms:.3f} ms/token (device+copy {avg.device_ms:.3f} ms); "
          f"Q40 bytes per token {weight_bytes / 1e9:.3f} GB (bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms) at {gbps / 1e9:.1f} GB/s "
          f"= {gbps / HBM_BYTES_PER_S:.3f} of 3.35 TB/s")
    busy = profile["device_ms_per_step"]
    if busy is not None:
        print(f"[main] {label}: device busy {busy:.3f} ms of {decode_ms:.3f} ms per "
              f"decode token: idle share {1 - busy / decode_ms:.3f}")
    cmp = compare_with_plain(engine, prompt)
    return dict(label=label, launches=counts, per_step=step, chunks=n_chunks,
                decode_steps=n_steps, profile=profile, prefill_tokens=len(prompt),
                prefill_ms=prefill_ms, prefill_tok_s=len(prompt) / (prefill_ms / 1e3),
                decode_ms_per_token=decode_ms, decode_device_ms=avg.device_ms,
                weight_bytes=weight_bytes, hbm_share=gbps / HBM_BYTES_PER_S,
                idle_share=None if busy is None else 1 - busy / decode_ms,
                logits_vs_plain=cmp)


def _engine(spec, seed: int, params=None, **kw):
    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    if params is None:
        params = synthetic_q40_params(spec, seed=seed, device="cuda")
    engine = Engine(spec, params, device="cuda", **kw)
    torch.cuda.synchronize()
    print(f"[main] {spec.arch.name} {spec.n_layers} layers, synthetic Q40 engine on "
          f"cuda in {time.perf_counter() - t0:.1f} s ({kw or 'bf16 cache'})")
    return engine


def phase_main_paths() -> dict:
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, 32000, 299).tolist()
    out = {}

    spec = _spec("llama2_7b")
    engine = _engine(spec, seed=0)
    out["llama2_7b"] = drive_path(
        "Llama-2-7B", engine, prompt, 32,
        per_chunk={"K1": 129, "K2": 0, "K3": 32},
        per_step={"K1": 129, "K2": 0, "K3": 32},
        weight_bytes=decode_weight_bytes(spec, engine.params))
    out["llama2_7b"]["logits_vs_plain"].pop("logits")
    del engine
    torch.cuda.empty_cache()

    spec = _spec("mixtral_8x7b")
    engine = _engine(spec, seed=1)
    wb = decode_weight_bytes(spec, engine.params)
    moe_counts = dict(per_chunk={"K1": 833, "K2": 0, "K3": 32},
                      per_step={"K1": 65, "K2": 96, "K3": 32}, weight_bytes=wb)
    check_moe_block_sync_free(engine)
    out["mixtral_8x7b"] = drive_path("Mixtral 8x7B", engine, prompt, 32, **moe_counts)
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    engine = _engine(spec, seed=1, params=params, cache_dtype=F8)
    out["mixtral_8x7b_f8"] = drive_path("Mixtral 8x7B, f8 cache", engine, prompt,
                                        32, **moe_counts)
    lb = out["mixtral_8x7b"]["logits_vs_plain"].pop("logits")
    lf = out["mixtral_8x7b_f8"]["logits_vs_plain"].pop("logits")
    dist = {}
    for what, a, b in zip(("prompt", "decode"), lb, lf):
        dist[what] = dict(max_abs=(a - b).abs().max().item(),
                          rel_l2=((a - b).norm() / a.norm()).item())
    print(f"[main] Mixtral 8x7B logits, f8 cache vs bf16 cache (for information): {dist}")
    out["mixtral_8x7b_f8"]["logits_vs_bf16_cache"] = dist
    del engine, params
    torch.cuda.empty_cache()

    spec = _spec("grok1_2l")
    engine = _engine(spec, seed=2)
    gprompt = [1] + np.random.default_rng(8).integers(3, spec.vocab_size, 39).tolist()
    out["grok1_2l"] = drive_path(
        "Grok-1 (2 layers)", engine, gprompt, 8,
        per_chunk={"K1": 53, "K2": 0, "K3": 2},
        per_step={"K1": 5, "K2": 6, "K3": 2},
        weight_bytes=decode_weight_bytes(spec, engine.params))
    out["grok1_2l"]["logits_vs_plain"].pop("logits")
    del engine
    torch.cuda.empty_cache()
    return out


def phase_file_path() -> None:
    from distributed_llama_tpu_torch.apps import dllama
    from distributed_llama_tpu_torch.models.spec import ArchType
    from distributed_llama_tpu_torch.testing import write_fixture

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dllama.main(argv)
        return buf.getvalue()

    def text(lines):
        return lines[next(i for i, l in enumerate(lines) if l.startswith("💡")):]

    # seed 82 keeps every routing decision of the Mixtral run >= 1.8e-4 from
    # a tie on the CPU, so f32 rounding on the card cannot flip one
    fixtures = {"llama": dict(seed=77),
                "mixtral": dict(seed=82, arch=ArchType.MIXTRAL, n_experts=4,
                                n_active_experts=2)}
    for name, kw in fixtures.items():
        with tempfile.TemporaryDirectory() as d:
            mpath, tpath = write_fixture(d, **kw)
            common = ["--model", mpath, "--tokenizer", tpath, "--prompt",
                      "hello world", "--steps", "16", "--seed", "3",
                      "--temperature", "0"]
            zero_counts()
            out = run(["inference", *common, "--device", "cuda"])
            counts = read_counts()
            print(f"[file] {name}: " + " | ".join(out.strip().splitlines()[-5:]))
            need = ("K1", "K2", "K3") if name == "mixtral" else ("K1", "K3")
            if "Generated tokens:    16" not in out or not all(counts[k] for k in need):
                fail(f"CLI inference on cuda, {name}: launches {counts}")
            f32 = ["generate", *common, "--compute-dtype", "f32", "--cache-dtype", "f32"]
            gpu = run(f32 + ["--device", "cuda"]).splitlines()
            cpu = run(f32 + ["--device", "cpu"]).splitlines()
            print(f"[file] {name}: CLI f32 tokens cuda == cpu: {text(gpu) == text(cpu)}; "
                  f"inference launches {counts}")
            if text(gpu) != text(cpu):
                fail(f"CLI f32 text differs ({name}): cuda {text(gpu)} vs cpu {text(cpu)}")
            if name == "mixtral":
                f8 = run(["inference", *common, "--device", "cuda", "--cache-dtype", "f8"])
                print("[file] mixtral, --cache-dtype f8: "
                      + " | ".join(f8.strip().splitlines()[-5:]))
                if "Generated tokens:    16" not in f8:
                    fail("CLI inference with --cache-dtype f8 did not complete")


def summarize(k1: dict, k2: dict, k3: dict, main: dict) -> dict:
    """One entry per kernel (K3's e4m3 mode its own): its time, plain and
    library times and bound for ONE decode step (t = 1, bf16), summed from
    the per-launch measurements above — K1 and K3 of a Llama-2-7B step, K2
    and K3-e4m3 of a Mixtral 8x7B step; launches from the main-path runs."""
    dec = {r["shape"]: r for r in k1["rows"] if r["t"] == 1 and r["dtype"] == "bfloat16"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    agg1 = {key: sum(dec[s][key] * c for s, c in K1_PER_STEP.items()) for key in keys}
    k2r = {r["shape"]: r for r in k2["rows"] if r["t"] == 1 and r["dtype"] == "bfloat16"}
    # per Mixtral layer: gate and up (one shape) and down
    agg2 = {key: 32 * (2 * k2r["mixtral_gate_up"][key] + k2r["mixtral_down"][key])
            for key in keys}

    def k3_row(cache, kvh, pos0):
        return next(r for r in k3["rows"] if r["cache"] == cache and r["b"] == 1
                    and r["kvh"] == kvh and r["t"] == 1 and r["pos0"] == [pos0])
    a3 = k3_row("bfloat16", 32, 511)
    a8 = k3_row("float8_e4m3fn", 8, 511)
    plain_paths = ("llama2_7b", "mixtral_8x7b", "grok1_2l")

    def launches(k, paths):
        return sum(main[p]["launches"][k] for p in paths)
    return {"kernels": [
        dict(name="q40_matmul", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258",
             launches=launches("K1", plain_paths + ("mixtral_8x7b_f8",)),
             max_abs_err=max(r["max_abs_err"] for r in k1["rows"]),
             **agg1, bound_by="bytes",
             at="one 7B decode step: 32x(wqkv,wo,w13,w2)+wcls, t=1, bf16"),
        dict(name="q40_expert_matmul", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:319",
             launches=launches("K2", ("mixtral_8x7b", "mixtral_8x7b_f8", "grok1_2l")),
             max_abs_err=max(r["max_abs_err"] for r in k2["rows"]),
             **agg2, bound_by="bytes",
             at="one Mixtral 8x7B decode step: 32x(gate, up, down), 2 of 8 experts, "
                "t=1, bf16"),
        dict(name="flash_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233",
             launches=launches("K3", plain_paths),
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"]
                             if r["cache"] == "bfloat16"),
             ms=32 * a3["ms"], plain_ms=32 * a3["plain_ms"],
             bound_ms=32 * a3["bound_ms"], bound_by=a3["bound_by"],
             library_ms=32 * a3["library_ms"],
             at="one 7B decode step: 32 layers, T=1, H=KVH=32, fill 512, bf16"),
        dict(name="flash_attention_e4m3", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233 (e4m3 cache, "
                      ":135-144)",
             launches=main["mixtral_8x7b_f8"]["launches"]["K3"],
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"]
                             if r["cache"] == "float8_e4m3fn"),
             ms=32 * a8["ms"], plain_ms=32 * a8["plain_ms"],
             bound_ms=32 * a8["bound_ms"], bound_by=a8["bound_by"],
             library_ms=32 * a8["library_ms"],
             at="one Mixtral decode step: 32 layers, T=1, H=32/KVH=8, fill 512, "
                "e4m3 cache, bf16 q"),
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import distributed_llama_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    k1 = phase_k1(gen)
    k2 = phase_k2(gen)
    k3 = phase_k3(gen)
    main_paths = phase_main_paths()
    phase_file_path()
    kernels = summarize(k1, k2, k3, main_paths)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, k1=k1["rows"], k1_paths=k1["paths"],
        k2=k2["rows"], k3=k3["rows"], main_paths=main_paths,
        kernels=kernels["kernels"], total_s=time.perf_counter() - t_start), indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
