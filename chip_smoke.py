#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (distributed_llama_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

 1. print the card (nvidia-smi name and power limit); build both kernels
    from csrc/ with nvcc for sm_90a, one process per source, in parallel.
 2. K1, the Q40 matmul, against its plain PyTorch version at the Llama-2-7B
    projection shapes (wqkv, wo, w13, w2, wcls) for t in {1, 16, 256} in
    bf16 and t = 1 in f32: error against tolerance, kernel / plain / library
    (dequantized weight through torch.matmul) times and the bound. Then
    K1's two bf16 paths, GEMV and tensor-core, each checked and timed at
    t from 4 to 128 on the per-layer shapes: where their times cross is
    where cuda_q40.TC_MIN_T belongs.
 3. K3, flash attention, against its plain version at B = 1, hs = 128,
    S = 2048, (H, KVH) in {(32, 32), (32, 8)}, T in {1, 256}, pos0 in
    {0, 511, 2048 - T}, plus B = 2 with a different pos0 per row; library
    time is scaled_dot_product_attention over the filled prefix.
 4. The main path at full width: a Llama-2-7B Engine on cuda from seeded
    synthetic Q40 weights, greedy generate of 32 tokens after a 300-token
    prompt (one 256-token chunk plus a remainder). Launch counts are zeroed
    just before and read just after; every decode step must launch K1
    exactly 129 times and K3 exactly 32 times. Logits must be finite, and
    the prompt's logits and one decode step's logits after it must match the
    same engine run on the plain versions.
 5. The file path: the tiny fixture's .m/.t through the port's CLI on cuda
    (f32 tokens equal to the CLI on the CPU; both kernels launched).

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
# Llama-2-7B widths (bench.py:101 LLAMA2_7B): dim 4096, hidden 11008,
# 32 layers, 32/32 heads, vocab 32000, seq 2048
K1_SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096),
             "w13": (22016, 4096), "w2": (4096, 11008),
             "wcls": (32000, 4096)}
K1_PER_STEP = {"wqkv": 32, "wo": 32, "w13": 32, "w2": 32, "wcls": 1}
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
    from distributed_llama_tpu_torch.quants.torch_codec import (
        QuantizedTensor, dequantize_q40_torch)

    rows, paths = [], []
    for name, (d, n) in K1_SHAPES.items():
        wbytes = d * n // 2 + d * n // 32 * 2

        def make_w():
            packed = torch.randint(0, 256, (d, n // 2), generator=gen,
                                   device="cuda", dtype=torch.uint8)
            scales = (torch.rand((d, n // 32), generator=gen, device="cuda")
                      * 0.004 + 0.001).to(torch.float16)
            return QuantizedTensor(packed, scales)

        ws = rotating(make_w, wbytes)
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
            wd = rotating(lambda: dequantize_q40_torch(make_w(), dt),
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
    dt = torch.bfloat16
    for b, h, kvh, t, pos0 in cases:
        g = h // kvh
        cache_bytes = 2 * b * kvh * s * hs * 2
        kvs = rotating(lambda: (
            torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(dt),
            torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(dt)),
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
        ok = err <= tol and bool(torch.isfinite(got).all())

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
        ks = k[:, :, :fill].repeat_interleave(g, dim=1)
        vs = v[:, :, :fill].repeat_interleave(g, dim=1)
        sl = torch.arange(fill, device="cuda")
        mask = sl[None, None, :] <= q_pos[:, :, None]           # (B, T, fill)
        mask = mask[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        # this run's work: query token tt of row b sees pos0[b] + tt + 1
        # slots, for each of its H heads a q.k and a p.v of hs multiply-adds;
        # bytes: q and out once, K and V up to each row's last position
        seen = sum(p + tt + 1 for p in pos0 for tt in range(t))
        nbytes = (2 * q.numel() * 2
                  + sum(2 * kvh * min(p + t, s) * hs * 2 for p in pos0))
        ops = 4.0 * hs * h * seen
        bms, by = bound_ms(nbytes, ops, dt)
        row = dict(b=b, h=h, kvh=kvh, t=t, pos0=pos0, hs=hs, s=s,
                   dtype="bfloat16", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        rows.append(row)
        print("[K3] " + json.dumps(row))
        if not ok:
            fail(f"K3 b={b} h={h}/{kvh} t={t} pos0={pos0}: max err {err:.3g} > tol {tol:.3g}")
        del kvs, k, v, ks, vs
    torch.cuda.empty_cache()
    return {"rows": rows}


def _llama2_7b():
    from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec

    return ModelSpec(arch=ArchType.LLAMA, dim=4096, hidden_dim=11008,
                     n_layers=32, n_heads=32, n_kv_heads=32, vocab_size=32000,
                     seq_len=2048, hidden_act=HiddenAct.SILU)


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
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return {"device_ms_per_step": None, "top": []}
    print(f"[profile] kernel time per decode step {total:.3f} ms; top kernels:")
    for name, count, ms in rows[:10]:
        print(f"[profile]   {ms:8.4f} ms  x{count:6.1f}  {name[:90]}")
    return {"device_ms_per_step": total,
            "top": [dict(name=n[:120], per_step=c, ms=m) for n, c, m in rows[:20]]}


@contextlib.contextmanager
def plain_versions():
    """Route the forward through the kernels' plain versions (on the card)
    — the comparison run of phase 4; launches there are not counted."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40

    with mock.patch.object(cuda_q40, "q40_matmul", cuda_q40.q40_matmul_reference), \
            mock.patch.object(cuda_attention, "flash_attention",
                              cuda_attention.flash_attention_reference):
        yield


def phase_main_path() -> dict:
    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.sampler import Sampler

    spec = _llama2_7b()
    t0 = time.perf_counter()
    params = synthetic_q40_params(spec, seed=0, device="cuda")
    weight_bytes = sum(w.packed.numel() + w.scales.numel() * 2
                       for lw in params["layers"] for k, w in lw.items()
                       if k.startswith("w")) + \
        params["wcls"].packed.numel() + params["wcls"].scales.numel() * 2
    engine = Engine(spec, params, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] Llama-2-7B synthetic Q40 engine on cuda in "
          f"{time.perf_counter() - t0:.1f} s; Q40 weight bytes read per token "
          f"{weight_bytes / 1e9:.3f} GB")
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, spec.vocab_size, 299).tolist()
    n_decode = 32

    engine.generate(prompt[:40], 3, Sampler(spec.vocab_size, 0.0, 0.9, 1))  # warm-up
    engine.reset()
    torch.cuda.synchronize()

    cuda_q40.q40_matmul.launches = 0
    cuda_attention.flash_attention.launches = 0
    res = engine.generate(prompt, n_decode, Sampler(spec.vocab_size, 0.0, 0.9, 1))
    k1, k3 = cuda_q40.q40_matmul.launches, cuda_attention.flash_attention.launches

    n_fwd = 2 + (len(res.tokens) - 1)       # two prefill chunks + decode steps
    print(f"[main] generated {len(res.tokens)} tokens; launches K1 {k1}, K3 {k3} "
          f"over {n_fwd} forwards")
    if len(res.tokens) != n_decode:
        fail(f"generate returned {len(res.tokens)} tokens, wanted {n_decode}")
    if k1 != 129 * n_fwd or k3 != 32 * n_fwd:
        fail(f"launch counts K1 {k1} / K3 {k3}, wanted {129 * n_fwd} / {32 * n_fwd}")
    c1, c3 = k1, k3
    logits = engine.step(np.asarray([[res.tokens[-1]]], np.int32), engine.pos)
    torch.cuda.synchronize()
    d1 = cuda_q40.q40_matmul.launches - c1
    d3 = cuda_attention.flash_attention.launches - c3
    print(f"[main] one decode step: K1 {d1} launches, K3 {d3} launches")
    if (d1, d3) != (129, 32):
        fail(f"per-step launches K1 {d1} / K3 {d3}, wanted 129 / 32")
    if not bool(torch.isfinite(logits).all()):
        fail("decode logits not finite")

    profile = profile_decode(engine, res.tokens[-1])

    prefill_ms = res.stats.steps[0].generation_ms
    avg = res.stats.averages()
    decode_ms = avg.generation_ms
    gbps = weight_bytes / (avg.device_ms / 1e3)
    print(f"[main] prefill {len(prompt)} tokens in {prefill_ms:.1f} ms = "
          f"{len(prompt) / (prefill_ms / 1e3):.1f} tok/s; decode "
          f"{decode_ms:.3f} ms/token (device+copy {avg.device_ms:.3f} ms); "
          f"Q40 weight bytes {gbps / 1e9:.1f} GB/s = "
          f"{gbps / HBM_BYTES_PER_S:.3f} of 3.35 TB/s")

    # the prompt (a 256-token chunk and a 44-token one), then one decode
    # step at fill 300, through the kernels and through the plain versions
    def prompt_then_step():
        engine.reset()
        lpre = engine.prefill(prompt).float()
        ldec = engine.step(np.asarray([[int(lpre.argmax())]], np.int32),
                           engine.pos).float()
        return lpre, ldec

    kern = prompt_then_step()
    with plain_versions():
        plain = prompt_then_step()
    torch.cuda.synchronize()
    cmp = {}
    for what, lk, lp in zip(("prompt", "decode"), kern, plain):
        if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
            fail(f"{what} logits not finite")
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        rel_l2 = ((lk - lp).norm() / lp.norm()).item()
        same_top = int(lk.argmax()) == int(lp.argmax())
        print(f"[main] {what} logits kernels vs plain: max abs err {err:.4g} "
              f"(max |logit| {scale:.4g}, tol {LOGITS_TOL * scale:.4g}), rel L2 "
              f"{rel_l2:.3g} (tol {LOGITS_REL_L2_TOL}), same argmax {same_top}")
        if err > LOGITS_TOL * scale or rel_l2 > LOGITS_REL_L2_TOL:
            fail(f"{what} logits differ: max abs {err:.4g} (tol "
                 f"{LOGITS_TOL * scale:.4g}), rel L2 {rel_l2:.3g}")
        cmp[what] = dict(max_abs_err=err, rel_l2=rel_l2, same_argmax=same_top)
    del engine, params
    torch.cuda.empty_cache()
    busy = profile["device_ms_per_step"]
    if busy is not None:
        print(f"[main] device busy {busy:.3f} ms of {decode_ms:.3f} ms per "
              f"decode token: idle share {1 - busy / decode_ms:.3f}")
    return dict(k1_launches=k1, k3_launches=k3, forwards=n_fwd, profile=profile,
                prefill_tokens=len(prompt), prefill_ms=prefill_ms,
                prefill_tok_s=len(prompt) / (prefill_ms / 1e3),
                decode_ms_per_token=decode_ms, decode_device_ms=avg.device_ms,
                weight_bytes=weight_bytes, hbm_share=gbps / HBM_BYTES_PER_S,
                logits_vs_plain=cmp)


def phase_file_path() -> None:
    from distributed_llama_tpu_torch.apps import dllama
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.testing import write_fixture

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dllama.main(argv)
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = write_fixture(d, seed=77)
        common = ["--model", mpath, "--tokenizer", tpath, "--prompt",
                  "hello world", "--steps", "16", "--seed", "3",
                  "--temperature", "0"]
        cuda_q40.q40_matmul.launches = 0
        cuda_attention.flash_attention.launches = 0
        out = run(["inference", *common, "--device", "cuda"])
        k1, k3 = cuda_q40.q40_matmul.launches, cuda_attention.flash_attention.launches
        print("[file] " + " | ".join(out.strip().splitlines()[-5:]))
        if "Generated tokens:    16" not in out or not (k1 and k3):
            fail(f"CLI inference on cuda: K1 {k1}, K3 {k3} launches")
        f32 = ["generate", *common, "--compute-dtype", "f32", "--cache-dtype", "f32"]
        gpu = run(f32 + ["--device", "cuda"]).splitlines()
        cpu = run(f32 + ["--device", "cpu"]).splitlines()
        text = lambda lines: lines[next(i for i, l in enumerate(lines)  # noqa: E731
                                        if l.startswith("💡")):]
        print(f"[file] CLI f32 tokens cuda == cpu: {text(gpu) == text(cpu)}; "
              f"inference launches K1 {k1}, K3 {k3}")
        if text(gpu) != text(cpu):
            fail(f"CLI f32 text differs: cuda {text(gpu)} vs cpu {text(cpu)}")


def summarize(k1: dict, k3: dict, main: dict) -> dict:
    """One entry per kernel: its time, plain and library times and bound for
    ONE Llama-2-7B decode step (t = 1, bf16) — K1 over 32 x (wqkv, wo, w13,
    w2) + wcls, K3 over 32 layers at fill 512 (MHA) — summed from the
    per-launch measurements above; launches from the main-path run."""
    dec = {r["shape"]: r for r in k1["rows"] if r["t"] == 1 and r["dtype"] == "bfloat16"}
    agg1 = {key: sum(dec[s][key] * c for s, c in K1_PER_STEP.items())
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    a3 = next(r for r in k3["rows"] if r["b"] == 1 and r["kvh"] == 32
              and r["t"] == 1 and r["pos0"] == [511])
    return {"kernels": [
        dict(name="q40_matmul", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258",
             launches=main["k1_launches"],
             max_abs_err=max(r["max_abs_err"] for r in k1["rows"]),
             **agg1, bound_by="bytes",
             at="one 7B decode step: 32x(wqkv,wo,w13,w2)+wcls, t=1, bf16"),
        dict(name="flash_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233",
             launches=main["k3_launches"],
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"]),
             ms=32 * a3["ms"], plain_ms=32 * a3["plain_ms"],
             bound_ms=32 * a3["bound_ms"], bound_by=a3["bound_by"],
             library_ms=32 * a3["library_ms"],
             at="one 7B decode step: 32 layers, T=1, H=KVH=32, fill 512, bf16"),
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
    k3 = phase_k3(gen)
    main_path = phase_main_path()
    phase_file_path()
    kernels = summarize(k1, k3, main_path)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, k1=k1["rows"], k3=k3["rows"],
        main_path=main_path, kernels=kernels["kernels"],
        total_s=time.perf_counter() - t_start), indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
