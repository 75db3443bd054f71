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
    bf16 and t = 1 in f32, and at Mixtral's dense-expert prefill shapes
    (14336x4096, 4096x14336) for t in {44, 256}: error against tolerance,
    kernel / plain / library (dequantized weight through torch.matmul)
    times and the bound. The tensor-core path's plan of each shape (tokens
    a CTA, split of n, CTAs), from the kernel's own plan export, must equal
    cuda_q40.tc_plan. Then K1's two bf16 paths, GEMV and tensor-core
    (wgmma), each checked and timed at t from 4 to 256 (44 a ragged chunk)
    on the per-layer shapes, beside plain, library and bound: where their
    times cross is where cuda_q40.TC_MIN_T belongs.
 2b. The Q80 round trip (csrc/q80_roundtrip.cu) against its plain version,
    bit for bit, at the 7B and Mixtral matmul input shapes (t 1 and 256;
    n 4096, 11008, 14336), bf16 and f32 in and out, timed beside it; each
    input holds a NaN block and a +inf and a -inf block, which must come
    out as NaN at the same 96 positions (the other values bit for bit).
 3. K2, the expert-indexed Q40 matmul, against its plain version at the
    Mixtral 8x7B and Grok-1 expert shapes (gate/up and down; 8 experts, 2
    active), t in {1, 4}, bf16 and f32; library time is index_select of the
    two experts' bytes, dequantize to the dtype, torch.matmul. Then the
    t = 1 GEMV that K1 and K2 share at its edges, in all four f32/bf16
    in/out pairs: d of 1-4097 (not a multiple of its 4-row items or of a
    CTA's rows), n of 1-3 Q40 blocks and n not a multiple of its 1024-value
    chunk; a NaN in x must reach every output, an expert index out of range
    is clamped; each case launched twice must give the same bits.
 3b. [GEMV1-Q80]: the Q80 round trip fused into that t = 1 GEMV (K1 and K2
    with activation_q80 at t = 1, x raw), at every t = 1 shape of the main
    paths (7B's five projections, Mixtral's wqkv, the Mixtral and Grok-1
    expert stacks) in all four dtype pairs, on a finite input (a zero
    block, exact halves) and on one holding a NaN, a +inf and a -inf
    block: each launch must equal the unfused pair (the standalone Q80
    kernel, then the GEMV) bit for bit with NaN at the same positions, be
    within TOL of the plain version and repeat bit for bit; then the 120
    edge cases of phase 3 with the round trip fused, held the same way.
    Timed at bf16 per shape (the fused launch, the GEMV alone, in turns;
    the Q80 kernel alone, the pair, the plain round trip), and summed over
    a 7B decode step (129 launches) and a Mixtral one (65 K1 + 96 K2).
 4. K3, flash attention, against its plain version with bf16 q at B = 1,
    hs = 128, S = 2048, (H, KVH) in {(32, 32), (32, 8)}, T in {1, 256},
    pos0 in {0, 511, 2048 - T}, plus B = 2 with a different pos0 per row,
    decode at P2's shape (H = KVH = 32, S = 8192, pos0 7680), T = 100 at
    pos0 1000 (a ragged last tile) and hs = 64 at a decode and a prefill
    case, each with a bf16 cache and with an fp8 (e4m3) cache (the
    tensor-core paths); then f32 q over an f32 cache at four cases and over
    an e4m3 cache at one (the exact f32 path). Each row names its split
    plan (rows a block, n_split); library time is
    scaled_dot_product_attention over the filled prefix (in q's dtype).
    Then K3 against its plain version, untimed, at 560 small cases that
    reach every path and edge (hs 16-128, G 1/4/6, S not a multiple of the
    tile, rows with no slot in a split). Then, at seven of the bf16 q
    cases, K3 at other split counts than the
    plan's, each checked and timed: where the plan's count stands. Last,
    one Mixtral decode call captured in a CUDA graph is replayed with its
    positions moved in place (bf16 and e4m3 caches), each replay held
    against the plain version.
 4b. The probes: the Q40 decode-GEMV design probes of the JAX repository's
    tools/, as ported into distributed_llama_tpu_torch/tools, at the tools'
    full shapes: kernel_ladder (P7, 32 x 11008x4096, stages read/unpack/
    convert/mul/dot), kernel_experiments (P4 A and B, the same shape, and
    K1 beside them) and exp_int8_dot (P1, 24 x 11008x4096, and K1). One
    untimed pass of each tool's passes, counts zeroed just before and read
    just after, must launch each kernel exactly once per weight (the ladder
    once per weight and stage); then the tool's timed lines, as its
    `python -m` entry point prints them. Then each probe kernel against its
    plain version at that shape (P1, read and unpack bit for bit, the rest
    within TOL), and the plain versions and the library yardstick (the
    dequantized bf16 weight through torch.matmul) timed over the same pass
    of weights. Then the later probes, each at its tool's shape, each pass
    counted on its own (counts zeroed just before, read just after, exact):
    exp_f8_flash (P2: one flash-decode call per cache mode, bf16 / e4m3
    astype / bits / bitsflush, B 1, KVH 32, S 8192, fill 7680; bits must
    equal astype bit for bit; library: SDPA on the filled prefix in bf16;
    then each mode timed at 2-24 blocks a row against its plan, and held at
    its edges: pos 0, 255, 256, S - 1 and past S, B 2 with unequal pos, S
    100, at the plan's split and at 1, 5 and 13; the kernel's plan export
    must equal cuda_probes.f8_split_plan),
    exp_pk_decode (P3: base and pk at w1 22016x4096 and attn 4096x4096, K1
    beside each shape), exp_scale_f16 (P5: 32 x 22016x4096 with u16 and f32
    scales, K1 beside; the kernel's f16 decode checked over all 63,488
    finite patterns), each tool's DECISION line; P3 and P5 (one kernel,
    csrc/q40_gemv1_probes.cu) timed at every body (the other item loop, the
    FMA dequantize, the loads alone, an empty launch of the same grid), as
    programmatic dependent launches and at 4-128 rows a CTA, every product
    body held within TOL; held at 52
    edges (d 1, 4, 5, 17 x n 32, 1024, 1056 with a row of zero scales, and
    4096x4096 with x = 0); their plans equal to cuda_probes.gemv1_rows; and
    exp_unpack_overlap (P6: 11008x4096, T 256, K1's tensor-core path as
    `landed` and every (td, n_sub); then each (td, n_sub) held at t 44, 300
    and 1, d = td and n 256); each kernel against its plain version
    (within TOL; P3 pk within 1e-4), then plain and library times. Every
    P2, P3, P5 and P6 launch checked is launched twice and must repeat bit
    for bit; each P2, P3/P5 and P6 kernel's registers and local (spill)
    bytes are printed.
 5. The main paths at full width, each an Engine on cuda from seeded
    synthetic Q40 weights with the Q80 activation round trip on (as the
    CLI builds it for a Q40 model; the plain side runs the round trip's
    plain version too), greedy generate after a prompt. Every decode step
    replays the engine's captured CUDA graph (captured in a warm-up
    generate); a replay adds the launches the capture tallied, so launch
    counts stay exact. Launch counts
    are zeroed just before each generate and read just after; every
    prefill chunk and decode step must launch exactly its kernels' counts.
    Logits must be finite, and the prompt's logits and one decode step's
    logits after it must match an eager engine over the same weights
    (cuda_graphs=False: a captured graph no longer calls the wrappers that
    plain_versions() patches) run on the kernels and on the plain versions
    (MoE routing replayed from the kernel run, so a near-tie cannot pick
    other experts; the script prints how many decisions would differ):
    Q80 counts the standalone round trip's launches, Q80F the K1 and K2
    launches with it fused in (t = 1; also counted under K1 and K2):
      * Llama-2-7B, 300-token prompt, 32 tokens: per step K1 129, K3 32,
        Q80 0, Q80F 129; per chunk K1 129, K3 32, Q80 128, Q80F 1 (wcls);
      * Mixtral 8x7B, 32 layers, the same prompt and count: per step K1 65,
        K2 96, K3 32, Q80 32 (the router), Q80F 161, per 256-token chunk K1
        833, K2 0, K3 32, Q80 864, Q80F 1; its MoE block must run under
        torch.cuda.set_sync_debug_mode("error"); then the same with an fp8
        (e4m3) KV cache;
      * Grok-1 widths cut to 2 layers, 40-token prompt, 8 tokens: per step
        K1 5, K2 6, K3 2, Q80 2, Q80F 11; per chunk K1 53, K3 2, Q80 54,
        Q80F 1.
    Each prints its decode step's cudaGraphLaunch and cudaLaunchKernel
    counts, the cudaMemcpyAsync calls by the ops that make them, and the
    idle share.
 5b. The graph phase of each main path (`[graph]` lines): the capture's
    seconds, pool and tally; the whole T = 1 forward at a device position
    under set_sync_debug_mode("error"); one decode step eager and replayed
    on the same cache state, logits and caches bit-identical; 32 greedy
    tokens of generate, eager and graph, identical; decode ms/token eager
    and graph in turns (A, B, A, B, A, B: median and spread), each with
    its profile (idle share, cudaGraphLaunch and cudaLaunchKernel a step);
    decode_greedy_device: 32 tokens equal to generate's with a greedy host
    sampler from the same zeroed state, then ms/token over 128 tokens (3
    runs) and its Q40 bytes a token as a share of 3.35 TB/s;
    generate_device at temperature 0 and at 0.8 / top-p 0.9 (fixed seeds)
    against host generate with the same seed: equal, or at 0.8 a
    neighbouring token in the host's CDF order with the coin within the
    f32 summation bound of a boundary (printed with its margin). After
    each path its engines are deleted and the memory left is printed.
 6. The file path: tiny fixtures' .m/.t through the port's CLI on cuda
    (Llama and Mixtral: one run at the CLI's defaults, bf16 with Q80
    activations, whose kernels must launch, the fused round trip included;
    f32 tokens with
    --buffer-float-type f32 equal to the CLI on the CPU, and with
    --device-sampling too; one --device-sampling run at the defaults; one
    --cache-dtype f8 run; Llama: `dllama api --serve-batch 2` built from
    the CLI's arguments, one chat request, its f32 text equal to the same
    server's on the CPU).
 7. Serving (`[serve]` lines; run after phase 5, over its Llama-2-7B
    weights, full width and depth): (a) an Engine of B = 4 slots with Q80
    activations and a bf16 cache; the scheduler's warmup captures the
    slot decode graph, whose tally must be 129 K1 (the tensor-core path at
    t = 4), 32 K3 and 129 standalone Q80; three batch steps eager and
    replayed on the same cache state, tokens and positions moved between
    replays and a row gated in one, logits and caches bit-identical; a
    batch step and a chunk on the kernels against the plain versions on
    the eager twin (LOGITS_TOL, LOGITS_REL_L2_TOL); a (4, 256) chunk with
    rows 1 and 3 gated at pos S: their caches bit-untouched, the live
    rows' logits those of a batch-1 prefill of the same tokens; exact
    launches of a chunk (K1 1, K3 32, Q80 129) and of a step. (b) The
    scheduler: 8 greedy requests, seeded prompts of 40-300 tokens, 32
    tokens each, 4 submitted at once and 4 while those decode; exact
    launches over the run; each request's tokens equal to a sequential
    batch-1 generate up to the first batch-1 top-2 logit gap within the
    logits tolerance (printed); every live row of 4 batch steps against
    the batch-1 step at the same position and cache contents. Then ms per
    batch step with 4 live rows, eager and graph in turns (each step with
    its logits to the host and a greedy pick a row), aggregate tok/s,
    the step's profile (idle share, cudaGraphLaunch/cudaLaunchKernel).
    (c) `dllama api --serve-batch 4` in-process on 127.0.0.1:0 (ApiState
    over the 7B engine, a byte-fallback tokenizer of its vocab): four
    concurrent greedy streaming clients, two chat and two completions,
    whose text equals the scheduler's for the same prompts; /v1/models,
    /healthz, /readyz, /stats 200; a prompt past S 400; the legacy path's
    chat text equal to generate's. Printed with the card: tok/s, ms a
    batch step, TTFT and ITL p50/p95, ms a (4, 256) chunk, the idle share,
    and K1 at t = 4, the 129 standalone Q80 and K3 over 4 rows, each a
    step's sum against its bound, plain version and library call. K1's
    t = 4 layer rows come from phase 2's path rows, wcls's is timed here;
    the Q80 and K3 rows from phases 2b and 4, which run the batch step's
    shapes (Q80 at 4 x 4096 and 4 x 11008; K3 over 4 rows at their own
    fills, and with rows gated at S in a step and in a 256-token chunk).

Before the per-kernel JSON, the [K1] and [K2] step sums (one 7B step of K1,
one Mixtral step of K2, t = 1, bf16) print beside their bound and the share
of it, the serving phase's three step sums at B = 4, and the [GEMV1-Q80] step sums (fused, GEMV alone, GEMV + standalone
Q80) of a 7B and a Mixtral step. The line before the last holds the
per-kernel JSON; the last line is
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

from distributed_llama_tpu_torch.tools.timing import (HBM_BYTES_PER_S, bound_ms,
                                                       pass_rows, rotating, time_ms)

F8 = torch.float8_e4m3fn
# Llama-2-7B widths (bench.py:101 LLAMA2_7B): dim 4096, hidden 11008,
# 32 layers, 32/32 heads, vocab 32000, seq 2048
K1_SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096),
             "w13": (22016, 4096), "w2": (4096, 11008),
             "wcls": (32000, 4096)}
K1_PER_STEP = {"wqkv": 32, "wo": 32, "w13": 32, "w2": 32, "wcls": 1}
# Mixtral 8x7B's dense-expert prefill shapes (every expert of a chunk runs
# through K1): gate and up 14336x4096, down 4096x14336
K1_MOE_SHAPES = {"moe_gate_up": (14336, 4096), "moe_down": (4096, 14336)}
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
K1_PATH_TS = (2, 4, 8, 9, 12, 16, 24, 32, 44, 48, 64, 128, 256)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    libs = cuda_build.build_all(cuda_build.KERNELS + cuda_build.PROBES)
    dt = time.perf_counter() - t0
    print(f"[build] {', '.join(p.name for p in libs.values())} in {dt:.1f} s")
    # the t = 1 GEMV's registers a thread (2 CTAs of 256 threads an SM need
    # at most 128), from the library just built
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    lines = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(libs["q40_matmul"])],
                           capture_output=True, text=True, timeout=120).stdout.splitlines() \
        if cuobjdump.exists() else []
    # (template arguments as mangled: f float, 13__nv_bfloat16 bf16, S1_ /
    # S2_ a repeat of an earlier type; Lb1E the Q80 round trip fused in)
    for i, line in enumerate(lines[:-1]):
        if "q40_gemv1_kernel" in line:
            args = line.split("q40_gemv1_kernelI", 1)[1].split("EEv", 1)[0]
            print(f"[build] q40_gemv1_kernel<{args}>: {lines[i + 1].strip()}")
    return dt


def phase_k1(gen) -> dict:
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    rows, paths = [], []
    for name, (d, n) in {**K1_SHAPES, **K1_MOE_SHAPES}.items():
        wbytes = d * n // 2 + d * n // 32 * 2
        ws = rotating(lambda: random_q40(gen, d, n), wbytes)
        w0 = ws()
        runs = (((44, torch.bfloat16), (256, torch.bfloat16)) if name in K1_MOE_SHAPES else
                ((1, torch.bfloat16), (16, torch.bfloat16), (256, torch.bfloat16),
                 (1, torch.float32)))
        for t, dt in runs:
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
            tc = cuda_q40.uses_tc_path(dt, dt, t, n)
            row = dict(shape=name, d=d, n=n, t=t, dtype=str(dt).split(".")[-1],
                       path="tc" if tc else "gemv",
                       plan=cuda_q40.tc_plan(t, n, d) if tc else None,
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bms, bound_by=by)
            rows.append(row)
            print("[K1] " + json.dumps(row))
            if not ok:
                fail(f"K1 {name} t={t} {dt}: max err {err:.3g} > tol {tol:.3g}")
        if name in K1_PER_STEP and name != "wcls":   # wcls runs at t = 1 only
            paths += k1_paths(gen, name, d, n, ws, w0)
        del ws, w0
        torch.cuda.empty_cache()
    plans = tc_plans()
    # per layer: wqkv + wo + w13 + w2, each path's time summed at each t
    per_layer = {t: {p: sum(r[p + "_ms"] for r in paths if r["t"] == t)
                     for p in ("gemv", "tc")} for t in K1_PATH_TS}
    cross = next((t for t in K1_PATH_TS
                  if per_layer[t]["tc"] <= per_layer[t]["gemv"]), None)
    print("[K1-path] per-layer ms (gemv / tc): " + ", ".join(
        f"t={t}: {v['gemv']:.4f} / {v['tc']:.4f}" for t, v in per_layer.items()))
    print(f"[K1-path] first t where the tensor-core path is no slower: {cross}; "
          f"TC_MIN_T = {cuda_q40.TC_MIN_T}")
    return {"rows": rows, "paths": paths, "tc_from": cross, "plans": plans}


def tc_plans() -> dict:
    """The tensor-core path's plan (tokens a CTA, split of n, CTAs) of every
    K1 shape at t = 44 and 256, from csrc/q40_matmul.cu's own plan export;
    it must equal ops/cuda_q40.py tc_plan, the rule the CPU tests pin."""
    import ctypes

    from distributed_llama_tpu_torch.ops import cuda_build, cuda_q40

    fn = cuda_build.load("q40_matmul").q40_matmul_tc_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    out = {}
    for name, (d, n) in {**K1_SHAPES, **K1_MOE_SHAPES}.items():
        if name == "wcls":
            continue
        for t in K1_PATH_TS:
            got = [ctypes.c_int() for _ in range(2)]
            fn(t, n, d, *(ctypes.byref(v) for v in got))
            got = tuple(v.value for v in got)
            if got != cuda_q40.tc_plan(t, n, d):
                fail(f"K1 plan {name} t={t}: C {got} != python {cuda_q40.tc_plan(t, n, d)}")
            if t in (44, 256):
                out[f"{name} t={t}"] = dict(bn=got[0], split=got[1],
                                            ctas=cuda_q40.tc_ctas(t, n, d))
    print("[K1-plan] tensor-core tiles (tokens a CTA / split of n / CTAs): " + ", ".join(
        f"{k}: {v['bn']}/{v['split']}/{v['ctas']}" for k, v in out.items()))
    return out


def k1_paths(gen, name: str, d: int, n: int, ws, w0) -> list[dict]:
    """K1's GEMV and tensor-core paths side by side in bf16: each checked
    against the plain version and timed, at every t of K1_PATH_TS."""
    from distributed_llama_tpu_torch.ops import cuda_q40

    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    dt = torch.bfloat16
    force = {"gemv": cuda_q40.MAX_T + 1, "tc": 1}   # tc_min_t per path
    rows = []
    wd = rotating(lambda: dequantize_q40_torch(random_q40(gen, d, n), dt), d * n * 2)
    for t in K1_PATH_TS:
        x = torch.randn((t, n), generator=gen, device="cuda").to(dt)
        want = cuda_q40.q40_matmul_reference(x, w0, dt).float()
        tol = TOL[dt] * want.abs().max().item()
        bn, split = cuda_q40.tc_plan(t, n, d)
        nbytes = d * n // 2 + d * n // 32 * 2 + 2 * t * n + 2 * t * d
        bms, by = bound_ms(nbytes, 2.0 * t * d * n, dt)
        row = dict(shape=name, d=d, n=n, t=t, tc_bn=bn, tc_split=split,
                   tc_ctas=cuda_q40.tc_ctas(t, n, d), bound_ms=bms, bound_by=by,
                   plain_ms=time_ms(lambda: cuda_q40.q40_matmul_reference(x, ws(), dt)),
                   library_ms=time_ms(lambda: torch.matmul(x, wd().t())))
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
    del wd
    return rows


# the t = 1 GEMV's edges, (d, n): d not a multiple of its 4-row items or of
# a CTA's rows, n of 1-3 Q40 blocks (most lanes of a chunk past n), n not
# a multiple of a 1024-value chunk, 7B's w2 width
GEMV1_EDGES = ((1, 32), (3, 64), (37, 96), (130, 1056), (4097, 11008))
DTYPE_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
               (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def held(tag: str, fn, want: torch.Tensor, odt, pair=None) -> dict:
    """One case of the t = 1 GEMV: the kernel within TOL of the plain
    version, finite where the plain version is, NaN where it is, and a
    second launch bit-identical to the first. With `pair` (the fused Q80
    round trip): the launch also equals the unfused pair (the standalone
    Q80 kernel, then the GEMV) bit for bit, NaN at the same positions."""
    got, again = fn(), fn()
    ref = pair() if pair is not None else None
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    err = (got.float() - want.float())[~nan].abs().max().item() if (~nan).any() else 0.0
    tol = TOL[odt] * (want.float()[~nan].abs().max().item() if (~nan).any() else 0.0)
    ok = (tuple(got.shape) == tuple(want.shape) and err <= tol
          and torch.equal(torch.isnan(got), nan) and bool(torch.isfinite(got[~nan]).all())
          and same_bits(got, again))
    row = dict(case=tag, max_abs_err=err, tol=tol, nan=int(nan.sum()), repeat_equal=same_bits(got, again))
    if ref is not None:
        row["pair_equal"] = (torch.equal(torch.isnan(ref), nan)
                             and same_bits(got[~nan], ref[~nan]))
        ok = ok and row["pair_equal"]
    if not ok:
        fail(f"t = 1 GEMV {tag}: {row}")
    return row


def gemv1_edges(gen, q80: bool = False) -> list[dict]:
    """The t = 1 GEMV behind K1 and K2 against q40_matmul_reference and
    q40_expert_matmul_reference at its edges (GEMV1_EDGES), in each pair of
    f32/bf16 in and out: a NaN in x must reach every output, an expert
    index out of range is clamped, and every case launched twice gives the
    same bits. q80: the same cases with the Q80 round trip fused in, each
    also bit-equal to the unfused pair (the standalone Q80 kernel, then the
    GEMV)."""
    from distributed_llama_tpu_torch.ops import cuda_q40, cuda_q80

    rows = []
    for d, n in GEMV1_EDGES:
        w = random_q40(gen, d, n)
        we = random_q40(gen, N_EXPERTS, d, n)
        for dt, odt in DTYPE_PAIRS:
            x = torch.randn((1, n), generator=gen, device="cuda").to(dt)
            xn = x.clone()
            xn[0, n // 2 + 1] = math.nan
            tag = f"d={d} n={n} {str(dt)[6:]}->{str(odt)[6:]}"
            for label, xx in (("", x), (" NaN in x", xn)):
                rows.append(held(
                    "K1 " + tag + label,
                    lambda: cuda_q40.q40_matmul(xx, w, odt, activation_q80=q80),
                    cuda_q40.q40_matmul_reference(xx, w, odt, activation_q80=q80), odt,
                    pair=(lambda: cuda_q40.q40_matmul(cuda_q80.q80_roundtrip(xx, odt), w, odt))
                    if q80 else None))
            xk = torch.randn((N_ACTIVE, 1, n), generator=gen, device="cuda").to(dt)
            for label, xx, idx in (
                    ("", x, [5, 2]), (" per expert", xk, [1, 7]),
                    (" index out of range", xk, [-3, N_EXPERTS + 3]), (" NaN in x", xn, [0, 6])):
                ix = torch.tensor(idx, dtype=torch.int32, device="cuda")
                rows.append(held(
                    "K2 " + tag + label,
                    lambda: cuda_q40.q40_expert_matmul(xx, we, ix, odt, activation_q80=q80),
                    cuda_q40.q40_expert_matmul_reference(xx, we, ix, odt, activation_q80=q80), odt,
                    pair=(lambda: cuda_q40.q40_expert_matmul(cuda_q80.q80_roundtrip(xx, odt),
                                                             we, ix, odt))
                    if q80 else None))
        del w, we
    tag = "[GEMV1-Q80] edges, Q80 round trip fused:" if q80 else "[GEMV1-edge] t = 1 GEMV:"
    print(f"{tag} {len(rows)} cases (K1 and K2; d {[e[0] for e in GEMV1_EDGES]}, "
          f"n {[e[1] for e in GEMV1_EDGES]}; 4 dtype pairs; NaN in x, clamped expert index), "
          f"each within TOL and bit-identical on a second launch"
          f"{', and bit-equal to the unfused pair' if q80 else ''}; max err share "
          f"{max(r['max_abs_err'] / r['tol'] if r['tol'] else 0.0 for r in rows):.3f} of TOL")
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


# the t = 1 shapes of the fused Q80 round trip, (d, n, experts): K1's 7B
# projections and Mixtral's wqkv (32 KV heads of 128 -> 8: 6144x4096; its
# wo and wcls are 7B's), K2's Mixtral and Grok-1 expert stacks
GEMV1_Q80_SHAPES = {**{k: (d, n, 0) for k, (d, n) in K1_SHAPES.items()},
                    "mixtral_wqkv": (6144, 4096, 0),
                    **{k: (d, n, N_EXPERTS) for k, (d, n) in K2_SHAPES.items()}}
# launches a decode step (t = 1, bf16): Llama-2-7B's 129 K1; Mixtral's 65 K1
# and 96 K2 (gate and up each one launch a layer, down one)
GEMV1_Q80_STEPS = {
    "llama2_7b": {"wqkv": 32, "wo": 32, "w13": 32, "w2": 32, "wcls": 1},
    "mixtral_8x7b": {"mixtral_wqkv": 32, "wo": 32, "wcls": 1,
                     "mixtral_gate_up": 64, "mixtral_down": 32}}


def q80_input(gen, shape, dt, nonfinite: bool) -> torch.Tensor:
    """A matmul input for the fused round trip: values of very different
    sizes, a zero block, a block whose absmax is 127 holding exact halves,
    a block whose scale is below f16's range (it comes out as zeros);
    nonfinite: in its first row also a NaN block, a +inf and a -inf block
    (each comes out as 32 NaNs) and a block whose absmax is past f16's
    range times 127 (an inf scale: +-inf, and NaN where q is 0)."""
    x = torch.randn(shape, generator=gen, device="cuda")
    x = x * torch.rand((*shape[:-1], 1), generator=gen, device="cuda") * 30
    x[..., :32] = 0.0
    x[..., 32:64] = x[..., 32:64].clamp(-100.0, 100.0)
    x[..., 32:36] = torch.tensor([127.0, 0.5, 1.5, -2.5], device="cuda")
    x[..., 192:224] *= 1e-38   # a scale below f16's range (and 1 / scale past f32's)
    if nonfinite:
        first = x.reshape(-1, shape[-1])[0]
        first[64 + 5] = math.nan
        first[96 + 31] = math.inf
        first[128] = -math.inf
        first[160 + 9] = 3e7
    return x.to(dt)


def phase_gemv1_q80(gen) -> dict:
    """The Q80 round trip fused into the t = 1 GEMV of K1 and K2, at every
    t = 1 shape of the main paths (GEMV1_Q80_SHAPES) in all four f32/bf16
    in/out pairs, on a finite input and on one holding a NaN, a +inf, a
    -inf and an inf-scale block (K2's per-expert x: in expert 0's only):
    the fused launch equals the unfused pair (the standalone Q80 kernel,
    then the GEMV) bit for bit with NaN at the same positions, is within
    TOL of the plain version, and repeats bit for bit; then the edge cases. Timed at bf16:
    the fused launch, the GEMV alone (on the round-tripped input), the Q80
    kernel alone, the pair, and the plain round trip; summed over a 7B and
    a Mixtral decode step."""
    from distributed_llama_tpu_torch.ops import cuda_q40, cuda_q80

    bf16 = torch.bfloat16
    rows, timed = [], {}
    pairs = [torch.tensor([2 * i + 1, 2 * i], dtype=torch.int32, device="cuda")
             for i in range(N_EXPERTS // 2)]
    for name, (d, n, experts) in GEMV1_Q80_SHAPES.items():
        ws = None if experts else rotating(lambda: random_q40(gen, d, n),
                                           d * n // 2 + d * n // 32 * 2)
        w0 = random_q40(gen, experts, d, n) if experts else ws()
        state = {"i": 0}

        def idx():
            state["i"] = (state["i"] + 1) % len(pairs)
            return pairs[state["i"]]
        xshape = (N_ACTIVE, 1, n) if name.endswith("down") else (1, n)
        if experts:
            def kern(x, odt, q80, w=w0, ix=None):
                return cuda_q40.q40_expert_matmul(x, w, idx() if ix is None else ix, odt,
                                                  activation_q80=q80)

            def plain(x, odt, w=w0):
                return cuda_q40.q40_expert_matmul_reference(x, w, pairs[0], odt,
                                                            activation_q80=True)
            fixed = dict(ix=pairs[0])
        else:
            def kern(x, odt, q80, w=None, ix=None):
                return cuda_q40.q40_matmul(x, ws() if w is None else w, odt, activation_q80=q80)

            def plain(x, odt, w=w0):
                return cuda_q40.q40_matmul_reference(x, w, odt, activation_q80=True)
            fixed = dict(w=w0)
        for dt, odt in DTYPE_PAIRS:
            for nonfinite in (False, True):
                x = q80_input(gen, xshape, dt, nonfinite)
                tag = (f"{name} {str(dt)[6:]}->{str(odt)[6:]}"
                       f"{' NaN/+inf/-inf blocks' if nonfinite else ''}")
                rows.append(held(
                    tag, lambda: kern(x, odt, True, **fixed), plain(x, odt), odt,
                    pair=lambda: kern(cuda_q80.q80_roundtrip(x, odt), odt, False, **fixed)))
        x = q80_input(gen, xshape, bf16, False)
        xq = cuda_q80.q80_roundtrip(x, bf16)
        # in turns: GEMV, fused, fused, GEMV
        t = {}
        g1 = time_ms(lambda: kern(xq, bf16, False))
        f1 = time_ms(lambda: kern(x, bf16, True))
        f2 = time_ms(lambda: kern(x, bf16, True))
        g2 = time_ms(lambda: kern(xq, bf16, False))
        t["fused_ms"], t["gemv_ms"] = (f1 + f2) / 2, (g1 + g2) / 2
        t["q80_ms"] = time_ms(lambda: cuda_q80.q80_roundtrip(x, bf16))
        t["pair_ms"] = time_ms(lambda: kern(cuda_q80.q80_roundtrip(x, bf16), bf16, False))
        t["plain_q80_ms"] = time_ms(lambda: cuda_q80.q80_roundtrip_reference(x, bf16))
        t["x_bytes"] = x.numel() * x.element_size()
        t["bound_q80_ms"], _ = bound_ms(t["x_bytes"], 0.0, bf16)
        t["added_us"] = (t["fused_ms"] - t["gemv_ms"]) * 1e3
        timed[name] = t
        print(f"[GEMV1-Q80] {name} (d {d}, n {n}{', 2 of 8 experts' if experts else ''}), bf16: "
              f"fused {t['fused_ms'] * 1e3:.2f} us (runs {f1 * 1e3:.2f}, {f2 * 1e3:.2f}), "
              f"GEMV alone {t['gemv_ms'] * 1e3:.2f} us (runs {g1 * 1e3:.2f}, {g2 * 1e3:.2f}), "
              f"Q80 alone {t['q80_ms'] * 1e3:.2f} us, pair {t['pair_ms'] * 1e3:.2f} us; "
              f"fused - GEMV {t['added_us']:+.2f} us")
        del ws, w0, kern, plain, fixed
        torch.cuda.empty_cache()
    worst = max(r["max_abs_err"] / r["tol"] if r["tol"] else 0.0 for r in rows)
    print(f"[GEMV1-Q80] {len(rows)} cases at the main paths' t = 1 shapes (4 dtype pairs, finite "
          f"and NaN/+inf/-inf blocks): each bit-equal to the unfused pair with NaN at the same "
          f"positions, within TOL of the plain version (max err share {worst:.3f}), "
          f"bit-identical on a second launch")
    steps = {}
    for step, counts in GEMV1_Q80_STEPS.items():
        agg = {k: sum(timed[sh][k] * c for sh, c in counts.items())
               for k in ("fused_ms", "gemv_ms", "q80_ms", "pair_ms", "plain_q80_ms",
                         "bound_q80_ms")}
        agg["launches"] = sum(counts.values())
        agg["gemv_plus_q80_ms"] = agg["gemv_ms"] + agg["q80_ms"]
        agg["saved_ms"] = agg["gemv_plus_q80_ms"] - agg["fused_ms"]
        agg["fused_minus_gemv_ms"] = agg["fused_ms"] - agg["gemv_ms"]
        steps[step] = agg
        print(f"[GEMV1-Q80] {step} step ({agg['launches']} launches, bf16): fused "
              f"{agg['fused_ms']:.4f} ms; GEMV alone {agg['gemv_ms']:.4f}; Q80 alone "
              f"{agg['q80_ms']:.4f}; GEMV + Q80 {agg['gemv_plus_q80_ms']:.4f} (the pair in one "
              f"graph {agg['pair_ms']:.4f}); saved {agg['saved_ms']:.4f} ms; fused - GEMV "
              f"{agg['fused_minus_gemv_ms']:+.4f} ms")
    edges = gemv1_edges(gen, q80=True)
    return {"rows": rows, "timed": timed, "steps": steps, "edges": edges,
            "max_abs_err": max(r["max_abs_err"] for r in rows + edges)}


# Q80 round-trip inputs (tokens, width): 7B's and Mixtral's matmul inputs at
# a decode step and a 256-token chunk (dim 4096; 7B hidden 11008, Mixtral
# 14336, w2's and the expert down projection's)
Q80_SHAPES = ((1, 4096), (1, 11008), (1, 14336), (256, 4096), (256, 11008), (256, 14336),
              (4, 4096), (4, 11008))     # the last two: a 7B batch step's inputs, B = 4


def phase_q80(gen) -> dict:
    """The Q80 round trip against its plain version, bit for bit, at the
    7B and Mixtral matmul input shapes, f32 and bf16 in and out; timed
    beside the plain version (no single PyTorch call computes it)."""
    from distributed_llama_tpu_torch.ops import cuda_q80

    rows = []
    for t, n in Q80_SHAPES:
        for dt, odt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                        (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            if dt != odt and t != 256:
                continue
            # rows of very different sizes, a zero block and exact halves
            x = torch.randn((t, n), generator=gen, device="cuda")
            x = x * torch.rand((t, 1), generator=gen, device="cuda") * 30
            x[0, :32] = 0.0
            x[-1, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device="cuda")
            # a block holding a NaN, one holding +inf, one -inf: each comes
            # out as 32 NaNs in the plain version
            x[0, 32 + 5] = math.nan
            x[0, 64 + 31] = math.inf
            x[0, 96] = -math.inf
            x = x.to(dt)
            got = cuda_q80.q80_roundtrip(x, odt)
            want = cuda_q80.q80_roundtrip_reference(x, odt)
            torch.cuda.synchronize()
            # NaN at the same positions, every other value bit for bit (NaN
            # payloads may differ)
            nan = torch.isnan(want)
            exact = (torch.equal(torch.isnan(got), nan) and int(nan.sum()) == 96
                     and same_bits(got[~nan], want[~nan]))
            err = (got[~nan].float() - want[~nan].float()).abs().max().item()
            ms = time_ms(lambda: cuda_q80.q80_roundtrip(x, odt))
            plain = time_ms(lambda: cuda_q80.q80_roundtrip_reference(x, odt))
            bms, by = bound_ms(x.numel() * (x.element_size() + got.element_size()), 0.0, odt)
            row = dict(t=t, n=n, dtype=str(dt).split(".")[-1], out=str(odt).split(".")[-1],
                       exact=exact, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            print("[Q80] " + json.dumps(row))
            if not exact:
                fail(f"q80_roundtrip t={t} n={n} {dt}->{odt}: not bit-equal to the plain "
                     f"version (max err {err:.3g})")
    return {"rows": rows}


def phase_k3(gen) -> dict:
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention

    bf16 = torch.bfloat16
    # (b, h, kvh, t, pos0 per row, hs, S)
    cases = []
    for h, kvh in ((32, 32), (32, 8)):
        for t in (1, 256):
            for p0 in (0, 511, 2048 - t):
                cases.append((1, h, kvh, t, [p0], 128, 2048))
    cases += [(2, 32, 8, 1, [100, 1500], 128, 2048), (2, 32, 8, 16, [100, 1500], 128, 2048),
              (1, 32, 32, 1, [7680], 128, 8192),    # P2's shape: B1, KVH32, fill 7680
              (1, 32, 8, 100, [1000], 128, 2048),   # a ragged last tile
              (1, 32, 8, 1, [1500], 64, 2048),      # hs 64, decode and prefill
              (1, 32, 8, 256, [511], 64, 2048),
              # the serving phase's shapes: a 7B batch step, 4 rows at their
              # own fills; gated rows at pos0 == S in a step and in a chunk
              (4, 32, 32, 1, [511, 400, 300, 200], 128, 2048),
              (4, 32, 32, 1, [300, 2048, 100, 2048], 128, 2048),
              (4, 32, 32, 256, [0, 2048, 512, 2048], 128, 2048)]
    # (q dtype, cache dtype, cases): the bf16 q paths on every case, the
    # exact f32 path (f32 q, f32 or e4m3 cache) on a few
    f32_cases = [(1, 32, 8, 1, [2047], 128, 2048), (1, 32, 8, 256, [1792], 128, 2048),
                 (2, 32, 8, 16, [100, 1500], 128, 2048), (1, 32, 8, 100, [1000], 128, 2048)]
    runs = [(bf16, bf16, cases), (bf16, F8, cases), (torch.float32, torch.float32, f32_cases),
            (torch.float32, F8, f32_cases[:1])]
    rows = []
    for dt, cdt, run_cases in runs:   # dt: q and the output
        for b, h, kvh, t, pos0, hs, s in run_cases:
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
            fill = min(max(pos0) + t, s)     # a gated row (pos0 == S) sees all S
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
            seen = sum(min(p + tt + 1, s) for p in pos0 for tt in range(t))
            nbytes = (2 * q.numel() * q.element_size()
                      + sum(2 * kvh * min(p + t, s) * hs * csize for p in pos0))
            ops = 4.0 * hs * h * seen
            bms, by = bound_ms(nbytes, ops, dt)
            block_rows, n_split = cuda_attention.split_plan(b, kvh, s, t, g, dt == torch.float32)
            row = dict(b=b, h=h, kvh=kvh, t=t, pos0=pos0, hs=hs, s=s,
                       dtype=str(dt).split(".")[-1], cache=str(cdt).split(".")[-1],
                       block_rows=block_rows, n_split=n_split,
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=bms, bound_by=by)
            rows.append(row)
            print("[K3] " + json.dumps(row))
            if not ok:
                fail(f"K3 {dt} q, {cdt} cache b={b} h={h}/{kvh} t={t} pos0={pos0} hs={hs} "
                     f"S={s}: max err {err:.3g} > tol {tol:.3g}")
            del kvs, k, v, ks, vs
    torch.cuda.empty_cache()
    return {"rows": rows, "shapes": k3_shape_sweep(gen), "graph": k3_graph_replay(gen)}


def k3_shape_sweep(gen) -> dict:
    """K3 against its plain version, untimed, over small shapes that reach
    every path and edge: each q/cache dtype pair, hs 16-128, G 1, 2, 4 and
    6, S not a multiple of the 64-slot tile, T*G from 1 to 600 rows, splits
    that end mid-tile, rows with no slot in a split, and 300 kv heads, so
    many blocks that the plan takes one split: the kernels then write the
    output themselves, with no merge."""
    from distributed_llama_tpu_torch.ops import cuda_attention

    n, worst = 0, 0.0
    for dt, cdt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, F8),
                    (torch.float32, torch.float32), (torch.float32, F8)):
        single = set()    # the row-block sizes reached with one split
        for hs in (16, 32, 64, 128):
            for b, h, kvh, s in ((1, 8, 8, 512), (1, 12, 2, 100), (2, 8, 2, 512),
                                 (1, 600, 300, 128)):
                for t in (1, 3, 16, 100):
                    for pos0 in ([0], [63], [200], [s - t]) if b == 1 else ([0, s - t], [70, 5]):
                        if max(pos0) + t > s:
                            continue
                        block_rows, n_split = cuda_attention.split_plan(
                            b, kvh, s, t, h // kvh, dt == torch.float32)
                        if n_split == 1:
                            single.add(block_rows)
                        k = torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(cdt)
                        v = torch.randn((b, kvh, s, hs), generator=gen, device="cuda").to(cdt)
                        q = torch.randn((b, t, h, hs), generator=gen, device="cuda").to(dt)
                        q_pos = (torch.tensor(pos0, device="cuda", dtype=torch.int32)[:, None]
                                 + torch.arange(t, device="cuda", dtype=torch.int32)[None, :])
                        got = cuda_attention.flash_attention(q, k, v, q_pos).float()
                        want = cuda_attention.flash_attention_reference(q, k, v, q_pos).float()
                        err = (got - want).abs().max().item()
                        tol = TOL[dt] * want.abs().max().item()
                        if not (err <= tol and bool(torch.isfinite(got).all())):
                            fail(f"K3 {dt} q, {cdt} cache, b={b} h={h}/{kvh} S={s} hs={hs} t={t} "
                                 f"pos0={pos0}: max err {err:.3g} > tol {tol:.3g}")
                        n += 1
                        worst = max(worst, err / tol)
        if len(single) != 2:
            fail(f"K3 shape sweep, {dt} q, {cdt} cache: one split reached only at block "
                 f"rows {sorted(single)}, wanted both the decode and the prefill block")
    print(f"[K3-shapes] {n} small cases, every path and edge, within TOL "
          f"(largest err / tol {worst:.3f})")
    return {"cases": n, "worst_err_over_tol": worst}


def k3_graph_replay(gen) -> list[dict]:
    """K3 captured once in a CUDA graph at one position, replayed with the
    positions moved in place: the grid must not depend on them and every
    replay must match the plain version at the new positions."""
    from distributed_llama_tpu_torch.ops import cuda_attention

    rows = []
    for cdt in (torch.bfloat16, F8):
        k = torch.randn((1, 8, 2048, 128), generator=gen, device="cuda").to(cdt)
        v = torch.randn((1, 8, 2048, 128), generator=gen, device="cuda").to(cdt)
        q = torch.randn((1, 1, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        q_pos = torch.full((1, 1), 10, dtype=torch.int32, device="cuda")
        cuda_attention.flash_attention(q, k, v, q_pos)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = cuda_attention.flash_attention(q, k, v, q_pos)
        for p0 in (10, 700, 2047, 0, 1500):
            q_pos.fill_(p0)
            graph.replay()
            want = cuda_attention.flash_attention_reference(q, k, v, q_pos).float()
            err = (out.float() - want).abs().max().item()
            tol = TOL[torch.bfloat16] * want.abs().max().item()
            rows.append(dict(cache=str(cdt).split(".")[-1], pos0=p0, max_abs_err=err, tol=tol))
            if not err <= tol:
                fail(f"K3 graph replay, {cdt} cache, pos0 moved to {p0}: max err {err:.3g} > "
                     f"tol {tol:.3g}")
        del graph
    print(f"[K3-graph] one capture, {len(rows)} replays at moved positions: all within TOL")
    return rows


def phase_probes() -> dict:
    from distributed_llama_tpu_torch.ops import cuda_probes
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch
    from distributed_llama_tpu_torch.tools import (exp_int8_dot, kernel_experiments,
                                                   kernel_ladder)

    # each tool's passes at its shape: one untimed pass of each, with the
    # counts zeroed just before and read just after, must launch each kernel
    # once per weight (the ladder once per weight and stage); then the
    # tool's timed lines, as `python -m ...tools.<name>` prints them
    cuda = torch.device("cuda")
    counters = {**_counters(), **_probe_counters()}
    runs = {}
    for name, tool, want in (
            ("kernel_ladder", kernel_ladder, {"P7": len(cuda_probes.STAGES) * kernel_ladder.L}),
            ("kernel_experiments", kernel_experiments,
             {"P4a": kernel_experiments.L, "P4b": kernel_experiments.L,
              "K1": kernel_experiments.L}),
            ("exp_int8_dot", exp_int8_dot, {"P1": exp_int8_dot.L, "K1": exp_int8_dot.L})):
        print(f"[probe] python -m distributed_llama_tpu_torch.tools.{name}")
        ps = tool.passes(cuda)
        zero_counts()
        for _, one_pass, _ in ps:
            one_pass()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        if got != want:
            fail(f"tools.{name}: one pass launched {got}, wanted {want}")
        runs[name] = dict(launches=got, rows=pass_rows(ps, cuda))
        del ps
        torch.cuda.empty_cache()
    tool_rows = {name: {r["name"]: r for r in res["rows"]} for name, res in runs.items()}

    # the plain versions and the library yardstick over the same passes
    layers, d, n = kernel_ladder.L, kernel_ladder.H, kernel_ladder.D
    ws = kernel_ladder.random_weights(layers, d, n, seed=11, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    x32 = torch.randn((1, n), generator=gen, device="cuda")
    xb = torch.randn((1, n), generator=gen, device="cuda").to(torch.bfloat16)
    wds = [dequantize_q40_torch(w, torch.bfloat16) for w in ws]

    def library(k):
        return time_ms(lambda: [torch.matmul(xb, wd.t()) for wd in wds[:k]])
    lib = {layers: library(layers), exp_int8_dot.L: library(exp_int8_dot.L)}
    del wds
    rows = []

    def held(name, label, got, want, exact, plain, tool_row, ops, dtype, n_layers):
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        if exact:
            ok, tol = torch.equal(got, want), 0.0
        else:
            tol = TOL[torch.float32] * want.abs().max().item()
            ok = err <= tol and bool(torch.isfinite(got).all())
        bms, by = bound_ms(tool_row["bytes"], ops, dtype)
        row = dict(name=name, label=label, layers=n_layers, d=d, n=n,
                   max_abs_err=err, tol=tol, exact=exact, ms=tool_row["ms"],
                   plain_ms=plain, library_ms=lib[n_layers], bound_ms=bms,
                   bound_by=by, bytes=tool_row["bytes"], gbps=tool_row["gbps"],
                   hbm_share=tool_row["hbm_share"])
        rows.append(row)
        print("[probe] " + json.dumps(row))
        if not ok:
            fail(f"{name} {label}: max err {err:.3g} > tol {tol:.3g} (exact: {exact})")

    ops = 2.0 * layers * d * n
    for stage in cuda_probes.STAGES:
        held("q40_ladder", stage, cuda_probes.q40_ladder(stage, x32, ws[0]),
             cuda_probes.q40_ladder_reference(stage, x32, ws[0]),
             stage in ("read", "unpack"),
             time_ms(lambda: [cuda_probes.q40_ladder_reference(stage, x32, w) for w in ws]),
             tool_rows["kernel_ladder"][stage], ops if stage == "dot" else 0.0,
             torch.float32, layers)
    for name, label, fn, ref in (
            ("q40_matmul_a", "A bf16", cuda_probes.q40_matmul_a,
             cuda_probes.q40_matmul_a_reference),
            ("q40_matmul_b", "B bf16+corr", cuda_probes.q40_matmul_b,
             cuda_probes.q40_matmul_b_reference)):
        held(name, label, fn(xb, ws[0]), ref(xb, ws[0]), False,
             time_ms(lambda: [ref(xb, w) for w in ws]),
             tool_rows["kernel_experiments"][label], ops, torch.bfloat16, layers)
    del ws
    torch.cuda.empty_cache()

    layers8 = exp_int8_dot.L
    ws8, xq = exp_int8_dot.random_int8_weights(layers8, d, n, seed=13, device="cuda")
    pk, sc = ws8[0]
    held("int8_gemv", "int8 dp4a", cuda_probes.int8_gemv(xq, pk, sc),
         cuda_probes.int8_gemv_reference(xq, pk, sc), True,
         time_ms(lambda: [cuda_probes.int8_gemv_reference(xq, p, s) for p, s in ws8]),
         tool_rows["exp_int8_dot"]["int8 dp4a"], 2.0 * layers8 * d * n, torch.int8,
         layers8)
    del ws8
    torch.cuda.empty_cache()

    ladder = {r["label"]: r["gbps"] for r in rows if r["name"] == "q40_ladder"}
    below = next((s for s, g in ladder.items() if g < 0.95 * ladder["read"]), None)
    print("[probe] ladder GB/s: " + ", ".join(f"{s} {g:.0f}" for s, g in ladder.items())
          + f"; first stage below 95% of read's rate: {below}")
    print("[probe] GB/s at 11008x4096, t = 1: " + ", ".join(
        f"{r['name']} ({tool}) {r['gbps']:.0f}" for tool, res in tool_rows.items()
        if tool != "kernel_ladder" for r in res.values()))
    return {"rows": rows, "tools": runs, "first_below_read": below}


def counted_passes(name: str, ps: list, want: dict) -> dict:
    """Each of a tool's passes once, untimed, with the counts zeroed just
    before it and read just after: each must launch exactly want[label]."""
    cuda = torch.device("cuda")
    counters = {**_counters(), **_probe_counters()}
    print(f"[probe] python -m distributed_llama_tpu_torch.tools.{name}")
    got = {}
    for label, one_pass, _ in ps:
        zero_counts()
        one_pass()
        torch.cuda.synchronize()
        got[label] = {k: f.launches for k, f in counters.items() if f.launches}
    if got != want:
        fail(f"tools.{name}: one pass launched {got}, wanted {want}")
    return dict(launches=got, rows=pass_rows(ps, cuda))


def phase_probes_p2_p6() -> dict:
    """Phase 4b, its second part: the fp8-cache flash decode (P2), the pk
    substitution (P3) and the f16-bit scales (P5) (probes_p3_p5), and the
    prefill overlap (P6) at their tools' shapes. Per tool: the counted
    untimed pass, the timed lines, each kernel against its plain version,
    then plain, library and bound over the same call or pass."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_probes, cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch
    from distributed_llama_tpu_torch.tools import exp_f8_flash, exp_unpack_overlap

    cuda = torch.device("cuda")
    rows, tools = [], {}

    def held(name, label, got, want, tol_rel, exact, plain, lib, tool_row, ops, dtype,
             **at):
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        tol = tol_rel * want.double().abs().max().item()
        ok = torch.equal(got, want) if exact else \
            err <= tol and bool(torch.isfinite(got).all())
        bms, by = bound_ms(tool_row["bytes"], ops, dtype)
        row = dict(name=name, label=label, **at, max_abs_err=err, tol=tol, exact=exact,
                   ms=tool_row["ms"], plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by, bytes=tool_row["bytes"], gbps=tool_row["gbps"])
        rows.append(row)
        print("[probe] " + json.dumps(row))
        if not ok:
            fail(f"{name} {label}: max err {err:.3g} > tol {tol:.3g} (exact: {exact})")

    # P2: four modes of one flash-decode kernel, one call each
    f8 = exp_f8_flash
    a = f8.make_inputs(cuda)
    ps = f8.passes(cuda, a)
    tools["exp_f8_flash"] = res = counted_passes(
        "exp_f8_flash", ps, {label: {"P2": 1} for label, _ in f8.VARIANTS})
    tr = {r["name"]: r for r in res["rows"]}
    rows_n, seen = f8.B * f8.KVH, f8.FILL + 1
    qs = a["q"].reshape(f8.B, f8.KVH, 1, f8.HS)
    outs = {}
    for label, mode in f8.VARIANTS:
        k, v = a["bits" if mode == "bitsflush" else mode]
        outs[mode] = cuda_probes.f8_flash_decode(mode, a["pos"], a["q"], k, v)
        plain = time_ms(lambda: cuda_probes.f8_flash_decode_reference(
            mode, a["pos"], a["q"], k, v))
        ks = cuda_probes.f8_cache_bf16(mode, k[:, :seen]).reshape(f8.B, f8.KVH, seen, f8.HS)
        vs = cuda_probes.f8_cache_bf16(mode, v[:, :seen]).reshape(f8.B, f8.KVH, seen, f8.HS)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
        del ks, vs
        held("f8_flash_decode", label, outs[mode].float(),
             cuda_probes.f8_flash_decode_reference(mode, a["pos"], a["q"], k, v).float(),
             TOL[torch.bfloat16], False, plain, lib, tr[label],
             4.0 * f8.HS * seen * rows_n, torch.bfloat16, mode=mode, rows=rows_n,
             s=f8.S, fill=f8.FILL)
    if not torch.equal(outs["bits"], outs["astype"]):
        fail("f8_flash_decode: bits differs from astype on the card")
    print("[probe] bits == astype exact: ok")
    for label, mode in f8.VARIANTS:   # a second launch gives the same bits
        k, v = a["bits" if mode == "bitsflush" else mode]
        if not torch.equal(cuda_probes.f8_flash_decode(mode, a["pos"], a["q"], k, v), outs[mode]):
            fail(f"f8_flash_decode {mode}: a repeated launch differs")
    p2_sweep = f8_split_sweep(a)
    del a, ps, outs
    torch.cuda.empty_cache()
    p2_edges = f8_edges()

    pk_err, gemv1 = probes_p3_p5(held, tools)

    # P6: landed (K1's tensor-core path, wgmma) and every (td, n_sub), one call each
    uo = exp_unpack_overlap
    ps = uo.passes(cuda)
    tools["exp_unpack_overlap"] = res = counted_passes(
        "exp_unpack_overlap", ps,
        {label: {"K1" if label == "landed" else "P6": 1} for label, _, _ in ps})
    del ps
    best = {r["name"]: r["ms"] for r in res["rows"]}
    print("[probe] " + uo.decision(best))
    tr = {r["name"]: r for r in res["rows"]}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    w = uo.make_weight(cuda, gen)
    xb = torch.randn((uo.T, uo.N), generator=gen, device="cuda").to(torch.bfloat16)
    want = cuda_probes.q40_matmul_sub_reference(xb, w).float()
    plain = time_ms(lambda: cuda_probes.q40_matmul_sub_reference(xb, w))
    wd = rotating(lambda: dequantize_q40_torch(uo.make_weight(cuda, gen), torch.bfloat16),
                  uo.D * uo.N * 2)
    lib = time_ms(lambda: torch.matmul(xb, wd().t()))
    del wd
    at = dict(d=uo.D, n=uo.N, t=uo.T)
    held("q40_matmul (landed, wgmma)", "landed", cuda_q40.q40_matmul(xb, w, torch.bfloat16).float(),
         cuda_q40.q40_matmul_reference(xb, w, torch.bfloat16).float(), TOL[torch.bfloat16],
         False, time_ms(lambda: cuda_q40.q40_matmul_reference(xb, w, torch.bfloat16)), lib,
         tr["landed"], uo.flops(), torch.bfloat16, **at)
    for td, ns in uo.combos():
        label = f"td={td} n_sub={ns}"
        y = cuda_probes.q40_matmul_sub(xb, w, ns, td)
        held("q40_matmul_sub", label, y.float(),
             want, TOL[torch.bfloat16], False, plain, lib, tr[label], uo.flops(),
             torch.bfloat16, td=td, n_sub=ns, **at)
        if not torch.equal(cuda_probes.q40_matmul_sub(xb, w, ns, td), y):
            fail(f"q40_matmul_sub {label}: a repeated launch differs")
    del w, xb, want
    torch.cuda.empty_cache()
    p6_edges = sub_edges()
    attrs = probe_attrs()
    return {"rows": rows, "tools": tools, "pk_vs_base": pk_err,
            "decision": uo.decision(best), "p2_split_sweep": p2_sweep, "p2_edges": p2_edges,
            "p6_edges": p6_edges, "attrs": attrs, "gemv1": gemv1}


def probes_p3_p5(held, tools: dict) -> tuple[dict, dict]:
    """Phase 4b's P3 (the pk substitution) and P5 (the f16-bit scales), one
    kernel template on the design of the t = 1 GEMV: per tool the counted
    untimed pass (K1 beside each shape or pass), the timed lines and the
    DECISION line; each mode against its plain version at full shape, then
    plain, library and bound, a repeat launch bit for bit; P5's f16 decode
    over every finite pattern; then the sweeps over bodies and rows a CTA,
    the edge cases, the kernel's plans and its registers. `held` records
    and checks one full-shape row. Returns (pk vs base error, the rest)."""
    from distributed_llama_tpu_torch.ops import cuda_probes
    from distributed_llama_tpu_torch.quants.torch_codec import (QuantizedTensor,
                                                                dequantize_q40_torch)
    from distributed_llama_tpu_torch.tools import exp_pk_decode, exp_scale_f16

    cuda = torch.device("cuda")
    # P3: base and pk at w1 and attn, one call each, K1 beside them
    cases = {name: exp_pk_decode.make_case(d, n, 0, cuda)
             for name, d, n, _ in exp_pk_decode.SHAPES}
    ps = exp_pk_decode.passes(cuda, cases)
    tools["exp_pk_decode"] = res = counted_passes(
        "exp_pk_decode", ps, {label: {"K1" if label.endswith("K1") else "P3": 1}
                              for label, _, _ in ps})
    tr = {r["name"]: r for r in res["rows"]}
    decisions = {"exp_pk_decode": exp_pk_decode.decision({r["name"]: r["ms"] for r in res["rows"]})}
    print("[probe] " + decisions["exp_pk_decode"])
    pk_err = {}
    for name, d, n, _ in exp_pk_decode.SHAPES:
        c = cases[name]
        wd = rotating(lambda c=c: dequantize_q40_torch(c["w"], torch.bfloat16), d * n * 2)
        xb = torch.randn((1, n), device="cuda").to(torch.bfloat16)
        lib = time_ms(lambda: torch.matmul(xb, wd().t()))
        del wd
        y = {}
        for mode in cuda_probes.PK_MODES:
            args = (mode, c["x1"], c["x2"][mode], c["xs"], c["w"])
            y[mode] = cuda_probes.q40_pk_gemv(*args)
            # pk: x1 . pk and x2 . hi are each ~16x the result and cancel, so
            # the sum order's rounding is amplified about 16x
            held("q40_pk_gemv", f"{name} {mode}", y[mode],
                 cuda_probes.q40_pk_gemv_reference(*args),
                 1e-4 if mode == "pk" else TOL[torch.float32], False,
                 time_ms(lambda: cuda_probes.q40_pk_gemv_reference(*args)), lib,
                 tr[f"{name} {mode}"], 2.0 * d * n, torch.float32, shape=name, d=d, n=n,
                 k1_ms=tr[f"{name} K1"]["ms"])
            if not same_bits(cuda_probes.q40_pk_gemv(*args), y[mode]):
                fail(f"q40_pk_gemv {name} {mode}: a repeated launch differs")
        pk_err[name] = ((y["pk"] - y["base"]).abs().max()
                        / y["base"].abs().max()).item()
    print(f"[probe] pk vs base, max |diff| / max |base|: {pk_err}")
    sweeps = {"P3": gemv1_sweep_p3(cases)}
    del cases, ps
    torch.cuda.empty_cache()

    # P5: L weights with u16 and with f32 scales, K1 beside them
    sf = exp_scale_f16
    layers, x = made = sf.make_layers(cuda)
    ps = sf.passes(cuda, made)
    tools["exp_scale_f16"] = res = counted_passes(
        "exp_scale_f16", ps, {"u16 scales": {"P5": sf.L}, "f32 scales": {"P5": sf.L},
                              "K1": {"K1": sf.L}})
    tr = {r["name"]: r for r in res["rows"]}
    decisions["exp_scale_f16"] = sf.decision({r["name"]: r["ms"] for r in res["rows"]})
    print("[probe] " + decisions["exp_scale_f16"])
    del ps
    xb = x.to(torch.bfloat16)
    wds = [dequantize_q40_torch(QuantizedTensor(p, sc), torch.bfloat16) for p, sc, _ in layers]
    lib = time_ms(lambda: [torch.matmul(xb, wd.t()) for wd in wds])
    del wds
    for label, idx in (("u16 scales", 2), ("f32 scales", 1)):
        ws = [QuantizedTensor(layer[0], layer[idx]) for layer in layers]
        y5 = cuda_probes.q40_matmul_scales(x, ws[0])
        held("q40_matmul_scales", label, y5,
             cuda_probes.q40_matmul_scales_reference(x, ws[0]), TOL[torch.float32], False,
             time_ms(lambda: [cuda_probes.q40_matmul_scales_reference(x, w) for w in ws]),
             lib, tr[label], 2.0 * sf.L * sf.D_OUT * sf.D_IN, torch.float32,
             layers=sf.L, d=sf.D_OUT, n=sf.D_IN, k1_ms=tr["K1"]["ms"])
        if not same_bits(cuda_probes.q40_matmul_scales(x, ws[0]), y5):
            fail(f"q40_matmul_scales {label}: a repeated launch differs")
    # the kernel's f16 decode over every finite pattern: one 32-value row
    # per pattern, nibbles 9 and x = e_0, so y = 9 s - 8 s = s exactly
    bits = torch.arange(65536, dtype=torch.int32)
    bits = bits[torch.isfinite(bits.to(torch.int16).view(torch.float16))]
    su = bits.to(torch.int16).view(torch.uint16).reshape(-1, 1).to("cuda")
    e0 = torch.zeros((1, 32), device="cuda")
    e0[0, 0] = 1.0
    y = cuda_probes.q40_matmul_scales(e0, QuantizedTensor(
        torch.full((su.shape[0], 16), 0x99, dtype=torch.uint8, device="cuda"), su))
    want = bits.to(torch.int16).view(torch.float16).to(torch.float32).to("cuda")[None]
    if not torch.equal(y, want):
        fail("q40_matmul_scales: the kernel's f16 decode differs from float16")
    print(f"[probe] the kernel's f16 decode equals float16 over all {su.shape[0]} "
          "finite patterns")
    sweeps["P5"] = gemv1_sweep_p5(layers, x)
    del layers, x, made
    torch.cuda.empty_cache()
    gemv1 = dict(decisions=decisions, sweeps=sweeps, edges=gemv1_probe_edges(),
                 plans=gemv1_probe_plans(), attrs=gemv1_probe_attrs())
    return pk_err, gemv1


# rows a CTA that P3 and P5's kernel is timed at beside its plan's
GEMV1_SWEEP_ROWS = (4, 8, 16, 32, 64, 128)
# the bodies also timed as programmatic dependent launches (each launch's
# first weight loads overlap the tail of the launch before it)
GEMV1_PDL_BODIES = ("full", "loads", "empty")


def gemv1_sweep_p3(cases: dict) -> dict:
    """P3 at the tool's shapes (each call on the next of copies that pass
    the L2 cache), both modes: ms of every body of GEMV1_BODIES at the
    plan's rows a CTA (the product as kept, with the other item loop and
    with the FMA dequantize; the loads alone; no loads: what a short
    launch's time is made of), the product, the loads and the empty launch
    again as programmatic dependent launches, then the product at other
    rows a CTA; every product body at every rows a CTA, and the dependent
    launch, also held within TOL."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp
    from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor
    from distributed_llama_tpu_torch.tools import exp_pk_decode

    out = {}
    for name, d, n, _ in exp_pk_decode.SHAPES:
        c = cases[name]
        ws = rotating(lambda c=c: QuantizedTensor(c["w"].packed.clone(), c["w"].scales.clone()),
                      exp_pk_decode.call_bytes(d, n))
        plan = cp.gemv1_plan_kernel("base", n, d)[0]
        for mode in cp.PK_MODES:
            args = (c["x1"], c["x2"][mode], c["xs"])
            want = cp.q40_pk_gemv_reference(mode, *args, c["w"])
            tol = (1e-4 if mode == "pk" else TOL[torch.float32]) * want.abs().max().item()
            t = {body: time_ms(lambda body=body: cp.q40_gemv1_probe(mode, body, 0, *args, ws()))
                 for body in cp.GEMV1_BODIES}
            t.update({f"{body} pdl": time_ms(lambda body=body: cp.q40_gemv1_probe(
                mode, body, 0, *args, ws(), pdl=True)) for body in GEMV1_PDL_BODIES})
            y = cp.q40_gemv1_probe(mode, "full", 0, *args, c["w"], pdl=True)
            if not (y - want).abs().max().item() <= tol:
                fail(f"P3 {name} {mode} full pdl: beyond TOL")
            for rows in (0, *GEMV1_SWEEP_ROWS):
                for body in ("full", "other_loop", "fma"):
                    y = cp.q40_gemv1_probe(mode, body, rows, *args, c["w"])
                    if not (y - want).abs().max().item() <= tol:
                        fail(f"P3 {name} {mode} {body} at {rows or plan} rows a CTA: beyond TOL")
                if rows in (0, plan):
                    continue
                t[f"rows {rows}"] = time_ms(
                    lambda rows=rows: cp.q40_gemv1_probe(mode, "full", rows, *args, ws()))
            out[f"{name} {mode}"] = dict(plan_rows=plan, ms=t)
            print(f"[probe] P3 {name} {mode} (plan {plan} rows a CTA), ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
        del ws
    return out


def gemv1_sweep_p5(layers: list, x: torch.Tensor) -> dict:
    """P5 at the tool's shape, a pass over its L weights for u16 and f32
    scales: ms of every body of GEMV1_BODIES at the plan (the loads alone
    say what the bytes take at this load pattern), of GEMV1_PDL_BODIES as
    programmatic dependent launches (a pass is 32 GEMVs back to back, as in
    a decode step), and of the product at other rows a CTA; every product
    body and the dependent launch held within TOL on one weight."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp
    from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor

    out = {}
    d, n = layers[0][0].shape[0], layers[0][0].shape[1] * 2
    plan = cp.gemv1_plan_kernel("u16", n, d)[0]
    for mode, idx in (("u16", 2), ("f32", 1)):
        ws = [QuantizedTensor(layer[0], layer[idx]) for layer in layers]

        def one_pass(body, rows=0, pdl=False):
            for w in ws:
                cp.q40_gemv1_probe(mode, body, rows, x, None, None, w, pdl=pdl)
        want = cp.q40_matmul_scales_reference(x, ws[0])
        for body, pdl in (("full", False), ("other_loop", False), ("fma", False), ("full", True)):
            y = cp.q40_gemv1_probe(mode, body, 0, x, None, None, ws[0], pdl=pdl)
            if not (y - want).abs().max().item() <= TOL[torch.float32] * want.abs().max().item():
                fail(f"P5 {mode} {body}{' pdl' if pdl else ''}: beyond TOL")
        t = {body: time_ms(lambda body=body: one_pass(body)) for body in cp.GEMV1_BODIES}
        t.update({f"{body} pdl": time_ms(lambda body=body: one_pass(body, pdl=True))
                  for body in GEMV1_PDL_BODIES})
        for rows in (r for r in GEMV1_SWEEP_ROWS if r != plan):
            t[f"rows {rows}"] = time_ms(lambda rows=rows: one_pass("full", rows))
        out[mode] = dict(plan_rows=plan, ms=t)
        print(f"[probe] P5 {mode} scales, one pass of {len(ws)} (plan {plan} rows a CTA), ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return out


def gemv1_probe_edges() -> list[dict]:
    """P3 (base, pk) and P5 (u16, f32 scales) at their edges, each against
    its plain version within TOL (pk 1e-4) and bit-identical on a second
    launch: d 1, 4, 5, 17 (one item, or not a multiple of its 4 rows) by n
    32, 1024, 1056 (one block, one whole chunk, a ragged second chunk), row
    2's scales all 0 where d >= 4; then 4096x4096 with x = 0. Inputs come
    from a CPU generator, so every card sees the same values."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp
    from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor

    gen = torch.Generator().manual_seed(41)
    rows = []

    def case(tag, call, want, tol_rel):
        got, again = call(), call()
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        tol = tol_rel * want.double().abs().max().item()
        if not (tuple(got.shape) == tuple(want.shape) and err <= tol
                and bool(torch.isfinite(got).all())):
            fail(f"{tag}: max err {err:.3g} > tol {tol:.3g}")
        if not same_bits(got, again):
            fail(f"{tag}: a repeated launch differs")
        rows.append(dict(case=tag, max_abs_err=err, tol=tol))

    shapes = [(d, n, False) for d in (1, 4, 5, 17) for n in (32, 1024, 1056)] + [(4096, 4096, True)]
    for d, n, zero_x in shapes:
        packed = torch.randint(0, 256, (d, n // 2), generator=gen, dtype=torch.uint8).cuda()
        sc = torch.rand((d, n // 32), generator=gen) * 0.004 + 0.001
        if d >= 4:
            sc[2] = 0.0
        x = torch.zeros((1, n)) if zero_x else torch.randn((1, n), generator=gen)
        xr = x.reshape(-1, 32)
        x1, xh = xr[:, :16].reshape(1, -1), xr[:, 16:].reshape(1, -1)
        xs = xr.sum(1).reshape(1, -1).cuda()
        s16 = sc.to(torch.float16).cuda()
        at = f"d{d} n{n}{' x=0' if zero_x else ''}"
        for mode in cp.PK_MODES:
            x2 = (xh if mode == "base" else xh - 16.0 * x1).cuda()
            args = (mode, x1.cuda(), x2, xs, QuantizedTensor(packed, s16))
            case(f"P3 {mode} {at}", lambda: cp.q40_pk_gemv(*args),
                 cp.q40_pk_gemv_reference(*args), 1e-4 if mode == "pk" else TOL[torch.float32])
        for kind, scales in (("u16", s16.view(torch.uint16)), ("f32", sc.cuda())):
            w = QuantizedTensor(packed, scales)
            xc = x.cuda()
            case(f"P5 {kind} {at}", lambda: cp.q40_matmul_scales(xc, w),
                 cp.q40_matmul_scales_reference(xc, w), TOL[torch.float32])
    worst = max(r["max_abs_err"] / r["tol"] if r["tol"] else 0.0 for r in rows)
    print(f"[probe] P3/P5 edges: {len(rows)} cases (base, pk, u16, f32; d 1, 4, 5, 17 x n 32, "
          f"1024, 1056, a row of zero scales; 4096x4096 with x = 0), each within TOL and "
          f"bit-identical on a second launch (max err share {worst:.3f})")
    return rows


def gemv1_probe_plans() -> dict:
    """The P3/P5 kernel's own plan (rows a CTA, CTAs, resident CTAs) at
    every shape phase 4b runs, which must equal cuda_probes.gemv1_rows for
    the resident count it reports."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp

    out = {}
    shapes = [(4096, 22016), (4096, 4096)] + [(n, d) for d in (1, 4, 5, 17)
                                              for n in (32, 1024, 1056)]
    for mode in cp.GEMV1_MODES:
        for n, d in shapes:
            rows, ctas, resident = cp.gemv1_plan_kernel(mode, n, d)
            want = cp.gemv1_rows(n, d, resident)
            if (rows, ctas) != (want, -(-d // want)):
                fail(f"P3/P5 plan {mode} n{n} d{d}: kernel {rows} rows x {ctas} CTAs, "
                     f"gemv1_rows {want}")
            out[f"{mode} n{n} d{d}"] = dict(rows=rows, ctas=ctas, resident=resident)
    print(f"[probe] P3/P5 plans equal cuda_probes.gemv1_rows at {len(out)} shapes; resident CTAs "
          + ", ".join(f"{m} {out[f'{m} n4096 d4096']['resident']}" for m in cp.GEMV1_MODES)
          + f"; 4096x4096 {out['base n4096 d4096']['rows']} rows x "
          f"{out['base n4096 d4096']['ctas']} CTAs, 22016x4096 "
          f"{out['base n4096 d22016']['rows']} x {out['base n4096 d22016']['ctas']}")
    return out


def gemv1_probe_attrs() -> dict:
    """Registers and local (spill) bytes a thread of every mode and body of
    the P3/P5 kernel, as built; a spill is printed, not failed."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp

    out = {f"{m} {b}": cp.kernel_attrs("gemv1", i, j)
           for i, m in enumerate(cp.GEMV1_MODES) for j, b in enumerate(cp.GEMV1_BODIES)}
    print("[probe] P3/P5 kernel " + "; ".join(
        f"{k}: {a['regs']} registers, {a['local_bytes']} local bytes"
        f"{' (SPILLS)' if a['local_bytes'] else ''}" for k, a in out.items()))
    return out


def held_small(tag: str, got: torch.Tensor, want: torch.Tensor, again: torch.Tensor) -> dict:
    """One edge case of a probe: within TOL[bf16] of the plain version,
    finite, and a second launch bit for bit the first."""
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    tol = TOL[torch.bfloat16] * want.double().abs().max().item()
    if not (err <= tol and bool(torch.isfinite(got).all())):
        fail(f"{tag}: max err {err:.3g} > tol {tol:.3g}")
    if not torch.equal(got, again):
        fail(f"{tag}: a repeated launch differs")
    return dict(case=tag, max_abs_err=err, tol=tol)


def f8_edges() -> list[dict]:
    """P2 at its edges, every mode: pos 0, 255, 256 and S - 1 at S 1024,
    B 2 with pos 100 and 900, and pos past S (clamped); each the plan's
    split and 1, 5 and 13 blocks a row, against the plain version, bits
    equal to astype; the kernel's plan export equal to f8_split_plan."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    rows = []
    for b, kvh, s_len, pos in ((1, 2, 1024, [0]), (1, 2, 1024, [255]), (1, 2, 1024, [256]),
                               (1, 2, 1024, [1023]), (2, 2, 1024, [100, 900]),
                               (1, 2, 1024, [5000]), (1, 4, 100, [99])):
        r = b * kvh
        q = torch.randn((r, 1, cp.F8_HS), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((r, s_len, cp.F8_HS), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((r, s_len, cp.F8_HS), generator=gen, device="cuda").to(torch.bfloat16)
        k8, v8 = k.to(F8), v.to(F8)
        caches = {"plain": (k, v), "astype": (k8, v8),
                  "bits": (k8.view(torch.uint8), v8.view(torch.uint8))}
        caches["bitsflush"] = caches["bits"]
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        outs = {}
        for mode in cp.F8_MODES:
            kc, vc = caches[mode]
            want = cp.f8_flash_decode_reference(mode, p, q, kc, vc)
            outs[mode] = cp.f8_flash_decode(mode, p, q, kc, vc)
            tag = f"P2 {mode} b{b} kvh{kvh} S{s_len} pos{pos}"
            rows.append(held_small(tag, outs[mode].float(), want.float(),
                                   cp.f8_flash_decode(mode, p, q, kc, vc).float()))
            for n in (1, 5, 13):
                got = cp.f8_flash_decode_split(mode, p, q, kc, vc, n)
                rows.append(held_small(f"{tag} n_split {n}", got.float(), want.float(),
                                       cp.f8_flash_decode_split(mode, p, q, kc, vc, n).float()))
            plan = (cp.f8_flash_plan_kernel(r, s_len, mode), cp.f8_split_plan(r, s_len, mode))
            if plan[0] != plan[1]:
                fail(f"f8_flash_decode {mode}: the kernel's plan {plan[0]} != f8_split_plan {plan[1]}")
        if not torch.equal(outs["bits"], outs["astype"]):
            fail(f"f8_flash_decode b{b} kvh{kvh} S{s_len} pos{pos}: bits differs from astype")
    worst = max(r["max_abs_err"] / r["tol"] if r["tol"] else 0.0 for r in rows)
    print(f"[probe] P2 edges: {len(rows)} cases (pos 0, 255, 256, S - 1, past S, B 2 "
          f"unequal, S 100; plan and 1/5/13 blocks a row), each within TOL and bit-identical "
          f"on a second launch, bits == astype, plans equal (max err share {worst:.3f})")
    return rows


def f8_split_sweep(a: dict) -> dict:
    """P2 at the tool's shape, each mode timed at other blocks a row than
    its plan's: where the plan stands."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp
    from distributed_llama_tpu_torch.tools import exp_f8_flash as f8

    out = {}
    for _, mode in f8.VARIANTS:
        k, v = a["bits" if mode == "bitsflush" else mode]
        out[mode] = {"plan": cp.f8_split_plan(f8.B * f8.KVH, f8.S, mode), "ms": {
            n: time_ms(lambda n=n: cp.f8_flash_decode_split(mode, a["pos"], a["q"], k, v, n))
            for n in (2, 4, 8, 12, 16, 24)}}
        print(f"[probe] P2 {mode} split sweep (plan {out[mode]['plan']}): "
              + ", ".join(f"{n}: {ms:.4f}" for n, ms in out[mode]["ms"].items()) + " ms")
    return out


def sub_edges() -> list[dict]:
    """P6 at its edges, every (td, n_sub): t = 44 (TMA's zero fill past t),
    t = 300 (two token tiles), d = td (one row tile) and n = 256 (one
    256-value group, a short -8 correction), against the plain version,
    bit-identical on a second launch."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    rows = []
    for t, n, d in ((44, 4096, 11008), (300, 1024, 256), (44, 4096, 64), (256, 256, 128),
                    (1, 512, 128)):
        w = random_q40(gen, d, n)
        x = torch.randn((t, n), generator=gen, device="cuda").to(torch.bfloat16)
        want = cp.q40_matmul_sub_reference(x, w).float()
        for td in cp.SUB_TDS:
            if d % td:
                continue
            for ns in cp.SUB_NS:
                rows.append(held_small(f"P6 t{t} n{n} d{d} td{td} n_sub{ns}",
                                       cp.q40_matmul_sub(x, w, ns, td).float(), want,
                                       cp.q40_matmul_sub(x, w, ns, td).float()))
    worst = max(r["max_abs_err"] / r["tol"] if r["tol"] else 0.0 for r in rows)
    print(f"[probe] P6 edges: {len(rows)} cases (t 44, 300 and 1, d = td, n 256), each within "
          f"TOL and bit-identical on a second launch (max err share {worst:.3f})")
    return rows


def probe_attrs() -> dict:
    """Registers and local (spill) bytes a thread of every P2 and P6
    variant, as built; a spill is printed, not failed."""
    from distributed_llama_tpu_torch.ops import cuda_probes as cp

    out = {f"f8_flash_decode {m}": cp.kernel_attrs("f8", i) for i, m in enumerate(cp.F8_MODES)}
    out.update({f"q40_matmul_sub td={td} n_sub={ns}": cp.kernel_attrs("sub", td, ns)
                for td in cp.SUB_TDS for ns in cp.SUB_NS})
    for name, a in out.items():
        print(f"[probe] {name}: {a['regs']} registers, {a['local_bytes']} local bytes"
              f"{' (SPILLS)' if a['local_bytes'] else ''}, {a['dynamic_smem']} B shared, "
              f"{a['threads']} threads")
    return out


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
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40, cuda_q80

    return {"K1": cuda_q40.q40_matmul, "K2": cuda_q40.q40_expert_matmul,
            "K3": cuda_attention.flash_attention, "Q80": cuda_q80.q80_roundtrip,
            "Q80F": cuda_q40.q80_fused}


def _probe_counters() -> dict:
    from distributed_llama_tpu_torch.ops import cuda_probes

    return {"P7": cuda_probes.q40_ladder, "P4a": cuda_probes.q40_matmul_a,
            "P4b": cuda_probes.q40_matmul_b, "P1": cuda_probes.int8_gemv,
            "P2": cuda_probes.f8_flash_decode, "P3": cuda_probes.q40_pk_gemv,
            "P5": cuda_probes.q40_matmul_scales, "P6": cuda_probes.q40_matmul_sub}


def zero_counts() -> None:
    for f in (*_counters().values(), *_probe_counters().values()):
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


def profile_decode(engine, token: int, steps: int = 4, run=None) -> dict:
    """Device time per decode step by kernel name, from torch.profiler over
    a few steps (each ends in its logits copy, as in generate), or over
    run(), which makes `steps` decode steps itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if run is not None:
            run()
        else:
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
    # the host side: CUDA runtime calls per step (launches, graph launches,
    # copies, syncs; the logits copy ends each step with one)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and e.key.startswith("cuda")]
    runtime = sorted(((e.key, e.count / steps) for e in events), key=lambda r: -r[1])
    host_ms = {e.key: e.cpu_time_total / 1e3 / steps for e in events}
    calls = dict(runtime)
    print("[profile] CUDA runtime calls per decode step (host ms in them): "
          + ", ".join(f"{k} {c:.1f} ({host_ms[k]:.3f})" for k, c in runtime[:8]))
    print(f"[profile] per decode step: cudaGraphLaunch {calls.get('cudaGraphLaunch', 0.0):.1f}, "
          f"cudaLaunchKernel {calls.get('cudaLaunchKernel', 0.0):.1f}, cudaMemcpyAsync "
          f"{calls.get('cudaMemcpyAsync', 0.0):.1f}")
    copies = memcpy_callers(prof, steps)
    if copies:
        print("[profile] cudaMemcpyAsync per decode step by calling op: "
              + "; ".join(f"{k}: {c:.1f}" for k, c in copies.items()))
    out = {"runtime_calls": runtime, "runtime_host_ms": host_ms, "memcpy_callers": copies,
           "graph_launches_per_step": calls.get("cudaGraphLaunch", 0.0),
           "launch_kernel_per_step": calls.get("cudaLaunchKernel", 0.0)}
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return {"device_ms_per_step": None, "top": [], **out}
    print(f"[profile] kernel time per decode step {total:.3f} ms; top kernels:")
    for name, count, ms in rows[:10]:
        print(f"[profile]   {ms:8.4f} ms  x{count:6.1f}  {name[:90]}")
    return {"device_ms_per_step": total, **out,
            "device_ops_per_step": sum(r[1] for r in rows),
            "top": [dict(name=n[:120], per_step=c, ms=m) for n, c, m in rows[:20]]}


def memcpy_callers(prof, steps: int) -> dict:
    """cudaMemcpyAsync calls per step by the ops that made them (the op
    and its two enclosing ops), from the profiler's event tree."""
    tally: dict = {}
    for e in prof.events():
        if e.name != "cudaMemcpyAsync":
            continue
        chain, p = [], getattr(e, "cpu_parent", None)
        while p is not None and len(chain) < 3:
            chain.append(p.name)
            p = getattr(p, "cpu_parent", None)
        key = " < ".join(chain) or "(no enclosing op)"
        tally[key] = tally.get(key, 0) + 1
    top = sorted(tally.items(), key=lambda kv: -kv[1])[:8]
    return {k: v / steps for k, v in top}


@contextlib.contextmanager
def plain_versions():
    """Route the forward through the kernels' plain versions (on the card)
    — the comparison runs of phase 5; launches there are not counted."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40, cuda_q80

    with mock.patch.object(cuda_q80, "q80_roundtrip", cuda_q80.q80_roundtrip_reference), \
            mock.patch.object(cuda_q40, "q40_matmul", cuda_q40.q40_matmul_reference), \
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
    held to LOGITS_TOL and LOGITS_REL_L2_TOL. The engine must run eagerly:
    plain_versions() patches the wrappers the forward calls, which a
    captured graph no longer calls."""
    if engine.cuda_graphs:
        fail("compare_with_plain needs an eager engine (cuda_graphs=False): a captured "
             "graph would replay the kernels on both sides")

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
                                       engine.compute_dtype, engine.activation_q80)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("MoE block output not finite")
    print("[main]   the MoE decode block ran under set_sync_debug_mode('error')")


def drive_path(label: str, engine, eager, prompt: list[int], n_decode: int,
               per_chunk: dict, per_step: dict, weight_bytes: int) -> dict:
    """One main path: greedy generate with exact launch counts, one more
    decode step, profile, and the comparison with the plain versions. The
    engine replays its captured decode step (captured in the warm-up): each
    replay adds the capture's tally to the counters, so a step's counts are
    its kernels' launches. The comparison runs on `eager`, an eager engine
    over the same weights."""
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = engine.spec.vocab_size
    engine.generate(prompt[:40], 3, Sampler(vocab, 0.0, 0.9, 1))  # warm-up
    engine.reset()
    torch.cuda.synchronize()

    # the prompt's prefill inside generate: the counts read just before and
    # just after it, so the prefill's launches are counted, not inferred
    prefill_counts = {}

    def counted_prefill(p):
        c0 = read_counts()
        logits = type(engine).prefill(engine, p)
        prefill_counts.update({k: v - c0[k] for k, v in read_counts().items()})
        return logits

    engine.prefill = counted_prefill
    zero_counts()
    try:
        res = engine.generate(prompt, n_decode, Sampler(vocab, 0.0, 0.9, 1))
    finally:
        del engine.prefill
    counts = read_counts()

    n_chunks = math.ceil(len(prompt) / engine.prefill_chunk)
    n_steps = len(res.tokens) - 1
    want_prefill = {k: n_chunks * per_chunk[k] for k in counts}
    want = {k: want_prefill[k] + n_steps * per_step[k] for k in counts}
    print(f"[main] {label}: generated {len(res.tokens)} tokens; launches "
          f"{counts} over {n_chunks} prefill chunks ({prefill_counts}) + {n_steps} "
          f"decode steps")
    if len(res.tokens) != n_decode:
        fail(f"{label}: generate returned {len(res.tokens)} tokens, wanted {n_decode}")
    if prefill_counts != want_prefill:
        fail(f"{label}: prefill launch counts {prefill_counts}, wanted {want_prefill}")
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
    launches = profile["launch_kernel_per_step"]
    print(f"[main] {label}: per decode step cudaGraphLaunch {profile['graph_launches_per_step']} "
          f"and cudaLaunchKernel {launches} (the decode step is one captured graph; eager, "
          f"Llama-2-7B made 1,719 cudaLaunchKernel a step)")
    if busy is not None:
        print(f"[main] {label}: device busy {busy:.3f} ms of {decode_ms:.3f} ms per "
              f"decode token: idle share {1 - busy / decode_ms:.3f}")
    cmp = compare_with_plain(eager, prompt)
    return dict(label=label, launches=counts, per_step=step, chunks=n_chunks,
                prefill_launches=prefill_counts,
                decode_steps=n_steps, profile=profile, prefill_tokens=len(prompt),
                prefill_ms=prefill_ms, prefill_tok_s=len(prompt) / (prefill_ms / 1e3),
                decode_ms_per_token=decode_ms, decode_device_ms=avg.device_ms,
                weight_bytes=weight_bytes, hbm_share=gbps / HBM_BYTES_PER_S,
                idle_share=None if busy is None else 1 - busy / decode_ms,
                launch_kernel_calls_per_step=launches,
                logits_vs_plain=cmp)


def _eager_twin(engine):
    """An engine over the same weights and settings that runs every step
    eagerly (cuda_graphs=False): the A side of the graph phase, and the
    engine the kernels-against-plain comparison runs on."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    return Engine(engine.spec, engine.params, device="cuda",
                  compute_dtype=engine.compute_dtype, cache_dtype=engine.cache_dtype,
                  activation_q80=engine.activation_q80, cuda_graphs=False)


def check_forward_sync_free(engine) -> None:
    """The whole T = 1 forward, at a position on the device, under
    set_sync_debug_mode("error"): a host sync or a blocking copy from host
    memory (which could not be captured) raises."""
    from distributed_llama_tpu_torch.models.transformer import forward

    tok = torch.full((1, 1), 5, dtype=torch.int64, device="cuda")
    pos = torch.full((1,), 3, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = forward(engine.params, engine.spec, tok, pos, engine.cache,
                             compute_dtype=engine.compute_dtype,
                             activation_q80=engine.activation_q80)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    engine.reset()
    if not bool(torch.isfinite(logits).all()):
        fail("decode forward at a device position: logits not finite")
    print("[graph]   the T = 1 forward at a device position ran under "
          "set_sync_debug_mode('error')")


def _recording_sampler(vocab: int, temperature: float, topp: float, seed: int):
    """A host Sampler that keeps each draw's logits and RNG state."""
    from distributed_llama_tpu_torch.sampler import Sampler

    class Recording(Sampler):
        def sample(self, logits):
            self.seen.append((np.array(logits, np.float32), self.rng_state))
            return super().sample(logits)
    rec = Recording(vocab, temperature, topp, seed)
    rec.seen = []
    return rec


def cdf_margin(logits: np.ndarray, state: int, temperature: float, topp: float,
               host: int, device: int) -> dict:
    """Where the host Sampler's coin fell in its float64 CDF (the nucleus's
    for top-p): the distance to the nearest boundary, beside the bound of
    f32 summation over the same terms (n * 2^-24 * total), and whether the
    device's token is the host's neighbour in that CDF's order. A device
    token that differs is explained by the f32 CDF only if it is a
    neighbour and the margin is within the bound."""
    from distributed_llama_tpu_torch.sampler import topp_nucleus
    from distributed_llama_tpu_torch.utils.rng import xorshift_f32

    x = logits.astype(np.float32) / np.float32(temperature)
    x = np.exp(x - x.max())
    probs = x / x.sum()
    _, coin = xorshift_f32(state)
    if topp <= 0 or topp >= 1:
        order = np.arange(len(probs))
        cum = np.cumsum(probs.astype(np.float64))
        last = len(cum) - 1
    else:
        order, cum, last = topp_nucleus(probs, topp)
    r = coin * cum[last]
    where = {int(t): i for i, t in enumerate(order[:last + 1])}
    adjacent = device in where and abs(where[device] - where.get(host, -2)) == 1
    return dict(margin=float(np.min(np.abs(cum[:last + 1] - r))),
                f32_bound=float((last + 1) * 2.0 ** -24 * cum[last]),
                nucleus=last + 1, adjacent=adjacent)


def _ms_stats(xs: list) -> dict:
    return dict(median=float(np.median(xs)), min=float(min(xs)), max=float(max(xs)),
                runs=[float(x) for x in xs])


def graph_phase(label: str, engine, eager, prompt: list[int], weight_bytes: int,
                card: str) -> dict:
    """The compiled decode path of one main path: the captured step against
    the eager one (bit for bit, and 32 greedy tokens), ms/token of both in
    turns, decode_greedy_device and generate_device against host generate."""
    from distributed_llama_tpu_torch.runtime.graphs import LAUNCH_COUNTERS
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = engine.spec.vocab_size
    out: dict = {}

    def greedy():
        return Sampler(vocab, 0.0, 0.9, 1)

    def captures() -> dict:
        return {str(k): dict(capture_s=g.capture_s, pool_mib=g.pool_bytes / 2 ** 20,
                             tally=list(g.tally)) for k, g in engine.graphs.items()}
    g1 = engine.graphs[1]
    names = ("K1", "K2", "Q80F", "K3", "Q80")
    print(f"[graph] {label}: decode step captured in {g1.capture_s:.3f} s (eager warm-up "
          f"included), its pool {g1.pool_bytes / 2 ** 20:.1f} MiB; launches a replay "
          f"{dict(zip(names, g1.tally))}")
    if len(LAUNCH_COUNTERS) != len(names):
        fail("graph tally: counter names out of date")
    check_forward_sync_free(engine)

    # one step, eager and replayed, on the same cache state: the eager
    # engine takes the graph engine's cache after the prompt
    engine.reset()
    eager.reset()
    tok = int(engine.prefill(prompt).argmax())
    for dst, src in zip((*eager.cache.k, *eager.cache.v), (*engine.cache.k, *engine.cache.v)):
        dst.copy_(src)
    eager.pos = engine.pos
    le = eager.step(np.asarray([[tok]], np.int32), eager.pos)
    lg = engine.step(np.asarray([[tok]], np.int32), engine.pos)
    torch.cuda.synchronize()
    same_cache = all(torch.equal(a, b) for a, b in zip((*eager.cache.k, *eager.cache.v),
                                                       (*engine.cache.k, *engine.cache.v)))
    diff = (le - lg).abs().max().item()
    print(f"[graph] {label}: one decode step eager vs graph: logits bit-identical "
          f"{torch.equal(le, lg)} (max abs diff {diff:.3g}), caches bit-identical {same_cache}")
    if not torch.equal(le, lg) or not same_cache:
        fail(f"{label}: the graph's decode step differs from the eager step")

    toks = {}
    for name, e in (("eager", eager), ("graph", engine)):
        e.reset()
        toks[name] = e.generate(prompt, 32, greedy()).tokens
    print(f"[graph] {label}: 32 greedy tokens, eager == graph: {toks['eager'] == toks['graph']}")
    if toks["eager"] != toks["graph"]:
        fail(f"{label}: greedy tokens differ: eager {toks['eager']}, graph {toks['graph']}")

    # ms/token, eager and graph in turns (A, B, A, B, A, B)
    ms: dict = {"eager": [], "graph": []}
    for _ in range(3):
        for name, e in (("eager", eager), ("graph", engine)):
            e.reset()
            ms[name].append(e.generate(prompt[:40], 33, greedy()).stats.averages().generation_ms)
    out["card"] = card
    for name, e in (("eager", eager), ("graph", engine)):
        st = out[f"{name}_ms_per_token"] = _ms_stats(ms[name])
        print(f"[graph] {label}: {name} decode {st['median']:.3f} ms/token median "
              f"(min {st['min']:.3f}, max {st['max']:.3f}; runs "
              f"{', '.join(f'{x:.3f}' for x in st['runs'])}) [{card}]")
        prof = profile_decode(e, toks["graph"][-1])
        busy = prof["device_ms_per_step"]
        out[f"{name}_profile"] = dict(
            device_ms_per_step=busy,
            graph_launches_per_step=prof["graph_launches_per_step"],
            launch_kernel_per_step=prof["launch_kernel_per_step"],
            memcpy_callers=prof["memcpy_callers"], runtime_host_ms=prof["runtime_host_ms"],
            idle_share=None if busy is None else 1 - busy / st["median"])
        print(f"[graph] {label}: {name}: cudaGraphLaunch {prof['graph_launches_per_step']:.1f}, "
              f"cudaLaunchKernel {prof['launch_kernel_per_step']:.1f} a step; device busy "
              + ("not measured" if busy is None else
                 f"{busy:.3f} ms of {st['median']:.3f}: idle share {1 - busy / st['median']:.3f}"))

    # decode_greedy_device: tokens against generate with a greedy host
    # sampler from the same (zeroed) state, then ms/token
    first = prompt[1]
    engine.reset()
    want = engine.generate([first], 32, greedy()).tokens
    engine.reset()
    got, _ = engine.decode_greedy_device(first, 32)      # captures ("greedy",)
    print(f"[graph] {label}: decode_greedy_device 32 tokens == generate's: "
          f"{got.ravel().tolist() == want}")
    if got.ravel().tolist() != want:
        fail(f"{label}: decode_greedy_device {got.ravel().tolist()} vs generate {want}")
    n = 128
    dg = []
    for _ in range(3):
        engine.reset()
        _, sec = engine.decode_greedy_device(first, n)
        dg.append(sec / n * 1e3)
    st = out["greedy_device_ms_per_token"] = _ms_stats(dg)
    share = weight_bytes / (st["median"] / 1e3) / HBM_BYTES_PER_S
    out["greedy_device_hbm_share"] = share
    print(f"[graph] {label}: decode_greedy_device {n} tokens: {st['median']:.3f} ms/token "
          f"median (min {st['min']:.3f}, max {st['max']:.3f}); Q40 bytes per token "
          f"{weight_bytes / 1e9:.3f} GB = {share:.3f} of 3.35 TB/s [{card}]")
    engine.reset()
    prof = profile_decode(engine, first, 16, run=lambda: engine.decode_greedy_device(first, 16))
    busy = prof["device_ms_per_step"]
    out["greedy_device_profile"] = dict(
        device_ms_per_step=busy, graph_launches_per_step=prof["graph_launches_per_step"],
        launch_kernel_per_step=prof["launch_kernel_per_step"],
        idle_share=None if busy is None else 1 - busy / st["median"])
    print(f"[graph] {label}: decode_greedy_device: device busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms a token of {st['median']:.3f}: idle share {1 - busy / st['median']:.3f}"))

    # generate_device against host generate with the same seed
    out["generate_device"] = []
    for temperature, topp, seed in ((0.0, 0.9, 5), (0.8, 0.9, 1234)):
        engine.reset()
        rec = _recording_sampler(vocab, temperature, topp, seed)
        want = engine.generate(prompt[:40], 32, rec).tokens
        engine.reset()
        t0 = time.perf_counter()
        got = engine.generate_device(prompt[:40], 32, temperature=temperature, topp=topp,
                                     seed=seed)
        wall = time.perf_counter() - t0
        row = dict(temperature=temperature, topp=topp, seed=seed, equal=got == want,
                   steps=engine.last_device_steps, wall_s=wall)
        if got != want:
            k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            logits, state = rec.seen[k]
            m = (cdf_margin(logits, state, temperature, topp, want[k], got[k])
                 if temperature else None)
            row.update(first_difference=k, device=got[k], host=want[k], cdf=m)
            print(f"[graph] {label}: generate_device T={temperature} differs from host generate "
                  f"at token {k}: device {got[k]}, host {want[k]}; CDF margin {m}")
            if m is None or not m["adjacent"] or m["margin"] > m["f32_bound"]:
                fail(f"{label}: generate_device differs from host generate at token {k} "
                     f"beyond the f32 CDF bound ({m})")
        print(f"[graph] {label}: generate_device T={temperature} top-p {topp} seed {seed}: "
              f"{len(got)} tokens, equal to host generate {got == want}, "
              f"{engine.last_device_steps} device steps, {wall:.3f} s with the 40-token prefill")
        out["generate_device"].append(row)
    out["captures"] = captures()
    for key, c in out["captures"].items():
        print(f"[graph] {label}: graph {key}: captured in {c['capture_s']:.3f} s, pool "
              f"{c['pool_mib']:.1f} MiB")
    return out


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


def _release(label: str) -> None:
    """After `del` of a path's engines: their caches, graphs and graph
    pools go back to the card."""
    torch.cuda.empty_cache()
    print(f"[graph] {label}: after del of its engines, {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


def phase_main_paths(card: str) -> tuple[dict, dict]:
    """The main paths and their graph phases; returns their results and
    the Llama-2-7B params, which the serving phase reuses."""
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, 32000, 299).tolist()
    out = {}

    # every engine as the CLI builds it for a Q40 model: the Q80 round trip
    # on every matmul input, inside K1's or K2's launch at t = 1 (Q80F:
    # those launches, also counted under K1 and K2), the standalone kernel
    # (Q80) elsewhere; a chunk's wcls runs at t = 1. Each path's engine
    # replays its captured decode step; its eager twin over the same
    # weights runs the comparison with the plain versions and the graph
    # phase's A side.
    q80 = dict(activation_q80=True)
    spec = _spec("llama2_7b")
    engine = _engine(spec, seed=0, **q80)
    eager = _eager_twin(engine)
    wb = decode_weight_bytes(spec, engine.params)
    out["llama2_7b"] = drive_path(
        "Llama-2-7B", engine, eager, prompt, 32,
        per_chunk={"K1": 129, "K2": 0, "K3": 32, "Q80": 128, "Q80F": 1},
        per_step={"K1": 129, "K2": 0, "K3": 32, "Q80": 0, "Q80F": 129},
        weight_bytes=wb)
    out["llama2_7b"]["logits_vs_plain"].pop("logits")
    out["llama2_7b"]["graph"] = graph_phase("Llama-2-7B", engine, eager, prompt, wb, card)
    params_7b = engine.params
    del engine, eager
    _release("Llama-2-7B")

    spec = _spec("mixtral_8x7b")
    engine = _engine(spec, seed=1, **q80)
    eager = _eager_twin(engine)
    wb = decode_weight_bytes(spec, engine.params)
    # Q80: a chunk's wqkv, wo, router and 8 x (gate, up, down) a layer; a
    # step's router a layer. Q80F: a chunk's wcls; a step's wqkv, wo, gate,
    # up, down (K2: one call for both active experts) a layer, + wcls
    moe_counts = dict(per_chunk={"K1": 833, "K2": 0, "K3": 32, "Q80": 864, "Q80F": 1},
                      per_step={"K1": 65, "K2": 96, "K3": 32, "Q80": 32, "Q80F": 161},
                      weight_bytes=wb)
    check_moe_block_sync_free(engine)
    out["mixtral_8x7b"] = drive_path("Mixtral 8x7B", engine, eager, prompt, 32, **moe_counts)
    out["mixtral_8x7b"]["graph"] = graph_phase("Mixtral 8x7B", engine, eager, prompt, wb, card)
    params = engine.params
    del engine, eager
    _release("Mixtral 8x7B")
    engine = _engine(spec, seed=1, params=params, cache_dtype=F8, **q80)
    eager = _eager_twin(engine)
    out["mixtral_8x7b_f8"] = drive_path("Mixtral 8x7B, f8 cache", engine, eager, prompt,
                                        32, **moe_counts)
    out["mixtral_8x7b_f8"]["graph"] = graph_phase("Mixtral 8x7B, f8 cache", engine, eager,
                                                  prompt, wb, card)
    lb = out["mixtral_8x7b"]["logits_vs_plain"].pop("logits")
    lf = out["mixtral_8x7b_f8"]["logits_vs_plain"].pop("logits")
    dist = {}
    for what, a, b in zip(("prompt", "decode"), lb, lf):
        dist[what] = dict(max_abs=(a - b).abs().max().item(),
                          rel_l2=((a - b).norm() / a.norm()).item())
    print(f"[main] Mixtral 8x7B logits, f8 cache vs bf16 cache (for information): {dist}")
    out["mixtral_8x7b_f8"]["logits_vs_bf16_cache"] = dist
    del engine, eager, params
    _release("Mixtral 8x7B, f8 cache")

    spec = _spec("grok1_2l")
    engine = _engine(spec, seed=2, **q80)
    eager = _eager_twin(engine)
    wb = decode_weight_bytes(spec, engine.params)
    gprompt = [1] + np.random.default_rng(8).integers(3, spec.vocab_size, 39).tolist()
    out["grok1_2l"] = drive_path(
        "Grok-1 (2 layers)", engine, eager, gprompt, 8,
        per_chunk={"K1": 53, "K2": 0, "K3": 2, "Q80": 54, "Q80F": 1},
        per_step={"K1": 5, "K2": 6, "K3": 2, "Q80": 2, "Q80F": 11},
        weight_bytes=wb)
    out["grok1_2l"]["logits_vs_plain"].pop("logits")
    out["grok1_2l"]["graph"] = graph_phase("Grok-1 (2 layers)", engine, eager, gprompt, wb,
                                           card)
    del engine, eager
    _release("Grok-1 (2 layers)")
    return out, params_7b


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
            # the CLI at its defaults: bf16, and --buffer-float-type q80 (the
            # Q80 round trip on every matmul input)
            need = ("K1", "K3", "Q80", "Q80F") + (("K2",) if name == "mixtral" else ())
            if "Generated tokens:    16" not in out or not all(counts[k] for k in need):
                fail(f"CLI inference on cuda at its defaults, {name}: launches {counts}")
            f32 = ["generate", *common, "--compute-dtype", "f32", "--cache-dtype", "f32",
                   "--buffer-float-type", "f32"]
            gpu = run(f32 + ["--device", "cuda"]).splitlines()
            cpu = run(f32 + ["--device", "cpu"]).splitlines()
            print(f"[file] {name}: CLI f32 tokens cuda == cpu: {text(gpu) == text(cpu)}; "
                  f"inference launches {counts}")
            if text(gpu) != text(cpu):
                fail(f"CLI f32 text differs ({name}): cuda {text(gpu)} vs cpu {text(cpu)}")
            # --device-sampling: the whole decode loop in a replayed graph;
            # greedy, its text is the host loop's
            dsg = run(f32 + ["--device", "cuda", "--device-sampling"]).splitlines()
            print(f"[file] {name}: CLI --device-sampling f32 tokens on cuda == host loop on "
                  f"cpu: {text(dsg) == text(cpu)}")
            if text(dsg) != text(cpu):
                fail(f"CLI --device-sampling text differs ({name}): {text(dsg)} vs {text(cpu)}")
            zero_counts()
            ds = run(["inference", *common, "--device", "cuda", "--device-sampling"])
            counts = read_counts()
            print(f"[file] {name}: --device-sampling at the CLI's defaults: "
                  + " | ".join(ds.strip().splitlines()[-3:]) + f"; launches {counts}")
            if "(on-device loop, 16 device steps)" not in ds or "Wall time:" not in ds \
                    or not all(counts[k] for k in need):
                fail(f"CLI inference --device-sampling on cuda, {name}: {ds[-300:]} {counts}")
            if name == "mixtral":
                f8 = run(["inference", *common, "--device", "cuda", "--cache-dtype", "f8"])
                print("[file] mixtral, --cache-dtype f8: "
                      + " | ".join(f8.strip().splitlines()[-5:]))
                if "Generated tokens:    16" not in f8:
                    fail("CLI inference with --cache-dtype f8 did not complete")
            if name == "llama":
                # `dllama api --serve-batch 2` as serve() builds it, on
                # cuda and on the CPU: the same f32 chat text
                texts = {dev: cli_api_text(mpath, tpath, dev) for dev in ("cuda", "cpu")}
                print(f"[file] llama: dllama api --serve-batch 2, f32 chat text cuda == cpu: "
                      f"{texts['cuda'] == texts['cpu']} ({len(texts['cuda'])} chars)")
                if texts["cuda"] != texts["cpu"]:
                    fail(f"dllama api text differs: cuda {texts['cuda']!r}, cpu {texts['cpu']!r}")


def cli_api_text(mpath: str, tpath: str, device: str) -> str:
    """One greedy chat request through `dllama api --serve-batch 2` built
    by apps.api_server.build_server from the CLI's arguments, bound to
    127.0.0.1:0; the server drains and closes after it."""
    import http.client
    import threading

    from distributed_llama_tpu_torch.apps import api_server, dllama

    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--host", "127.0.0.1", "--port", "0",
         "--serve-batch", "2", "--temperature", "0", "--compute-dtype", "f32",
         "--cache-dtype", "f32", "--buffer-float-type", "f32", "--device", device])
    with contextlib.redirect_stdout(io.StringIO()):
        server, state = api_server.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=300)
        conn.request("POST", "/v1/chat/completions", json.dumps(
            {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 16,
             "temperature": 0}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        if resp.status != 200:
            fail(f"dllama api on {device}: {resp.status} {body}")
        return body["choices"][0]["message"]["content"]
    finally:
        server.shutdown()
        server.server_close()
        api_server.finish(state, drain_timeout=30.0)


# -- phase 7: serving (the batch-B slot engine, the scheduler, dllama api) --

SERVE_B, SERVE_C = 4, 256
# a batch step's launches: every projection at t = B on K1's tensor-core
# path with the standalone Q80 round trip before it (the fused one is
# t = 1 only), one K3 a layer; a (B, C) chunk's projections take the
# dequantize path (t = B*C > MAX_T), its wcls at t = B
SLOT_STEP = {"K1": 129, "K2": 0, "K3": 32, "Q80": 129, "Q80F": 0}
SLOT_CHUNK = {"K1": 1, "K2": 0, "K3": 32, "Q80": 129, "Q80F": 0}
COUNTER_NAMES = ("K1", "K2", "Q80F", "K3", "Q80")     # graphs.LAUNCH_COUNTERS order


def _tokenizer(vocab: int):
    """A byte-fallback tokenizer over the model's vocab (3 specials, 256
    byte tokens, fillers): the synthetic weights come with no .t file."""
    from distributed_llama_tpu_torch.io import TokenizerData
    from distributed_llama_tpu_torch.testing import byte_fallback_vocab
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    return Tokenizer(TokenizerData(vocab=byte_fallback_vocab(vocab), scores=[0.0] * vocab,
                                   bos_id=1, eos_id=2))


def _held_logits(what: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Logits held as compare_with_plain holds them: max abs error within
    LOGITS_TOL of max |want|, relative L2 within LOGITS_REL_L2_TOL."""
    got, want = got.float(), want.float()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        fail(f"{what}: logits not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    if err > LOGITS_TOL * scale or rel_l2 > LOGITS_REL_L2_TOL:
        fail(f"{what}: max abs {err:.4g} (tol {LOGITS_TOL * scale:.4g}), rel L2 {rel_l2:.3g}")
    return dict(max_abs_err=err, tol=LOGITS_TOL * scale, rel_l2=rel_l2,
                same_argmax=int(got.argmax()) == int(want.argmax()))


def _chunk(rows: dict, b: int, c: int, s: int):
    """A (B, C) slot chunk: rows {r: (tokens, pos)}; every other row gated."""
    tok = np.zeros((b, c), np.int32)
    pos = np.full((b,), s, np.int32)
    lidx = np.zeros((b,), np.int32)
    for r, (t, p) in rows.items():
        tok[r, :len(t)] = t
        pos[r] = p
        lidx[r] = len(t) - 1
    return tok, pos, lidx


def _copy_cache(dst, src, dst_rows=slice(None), src_rows=slice(None)) -> None:
    for a, b in zip((*dst.k, *dst.v), (*src.k, *src.v)):
        a[dst_rows].copy_(b[src_rows])


def serving_slot_engine(spec, one, eng, eager) -> tuple[dict, object]:
    """(a): the slot decode graph captured in warmup with its tally; one
    batch step eager and replayed bit for bit over moved tokens and
    positions; the kernels in the step and in a chunk against their plain
    versions; a (B, C) chunk with two rows gated: their caches untouched,
    the live rows' logits those of a batch-1 prefill; exact launches.
    Returns the results and the warmed scheduler."""
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler

    b, c, s, vocab = SERVE_B, SERVE_C, spec.seq_len, spec.vocab_size
    out: dict = {}
    sched = Scheduler(eng, chunk=c)
    t0 = time.perf_counter()
    sched.warmup()
    torch.cuda.synchronize()
    g = eng.graphs.get("slot_decode")
    if g is None:
        fail("warmup did not capture the slot decode graph")
    tally = dict(zip(COUNTER_NAMES, g.tally))
    out["warmup_s"], out["capture_s"] = time.perf_counter() - t0, g.capture_s
    out["pool_mib"], out["tally"] = g.pool_bytes / 2 ** 20, tally
    print(f"[serve] warmup {out['warmup_s']:.3f} s: slot_decode captured in {g.capture_s:.3f} "
          f"s, pool {out['pool_mib']:.1f} MiB, launches a replay {tally}")
    if tally != SLOT_STEP:
        fail(f"slot decode tally {tally}, wanted {SLOT_STEP}")

    rng = np.random.default_rng(11)
    lens = (256, 180, 256, 90)
    prompts = [rng.integers(3, vocab, n).tolist() for n in lens]
    eng.slot_prefill_chunk(*_chunk({r: (p, 0) for r, p in enumerate(prompts)}, b, c, s))
    _copy_cache(eager.cache, eng.cache)
    pos = np.asarray(lens, np.int32)
    for i in range(3):          # tokens and positions move between replays
        tok = rng.integers(3, vocab, (b, 1)).astype(np.int32)
        p = pos + i
        if i == 1:
            p[2] = s            # a gated row in the middle step
        le = eager.slot_decode_step(tok, p)
        lg = eng.slot_decode_step(tok, p)
        torch.cuda.synchronize()
        if not torch.equal(le, lg):
            fail(f"slot decode step {i}: eager and replayed logits differ "
                 f"(max abs {(le - lg).abs().max().item():.3g})")
    same = all(torch.equal(x, y) for x, y in zip((*eager.cache.k, *eager.cache.v),
                                                 (*eng.cache.k, *eng.cache.v)))
    print(f"[serve] 3 batch steps eager vs replayed (tokens and positions moved, a row gated "
          f"in one): logits bit-identical True, caches bit-identical {same}")
    if not same:
        fail("slot decode: eager and replayed caches differ")

    # the kernels inside the step and the chunk against their plain
    # versions, on the eager twin: the plain run rewrites the same slots
    tok = rng.integers(3, vocab, (b, 1)).astype(np.int32)
    p = pos + 3
    lk = eager.slot_decode_step(tok, p)
    with plain_versions():
        lp = eager.slot_decode_step(tok, p)
    out["step_vs_plain"] = _held_logits("batch step, kernels vs plain", lk, lp)
    args = _chunk({0: (prompts[0], 0), 2: (prompts[2][:200], 0)}, b, c, s)
    lk = eager.slot_prefill_chunk(*args)
    with plain_versions():
        lp = eager.slot_prefill_chunk(*args)
    out["chunk_vs_plain"] = _held_logits("chunk, kernels vs plain", lk[[0, 2]], lp[[0, 2]])
    print(f"[serve] kernels vs plain: batch step {out['step_vs_plain']}; chunk (rows 0, 2) "
          f"{out['chunk_vs_plain']}")

    # a (B, C) chunk with rows 1 and 3 gated at S: their caches bit for
    # bit, and the live rows' logits against a batch-1 prefill
    a_tok = rng.integers(3, vocab, 256).tolist()
    b_tok = rng.integers(3, vocab, 200).tolist()
    before = [t[[1, 3]] for t in (*eng.cache.k, *eng.cache.v)]   # copies
    zero_counts()
    lg = eng.slot_prefill_chunk(*_chunk({0: (a_tok, 0), 2: (b_tok, 0)}, b, c, s))
    torch.cuda.synchronize()
    chunk_counts = read_counts()
    untouched = all(torch.equal(x, t[[1, 3]]) for x, t in zip(before, (*eng.cache.k,
                                                                       *eng.cache.v)))
    del before
    if not untouched:
        fail("a (B, C) chunk changed the cache of a row gated at pos S")
    if chunk_counts != SLOT_CHUNK:
        fail(f"a (B, C) chunk launched {chunk_counts}, wanted {SLOT_CHUNK}")
    live = {}
    for r, t in ((0, a_tok), (2, b_tok)):
        one.reset()
        live[r] = _held_logits(f"chunk row {r} vs batch-1 prefill", lg[r], one.prefill(t)[0])
    out["gated_chunk"] = dict(gated_untouched=untouched, live_vs_batch1=live,
                              launches=chunk_counts)
    print(f"[serve] (4, 256) chunk, rows 1 and 3 gated at S: their caches bit-untouched "
          f"{untouched}; live rows vs batch-1 prefill {live}; launches {chunk_counts}")
    zero_counts()
    eng.slot_decode_step(tok, p + 1)
    torch.cuda.synchronize()
    step_counts = read_counts()
    print(f"[serve] one batch step (replay) launches {step_counts}")
    if step_counts != SLOT_STEP:
        fail(f"a batch step launched {step_counts}, wanted {SLOT_STEP}")
    out["step_launches"] = step_counts

    ms = []
    args = _chunk({r: (t, 0) for r, t in enumerate(prompts)}, b, c, s)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.slot_prefill_chunk(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["chunk_ms"] = _ms_stats(ms)
    return out, sched


def _top2_gap(logits: np.ndarray) -> float:
    """The gap between the two largest logits of one step."""
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


def serving_scheduler(spec, one, eng, sched) -> dict:
    """(b): 8 greedy requests, prompts of 40-300 tokens, 32 tokens each:
    4 at once, 4 joining while the first decode; exact launches; every
    live row of 4 batch steps against the batch-1 step at the same
    position and cache contents; then each request's tokens against a
    sequential batch-1 generate. A batch row's logits lie within e of the
    batch-1 step's (e the worst max abs difference of those 16 rows), so
    greedy tokens can part only where the batch-1 top-2 gap is at most
    2e: the tokens must be equal, or first differ at such a near-tie."""
    from distributed_llama_tpu_torch.sampler import Sampler

    b, s, vocab = SERVE_B, spec.seq_len, spec.vocab_size
    rng = np.random.default_rng(13)
    prompts = [[1] + rng.integers(3, vocab, n - 1).tolist()
               for n in rng.integers(40, 301, 8)]
    calls = {"chunk": 0, "step": 0}
    chunk_fn, step_fn = eng.slot_prefill_chunk, eng.slot_decode_step

    def counted(kind, fn):
        def run(*a):
            calls[kind] += 1
            return fn(*a)
        return run
    eng.slot_prefill_chunk = counted("chunk", chunk_fn)
    eng.slot_decode_step = counted("step", step_fn)
    zero_counts()
    t0 = time.perf_counter()
    try:
        reqs = [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[:4]]
        while not all(r.stats.t_first is not None for r in reqs):
            sched.step()
        reqs += [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[4:]]
        while not all(r.finished.is_set() for r in reqs):
            sched.step()
        torch.cuda.synchronize()
    finally:
        del eng.slot_prefill_chunk, eng.slot_decode_step
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {k: calls["chunk"] * SLOT_CHUNK[k] + calls["step"] * SLOT_STEP[k] for k in counts}
    print(f"[serve] scheduler: 8 requests x 32 tokens in {wall:.3f} s, {calls['chunk']} chunks "
          f"+ {calls['step']} batch steps, launches {counts}")
    if counts != want:
        fail(f"scheduler run launched {counts}, wanted {want}")
    got = [list(r.tokens(timeout=5.0)) for r in reqs]

    # every live row of 4 batch steps against the batch-1 step at the same
    # position and cache contents (row r's cache copied into the batch-1
    # engine before the step)
    lens = (300, 213, 97, 256)
    rows = [rng.integers(3, vocab, n).tolist() for n in lens]
    for lo in range(0, 300, SERVE_C):
        eng.slot_prefill_chunk(*_chunk({r: (t[lo:lo + SERVE_C], lo) for r, t in
                                        enumerate(rows) if len(t) > lo}, b, SERVE_C, s))
    step_rows = []
    tok = rng.integers(3, vocab, (b, 1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    for i in range(4):
        want_rows = []
        for r in range(b):
            _copy_cache(one.cache, eng.cache, slice(0, 1), slice(r, r + 1))
            want_rows.append(one.step(tok[r:r + 1], int(pos[r]))[0])
        lg = eng.slot_decode_step(tok, pos)
        step_rows += [_held_logits(f"batch step {i} row {r} vs batch-1 step", lg[r], w)
                      for r, w in enumerate(want_rows)]
        tok = lg.argmax(-1, keepdim=True).int().cpu().numpy()
        pos = pos + 1
    worst = max(step_rows, key=lambda r: r["max_abs_err"] / r["tol"])
    near_tie = 2 * max(r["max_abs_err"] for r in step_rows)
    print(f"[serve] 4 batch steps x 4 live rows vs the batch-1 step: all within tolerance; "
          f"worst {worst}; near-tie bound on a top-2 gap 2e = {near_tie:.4g}")

    parity = []
    for i, (p, toks) in enumerate(zip(prompts, got)):
        one.reset()
        rec = _recording_sampler(vocab, 0.0, 0.9, 1)
        ref = one.generate(p, 32, rec).tokens
        first_diff = next((k for k, (x, y) in enumerate(zip(toks, ref)) if x != y),
                          None if len(toks) == len(ref) else min(len(toks), len(ref)))
        gaps = [_top2_gap(lg) for lg, _ in rec.seen]
        gap = (None if first_diff is None or first_diff >= len(gaps) else gaps[first_diff])
        parity.append(dict(prompt=len(p), tokens=len(toks), first_difference=first_diff,
                           gap_at_difference=gap, min_gap=min(gaps)))
        print(f"[serve] request {i}: {len(p)}-token prompt, {len(toks)} tokens; "
              + ("equal to batch-1 generate's" if first_diff is None else
                 f"first difference from batch-1 generate at {first_diff}, batch-1 top-2 gap "
                 f"there {gap} (near-tie bound {near_tie:.4g})")
              + f"; smallest batch-1 top-2 gap {min(gaps):.4g}")
        if first_diff is not None and (gap is None or gap > near_tie):
            fail(f"request {i}: tokens differ from batch-1 generate at {first_diff}, where the "
                 f"batch-1 top-2 gap {gap} exceeds the near-tie bound {near_tie:.4g}")
    return dict(wall_s=wall, chunks=calls["chunk"], steps=calls["step"], launches=counts,
                parity=parity, step_rows_worst=worst, near_tie_bound=near_tie)


# the load run: greedy requests of 32 tokens with seeded prompts of 16-300
# tokens (one or two chunks), arriving as a seeded Poisson process
LOAD_N, LOAD_RATE = 200, 5.0      # requests, mean arrivals a second


def serving_load(spec, sched) -> dict:
    """LOAD_N requests through the scheduler at LOAD_RATE arrivals a
    second. The step loop runs here: a request is submitted at the first
    iteration after its arrival time, and each token is stamped when the
    step that made it returns. Aggregate tok/s: every token over the wall
    time from the first arrival to the last token. TTFT: arrival to first
    token, over every request. ITL: every gap between two consecutive
    tokens of a request, over every request."""
    import queue

    from distributed_llama_tpu_torch.runtime.stats import percentile
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    rng = np.random.default_rng(29)
    arrive = np.concatenate([[0.0], np.cumsum(rng.exponential(1 / LOAD_RATE, LOAD_N - 1))])
    prompts = [[1] + rng.integers(3, vocab, n - 1).tolist()
               for n in rng.integers(16, 301, LOAD_N)]
    stamps: list[list[float]] = [[] for _ in range(LOAD_N)]
    reqs: list = []
    live: set = set()
    t0 = time.perf_counter()
    while len(reqs) < LOAD_N or live:
        now = time.perf_counter() - t0
        while len(reqs) < LOAD_N and arrive[len(reqs)] <= now:
            live.add(len(reqs))
            reqs.append(sched.submit(prompts[len(reqs)], 32, Sampler(vocab, 0.0, 0.9, 1)))
        worked = sched.step()
        t = time.perf_counter() - t0
        for i in list(live):
            while True:
                try:
                    kind, val = reqs[i].events.get_nowait()
                except queue.Empty:
                    break
                if kind == "token":
                    stamps[i].append(t)
                elif kind == "done":
                    live.discard(i)
                else:
                    fail(f"load run: request {i} failed: {val}")
        if not worked:
            if live:
                fail(f"load run: the scheduler idled with {len(live)} requests unfinished")
            if len(reqs) < LOAD_N:
                time.sleep(max(0.0, arrive[len(reqs)] - (time.perf_counter() - t0)))
    wall = max(st[-1] for st in stamps)
    n_tok = sum(len(st) for st in stamps)
    if n_tok != 32 * LOAD_N:
        fail(f"load run: {n_tok} tokens, wanted {32 * LOAD_N}")
    ttft = [(st[0] - a) * 1e3 for st, a in zip(stamps, arrive)]
    itl = [(y - x) * 1e3 for st in stamps for x, y in zip(st, st[1:])]
    out = dict(requests=LOAD_N, rate_per_s=LOAD_RATE, arrival_span_s=float(arrive[-1]),
               wall_s=wall, tokens=n_tok, tok_s=n_tok / wall,
               prompt_tokens=sum(len(p) for p in prompts), n_gaps=len(itl))
    for name, xs in (("ttft", ttft), ("itl", itl)):
        out.update({f"{name}_p{q}_ms": percentile(xs, q) for q in (50, 95, 99)})
        out[f"{name}_max_ms"] = max(xs)
    return out


def serving_timing(spec, eng, eager, card: str) -> dict:
    """ms per batch step with 4 live rows, eager (A) and graph (B) in
    turns, each step as the scheduler's decode runs it (the step, its
    logits to the host, a greedy pick a row); the graph step's profile."""
    b, vocab = SERVE_B, spec.vocab_size
    start = np.asarray((300, 250, 200, 150), np.int32)

    def run(e, n):
        tok = np.full((b, 1), 5, np.int32)
        pos = start.copy()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            lg = e.fetch_logits(e.slot_decode_step(tok, pos))
            tok = lg.argmax(-1)[:, None].astype(np.int32)
            ms.append((time.perf_counter() - t0) * 1e3)
            pos = pos + 1
        return float(np.median(ms[2:]))
    ms = {"eager": [], "graph": []}
    for _ in range(3):
        for name, e in (("eager", eager), ("graph", eng)):
            ms[name].append(run(e, 34))
    out = {name: _ms_stats(v) for name, v in ms.items()}
    prof = profile_decode(eng, 5, 8, run=lambda: run(eng, 8))
    busy = prof["device_ms_per_step"]
    med = out["graph"]["median"]
    out["profile"] = dict(device_ms_per_step=busy,
                          graph_launches_per_step=prof["graph_launches_per_step"],
                          launch_kernel_per_step=prof["launch_kernel_per_step"],
                          kernels_per_step=prof.get("device_ops_per_step"),
                          idle_share=None if busy is None else 1 - busy / med,
                          top=prof.get("top", [])[:10])
    out["tok_s"] = b * 1e3 / med
    return out


def serving_http(spec, one, card: str) -> dict:
    """(c): `dllama api --serve-batch 4` in-process on 127.0.0.1:0 over
    the 7B engine: four concurrent greedy streaming clients (two chat, two
    completions) whose text equals the scheduler's for the same prompts;
    the GET routes; a prompt past S gets 400; then the legacy path's chat
    text against generate. The step sampler (runtime/profiler.PROFILER)
    times every 4th working step with CUDA events; /stats reports it."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from distributed_llama_tpu_torch.apps import api_server
    from distributed_llama_tpu_torch.runtime.profiler import PROFILER
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    tokenizer = _tokenizer(vocab)
    sampler = Sampler(vocab, 0.0, 0.9, 3)
    rng = np.random.default_rng(17)

    def words(n):
        return " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5)) for _ in range(n))
    bodies = [("/v1/chat/completions", {"messages": [{"role": "user", "content": words(20)}]}),
              ("/v1/completions", {"prompt": words(40)}),
              ("/v1/chat/completions", {"messages": [{"role": "system", "content": words(8)},
                                                     {"role": "user", "content": words(30)}]}),
              ("/v1/completions", {"prompt": words(5)})]
    bodies = [(r, {**bd, "max_tokens": 32, "temperature": 0, "stream": True})
              for r, bd in bodies]

    def start(state):
        server = ThreadingHTTPServer(("127.0.0.1", 0), api_server.make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    def post(addr, route, body):
        conn = http.client.HTTPConnection(*addr, timeout=600)
        conn.request("POST", route, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()

    def streamed_text(route, raw):
        events = [json.loads(line[6:]) for line in raw.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        if route.endswith("chat/completions"):
            return "".join(e["choices"][0]["delta"].get("content", "") for e in events)
        return "".join(e["choices"][0]["text"] for e in events)

    def scanned(chat, body, toks):
        prompt, markers, stops = api_server._prompt_and_stops(body, chat)
        scan = api_server._piece_scanner(tokenizer, tokenizer.encode(prompt)[-1], markers, stops)
        text = ""
        for t in toks:
            piece = scan(t)
            if piece is None:
                break
            text += piece
        return text

    out: dict = {}
    state = api_server.ApiState(one, tokenizer, sampler, model_name="llama2-7b-synthetic",
                                serve_batch=SERVE_B, serve_chunk=SERVE_C)
    server = start(state)
    addr = server.server_address[:2]
    PROFILER.sample_every = 4
    try:
        results: dict = {}

        def client(i, route, body):
            results[i] = post(addr, route, body)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, r, bd))
                   for i, (r, bd) in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(results[i][0] != 200 for i in range(4)):
            fail(f"HTTP streaming clients: {[results.get(i, (None,))[0] for i in range(4)]}")
        texts = [streamed_text(r, results[i][1]) for i, (r, _) in enumerate(bodies)]
        # the scheduler's text for the same prompts, through the same supervisor
        sup = state._scheduler
        reqs = []
        for route, body in bodies:
            prompt, _, _ = api_server._prompt_and_stops(body, route.endswith("chat/completions"))
            reqs.append(sup.submit(tokenizer.encode(prompt), 32, Sampler(vocab, 0.0, 0.9, 1),
                                   eos_id=tokenizer.eos_id))
        want = [scanned(r.endswith("chat/completions"), bd, list(q.tokens(timeout=600)))
                for (r, bd), q in zip(bodies, reqs)]
        equal = texts == want
        print(f"[serve] HTTP: 4 concurrent streaming clients (2 chat, 2 completions) in "
              f"{wall:.3f} s; text equal to the scheduler's for the same prompts: {equal}")
        if not equal:
            fail(f"HTTP text differs from the scheduler's: {texts} vs {want}")
        for path in ("/v1/models", "/healthz", "/readyz", "/stats"):
            conn = http.client.HTTPConnection(*addr, timeout=60)
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                fail(f"GET {path}: {resp.status}")
            if path == "/stats":
                out["stats"] = json.loads(body)
        dev = out["stats"].get("device_time", {})
        sampled = dev.get("by_entry", {}).get("scheduler_step")
        print(f"[serve] HTTP /stats: {dev.get('sampled_steps')} working steps sampled by the "
              f"step sampler (CUDA events), device ms a step {sampled} [{card}]")
        if not sampled:
            fail(f"the step sampler recorded no device time: {dev}")
        status, raw = post(addr, "/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "x" * 3000}],
                            "max_tokens": 2, "temperature": 0})
        print(f"[serve] HTTP: GET /v1/models, /healthz, /readyz, /stats 200; a prompt past S "
              f"answers {status} {raw[:80]}")
        if status != 400:
            fail(f"a prompt past S answered {status}, wanted 400")
        out.update(wall_s=wall, texts_equal=equal, clients=len(bodies))
    finally:
        PROFILER.reset()
        server.shutdown()
        server.server_close()
        api_server.finish(state, drain_timeout=30.0)
        if state._scheduler is not None:
            state._scheduler.engine.release()

    # the legacy path (no --serve-batch): one chat request against generate
    legacy = api_server.ApiState(one, tokenizer, Sampler(vocab, 0.0, 0.9, 3),
                                 model_name="llama2-7b-synthetic")
    server = start(legacy)
    try:
        route, body = bodies[0]
        status, raw = post(server.server_address[:2], route, {**body, "stream": False})
        if status != 200:
            fail(f"legacy chat request: {status} {raw[:200]}")
        got = json.loads(raw)["choices"][0]["message"]["content"]
        prompt, _, _ = api_server._prompt_and_stops(body, True)
        one.reset()
        toks = one.generate(tokenizer.encode(prompt), 32, Sampler(vocab, 0.0, 0.9, 1)).tokens
        want = scanned(True, body, toks)
        print(f"[serve] HTTP legacy path: chat text equal to generate's: {got == want}")
        if got != want:
            fail(f"legacy chat text {got!r} differs from generate's {want!r}")
        out["legacy_equal"] = True
    finally:
        server.shutdown()
        server.server_close()
    return out


def k1_wcls_t4(gen) -> dict:
    """K1 on wcls at t = B, the one projection of a batch step that phase
    2's path rows do not time at t = 4: kernel, plain, library, bound."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    d, n = K1_SHAPES["wcls"]
    dt, t = torch.bfloat16, SERVE_B
    wbytes = d * n // 2 + d * n // 32 * 2
    ws = rotating(lambda: random_q40(gen, d, n), wbytes)
    w0 = ws()
    x = torch.randn((t, n), generator=gen, device="cuda").to(dt)
    got = cuda_q40.q40_matmul(x, w0, dt).float()
    want = cuda_q40.q40_matmul_reference(x, w0, dt).float()
    err = (got - want).abs().max().item()
    tol = TOL[dt] * want.abs().max().item()
    if not (err <= tol and bool(torch.isfinite(got).all())):
        fail(f"K1 wcls t={t}: max err {err:.3g} > tol {tol:.3g}")
    wd = rotating(lambda: dequantize_q40_torch(random_q40(gen, d, n), dt), d * n * 2)
    bms, by = bound_ms(wbytes + 2 * t * n + 2 * t * d, 2.0 * t * d * n, dt)
    row = dict(shape="wcls", d=d, n=n, t=t, max_abs_err=err, tol=tol,
               ms=time_ms(lambda: cuda_q40.q40_matmul(x, ws(), dt)),
               plain_ms=time_ms(lambda: cuda_q40.q40_matmul_reference(x, ws(), dt)),
               library_ms=time_ms(lambda: torch.matmul(x, wd().t())), bound_ms=bms, bound_by=by)
    print("[serve] [K1] " + json.dumps(row))
    del ws, wd, w0
    return row


def phase_serving(card: str, params) -> dict:
    """Phase 7, serving at Llama-2-7B full width and depth over phase 5's
    weights: the batch-4 slot engine (a), the scheduler (b), the timing of
    the batch step, and `dllama api` over HTTP (c)."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    spec = _spec("llama2_7b")
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    q80 = dict(activation_q80=True)
    one = Engine(spec, params, device="cuda", **q80)       # the CLI's batch-1 engine
    eng = Engine(spec, params, device="cuda", batch=SERVE_B, **q80)
    eager = Engine(spec, params, device="cuda", batch=SERVE_B, cuda_graphs=False, **q80)
    out, sched = serving_slot_engine(spec, one, eng, eager)
    out["scheduler"] = serving_scheduler(spec, one, eng, sched)
    out["load"] = serving_load(spec, sched)
    out["timing"] = serving_timing(spec, eng, eager, card)
    eng.release()
    eager.release()
    del eng, eager, sched
    out["http"] = serving_http(spec, one, card)
    del one
    torch.cuda.empty_cache()
    out["k1_wcls_t4"] = k1_wcls_t4(gen)
    out["seconds"] = time.perf_counter() - t_start
    tm, ld = out["timing"], out["load"]
    g, e, prof = tm["graph"], tm["eager"], tm["profile"]
    busy = prof["device_ms_per_step"]
    print(f"[serve] load run: {ld['requests']} requests x 32 tokens, Poisson arrivals at "
          f"{ld['rate_per_s']:.1f} a second over {ld['arrival_span_s']:.3f} s, 4 slots: aggregate "
          f"{ld['tok_s']:.1f} tok/s ({ld['tokens']} tokens in {ld['wall_s']:.3f} s) [{card}]")
    print(f"[serve] load run: TTFT p50 {ld['ttft_p50_ms']:.1f} ms, p95 {ld['ttft_p95_ms']:.1f}, "
          f"p99 {ld['ttft_p99_ms']:.1f}, max {ld['ttft_max_ms']:.1f} ({ld['requests']} requests); "
          f"ITL p50 {ld['itl_p50_ms']:.3f} ms, p95 {ld['itl_p95_ms']:.3f}, p99 "
          f"{ld['itl_p99_ms']:.3f}, max {ld['itl_max_ms']:.3f} (every gap: {ld['n_gaps']}) "
          f"[{card}]")
    print(f"[serve] isolated batch step loop (4 live rows, no scheduler, greedy on the host): "
          f"{tm['tok_s']:.1f} tok/s [{card}]")
    print(f"[serve] batch step (B = 4): graph {g['median']:.3f} ms median (min {g['min']:.3f}, "
          f"max {g['max']:.3f}; runs {', '.join(f'{x:.3f}' for x in g['runs'])}), eager "
          f"{e['median']:.3f} ms (min {e['min']:.3f}, max {e['max']:.3f}), in turns [{card}]")
    c = out["chunk_ms"]
    print(f"[serve] (4, 256) prefill chunk {c['median']:.3f} ms median (min {c['min']:.3f}, "
          f"max {c['max']:.3f}) [{card}]")
    print(f"[serve] batch step: device busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms of {g['median']:.3f}: idle share {1 - busy / g['median']:.3f}")
          + f"; cudaGraphLaunch {prof['graph_launches_per_step']:.1f}, cudaLaunchKernel "
            f"{prof['launch_kernel_per_step']:.1f} a step [{card}]")
    ops = prof["kernels_per_step"]
    print(f"[serve] batch step kernels: {SLOT_STEP['K1']} K1 + {SLOT_STEP['K3']} K3 + "
          f"{SLOT_STEP['Q80']} Q80 (counted) + "
          + ("not measured" if ops is None else
             f"{ops - sum(SLOT_STEP.values()):.0f} other kernels, PyTorch's and K3's merge "
             f"passes (profiler: {ops:.0f} in all)")
          + " a step")
    print(f"[serve] phase 7 in {out['seconds']:.1f} s")
    return out


def serving_entries(k1: dict, q80: dict, k3: dict, serving: dict) -> list[dict]:
    """The kernels at the serving phase's shapes, each for ONE 7B batch
    step (B = 4, t = 4): K1 on its tensor-core path (phase 2's path rows
    at t = 4 for the layers, wcls timed in phase 7), the 129 standalone
    Q80 round trips (phase 2b's t = 4 rows), K3 over 4 rows (phase 4).
    Launches: counted over phase 7's scheduler run (its batch steps and
    chunks; a chunk's K1 is its wcls at t = 4, its Q80 128 inputs at
    t = 1024 and wcls's at t = 4)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    kp = {r["shape"]: r for r in k1["paths"] if r["t"] == SERVE_B}
    w = serving["k1_wcls_t4"]
    layer = ("wqkv", "wo", "w13", "w2")
    k1s = {key: 32 * sum(kp[sh]["tc_ms" if key == "ms" else key] for sh in layer) + w[key]
           for key in keys}
    qr = {(r["t"], r["n"]): r for r in q80["rows"]
          if r["dtype"] == "bfloat16" and r["out"] == "bfloat16"}
    q80s = {key: 97 * qr[(SERVE_B, 4096)][key] + 32 * qr[(SERVE_B, 11008)][key]
            for key in ("ms", "plain_ms", "bound_ms")}
    a = next(r for r in k3["rows"] if r["b"] == SERVE_B and r["t"] == 1 and r["cache"] == "bfloat16"
             and r["dtype"] == "bfloat16" and r["pos0"] == [511, 400, 300, 200])
    counts = serving["scheduler"]["launches"]
    return [
        dict(name="q40_matmul_slot_step", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (t = B = 4: wgmma with the "
                      "weight dequantized into registers, one 64-token tile)",
             launches=counts["K1"],
             max_abs_err=max([kp[sh]["tc_err"] for sh in layer] + [w["max_abs_err"]]),
             **k1s, bound_by="bytes",
             at="one 7B batch step: 32x(wqkv,wo,w13,w2)+wcls at t=4, bf16; launches: phase "
                "7's scheduler run"),
        dict(name="q80_roundtrip_slot_step", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q80_roundtrip.cu",
             replaces="distributed_llama_tpu/ops/matmul.py:93 (quantize_q80_jax / "
                      "dequantize_q80_jax before every matmul; no pallas_call)",
             launches=counts["Q80"],
             max_abs_err=max(qr[(SERVE_B, n)]["max_abs_err"] for n in (4096, 11008)),
             **q80s, bound_by="bytes", library_ms=None,
             at="one 7B batch step: 97 inputs at 4x4096 + 32 at 4x11008, bf16; launches: "
                "phase 7's scheduler run (its chunks' inputs at t=1024 too)"),
        dict(name="flash_attention_slot_step", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233",
             launches=counts["K3"],
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"] if r["b"] == SERVE_B
                             and r["cache"] == "bfloat16" and r["dtype"] == "bfloat16"),
             ms=32 * a["ms"], plain_ms=32 * a["plain_ms"], bound_ms=32 * a["bound_ms"],
             bound_by=a["bound_by"], library_ms=32 * a["library_ms"],
             at="one 7B batch step: 32 layers, 4 rows at pos0 511/400/300/200, T=1, H=KVH=32, "
                "bf16; launches: phase 7's scheduler run (its (4, 256) chunks too)"),
    ]


def summarize(k1: dict, q80: dict, fused: dict, k2: dict, k3: dict, probes: dict,
              probes2: dict, main: dict) -> dict:
    """One entry per kernel (K3's e4m3 mode its own): its time, plain and
    library times and bound for ONE decode step (t = 1, bf16), summed from
    the per-launch measurements above — K1 and K3 of a Llama-2-7B step, K2
    and K3-e4m3 of a Mixtral 8x7B step; launches from the main-path runs.
    K1 and K3 also have a prefill entry: one 7B 256-token chunk, launches
    counted over the prompts' prefills of the main paths."""
    dec = {r["shape"]: r for r in k1["rows"] if r["t"] == 1 and r["dtype"] == "bfloat16"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    agg1 = {key: sum(dec[s][key] * c for s, c in K1_PER_STEP.items()) for key in keys}
    k2r = {r["shape"]: r for r in k2["rows"] if r["t"] == 1 and r["dtype"] == "bfloat16"}
    # per Mixtral layer: gate and up (one shape) and down
    agg2 = {key: 32 * (2 * k2r["mixtral_gate_up"][key] + k2r["mixtral_down"][key])
            for key in keys}

    # K1 over one 7B prefill chunk: 32 x (wqkv, wo, w13, w2) at t = 256, and
    # wcls at the chunk's last position (t = 1)
    pre = {r["shape"]: r for r in k1["rows"] if r["t"] == 256 and r["dtype"] == "bfloat16"}
    agg1p = {key: 32 * sum(pre[sh][key] for sh in ("wqkv", "wo", "w13", "w2"))
             + dec["wcls"][key] for key in keys}

    # Mixtral's dense experts at t = 256: one layer of a chunk, 8 x (gate,
    # up, down)
    moe = {r["shape"]: r for r in k1["rows"] if r["t"] == 256 and r["shape"] in K1_MOE_SHAPES}
    agg_moe = {key: 8 * (2 * moe["moe_gate_up"][key] + moe["moe_down"][key]) for key in keys}
    # the standalone Q80 round trip where a 7B path still runs it: one
    # prefill chunk, 32 x (wqkv, wo, w13 inputs at 4096, w2's at 11008) at
    # t = 256, bf16 (the chunk's wcls input, t = 1, is fused)
    qr = {(r["t"], r["n"]): r for r in q80["rows"]
          if r["dtype"] == "bfloat16" and r["out"] == "bfloat16"}
    aggq = {key: 32 * (3 * qr[(256, 4096)][key] + qr[(256, 11008)][key])
            for key in ("ms", "plain_ms", "bound_ms")}
    # the round trip fused into the t = 1 GEMV, one 7B decode step: the
    # fused launches' time less the GEMV's alone; bound: x read once
    f7 = fused["steps"]["llama2_7b"]

    def k3_row(cache, kvh, t, pos0):
        return next(r for r in k3["rows"] if r["cache"] == cache and r["dtype"] == "bfloat16"
                    and r["b"] == 1 and r["kvh"] == kvh and r["t"] == t
                    and r["pos0"] == [pos0] and r["hs"] == 128 and r["s"] == 2048)
    a3 = k3_row("bfloat16", 32, 1, 511)
    a8 = k3_row("float8_e4m3fn", 8, 1, 511)
    ap = k3_row("bfloat16", 32, 256, 1792)
    plain_paths = ("llama2_7b", "mixtral_8x7b", "grok1_2l")
    all_paths = plain_paths + ("mixtral_8x7b_f8",)

    def launches(k, paths):
        return sum(main[p]["launches"][k] for p in paths)

    def prefill_launches(k):
        return sum(main[p]["prefill_launches"][k] for p in all_paths)
    return {"kernels": [
        dict(name="q40_matmul", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258",
             launches=launches("K1", plain_paths + ("mixtral_8x7b_f8",)),
             max_abs_err=max(r["max_abs_err"] for r in k1["rows"]),
             **agg1, bound_by="bytes",
             at="one 7B decode step: 32x(wqkv,wo,w13,w2)+wcls, t=1, bf16"),
        dict(name="q40_matmul_prefill", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (t >= TC_MIN_T: wgmma with "
                      "the weight dequantized into registers, TMA ring)",
             launches=prefill_launches("K1"),
             max_abs_err=max(r["max_abs_err"] for r in k1["rows"] if r["t"] == 256),
             **agg1p, bound_by="operations",
             mixtral_layer=dict(**agg_moe, bound_by="operations",
                                at="one Mixtral chunk layer: 8x(gate, up, down) at t=256"),
             at="one 7B prefill chunk: 32x(wqkv,wo,w13,w2) at t=256 + wcls at t=1, bf16; "
                "launches: counted over the main paths' prompt prefills"),
        dict(name="q80_roundtrip", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q80_roundtrip.cu",
             replaces="distributed_llama_tpu/ops/matmul.py:93 (quantize_q80_jax / "
                      "dequantize_q80_jax before every matmul; no pallas_call)",
             launches=sum(main[p]["launches"]["Q80"] for p in main),
             max_abs_err=max(r["max_abs_err"] for r in q80["rows"]),
             **aggq, bound_by="bytes", library_ms=None,
             at="one 7B prefill chunk: 32x(wqkv, wo, w13, w2 inputs) at t=256, bf16; "
                "launches: the standalone kernel's (router, prefill inputs)"),
        dict(name="q40_gemv1_q80", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/matmul.py:93 and :165 (quantize_q80_jax / "
                      "dequantize_q80_jax, fused by XLA into the Q40 kernel's operand; no "
                      "pallas_call)",
             launches=sum(main[p]["launches"]["Q80F"] for p in main),
             max_abs_err=fused["max_abs_err"],
             ms=f7["fused_minus_gemv_ms"], plain_ms=f7["plain_q80_ms"],
             bound_ms=f7["bound_q80_ms"], bound_by="bytes", library_ms=None,
             fused_ms=f7["fused_ms"], gemv_ms=f7["gemv_ms"],
             gemv_plus_q80_ms=f7["gemv_plus_q80_ms"],
             at="one 7B decode step, 129 inputs, t=1, bf16: the fused K1 launches' time less "
                "the GEMV's alone (fused_ms - gemv_ms); plain: the codec's round trip"),
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
                             if r["cache"] == "bfloat16" and r["dtype"] == "bfloat16"),
             ms=32 * a3["ms"], plain_ms=32 * a3["plain_ms"],
             bound_ms=32 * a3["bound_ms"], bound_by=a3["bound_by"],
             library_ms=32 * a3["library_ms"],
             at="one 7B decode step: 32 layers, T=1, H=KVH=32, fill 512, bf16"),
        dict(name="flash_attention_prefill", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233",
             launches=prefill_launches("K3"),
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"]
                             if r["cache"] == "bfloat16" and r["dtype"] == "bfloat16"
                             and r["t"] > 1),
             ms=32 * ap["ms"], plain_ms=32 * ap["plain_ms"],
             bound_ms=32 * ap["bound_ms"], bound_by=ap["bound_by"],
             library_ms=32 * ap["library_ms"],
             at="one 7B prefill chunk: 32 layers, T=256 at pos0 1792, H=KVH=32, bf16; "
                "launches: counted over the main paths' prompt prefills"),
        dict(name="flash_attention_e4m3", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233 (e4m3 cache, "
                      ":135-144)",
             launches=main["mixtral_8x7b_f8"]["launches"]["K3"],
             max_abs_err=max(r["max_abs_err"] for r in k3["rows"]
                             if r["cache"] == "float8_e4m3fn" and r["dtype"] == "bfloat16"),
             ms=32 * a8["ms"], plain_ms=32 * a8["plain_ms"],
             bound_ms=32 * a8["bound_ms"], bound_by=a8["bound_by"],
             library_ms=32 * a8["library_ms"],
             at="one Mixtral decode step: 32 layers, T=1, H=32/KVH=8, fill 512, "
                "e4m3 cache, bf16 q"),
        *probe_entries(probes),
        *probe_entries_p2_p6(probes2),
    ]}


def probe_entries(probes: dict) -> list[dict]:
    """One entry per probe kernel, each for ONE pass of its tool (the L
    weights at 11008x4096, t = 1); the ladder's at its dot stage, with every
    stage under `stages`. Launches from the tools' runs."""
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    rows = probes["rows"]
    launches = {name: res["launches"] for name, res in probes["tools"].items()}
    src = "distributed_llama_tpu_torch/csrc/q40_probes.cu"

    def entry(name, label, replaces, tool, counter, at):
        r = next(r for r in rows if r["name"] == name and r["label"] == label)
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[tool][counter], **{k: r[k] for k in keys},
                    at=at)
    ladder = entry("q40_ladder", "dot", "tools/kernel_ladder.py:92", "kernel_ladder",
                   "P7", "one pass of tools.kernel_ladder: 32 x 11008x4096, f32 "
                   "scales, t=1; the dot stage (all stages under 'stages')")
    ladder["stages"] = {r["label"]: {k: r[k] for k in keys + ("gbps",)}
                        for r in rows if r["name"] == "q40_ladder"}
    return [
        ladder,
        entry("q40_matmul_a", "A bf16", "tools/kernel_experiments.py:80",
              "kernel_experiments", "P4a", "one pass of tools.kernel_experiments: "
              "32 x 11008x4096, f32 scales, t=1, bf16 x, f32 out"),
        entry("q40_matmul_b", "B bf16+corr", "tools/kernel_experiments.py:126",
              "kernel_experiments", "P4b", "the same as q40_matmul_a"),
        entry("int8_gemv", "int8 dp4a", "tools/exp_int8_dot.py:56", "exp_int8_dot",
              "P1", "one pass of tools.exp_int8_dot: 24 x 11008x4096 int4 values, "
              "f32 row scales, int8 x, f32 out"),
    ]


def probe_entries_p2_p6(probes2: dict) -> list[dict]:
    """One entry per kernel or mode of P2, P3, P5 and P6, each for ONE call
    or pass of its tool at the tool's shape (P3 at w1, attn under `shapes`;
    P6 at td = 128, td = 64 under `td64`, K1's landed row under `landed`).
    Launches from the tools' counted untimed passes."""
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    rows, tools = probes2["rows"], probes2["tools"]

    def row(name, label):
        return next(r for r in rows if r["name"] == name and r["label"] == label)

    def entry(name, src, replaces, tool, label, counter, rname, at, **extra):
        r = row(rname, label)
        return dict(name=name, route="cuda", source=f"distributed_llama_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=tools[tool]["launches"][label][counter],
                    **{k: r[k] for k in keys}, at=at, **extra)
    out = [entry(f"f8_flash_decode_{mode}", "f8_flash_probe.cu", "tools/exp_f8_flash.py:117",
                 "exp_f8_flash", label, "P2", "f8_flash_decode",
                 "one call of tools.exp_f8_flash: B 1, KVH 32, S 8192, hs 128, fill 7680, t=1")
           for label, mode in (("bf16", "plain"), ("astype-f8", "astype"),
                               ("bits-f8", "bits"), ("bitsflush-f8", "bitsflush"))]
    out += [entry(f"q40_pk_gemv_{mode}", "q40_gemv1_probes.cu", "tools/exp_pk_decode.py:79",
                  "exp_pk_decode", f"w1 {mode}", "P3", "q40_pk_gemv",
                  "one call of tools.exp_pk_decode at w1: 22016x4096, f16 scales, t=1, f32",
                  k1_ms=row("q40_pk_gemv", f"w1 {mode}")["k1_ms"],
                  shapes={"attn": {k: row("q40_pk_gemv", f"attn {mode}")[k]
                                   for k in keys + ("k1_ms",)}})
            for mode in ("base", "pk")]
    out += [entry(f"q40_matmul_scales_{kind}", "q40_gemv1_probes.cu", "tools/exp_scale_f16.py:60",
                  "exp_scale_f16", f"{kind} scales", "P5", "q40_matmul_scales",
                  f"one pass of tools.exp_scale_f16: 32 x 22016x4096, {kind} scales, t=1, f32",
                  k1_ms=row("q40_matmul_scales", f"{kind} scales")["k1_ms"])
            for kind in ("u16", "f32")]
    landed = {k: row("q40_matmul (landed, wgmma)", "landed")[k] for k in keys}
    out += [entry(f"q40_matmul_sub_n{ns}", "q40_prefill_probe.cu",
                  "tools/exp_unpack_overlap.py:86", "exp_unpack_overlap",
                  f"td=128 n_sub={ns}", "P6", "q40_matmul_sub",
                  f"one call of tools.exp_unpack_overlap: 11008x4096, T=256, bf16, td=128, "
                  f"n_sub={ns}",
                  td64={k: row("q40_matmul_sub", f"td=64 n_sub={ns}")[k] for k in keys},
                  landed=landed)
            for ns in (1, 2, 4, 8)]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    k1 = phase_k1(gen)
    q80 = phase_q80(gen)
    k2 = phase_k2(gen)
    edges = gemv1_edges(gen)
    fused = phase_gemv1_q80(gen)
    k3 = phase_k3(gen)
    probes = phase_probes()
    t_p2 = time.perf_counter()
    probes2 = phase_probes_p2_p6()
    probes2["seconds"] = time.perf_counter() - t_p2
    print(f"[probe] P2, P3, P5, P6 in {probes2['seconds']:.1f} s")
    t_main = time.perf_counter()
    main_paths, params_7b = phase_main_paths(card)
    main_s = time.perf_counter() - t_main
    print(f"[main] main paths and their graph phases in {main_s:.1f} s")
    serving = phase_serving(card, params_7b)
    del params_7b
    torch.cuda.empty_cache()
    phase_file_path()
    kernels = summarize(k1, q80, fused, k2, k3, probes, probes2, main_paths)
    kernels["kernels"] += serving_entries(k1, q80, k3, serving)
    for tag, name, what in (("K1", "q40_matmul", "one 7B decode step, t = 1, bf16"),
                            ("K2", "q40_expert_matmul", "one Mixtral 8x7B decode step, t = 1, bf16")):
        e = next(k for k in kernels["kernels"] if k["name"] == name)
        print(f"[{tag}] step sum, {what}: {e['ms']:.4f} ms against a bound of "
              f"{e['bound_ms']:.4f} ms = {e['bound_ms'] / e['ms']:.3f} of the bound; plain "
              f"{e['plain_ms']:.3f} ms, library {e['library_ms']:.4f} ms [{card}]")
    for tag, name, what in (("K1", "q40_matmul_slot_step", "one 7B batch step, t = 4, bf16, "
                                                          "the tensor-core path"),
                            ("Q80", "q80_roundtrip_slot_step", "one 7B batch step's 129 "
                                                               "standalone launches, t = 4"),
                            ("K3", "flash_attention_slot_step", "one 7B batch step, 4 rows "
                                                                "at fills 512/401/301/201")):
        e = next(k for k in kernels["kernels"] if k["name"] == name)
        lib = ("none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms")
        print(f"[serve] [{tag}] {what}: {e['ms']:.4f} ms against a bound of {e['bound_ms']:.4f} "
              f"ms ({e['bound_by']}) = {e['bound_ms'] / e['ms']:.3f} of the bound; plain "
              f"{e['plain_ms']:.3f} ms, library {lib} [{card}]")
    for step, a in fused["steps"].items():
        print(f"[GEMV1-Q80] {step} step, t = 1, bf16: fused {a['fused_ms']:.4f} ms, GEMV alone "
              f"{a['gemv_ms']:.4f} ms, GEMV + standalone Q80 {a['gemv_plus_q80_ms']:.4f} ms: "
              f"saved {a['saved_ms']:.4f} ms, fused - GEMV {a['fused_minus_gemv_ms']:+.4f} ms "
              f"[{card}]")
    def share(x):
        return "not measured" if x is None else f"{x:.3f}"
    for key, path in main_paths.items():
        g = path["graph"]
        e, r = g["eager_ms_per_token"], g["graph_ms_per_token"]
        print(f"[graph] {key}: decode ms/token eager {e['median']:.3f} [{e['min']:.3f}, "
              f"{e['max']:.3f}], graph {r['median']:.3f} [{r['min']:.3f}, {r['max']:.3f}] "
              f"({e['median'] / r['median']:.2f}x); idle share eager "
              f"{share(g['eager_profile']['idle_share'])}, graph "
              f"{share(g['graph_profile']['idle_share'])}; a graph step "
              f"{g['graph_profile']['graph_launches_per_step']:.1f} cudaGraphLaunch, "
              f"{g['graph_profile']['launch_kernel_per_step']:.1f} cudaLaunchKernel; "
              f"decode_greedy_device {g['greedy_device_ms_per_token']['median']:.3f} ms/token "
              f"= {g['greedy_device_hbm_share']:.3f} of 3.35 TB/s [{card}]")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, k1=k1["rows"], k1_paths=k1["paths"],
        k1_plans=k1["plans"], q80=q80["rows"],
        k2=k2["rows"], gemv1_edges=edges, gemv1_q80=fused, k3=k3["rows"],
        k3_shapes=k3["shapes"], k3_graph=k3["graph"],
        probes=probes, probes2=probes2, main_paths=main_paths, main_paths_s=main_s,
        serving=serving,
        kernels=kernels["kernels"], total_s=time.perf_counter() - t_start), indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
