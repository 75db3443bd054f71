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
    n 4096, 11008, 14336; and a 7B batch step's t = 4 and verify forward's
    t = 8 at n 4096, 11008), bf16 and f32 in and out, timed beside it; each
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
    pos0 1000 (a ragged last tile), hs = 64 at a decode and a prefill
    case, and T = 8 at pos0 300 (a 7B verify forward), each with a bf16 cache and with an fp8 (e4m3) cache (the
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

 7b. KV reuse (`[prefix]`, `[session]` lines; over phase 7's engines and
    weights): a PrefixCache at the serving default (2 x 4 x 2048 tokens in
    blocks of 32: 512 blocks, 8 GiB); 24 blocks published from a
    prefilled row bit-equal to its cache slices, a row seeded from them
    bit-equal to the source row, no cache tensor moved; an e4m3 arena block
    of every byte code seeds a row with 0x7F and 0xFF saturated to +-448;
    a 24-block seed and one publish timed (CUDA events; kernel ms,
    launches) beside their bound in bytes; the slot decode graph replayed
    after a seed bit-equal to the eager step. Hit parity: 8 greedy
    requests of 32 tokens sharing a 768-token prefix (3 chunks, 24
    blocks), suffixes of 16-200 tokens, the first cold, then 7 that must
    hit, against the same requests with the cache off: tokens equal or
    first different at a cache-off top-2 gap within phase 7's near-tie
    bound. Eviction: a 40-block arena, 6 requests one at a time over 2
    alternating 768-token prefixes, tokens held against the cache-off run
    as above; evictions, hits and every block accounted for. Load runs
    with shared prefixes (a synthetic smoke load, from no trace), cache
    off then on: 12 requests at 0.8 a second (below the cold run's knee)
    and 16 at 2 a second (past it), each one of 4 seeded 768-token
    prefixes and a unique suffix (aggregate tok/s, TTFT and ITL
    p50/p95/p99, TTFT p50 over each half of the arrivals, the share of
    gaps a chunk stalled, hit rate, tokens saved and prefilled,
    evictions). Sessions: a batch-1
    engine runs a 300-token prompt and 16 tokens and saves; a fresh
    engine loads the file and its 32 greedy tokens through the graph step
    equal the uninterrupted run's.
 8. Chat (`[chat]` lines): `python -m distributed_llama_tpu_torch.apps.
    dllama chat --device cuda` on the tiny Llama and Mixtral fixtures,
    greedy, at the CLI's defaults: two turns with --session, then a third
    resumed from the file in a new process, equal to an uninterrupted
    three-turn run.
 9. Speculative decoding (`[spec]` lines; after phase 7, over the same
    Llama-2-7B weights, full width and depth, bf16 cache, Q80 on): a plain
    graph generate of 39 greedy tokens after a 300-token prompt, its
    logits recorded. Each verify width T = 2..8: the graph ("lookup", T)
    after the prompt, its tally exactly 129 K1 (the tensor-core path),
    32 K3, 129 standalone Q80; each position's logits held (LOGITS_TOL,
    LOGITS_REL_L2_TOL) to the plain decode step's at that position, whose
    largest difference e gives the near-tie bound 2e; the forward on the
    kernels against the plain versions on the eager twin; ms a forward by
    CUDA events beside the decode step's. Then 32 greedy tokens each of
    prompt lookup, the self-draft at depth 4 (draft_len 7), a draft that
    always matches (the plain run's next tokens) and one that never does
    (each shifted by one), through Engine._lookup_loop: tokens equal to
    plain generate's or first different at a plain top-2 gap within the
    near-tie bound; each run twice, the second with launches zeroed just
    before and read just after (K1, K3, Q80 and Q80F must launch), timed:
    ms/token, tokens a verify, device and host ms; the self-draft's
    proposal alone. One sampled lookup run and one sampled self-draft run:
    device and host ms. The scheduler with --draft self:4 over a B = 4
    engine: the verify step's position-0 logits of 4 live rows against
    the batch-1 step's; warmup captures the draft's proposal and
    ("slot_verify", 8, 32000); 8 greedy requests capture nothing more and
    give batch-1 generate's tokens (near-ties as above); slot_verify_step
    and the slot decode step timed. Last, `dllama inference
    --lookup-decode 4` and `--draft self:1` on the tiny Llama and Mixtral
    fixtures, at the defaults with their kernels launched, and in f32
    with the CPU's tokens.
10. The flight recorder, the device profiler and the batch generators
    (`[trace]`, `[batch]`, `[F3]` lines; over the same 7B weights, B = 4,
    C = 256, bf16 cache, Q80 on): (a) phase 7's 8 requests with --trace
    and --profile-sample 1: each request's span holds enqueue > admit >
    prefill > first_token > finish under its own trace id; the step
    timeline's compositions; each sampled step's wall ms, device ms by
    entry (CUDA events around each graph replay and eager entry) and host
    gap; no capture after warmup; tokens held to batch-1 generate's. A
    scheduler step with 4 live decode rows timed with tracing off and on
    in turns, TRACE_PAIRS pairs: tracing must cost at most 2%. (d) The
    batch generators over 4 prompts: generate_batch against batch-1
    generate, generate_batch_device (T 0.8, top-p 0.9, row i seeded
    11 + i) against its host twin (same forward, a Sampler a row): equal
    or a CDF neighbour within the f32 bound, generate_batch_lookup against
    generate_batch; wall, prefill, ms a decode forward and tok/s. (b)
    `dllama api --serve-batch 4` in-process: POST /admin/profile?ms=200
    while 3 streams decode and a 4th is admitted, the trace's K1 and K3
    kernels counted (inside graph replays too; none there is printed, not
    failed); POST /v1/batch/completions with 4 prompts, texts equal to
    generate_batch's on the same engine. (c, e) Three CLI processes on the
    tiny Llama Q40 fixture: `generate --profile DIR` (its trace must hold
    K1 kernels), the KV-header file, and its legacy-header copy with
    --weights-float-type q40, whose tokens must equal the KV-header
    file's.
11. Admission, auto-sizing and native (`[autotune]`, `[autosize]`,
    `[admission]`, `[native]` lines; over the same 7B weights, bf16
    cache, Q80 on): the calibration tool at its defaults (B = 2-128,
    chunk 32, 32 steps, seq 256, its own synthetic weights): the decode
    curve, the knee, the ladder's widths, the artifact written to
    OUT_DIR and loaded back; three auto-sizing decisions against the
    template engine (no artifact, the card's, the card's with a 50 ms ITL
    SLO) with their bytes against the headroom, then the no-artifact,
    no-arena decision built through the server's state under
    --freeze-compiles: 8 requests against batch-1 generate, 0 captures
    after warmup; phase 7's load cut to 50 requests at 5 a second, B = 4,
    C = 256, static then with a 50 ms ITL SLO, launches counted from 0
    around each (K1, K3 and Q80 must launch), 0 captures after warmup,
    the steps at each rung, each rung's (4, w) chunk by CUDA events with
    its route; --draft self:4 under an 8 ms ITL SLO (the actuator must
    fire, tokens against batch-1 generate); `make -C native clean`, a
    `dllama generate` at T 0.8 on the tiny fixture, `make -C native`, the
    same run on the native backends (tokens equal), and the native
    tokenizer and sampler against the Python ones.
12. Tensor parallelism (`[tp]` lines; after phase 11, over the same 7B
    weights): ranks are gloo processes sharing the card
    (parallel/launch.RankPool: NCCL needs a card a rank), each building
    the same synthetic Q40 weights from one seed on the card and keeping
    its shard (Engine(mesh=)), Q80 activations and collectives and a bf16
    cache as the CLI builds them; every collective stages through host
    memory, so steps run eagerly. Llama-2-7B at full width and depth at
    tp = 2 and tp = 4, Mixtral 8x7B at full width and 2 layers at tp = 2
    (routing replayed from the one-GPU run): greedy tokens after the
    300-token prompt, launches counted from 0 on rank 0, against one GPU
    over the same weights: every rank's tokens equal; each step's logits
    on rank 0, up to and including the first token difference, within
    LOGITS_TOL and LOGITS_REL_L2_TOL of one GPU's; tokens equal one GPU's
    up to the first step whose one-GPU top-2 logit gap is within the
    near-tie bound those tolerances allow (2 x LOGITS_TOL x max |logit|);
    launches equal to one GPU's (the same kernels a step at the shard
    shapes). Then one 256-token chunk and TP_TIMED decode steps timed,
    with the host ms of the collectives and of the staging. The data axis
    (`[dp]` lines): 7B generate_batch over dp = 2 ranks (two rows each,
    prompts of DP_PROMPTS tokens), greedy and at T 0.8, against one GPU's
    generate_batch: rows equal on every rank, each draw's logits within
    those tolerances while its row's history is one GPU's, the shared
    sampler's RNG state at every draw equal to one GPU's, greedy rows
    equal up to a near tie. The NCCL path at world size 1: a 1-rank NCCL group,
    the 7B engine with force_mesh_kernels (marked weights, the exact
    all-reduce over the group of one), its decode step captured as a CUDA
    graph with the all-reduces inside: tokens equal to the plain engine's,
    both timed through their graphs in turns. The CLI: `dllama generate
    --tp 2` on the tiny Llama fixture (this process rank 0, one rank
    spawned), its f32 text equal to one GPU's, rank 0's
    kernels launched; `inference --dp 2` counting both rows. Last, K1 at
    the 7B tp = 2 and tp = 4 row and column shards (t = 1 with the Q80
    round trip fused, t = 256), the standalone Q80 at the column shards'
    chunk inputs, K2 at the Mixtral tp = 2 expert shards and K3 over
    16/16, 8/8 and 16/4 local heads, each against its plain version and
    timed beside its plain version, library call and bound.
13. Serving over ranks (`[serve-tp]` lines; phase 12's pool of 2 ranks):
    the scheduler over tp = 2 with the prefix cache and a self draft, the
    CLI's chat and api over ranks, and K1, K3 and Q80 at one rank's step
    shapes.
14. The other mesh axes (`[axes]` lines; phase 12's pool of 2 ranks, gloo
    on the one card): Llama-2-7B at full width and depth over pp = 2 at
    the CLI's pp defaults (Q80 off; the 300-token prompt's 256 chunk on
    GPipe with 8 microbatches, the 44-token tail and decode on the stage
    relay) and over sp = 2 (the prompt one ring-attention segment, decode
    over the sequence-sharded cache), Mixtral 8x7B at full width and 2
    layers over ep = 2 (4 experts a rank, routing replayed from the
    one-GPU run): tokens and logits held to one GPU's as in phase 12;
    every rank's K1, K2 and K3 launches equal to its share; a rank's
    parameter and cache bytes equal to its share of one GPU's; decode
    ms/token, the prompt's prefill ms, collectives and staged bytes a
    step. Then K1 at t = 32 (a GPipe microbatch, the 7B layer shapes), K1
    at t = 1 on a Mixtral local expert without and with the fused Q80
    round trip, and K3 over a 32-token microbatch at pos0 32*m, each
    against its plain version and timed beside plain, library and bound.

Before the per-kernel JSON, the [K1] and [K2] step sums (one 7B step of K1,
one Mixtral step of K2, t = 1, bf16) print beside their bound and the share
of it, the serving phase's three step sums at B = 4, phase 9's three sums
of one 7B verify forward at T = 8, and the [GEMV1-Q80] step sums (fused,
GEMV alone, GEMV + standalone Q80) of a 7B and a Mixtral step. The line before the last holds the
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


def k1_row(gen, tag: str, name: str, d: int, n: int, t: int, dt, ws, w0,
           q80: bool = False) -> dict:
    """K1 on t tokens of x (d, n): against its plain version (within TOL),
    timed beside the plain version, the library call (the dequantized
    weight through torch.matmul) and its bound; ws() rotates weights of
    the shape so the timed reads miss L2. With q80 the Q80 round trip runs
    inside the launch (t = 1, as a decode step runs it), on both sides."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    wbytes = d * n // 2 + d * n // 32 * 2
    x = torch.randn((t, n), generator=gen, device="cuda").to(dt)
    got = cuda_q40.q40_matmul(x, w0, dt, activation_q80=q80)
    want = cuda_q40.q40_matmul_reference(x, w0, dt, activation_q80=q80)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = TOL[dt] * scale
    ok = err <= tol and bool(torch.isfinite(got).all())
    ms = time_ms(lambda: cuda_q40.q40_matmul(x, ws(), dt, activation_q80=q80))
    plain = time_ms(lambda: cuda_q40.q40_matmul_reference(x, ws(), dt,
                                                          activation_q80=q80))
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
    if q80:
        row["q80"] = True
    print(tag + json.dumps(row))
    if not ok:
        fail(f"K1 {name} t={t} {dt}: max err {err:.3g} > tol {tol:.3g}")
    return row


def phase_k1(gen) -> dict:
    from distributed_llama_tpu_torch.ops import cuda_q40

    rows, paths = [], []
    for name, (d, n) in {**K1_SHAPES, **K1_MOE_SHAPES}.items():
        wbytes = d * n // 2 + d * n // 32 * 2
        ws = rotating(lambda: random_q40(gen, d, n), wbytes)
        w0 = ws()
        runs = (((44, torch.bfloat16), (256, torch.bfloat16)) if name in K1_MOE_SHAPES else
                ((1, torch.bfloat16), (16, torch.bfloat16), (256, torch.bfloat16),
                 (1, torch.float32)))
        for t, dt in runs:
            rows.append(k1_row(gen, "[K1] ", name, d, n, t, dt, ws, w0))
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
    """K2 at the MoE expert shapes: an (8, d, n) stack, 2 active experts."""
    rows = []
    for name, (d, n) in K2_SHAPES.items():
        w = random_q40(gen, N_EXPERTS, d, n)
        for t in (1, 4):
            for dt in (torch.bfloat16, torch.float32):
                rows.append(k2_row(gen, "[K2] ", name, w, t, dt))
        del w
        torch.cuda.empty_cache()
    return {"rows": rows}


def k2_row(gen, tag: str, name: str, w, t: int, dt, q80: bool = False) -> dict:
    """K2 on t tokens against 2 active experts of the (8, d, n) stack w:
    against its plain version (within TOL), timed beside the plain version,
    the library call (index_select of the two experts' bytes, dequantize,
    torch.matmul) and its bound. The timed calls cycle the active pair
    through all 8 experts, so the stack's bytes (264 MB at Mixtral) keep
    each call's reads out of L2. With q80 the Q80 round trip runs inside
    the launch (t = 1), on both sides."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import (
        QuantizedTensor, dequantize_q40_torch)

    _, d, n = w.shape
    pairs = [torch.tensor([2 * i + 1, 2 * i], dtype=torch.int32, device="cuda")
             for i in range(N_EXPERTS // 2)]
    state = {"i": 0}

    def idx():
        state["i"] = (state["i"] + 1) % len(pairs)
        return pairs[state["i"]]
    per_expert = name.startswith(("mixtral_down", "grok1_down"))   # one x an expert
    shape = (N_ACTIVE, t, n) if per_expert else (t, n)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    got = cuda_q40.q40_expert_matmul(x, w, pairs[0], dt, activation_q80=q80)
    want = cuda_q40.q40_expert_matmul_reference(x, w, pairs[0], dt,
                                                activation_q80=q80)
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

    ms = time_ms(lambda: cuda_q40.q40_expert_matmul(x, w, idx(), dt,
                                                    activation_q80=q80))
    plain = time_ms(lambda: cuda_q40.q40_expert_matmul_reference(
        x, w, idx(), dt, activation_q80=q80))
    lib = time_ms(library)
    nbytes = (N_ACTIVE * (d * n // 2 + d * n // 32 * 2)
              + x.numel() * x.element_size()
              + N_ACTIVE * t * d * x.element_size())
    bms, by = bound_ms(nbytes, 2.0 * N_ACTIVE * t * d * n, dt)
    row = dict(shape=name, e=N_EXPERTS, k=N_ACTIVE, d=d, n=n, t=t,
               dtype=str(dt).split(".")[-1], max_abs_err=err,
               tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
               bound_ms=bms, bound_by=by)
    if q80:
        row["q80"] = True
    print(tag + json.dumps(row))
    if not ok:
        fail(f"K2 {name} t={t} {dt}: max err {err:.3g} > tol "
             f"{tol:.3g}, shape {tuple(got.shape)}")
    return row


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
              (4, 4096), (4, 11008),     # a 7B batch step's inputs, B = 4
              (8, 4096), (8, 11008))     # a 7B verify forward's, T = 8


def phase_q80(gen) -> dict:
    """The Q80 round trip against its plain version, bit for bit, at the
    7B and Mixtral matmul input shapes, f32 and bf16 in and out; timed
    beside the plain version (no single PyTorch call computes it)."""
    rows = []
    for t, n in Q80_SHAPES:
        for dt, odt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                        (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            if dt != odt and t != 256:
                continue
            rows.append(q80_row(gen, "[Q80] ", t, n, dt, odt))
    return {"rows": rows}


def q80_row(gen, tag: str, t: int, n: int, dt, odt) -> dict:
    """The Q80 round trip of a (t, n) input against its plain version, bit
    for bit, timed beside it."""
    from distributed_llama_tpu_torch.ops import cuda_q80

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
    print(tag + json.dumps(row))
    if not exact:
        fail(f"q80_roundtrip t={t} n={n} {dt}->{odt}: not bit-equal to the plain "
             f"version (max err {err:.3g})")
    return row


def phase_k3(gen) -> dict:
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
              (4, 32, 32, 256, [0, 2048, 512, 2048], 128, 2048),
              # a 7B verify forward: 8 query rows after a 300-token prompt
              (1, 32, 32, 8, [300], 128, 2048)]
    # (q dtype, cache dtype, cases): the bf16 q paths on every case, the
    # exact f32 path (f32 q, f32 or e4m3 cache) on a few
    f32_cases = [(1, 32, 8, 1, [2047], 128, 2048), (1, 32, 8, 256, [1792], 128, 2048),
                 (2, 32, 8, 16, [100, 1500], 128, 2048), (1, 32, 8, 100, [1000], 128, 2048)]
    runs = [(bf16, bf16, cases), (bf16, F8, cases), (torch.float32, torch.float32, f32_cases),
            (torch.float32, F8, f32_cases[:1])]
    rows = [k3_row(gen, "[K3] ", dt, cdt, case)
            for dt, cdt, run_cases in runs for case in run_cases]
    torch.cuda.empty_cache()
    return {"rows": rows, "shapes": k3_shape_sweep(gen), "graph": k3_graph_replay(gen)}


def k3_row(gen, tag: str, dt, cdt, case: tuple) -> dict:
    """K3 on one case (b, h, kvh, t, pos0 per row, hs, S) with q and the
    output in dt over a cdt cache: against its plain version (within TOL),
    timed beside the plain version, SDPA over the filled prefix and its
    bound."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention

    b, h, kvh, t, pos0, hs, s = case
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
    print(tag + json.dumps(row))
    if not ok:
        fail(f"K3 {dt} q, {cdt} cache b={b} h={h}/{kvh} t={t} pos0={pos0} hs={hs} "
             f"S={s}: max err {err:.3g} > tol {tol:.3g}")
    del kvs, k, v, ks, vs
    return row


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


def profile_decode(engine, token: int, steps: int = 4, run=None,
                   quiet: bool = False) -> dict:
    """Device time per decode step by kernel name, from torch.profiler over
    a few steps (each ends in its logits copy, as in generate), or over
    run(), which makes `steps` decode steps (or other calls) itself;
    `quiet` prints nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    say = (lambda *_: None) if quiet else print

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
    say("[profile] CUDA runtime calls per decode step (host ms in them): "
          + ", ".join(f"{k} {c:.1f} ({host_ms[k]:.3f})" for k, c in runtime[:8]))
    say(f"[profile] per decode step: cudaGraphLaunch {calls.get('cudaGraphLaunch', 0.0):.1f}, "
          f"cudaLaunchKernel {calls.get('cudaLaunchKernel', 0.0):.1f}, cudaMemcpyAsync "
          f"{calls.get('cudaMemcpyAsync', 0.0):.1f}")
    copies = memcpy_callers(prof, steps)
    if copies:
        say("[profile] cudaMemcpyAsync per decode step by calling op: "
              + "; ".join(f"{k}: {c:.1f}" for k, c in copies.items()))
    out = {"runtime_calls": runtime, "runtime_host_ms": host_ms, "memcpy_callers": copies,
           "graph_launches_per_step": calls.get("cudaGraphLaunch", 0.0),
           "launch_kernel_per_step": calls.get("cudaLaunchKernel", 0.0)}
    if not rows:
        say("[profile] the profiler recorded no device time: not measured")
        return {"device_ms_per_step": None, "top": [], **out}
    say(f"[profile] kernel time per decode step {total:.3f} ms; top kernels:")
    for name, count, ms in rows[:10]:
        say(f"[profile]   {ms:8.4f} ms  x{count:6.1f}  {name[:90]}")
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
            out = transformer._moe_ffn(xb, engine.params["layers"][0], spec, dict(
                compute_dtype=engine.compute_dtype, activation_q80=engine.activation_q80,
                mesh=None, tp_reduce="exact"))
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
        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=180)
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

    parity = batch1_parity(one, prompts, got, near_tie, "[serve] request")
    return dict(wall_s=wall, chunks=calls["chunk"], steps=calls["step"], launches=counts,
                parity=parity, step_rows_worst=worst, near_tie_bound=near_tie)


def batch1_parity(one, prompts: list, got: list, near_tie: float, tag: str,
                  n: int = 32) -> list:
    """Each row's greedy tokens against a sequential batch-1 generate of its
    prompt: equal, or first different where the batch-1 top-2 logit gap is
    within the near-tie bound (a batch row's logits lie within e of the
    batch-1 step's)."""
    vocab = one.spec.vocab_size
    parity = []
    for i, (p, toks) in enumerate(zip(prompts, got)):
        one.reset()
        rec = _recording_sampler(vocab, 0.0, 0.9, 1)
        ref = one.generate(p, n, rec).tokens
        first_diff = next((k for k, (x, y) in enumerate(zip(toks, ref)) if x != y),
                          None if len(toks) == len(ref) else min(len(toks), len(ref)))
        gaps = [_top2_gap(lg) for lg, _ in rec.seen]
        gap = (None if first_diff is None or first_diff >= len(gaps) else gaps[first_diff])
        parity.append(dict(prompt=len(p), tokens=len(toks), first_difference=first_diff,
                           gap_at_difference=gap, min_gap=min(gaps)))
        print(f"{tag} {i}: {len(p)}-token prompt, {len(toks)} tokens; "
              + ("equal to batch-1 generate's" if first_diff is None else
                 f"first difference from batch-1 generate at {first_diff}, batch-1 top-2 gap "
                 f"there {gap} (near-tie bound {near_tie:.4g})")
              + f"; smallest batch-1 top-2 gap {min(gaps):.4g}")
        if first_diff is not None and (gap is None or gap > near_tie):
            fail(f"{tag} {i}: tokens differ from batch-1 generate at {first_diff}, where the "
                 f"batch-1 top-2 gap {gap} exceeds the near-tie bound {near_tie:.4g}")
    return parity


# the load run: greedy requests of 32 tokens with seeded prompts of 16-300
# tokens (one or two chunks), arriving as a seeded Poisson process
LOAD_N, LOAD_RATE = 80, 5.0       # requests, mean arrivals a second
LOAD_DRAIN_S = 120.0              # a load run fails this long after its last arrival


def serving_load(spec, sched, n_req: int = LOAD_N, rate: float = LOAD_RATE,
                 prompts: list | None = None, seed: int = 29) -> dict:
    """n_req requests through the scheduler at `rate` seeded Poisson
    arrivals a second; `prompts` (default: seeded prompts of 16-300
    tokens). The step loop runs here: a request is submitted at the first
    iteration after its arrival time, and each token is stamped when the
    step that made it returns. Aggregate tok/s: every token over the wall
    time from the first arrival to the last token. TTFT: arrival to first
    token, over every request, and its p50 over the first and the second
    half of the arrivals (a queue that grows shows as a later half slower
    than the earlier). ITL: every gap between two consecutive tokens of a
    request, over every request, and the share of gaps over 4x the median
    (those a prefill chunk stalled)."""
    import queue

    from distributed_llama_tpu_torch.runtime.stats import percentile
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    rng = np.random.default_rng(seed)
    arrive = np.concatenate([[0.0], np.cumsum(rng.exponential(1 / rate, n_req - 1))])
    if prompts is None:
        prompts = [[1] + rng.integers(3, vocab, n - 1).tolist()
                   for n in rng.integers(16, 301, n_req)]
    stamps: list[list[float]] = [[] for _ in range(n_req)]
    reqs: list = []
    live: set = set()
    t0 = time.perf_counter()
    while len(reqs) < n_req or live:
        now = time.perf_counter() - t0
        if now > arrive[-1] + LOAD_DRAIN_S:
            fail(f"load run: {len(live)} requests unfinished {LOAD_DRAIN_S:g} s after the "
                 f"last arrival")
        while len(reqs) < n_req and arrive[len(reqs)] <= now:
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
            if len(reqs) < n_req:
                time.sleep(max(0.0, arrive[len(reqs)] - (time.perf_counter() - t0)))
    wall = max(st[-1] for st in stamps)
    n_tok = sum(len(st) for st in stamps)
    if n_tok != 32 * n_req:
        fail(f"load run: {n_tok} tokens, wanted {32 * n_req}")
    ttft = [(st[0] - a) * 1e3 for st, a in zip(stamps, arrive)]
    itl = [(y - x) * 1e3 for st in stamps for x, y in zip(st, st[1:])]
    out = dict(requests=n_req, rate_per_s=rate, arrival_span_s=float(arrive[-1]),
               wall_s=wall, tokens=n_tok, tok_s=n_tok / wall,
               prompt_tokens=sum(len(p) for p in prompts), n_gaps=len(itl))
    for name, xs in (("ttft", ttft), ("itl", itl)):
        out.update({f"{name}_p{q}_ms": percentile(xs, q) for q in (50, 95, 99)})
        out[f"{name}_max_ms"] = max(xs)
    out["ttft_p50_first_half_ms"] = percentile(ttft[:n_req // 2], 50)
    out["ttft_p50_second_half_ms"] = percentile(ttft[n_req // 2:], 50)
    out["itl_stall_share"] = sum(g > 4 * out["itl_p50_ms"] for g in itl) / len(itl)
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
        conn = http.client.HTTPConnection(*addr, timeout=180)
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
            t.join(timeout=180)
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
        want = [scanned(r.endswith("chat/completions"), bd, list(q.tokens(timeout=180)))
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
        sampled = dev.get("by_entry", {}).get("slot_decode")
        print(f"[serve] HTTP /stats: {dev.get('sampled_steps')} working steps sampled by the "
              f"step sampler (CUDA events around each entry), device ms by entry {dev.get('by_entry')} "
              f"[{card}]")
        if not sampled:
            fail(f"the step sampler recorded no slot_decode device time: {dev}")
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


# -- phase 7b: KV reuse (the prefix cache, sessions, chat) -------------------

# the prefix cache at its serving default: 2 x B x context tokens in blocks
# of 32 (512 blocks of 16 MiB at 7B in bf16, 8 GiB); the shared prefixes are
# 768 tokens: 3 whole chunks, 24 blocks
PREFIX_BL, PREFIX_SHARED = 32, 768
# the load runs, (arrivals a second, requests): below the cold run's knee
# (~1.7 requests a second: four 134 ms chunks a request), and past it
PREFIX_LOAD = ((0.8, 12), (2.0, 16))
# the eviction check's arena: less than two 768-token prefixes' 48 blocks
PREFIX_EVICT_BLOCKS = 40


def event_ms(fn, reps: int = 7) -> dict:
    """CUDA-event ms per eager call of `fn`, `reps` calls one at a time
    (the seed reads its block ids from the host, so it cannot be
    captured)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return _ms_stats(ms)


def _ptrs(*engines) -> list[int]:
    return [t.data_ptr() for e in engines for t in (*e.cache.k, *e.cache.v)]


def prefix_seed_publish(spec, params, eng, eager, pc, card: str) -> dict:
    """(a) Seed and publish at 7B on the card: published blocks (12 in one
    call, 12 one at a time) against the cache slices they came from and a
    seeded row against its blocks, bit for bit; the cache tensors'
    addresses unchanged; the e4m3 guard; the device ms and launches of a
    24-block seed, a one-block publish and a 24-block publish beside their
    bound; the slot decode graph replayed after a seed against the eager
    step."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    b, c, s, vocab = SERVE_B, SERVE_C, spec.seq_len, spec.vocab_size
    bl, nb = PREFIX_BL, PREFIX_SHARED // PREFIX_BL
    out: dict = {}
    ptrs = _ptrs(eng, eager)
    rng = np.random.default_rng(43)
    toks = [1] + rng.integers(3, vocab, PREFIX_SHARED - 1).tolist()
    for lo in range(0, PREFIX_SHARED, c):       # row 0 holds a prefilled prefix
        eng.slot_prefill_chunk(*_chunk({0: (toks[lo:lo + c], lo)}, b, c, s))
    ids = list(range(pc.num_blocks - 1, pc.num_blocks - 1 - nb, -1))   # the free list's order
    eng.slot_publish_block(pc.arena_k, pc.arena_v, 0, 0, ids[:nb // 2])   # as a publish does
    for i in range(nb // 2, nb):                                          # and block by block
        eng.slot_publish_block(pc.arena_k, pc.arena_v, 0, i * bl, [ids[i]])
    torch.cuda.synchronize()
    pub_ok = all(torch.equal(a[dst, l].view(torch.int16), cch[l][0, :, i * bl:(i + 1) * bl]
                             .view(torch.int16))
                 for a, cch in ((pc.arena_k, eng.cache.k), (pc.arena_v, eng.cache.v))
                 for l in range(spec.n_layers) for i, dst in enumerate(ids))
    eng.slot_seed_prefix(pc.arena_k, pc.arena_v, 2, ids)
    torch.cuda.synchronize()
    seed_ok = all(torch.equal(cch[l][2, :, :PREFIX_SHARED].view(torch.int16),
                              cch[l][0, :, :PREFIX_SHARED].view(torch.int16))
                  for cch in (eng.cache.k, eng.cache.v) for l in range(spec.n_layers))
    moved = _ptrs(eng, eager) != ptrs
    print(f"[prefix] {nb} blocks published from row 0 bit-equal to its cache slices: {pub_ok}; "
          f"row 2 seeded from them bit-equal to row 0's first {PREFIX_SHARED} positions: "
          f"{seed_ok}; cache tensors moved: {moved}")
    if not (pub_ok and seed_ok) or moved:
        fail(f"seed/publish: published {pub_ok}, seeded {seed_ok}, moved {moved}")

    # the seed and one publish: device ms, launches, bound
    blk_bytes = 2 * spec.n_layers * spec.n_kv_heads * bl * spec.head_size * 2   # K, V in bf16
    rows = {}
    for name, fn, nbytes in (
            ("seed_24_blocks", lambda: eng.slot_seed_prefix(pc.arena_k, pc.arena_v, 2, ids),
             2 * nb * blk_bytes),
            ("publish_1_block", lambda: eng.slot_publish_block(pc.arena_k, pc.arena_v, 0, 0,
                                                               ids[:1]), 2 * blk_bytes),
            ("publish_24_blocks", lambda: eng.slot_publish_block(pc.arena_k, pc.arena_v, 0, 0,
                                                                 ids), 2 * nb * blk_bytes)):
        ev = event_ms(fn)          # ends synchronized
        prof = profile_decode(None, 0, steps=3, run=lambda: [fn() for _ in range(3)],
                              quiet=True)
        calls = {k: n for k, n in prof["runtime_calls"]
                 if k in ("cudaLaunchKernel", "cudaMemcpyAsync")}
        row = dict(event_ms=ev, device_ms=prof["device_ms_per_step"],
                   launches=sum(calls.values()), calls=calls, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        rows[name] = row
        dev = row["device_ms"]
        print(f"[prefix] {name}: {row['event_ms']['median']:.4f} ms by CUDA events (median "
              f"of {len(row['event_ms']['runs'])}), kernels "
              + ("not measured" if dev is None else f"{dev:.4f} ms")
              + f" (torch.profiler), {row['launches']:.0f} launches {row['calls']}; bound "
              f"{row['bound_ms']:.4f} ms ({nbytes / 2 ** 20:.0f} MiB at 3.35 TB/s) [{card}]")
    out["copies"] = rows
    if _ptrs(eng, eager) != ptrs:
        fail("timing the seed and the publish moved a cache tensor")

    # the e4m3 guard: an arena block holding every byte code, 0x7F and
    # 0xFF included, seeds a row of an f8 engine over the same weights
    f8 = Engine(spec, params, device="cuda", cache_dtype=F8, activation_q80=True)
    ak, av = f8.new_prefix_arena(1, bl)
    codes = torch.arange(256, dtype=torch.uint8, device=ak.device)
    for a in (ak, av):
        a.view(torch.uint8).view(-1).copy_(codes.repeat(a.numel() // 256))
    f8_ptrs = _ptrs(f8)
    f8.slot_seed_prefix(ak, av, 0, [0])
    want = codes.view(F8).float()
    want[0x7F], want[0xFF] = 448.0, -448.0
    got = [cch[l][0, :, :bl].float().reshape(-1) for cch in (f8.cache.k, f8.cache.v)
           for l in range(spec.n_layers)]
    f8_ok = all(torch.equal(g, want.repeat(g.numel() // 256)) for g in got)
    nan = any(bool(torch.isnan(g).any()) for g in got)
    print(f"[prefix] e4m3: a block of every byte code seeds a row with 0x7F -> "
          f"{got[0][0x7F].item()}, 0xFF -> {got[0][0xFF].item()}, every other code as it is: "
          f"{f8_ok}; NaN in the row: {nan}; cache tensors moved: {_ptrs(f8) != f8_ptrs}")
    if not f8_ok or nan or _ptrs(f8) != f8_ptrs:
        fail("the e4m3 seeding guard")
    out["f8_guard"] = dict(ok=f8_ok, nan=nan)
    f8.release()
    del f8, ak, av

    # the captured slot decode graph after a seed: row 1 seeded in both
    # engines from the same blocks, one step at pos 768, rows 0, 2, 3 gated
    for e in (eng, eager):
        e.slot_seed_prefix(pc.arena_k, pc.arena_v, 1, ids)
    tok = np.zeros((b, 1), np.int32)
    tok[1, 0] = int(rng.integers(3, vocab))
    pos = np.full((b,), s, np.int32)
    pos[1] = PREFIX_SHARED
    lg = eng.slot_decode_step(tok, pos)
    le = eager.slot_decode_step(tok, pos)
    torch.cuda.synchronize()
    same = torch.equal(lg[1], le[1])
    print(f"[prefix] slot_decode graph replayed after a seed: row 1's logits bit-equal to the "
          f"eager step's: {same}")
    if not same:
        fail(f"graph after a seed: max abs {(lg[1] - le[1]).abs().max().item():.3g}")
    out["graph_after_seed_equal"] = same
    return out


def _suffixed(rng, vocab: int, heads: list, n: int) -> list:
    """n prompts: a head from `heads`, chosen uniformly, and a unique
    suffix of 16-200 tokens."""
    return [list(heads[int(rng.integers(len(heads)))])
            + rng.integers(3, vocab, int(k)).tolist() for k in rng.integers(16, 201, n)]


def _cache_runs(spec, eng, prompts, caches: dict, first_alone: bool) -> dict:
    """Greedy requests of 32 tokens through a scheduler over `eng` for each
    (name, prefix cache or None) of `caches`, the same prompts each time:
    the first request alone until its first token, then the rest at once
    (`first_alone`), or one request at a time, each to its end. Each run's
    tokens, recording samplers, wall time and launches."""
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler

    vocab, runs = spec.vocab_size, {}
    for name, pc in caches.items():
        sched = Scheduler(eng, chunk=SERVE_C, prefix_cache=pc)
        recs = [_recording_sampler(vocab, 0.0, 0.9, 1) for _ in prompts]
        zero_counts()
        t0 = time.perf_counter()
        reqs = []
        for i, (p, r) in enumerate(zip(prompts, recs)):
            if first_alone and i > 0:
                reqs += [sched.submit(q, 32, rr) for q, rr in zip(prompts[1:], recs[1:])]
                break
            reqs.append(sched.submit(p, 32, r))
            while (reqs[0].stats.t_first is None if first_alone
                   else not reqs[-1].finished.is_set()):
                sched.step()
        while not all(r.finished.is_set() for r in reqs):
            sched.step()
        torch.cuda.synchronize()
        runs[name] = dict(tokens=[list(r.tokens(timeout=5.0)) for r in reqs], recs=recs,
                          wall_s=time.perf_counter() - t0, launches=read_counts())
        if not all(runs[name]["launches"][k] for k in ("K1", "K3", "Q80")):
            fail(f"prefix cache run {name}: launches {runs[name]['launches']}")
    return runs


def _cache_parity(runs: dict, prompts, near_tie: float, what: str) -> list:
    """The cache-on run's tokens against the cache-off run's: equal, or
    first different where the cache-off run's top-2 gap is within phase
    7's near-tie bound 2e (the gap printed wherever tokens differ)."""
    parity = []
    for i, (a, b_) in enumerate(zip(runs["on"]["tokens"], runs["off"]["tokens"])):
        first = next((k for k, (x, y) in enumerate(zip(a, b_)) if x != y),
                     None if len(a) == len(b_) else min(len(a), len(b_)))
        gaps = [_top2_gap(lg) for lg, _ in runs["off"]["recs"][i].seen]
        gap = None if first is None or first >= len(gaps) else gaps[first]
        parity.append(dict(prompt=len(prompts[i]), first_difference=first, gap=gap))
        if first is not None:
            print(f"[prefix] {what} request {i}: first difference at token {first}, cache-off "
                  f"top-2 gap there {gap} (near-tie bound {near_tie:.4g})")
            if gap is None or gap > near_tie:
                fail(f"{what} request {i}: tokens differ at {first} where the gap {gap} "
                     f"exceeds {near_tie:.4g}")
    return parity


def prefix_hit_parity(spec, eng, pc, near_tie: float) -> dict:
    """(b) 8 greedy requests of 32 tokens sharing one 768-token prefix,
    each with its own suffix: the first runs cold and publishes, then the
    other 7 join and must hit. The same requests through the scheduler
    without the cache, over the same engine: the tokens must be equal, or
    first differ at a near-tie (_cache_parity)."""
    vocab = spec.vocab_size
    rng = np.random.default_rng(47)
    head = [1] + rng.integers(3, vocab, PREFIX_SHARED - 1).tolist()
    prompts = _suffixed(rng, vocab, [head], 8)
    runs = _cache_runs(spec, eng, prompts, {"on": pc, "off": None}, first_alone=True)
    st = pc.stats.summary()
    parity = _cache_parity(runs, prompts, near_tie, "hit parity")
    equal = sum(p["first_difference"] is None for p in parity)
    print(f"[prefix] hit parity: 8 requests (768-token shared prefix + 16-200-token suffixes) "
          f"x 32 tokens; cache on: {st['hits']} hits of {st['lookups']} lookups, "
          f"tokens_saved {st['tokens_saved']}, tokens_prefilled {st['tokens_prefilled']}, "
          f"{st['blocks_published']} blocks published, {runs['on']['wall_s']:.3f} s; cache off "
          f"{runs['off']['wall_s']:.3f} s; {equal} of 8 token streams equal; launches on "
          f"{runs['on']['launches']}, off {runs['off']['launches']}")
    if st["hits"] != 7 or st["lookups"] != 8:
        fail(f"hit parity: {st['hits']} hits of {st['lookups']} lookups, wanted 7 of 8")
    return dict(stats=st, parity=parity, equal=equal,
                wall_s={k: v["wall_s"] for k, v in runs.items()},
                launches={k: v["launches"] for k, v in runs.items()})


def prefix_evict(spec, eng, near_tie: float) -> dict:
    """(c) Eviction on the card: an arena of PREFIX_EVICT_BLOCKS blocks,
    less than two prompts' blocks, serves 6 greedy requests of 32 tokens
    one at a time, alternating between 2 seeded 768-token prefixes (each
    with its own 16-200-token suffix). Every publish after the first
    evicts the other prefix's LRU leaves, so later requests hit on what
    is left of their prefix. Tokens against the cache-off run
    (_cache_parity); the pool must account for every block."""
    from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache

    vocab = spec.vocab_size
    rng = np.random.default_rng(67)
    heads = [[1] + rng.integers(3, vocab, PREFIX_SHARED - 1).tolist() for _ in range(2)]
    prompts = [_suffixed(rng, vocab, [heads[i % 2]], 1)[0] for i in range(6)]
    pc = PrefixCache(eng, num_blocks=PREFIX_EVICT_BLOCKS, block_len=PREFIX_BL)
    runs = _cache_runs(spec, eng, prompts, {"on": pc, "off": None}, first_alone=False)
    st = pc.stats.summary()
    parity = _cache_parity(runs, prompts, near_tie, "eviction")
    equal = sum(p["first_difference"] is None for p in parity)
    accounted = st["blocks_in_use"] + len(pc._free) == pc.num_blocks
    print(f"[prefix] eviction: {PREFIX_EVICT_BLOCKS}-block arena, 6 requests one at a time over "
          f"2 alternating {PREFIX_SHARED}-token prefixes: {st['evictions']} evictions, {st['publish_drops']} "
          f"publish drops, {st['hits']} hits of {st['lookups']} ({st['tokens_saved']} tokens "
          f"saved), {st['blocks_in_use']} blocks in use + {len(pc._free)} free = "
          f"{pc.num_blocks}: {accounted}; {equal} of 6 token streams equal to the cache-off run")
    if not st["evictions"] or not st["hits"] or not accounted:
        fail(f"eviction: {st}, pool accounted {accounted}")
    pc.release()
    return dict(stats=st, parity=parity, equal=equal)


def prefix_load(spec, eng, new_pc, card: str) -> dict:
    """(d) The load runs with shared prefixes, cache off then on (a fresh
    tree from `new_pc()`), in one process over the same engine, at each
    (rate, requests) of PREFIX_LOAD: greedy requests of 32 tokens at
    seeded Poisson arrivals, each prompt one of 4 seeded 768-token
    prefixes, chosen uniformly, then a unique suffix of 16-200 tokens. A
    synthetic shape, taken from no trace: a smoke load of the cache. The
    first rate sits below the cold run's knee (its TTFT p50 over the
    second half of the requests is printed beside the first half's), the
    second past it, where only the aggregate rate compares."""
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler

    vocab = spec.vocab_size
    rng = np.random.default_rng(53)
    heads = [[1] + rng.integers(3, vocab, PREFIX_SHARED - 1).tolist() for _ in range(4)]
    out = {}
    for rate, n_req in PREFIX_LOAD:
        prompts = _suffixed(rng, vocab, heads, n_req)
        where = "below" if rate == PREFIX_LOAD[0][0] else "past"
        runs = {}
        for name in ("off", "on"):
            pc = new_pc() if name == "on" else None
            sched = Scheduler(eng, chunk=SERVE_C, prefix_cache=pc)
            ld = serving_load(spec, sched, n_req, rate, prompts, seed=59)
            print(f"[prefix] load {rate:g}/s ({where} the cold knee), cache {name}: "
                  f"{ld['requests']} requests x 32 tokens over {ld['arrival_span_s']:.3f} s: "
                  f"aggregate {ld['tok_s']:.1f} tok/s ({ld['tokens']} tokens in "
                  f"{ld['wall_s']:.3f} s); TTFT p50 {ld['ttft_p50_ms']:.1f} ms, p95 "
                  f"{ld['ttft_p95_ms']:.1f}, p99 {ld['ttft_p99_ms']:.1f} (p50 first half "
                  f"{ld['ttft_p50_first_half_ms']:.1f}, second half "
                  f"{ld['ttft_p50_second_half_ms']:.1f}); ITL p50 {ld['itl_p50_ms']:.3f} ms, "
                  f"p95 {ld['itl_p95_ms']:.3f}, p99 {ld['itl_p99_ms']:.3f} ({ld['n_gaps']} gaps, "
                  f"{ld['itl_stall_share']:.4f} of them over 4x the median) [{card}]")
            if pc is not None:
                st = ld["prefix_cache"] = pc.stats.summary()
                print(f"[prefix] load {rate:g}/s, cache on: hit rate {st['hit_rate']} "
                      f"({st['hits']} of {st['lookups']}), tokens saved {st['tokens_saved']} "
                      f"against {st['tokens_prefilled']} prefilled (saved share "
                      f"{st['prefill_saved_frac']}), {st['blocks_published']} blocks "
                      f"published, {st['evictions']} evictions, {st['publish_drops']} "
                      f"publish drops")
                if not st["hits"]:
                    fail(f"load run at {rate:g}/s with the cache on: no hit")
                pc.release()
                del pc, sched
                torch.cuda.empty_cache()
            runs[name] = ld
        out[f"{rate:g}/s"] = runs
    return out


def phase_prefix(spec, params, eng, eager, near_tie: float, card: str) -> dict:
    """Phase 7b over phase 7's slot engines: (a) seed and publish, (b) hit
    parity, (c) eviction, (d) the load runs with shared prefixes, cache
    off and on."""
    from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache

    t0 = time.perf_counter()
    n_blocks = 2 * SERVE_B * spec.seq_len // PREFIX_BL
    pc = PrefixCache(eng, num_blocks=n_blocks, block_len=PREFIX_BL)
    print(f"[prefix] PrefixCache: {n_blocks} blocks of {PREFIX_BL} tokens (2 x {SERVE_B} x "
          f"{spec.seq_len}), arena {2 * pc.arena_k.numel() * 2 / 2 ** 30:.2f} GiB")
    out = prefix_seed_publish(spec, params, eng, eager, pc, card)
    out["hit_parity"] = prefix_hit_parity(spec, eng, pc, near_tie)
    pc.release()
    del pc
    torch.cuda.empty_cache()
    out["eviction"] = prefix_evict(spec, eng, near_tie)
    out["load"] = prefix_load(
        spec, eng, lambda: PrefixCache(eng, num_blocks=n_blocks, block_len=PREFIX_BL), card)
    out["seconds"] = time.perf_counter() - t0
    print(f"[prefix] phase 7b in {out['seconds']:.1f} s")
    return out


def phase_session(spec, params, one, card: str) -> dict:
    """Sessions at 7B: a batch-1 engine runs a 300-token prompt and 16
    tokens and saves its session; a fresh engine over the same params
    loads it and takes 32 greedy tokens through its graph step, which
    must equal the first engine's uninterrupted 32, bit for bit."""
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    prompt = [1] + np.random.default_rng(61).integers(3, vocab, 299).tolist()
    one.reset()
    part1 = one.generate(prompt, 16, Sampler(vocab, 0.0, 0.9, 1)).tokens
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/s.npz"
        t0 = time.perf_counter()
        one.save_session(path, tokens=prompt + part1)
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        want = one.generate([part1[-1]], 32, Sampler(vocab, 0.0, 0.9, 1)).tokens
        fresh = Engine(spec, params, device="cuda", activation_q80=True)
        ptrs = _ptrs(fresh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = fresh.load_session(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    moved = _ptrs(fresh) != ptrs
    zero_counts()
    got = fresh.generate([part1[-1]], 32, Sampler(vocab, 0.0, 0.9, 1)).tokens
    torch.cuda.synchronize()
    counts = read_counts()
    graph = 1 in fresh.graphs
    fresh.release()
    del fresh
    torch.cuda.empty_cache()
    equal = got == want and hist == prompt + part1
    print(f"[session] 7B: 300-token prompt + 16 tokens saved ({size / 2 ** 20:.1f} MiB, pos "
          f"{len(prompt) + 15}) in {save_s:.3f} s; a fresh engine loaded it in {load_s:.3f} s "
          f"(cache tensors moved: {moved}) and took 32 greedy tokens through its graph step "
          f"(captured: {graph}; launches {counts}): equal to the uninterrupted run's: {equal} "
          f"[{card}]")
    if not equal or moved or not graph or not counts["K1"]:
        fail(f"session continuation: equal {equal}, moved {moved}, graph {graph}, {counts}")
    return dict(bytes=size, save_s=save_s, load_s=load_s, equal=equal, launches=counts)


def phase_chat() -> dict:
    """`python -m ...apps.dllama chat --device cuda` on the tiny Llama and
    Mixtral fixtures, greedy, at the CLI's defaults: two turns on stdin
    with --session, then a third turn resumed from the session in a new
    process, against an uninterrupted three-turn run. The processes of a
    wave run side by side."""
    from distributed_llama_tpu_torch.models.spec import ArchType
    from distributed_llama_tpu_torch.testing import write_fixture

    fixtures = {"llama": dict(seed=77),
                "mixtral": dict(seed=82, arch=ArchType.MIXTRAL, n_experts=4,
                                n_active_experts=2)}
    lines = ["Be brief.", "hello there", "and then?", "why so?"]

    def start(argv, stdin):
        return subprocess.Popen([sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
                                 "chat", *argv], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                cwd=str(Path(__file__).resolve().parent)), stdin

    def finish(procs):
        outs = []
        try:
            for p, stdin in procs:
                o, e = p.communicate(stdin, timeout=180)
                if p.returncode:
                    fail(f"dllama chat exited {p.returncode}: {e[-600:]}")
                outs.append(o)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs

    def turns(out):
        """The assistant's text of each turn."""
        return [t.split("👱 User")[0] for t in out.split("🤖 Assistant")[1:]]

    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        common, sess = {}, {}
        for name, kw in fixtures.items():
            m, t = write_fixture(tempfile.mkdtemp(dir=d), **kw)
            common[name] = ["--model", m, "--tokenizer", t, "--steps", "12", "--seed", "3",
                            "--temperature", "0", "--device", "cuda"]
            sess[name] = ["--session", f"{d}/{name}.npz"]
        first = finish([start(common[n] + sess[n], "\n".join(lines[:3]) + "\n") for n in fixtures]
                       + [start(common[n], "\n".join(lines) + "\n") for n in fixtures])
        resumed = finish([start(common[n] + sess[n], lines[3] + "\n") for n in fixtures])
    for i, name in enumerate(fixtures):
        two, whole, third = first[i], first[i + len(fixtures)], resumed[i]
        ok = ("resumed session" in third and len(turns(whole)) == 3
              and turns(whole)[:2] == turns(two) and turns(third) == turns(whole)[2:])
        out[name] = dict(equal=ok, third=turns(third)[0].strip() if turns(third) else None)
        print(f"[chat] {name}: two turns with --session, then a third resumed in a new process: "
              f"its text equal to the uninterrupted three-turn run's: {ok} "
              f"({len(out[name]['third'] or '')} chars)")
        if not ok:
            fail(f"chat resume ({name}): {whole[-400:]!r} vs {third[-400:]!r}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[chat] in {out['seconds']:.1f} s")
    return out


def k1_wcls(gen, t: int = SERVE_B, tag: str = "[serve] [K1] ") -> dict:
    """K1 on wcls at t tokens, the one projection that phase 2's path rows
    do not time at t > 1 (a batch step's t = B, a verify forward's t = 8):
    kernel, plain, library, bound."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.quants.torch_codec import dequantize_q40_torch

    d, n = K1_SHAPES["wcls"]
    dt = torch.bfloat16
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
    print(tag + json.dumps(row))
    del ws, wd, w0
    return row


def phase_serving(card: str, params) -> dict:
    """Phase 7, serving at Llama-2-7B full width and depth over phase 5's
    weights: the batch-4 slot engine (a), the scheduler (b), the timing of
    the batch step, the KV-reuse phase over the same engines (7b), `dllama
    api` over HTTP (c), then sessions on the batch-1 engine."""
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
    out["prefix"] = phase_prefix(spec, params, eng, eager,
                                 out["scheduler"]["near_tie_bound"], card)
    eng.release()
    eager.release()
    del eng, eager, sched
    out["http"] = serving_http(spec, one, card)
    out["session"] = phase_session(spec, params, one, card)
    del one
    torch.cuda.empty_cache()
    out["k1_wcls_t4"] = k1_wcls(gen)
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


# -- phase 9: speculative decoding (prompt lookup, the real draft, the
# scheduler's verify step) ----------------------------------------------------

SPEC_K = 7          # the CLI's default draft length: a verify forward of 8 tokens
SPEC_DEPTH = 4      # the self-draft's layers, of 32
SPEC_N = 32         # tokens of each exactness run, after the 300-token prompt
# a verify forward at 2 <= T <= 8 tokens: every projection on K1's
# tensor-core path with the standalone Q80 round trip before it, wcls
# included (the logits of every position), one K3 a layer
VERIFY_TALLY = {"K1": 129, "K2": 0, "K3": 32, "Q80": 129, "Q80F": 0}


def _tally(graph) -> dict:
    """A captured graph's launch tally by counter name."""
    from distributed_llama_tpu_torch.runtime.graphs import LAUNCH_COUNTERS

    by_id = {id(c): n for c, n in zip(LAUNCH_COUNTERS, graph.tally)}
    return {name: by_id[id(c)] for name, c in _counters().items()}


def _greedy_verify_loop(engine, prompt: list[int], n: int, draft_fn, stats) -> list[int]:
    """Engine._lookup_loop greedy, with the draft from draft_fn(hist, k,
    token, pos0): the verify loop every speculative mode runs, fed a draft
    of known quality."""
    from distributed_llama_tpu_torch.runtime.speculative import count_accepted

    def verify(seg_logits, draft):
        greedy = np.argmax(seg_logits, axis=-1)
        return [int(g) for g in greedy[:count_accepted(draft, greedy) + 1]]
    return list(engine._lookup_loop(prompt, n, None, draft_len=SPEC_K, max_ngram=0,
                                    history=None, stats=stats,
                                    first_fn=lambda row: int(np.argmax(row)),
                                    verify_fn=verify, draft_fn=draft_fn))


def _held_to_plain(what: str, got: list[int], want: list[int], gaps: list[float],
                   near_tie: float) -> dict:
    """Tokens equal to the plain run's, or first different where the plain
    run's top-2 logit gap is within the near-tie bound (a verify forward
    takes another kernel path, which rounds the logits differently)."""
    first = next((k for k, (x, y) in enumerate(zip(got, want)) if x != y),
                 None if len(got) == len(want) else min(len(got), len(want)))
    gap = None if first is None or first >= len(gaps) else gaps[first]
    if first is not None and (gap is None or gap > near_tie):
        fail(f"{what}: tokens differ from plain generate at {first}, where its top-2 gap "
             f"{gap} exceeds the near-tie bound {near_tie:.4g}")
    return dict(first_difference=first, gap_at_difference=gap)


def _spec_timing(stats, n: int, fwd: int) -> dict:
    """ms a token and tokens a verify over the decode part of a run (the
    prefill's record and its token left out)."""
    body = stats.steps[1:]
    return dict(ms_per_token=sum(s.generation_ms for s in body) / max(n - 1, 1),
                tokens_per_forward=(n - 1) / max(fwd - 1, 1),
                device_ms=sum(s.device_ms for s in body),
                host_ms=sum(s.host_ms for s in body), forwards=fwd, tokens=n)


def spec_verify_widths(one, eager, prompt: list[int], want: list[int], seen: list,
                       card: str) -> dict:
    """Each verify width T = 2..8: its graph ("lookup", T) replayed after
    the prompt, its tally exact; each position's logits against the plain
    graph decode step's at the same position (their largest difference e
    sets the near-tie bound 2e); the forward on the kernels against the
    plain versions on the eager twin; its ms a forward (CUDA events)."""
    pos0 = len(prompt)
    for e in (one, eager):
        e.reset()
        e.prefill(prompt)
    rows, worst = [], 0.0
    for t in range(2, SPEC_K + 2):
        seg = np.asarray([want[:t]], np.int32)
        lg = torch.from_numpy(one._verify_logits(seg, pos0))
        g = one.graphs[("lookup", t)]
        tally = _tally(g)
        if tally != VERIFY_TALLY:
            fail(f"verify graph T={t}: tally {tally}, wanted {VERIFY_TALLY}")
        dec = [_held_logits(f"verify T={t} position {i} vs the decode step", lg[i],
                            torch.from_numpy(seen[i + 1][0])) for i in range(t)]
        worst = max([worst] + [d["max_abs_err"] for d in dec])
        tok = torch.as_tensor(seg.astype(np.int64), device=eager.device)
        lk = eager._forward(tok, pos0, logits_for_all=True)[0]
        with plain_versions():
            lp = eager._forward(tok, pos0, logits_for_all=True)[0]
        held = _held_logits(f"verify T={t} kernels vs plain", lk, lp)
        ms = event_ms(g.replay, reps=15)
        row = dict(t=t, tally=tally, capture_s=g.capture_s, pool_mib=g.pool_bytes / 2 ** 20,
                   vs_decode_max_abs=max(d["max_abs_err"] for d in dec),
                   kernels_vs_plain=held, ms=ms)
        rows.append(row)
        print(f"[spec] verify T={t}: {ms['median']:.3f} ms a forward (graph replay; min "
              f"{ms['min']:.3f}, max {ms['max']:.3f}); tally {tally}; capture "
              f"{g.capture_s:.2f} s, pool {row['pool_mib']:.1f} MiB; logits vs the decode "
              f"step max abs {row['vs_decode_max_abs']:.4g}; kernels vs plain max abs "
              f"{held['max_abs_err']:.4g} (tol {held['tol']:.4g}), rel L2 "
              f"{held['rel_l2']:.3g} [{card}]")
    step = event_ms(one.graphs[1].replay, reps=15)
    print(f"[spec] plain decode step (graph 1, T = 1): {step['median']:.3f} ms [{card}]")
    return dict(rows=rows, decode_step_ms=step, near_tie_bound=2 * worst)


def spec_streams(one, prompt: list[int], want: list[int], gaps: list[float],
                 near_tie: float, card: str) -> dict:
    """The batch-1 speculative streams at Llama-2-7B, greedy, SPEC_N tokens
    after the prompt: prompt lookup, the self-draft at depth 4, a draft
    that always matches (the plain run's own next tokens) and one that
    never does (each shifted by one). Each runs twice (the first captures
    its graphs); the second, with launches zeroed just before and read just
    after, is held to the plain run's tokens and timed."""
    from distributed_llama_tpu_torch.runtime.draft import DraftModel
    from distributed_llama_tpu_torch.runtime.stats import RunStats
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = one.spec.vocab_size
    one.reset()
    res = one.generate(prompt, SPEC_N, Sampler(vocab, 0.0, 0.9, 1))
    plain = _spec_timing(res.stats, SPEC_N, SPEC_N)
    draft = DraftModel.self_draft(one, SPEC_DEPTH)

    def oracle(shift):
        def fn(hist, k, token, pos0):
            e = len(hist) - len(prompt)
            return [(t + shift) % vocab for t in want[e:e + k]]
        return fn

    modes = {
        "lookup": lambda st: list(one.generate_lookup_stream(
            prompt, SPEC_N, draft_len=SPEC_K, stats=st)),
        f"self-draft depth {SPEC_DEPTH}": lambda st: list(one.generate_draft_stream(
            prompt, SPEC_N, draft=draft, draft_len=SPEC_K, stats=st)),
        "always-matching draft": lambda st: _greedy_verify_loop(one, prompt, SPEC_N,
                                                                oracle(0), st),
        "never-matching draft": lambda st: _greedy_verify_loop(one, prompt, SPEC_N,
                                                               oracle(1), st),
    }
    out, total = {}, {k: 0 for k in _counters()}
    for name, run in modes.items():
        one.reset()
        run(RunStats())
        one.reset()
        st = RunStats()
        zero_counts()
        toks = run(st)
        torch.cuda.synchronize()
        counts = read_counts()
        if not all(counts[k] for k in ("K1", "K3", "Q80", "Q80F")):
            fail(f"{name}: a kernel of the path did not launch: {counts}")
        for k in counts:
            total[k] += counts[k]
        fwd, n = one.last_accept_stats
        held = _held_to_plain(name, toks, want[:SPEC_N], gaps, near_tie)
        tm = _spec_timing(st, n, fwd)
        out[name] = dict(**held, **tm, launches=counts, spec=dict(one.last_spec))
        print(f"[spec] {name}: {n} tokens in {fwd} forwards ({tm['tokens_per_forward']:.2f} "
              f"tokens a verify after the prefill); "
              + ("every token equal to plain generate's" if held["first_difference"] is None
                 else f"first difference at {held['first_difference']} (plain top-2 gap "
                      f"{held['gap_at_difference']:.4g}, near-tie bound {near_tie:.4g})")
              + f"; {tm['ms_per_token']:.3f} ms/token (plain generate "
                f"{plain['ms_per_token']:.3f}); device {tm['device_ms']:.1f} ms, host "
                f"{tm['host_ms']:.1f} ms; launches {counts} [{card}]")
    # the draft's proposal alone: SPEC_K captured depth-4 steps, one host read
    one.reset()
    one.prefill(prompt)
    tok, pos = np.asarray([want[0]], np.int32), np.asarray([len(prompt)], np.int32)
    prop = event_ms(lambda: draft.propose(draft.cache, tok, pos, SPEC_K,
                                          n_vocab=vocab), reps=10)
    print(f"[spec] self-draft proposal: {SPEC_K} steps of {SPEC_DEPTH} layers in "
          f"{prop['median']:.3f} ms ({prop['median'] / SPEC_K:.3f} ms a step) [{card}]")
    return dict(plain=plain, modes=out, launches=total, draft=draft, proposal_ms=prop)


def spec_sampled(one, prompt: list[int], want: list[int], draft, card: str) -> dict:
    """One sampled lookup run (history primed with the greedy continuation,
    so drafts are proposed) and one sampled self-draft run: their device
    and host ms. target_dist softmaxes and sorts the whole vocabulary on
    the host for every position it weighs."""
    from distributed_llama_tpu_torch.runtime.stats import RunStats

    out = {}
    runs = {"sampled lookup": lambda st: list(one.generate_lookup_sampled_stream(
                prompt, SPEC_N, temperature=0.8, topp=0.9, seed=5, draft_len=SPEC_K,
                history=prompt + want, stats=st)),
            f"sampled self-draft depth {SPEC_DEPTH}": lambda st: list(
                one.generate_draft_sampled_stream(
                    prompt, 16, draft=draft, temperature=0.8, topp=0.9, seed=5,
                    draft_len=SPEC_K, stats=st))}
    for name, run in runs.items():
        one.reset()
        run(RunStats())
        one.reset()
        st = RunStats()
        toks = run(st)
        fwd, n = one.last_accept_stats
        tm = _spec_timing(st, n, fwd)
        if len(toks) != n or not all(0 <= t < one.spec.vocab_size for t in toks):
            fail(f"{name}: {len(toks)} tokens, {n} counted")
        out[name] = dict(**tm, spec=dict(one.last_spec))
        print(f"[spec] {name}: {n} tokens in {fwd} forwards, {tm['ms_per_token']:.3f} "
              f"ms/token: device (verify + logits copy) {tm['device_ms']:.1f} ms, host "
              f"(drafting, target_dist, accepting) {tm['host_ms']:.1f} ms [{card}]")
    return out


def spec_serving(spec, params, one, near_tie: float, card: str) -> dict:
    """The scheduler with --draft self:4 (draft_len 7) over a B = 4 engine.
    First the verify step's position-0 logits of 4 live rows against the
    batch-1 step's (the near-tie bound). Then warmup captures the draft's proposal and the verify graph ("slot_verify",
    8, vocab); 8 greedy requests of 32 tokens (4 at once, 4 joining) capture
    nothing more, launch K1, K3 and Q80, and give each request the tokens of
    a batch-1 generate (or first differ at a near-tie). Then one
    slot_verify_step and one slot decode step timed at 4 live rows."""
    from distributed_llama_tpu_torch.runtime.draft import DraftModel
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.profiler import COMPILES
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    eng = Engine(spec, params, device="cuda", batch=SERVE_B, activation_q80=True)
    # the verify step's position-0 logits of 4 live rows against the batch-1
    # step at the same position and cache contents: their largest
    # difference e gives the scheduler's near-tie bound 2e (at least the
    # batch-1 streams' and phase 7's)
    rng = np.random.default_rng(17)
    lens = (300, 213, 97, 256)
    rows = [rng.integers(3, vocab, n).tolist() for n in lens]
    for lo in range(0, 300, SERVE_C):
        eng.slot_prefill_chunk(*_chunk({r: (t[lo:lo + SERVE_C], lo) for r, t in
                                        enumerate(rows) if len(t) > lo}, SERVE_B, SERVE_C,
                                       spec.seq_len))
    tok = rng.integers(3, vocab, (SERVE_B, 1 + SPEC_K)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    _, lg0 = eng.slot_verify_step(tok, pos, vocab)
    held = []
    for r in range(SERVE_B):
        _copy_cache(one.cache, eng.cache, slice(0, 1), slice(r, r + 1))
        held.append(_held_logits(f"slot verify row {r} position 0 vs the batch-1 step",
                                 lg0[r], one.step(tok[r:r + 1, :1], int(pos[r]))[0]))
    near_tie = max(near_tie, 2 * max(h["max_abs_err"] for h in held))
    sched = Scheduler(eng, chunk=SERVE_C, draft_len=SPEC_K, draft_vocab=vocab,
                      draft_factory=lambda e: DraftModel.self_draft(e, SPEC_DEPTH))
    t0 = time.perf_counter()
    sched.warmup()
    warm_s = time.perf_counter() - t0
    keys = sorted(map(str, [*eng.graphs, *sched.draft.graphs]))
    after = COMPILES.after_warmup
    prompts = [[1] + rng.integers(3, vocab, n - 1).tolist() for n in rng.integers(40, 301, 8)]
    zero_counts()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[:4]]
    while not all(r.stats.t_first is not None for r in reqs):
        sched.step()
    reqs += [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[4:]]
    while not all(r.finished.is_set() for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    captured = COMPILES.after_warmup - after
    blk = sched.stats.summary()["spec"]
    print(f"[spec] scheduler --draft self:{SPEC_DEPTH}, B = {SERVE_B}: warmup {warm_s:.1f} s "
          f"captured {keys}; 8 requests x 32 tokens in {wall:.3f} s, {captured} captures "
          f"after warmup; spec {blk}; launches {counts} [{card}]")
    if captured or not all(counts[k] for k in ("K1", "K3", "Q80")):
        fail(f"speculative serving: {captured} captures after warmup, launches {counts}")
    parity = []
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        one.reset()
        rec = _recording_sampler(vocab, 0.0, 0.9, 1)
        ref = one.generate(p, 32, rec).tokens
        held = _held_to_plain(f"scheduler request {i}", list(r.tokens(timeout=5.0)), ref,
                              [_top2_gap(lg) for lg, _ in rec.seen], near_tie)
        parity.append(held)
    print(f"[spec] scheduler tokens against batch-1 generate: "
          + ", ".join("equal" if h["first_difference"] is None else
                      f"first difference at {h['first_difference']} (gap "
                      f"{h['gap_at_difference']:.4g})" for h in parity)
          + f" (near-tie bound {near_tie:.4g})")
    # one verify step and one decode step at 4 live rows (fills 300-97)
    eng.slot_verify_step(tok, pos, vocab)
    verify = event_ms(eng.graphs[("slot_verify", 1 + SPEC_K, vocab)].replay, reps=15)
    eng.slot_decode_step(tok[:, :1], pos)
    step = event_ms(eng.graphs["slot_decode"].replay, reps=15)
    call = []
    for _ in range(10):
        c0 = time.perf_counter()
        eng.slot_verify_step(tok, pos, vocab)
        call.append((time.perf_counter() - c0) * 1e3)
    print(f"[spec] slot_verify_step B = {SERVE_B}, K = {SPEC_K}: {verify['median']:.3f} ms a "
          f"replay, {np.median(call):.3f} ms a call with its host copies; slot decode step "
          f"{step['median']:.3f} ms [{card}]")
    sched.close()
    eng.release()
    return dict(warmup_s=warm_s, graphs=keys, wall_s=wall, captures_after_warmup=captured,
                spec=blk, launches=counts, parity=parity, near_tie_bound=near_tie,
                verify_rows_vs_batch1=held, slot_verify_ms=verify,
                slot_verify_call_ms=_ms_stats(call), slot_decode_ms=step)


def spec_file_path() -> dict:
    """`dllama inference --lookup-decode 4` and `--draft self:1` on the tiny
    Llama and Mixtral fixtures on cuda: at the CLI's defaults (bf16, Q80
    activations) with K1, K3, Q80 and Q80F launched (K2 too for Mixtral),
    and in f32 with the tokens of the CLI on the CPU."""
    from distributed_llama_tpu_torch.apps import dllama
    from distributed_llama_tpu_torch.models.spec import ArchType
    from distributed_llama_tpu_torch.testing import write_fixture

    def run(argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dllama.main(argv)
        return buf.getvalue()

    def text(out):
        lines = out.splitlines()
        return lines[next(i for i, l in enumerate(lines) if l.startswith("💡")):][:2]

    out = {}
    fixtures = {"llama": dict(seed=77),
                "mixtral": dict(seed=82, arch=ArchType.MIXTRAL, n_experts=4,
                                n_active_experts=2)}
    for name, kw in fixtures.items():
        with tempfile.TemporaryDirectory() as d:
            mpath, tpath = write_fixture(d, **kw)
            common = ["inference", "--model", mpath, "--tokenizer", tpath, "--prompt",
                      "hello hello world hello", "--steps", "16", "--seed", "3",
                      "--temperature", "0"]
            need = ("K1", "K3", "Q80", "Q80F") + (("K2",) if name == "mixtral" else ())
            for flag in (["--lookup-decode", "4"], ["--draft", "self:1"]):
                zero_counts()
                dflt = run(common + flag + ["--device", "cuda"])
                counts = read_counts()
                f32 = common + flag + ["--compute-dtype", "f32", "--cache-dtype", "f32",
                                       "--buffer-float-type", "f32"]
                gpu, cpu = run(f32 + ["--device", "cuda"]), run(f32 + ["--device", "cpu"])
                ok = ("Generated tokens:    16" in dflt and all(counts[k] for k in need)
                      and text(gpu) == text(cpu))
                line = next(l for l in dflt.splitlines() if l.startswith("Generated tokens"))
                out[f"{name} {' '.join(flag)}"] = dict(ok=ok, launches=counts, line=line)
                print(f"[spec] CLI {name} {' '.join(flag)}: defaults on cuda: {line}, launches "
                      f"{counts}; f32 text cuda == cpu: {text(gpu) == text(cpu)}")
                if not ok:
                    fail(f"CLI {' '.join(flag)} ({name}): {dflt[-300:]!r} {counts}; f32 "
                         f"{text(gpu)} vs {text(cpu)}")
    return out


def phase_spec(card: str, params, near_tie_7: float, gen) -> dict:
    """Phase 9, speculative decoding at Llama-2-7B full width and depth over
    phase 5's weights (bf16 cache, Q80 activations): the verify widths, the
    batch-1 streams, the sampled modes, the scheduler with a self-draft,
    then the CLI on the tiny fixtures; K1 on wcls at t = 8 for the verify
    forward's kernel sums. near_tie_7: phase 7's bound (a batch step's
    logits against the batch-1 step's)."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t_start = time.perf_counter()
    spec = _spec("llama2_7b")
    vocab = spec.vocab_size
    one = Engine(spec, params, device="cuda", activation_q80=True)
    eager = _eager_twin(one)
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, vocab, 299).tolist()
    # the plain graph run, its logits recorded: the tokens every stream is
    # held to and the decode step's logits each verify position is held to
    one.reset()
    rec = _recording_sampler(vocab, 0.0, 0.9, 1)
    want = one.generate(prompt, SPEC_N + SPEC_K, rec).tokens
    gaps = [_top2_gap(lg) for lg, _ in rec.seen]
    out = {"verify": spec_verify_widths(one, eager, prompt, want, rec.seen, card)}
    del eager
    near = max(out["verify"]["near_tie_bound"], near_tie_7)
    out["near_tie_bound"] = near
    streams = spec_streams(one, prompt, want, gaps, near, card)
    draft = streams.pop("draft")
    out["streams"] = streams
    out["sampled"] = spec_sampled(one, prompt, want, draft, card)
    del draft
    one.release()
    del one
    torch.cuda.empty_cache()
    out["serving"] = spec_serving(spec, params, Engine(spec, params, device="cuda",
                                                       activation_q80=True), near, card)
    torch.cuda.empty_cache()
    out["cli"] = spec_file_path()
    out["k1_wcls"] = k1_wcls(gen, 1 + SPEC_K, "[spec] [K1] ")
    out["seconds"] = time.perf_counter() - t_start
    v = {r["t"]: r["ms"]["median"] for r in out["verify"]["rows"]}
    step = out["verify"]["decode_step_ms"]["median"]
    m = out["streams"]["modes"]
    full, none = m["always-matching draft"], m["never-matching draft"]
    # break-even: the verify at T = 8 costs v8 / step plain steps; it pays
    # once a forward emits more tokens than that
    print(f"[spec] verify ms at T = 2..8: " + ", ".join(f"{t}: {x:.3f}" for t, x in v.items())
          + f"; plain decode step {step:.3f} ms; verify at T = 8 = {v[8] / step:.2f} plain "
            f"steps: break-even at {v[8] / step:.2f} tokens a forward [{card}]")
    print(f"[spec] decode ms/token: plain generate {out['streams']['plain']['ms_per_token']:.3f}, "
          f"always-matching draft {full['ms_per_token']:.3f} ({full['tokens_per_forward']:.2f} "
          f"tokens a forward), never-matching {none['ms_per_token']:.3f} "
          f"({none['tokens_per_forward']:.2f}) [{card}]")
    print(f"[spec] phase 9 in {out['seconds']:.1f} s")
    return out


# -- phase 10: the flight recorder, the device profiler and the batch
# generators -------------------------------------------------------------------

# untraced/traced batch-step pairs, in ABBA order; tracing may cost at most
# this share of a batch step (the JAX package's bar, tests/test_trace.py:316)
TRACE_PAIRS, TRACE_BOUND = 100, 0.02
SPAN_ORDER = ("enqueue", "admit", "prefill", "first_token", "finish")
BATCH_N = 32        # tokens a row of each batch generator run


def _in_order(kinds: list, want: tuple) -> bool:
    """Whether `want` is a subsequence of `kinds`."""
    it = iter(kinds)
    return all(k in it for k in want)


def trace_run(spec, one, sched, near_tie: float, card: str) -> dict:
    """(a): phase 7's 8 parity requests with the flight recorder on and
    every working step sampled (--trace, --profile-sample 1): each
    request's span in order under its own trace id; the step timeline's
    compositions; each sampled step's wall ms, device ms by entry (CUDA
    events around each entry point) and host gap (wall - device); no graph
    captured after warmup; tokens held to batch-1 generate's."""
    from distributed_llama_tpu_torch.runtime.profiler import COMPILES, PROFILER
    from distributed_llama_tpu_torch.runtime.trace import TRACER
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab, eng = spec.vocab_size, sched.engine
    rng = np.random.default_rng(13)
    prompts = [[1] + rng.integers(3, vocab, n - 1).tolist()
               for n in rng.integers(40, 301, 8)]
    graphs0, warm0 = set(eng.graphs), COMPILES.summary()["after_warmup"]
    TRACER.configure(capacity=1 << 16)
    PROFILER.reset()
    PROFILER.sample_every = 1
    t0 = time.perf_counter()
    try:
        reqs = [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[:4]]
        while not all(r.stats.t_first is not None for r in reqs):
            sched.step()
        reqs += [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts[4:]]
        while not all(r.finished.is_set() for r in reqs):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [e for e in TRACER.recent(0) if e["kind"] == "step"]
        end = time.perf_counter() + 60
        while (PROFILER.sampled + PROFILER.sample_failures < len(steps)
               and time.perf_counter() < end):
            time.sleep(0.01)
    finally:
        PROFILER.sample_every = 0
    if PROFILER.sample_failures or PROFILER.sampled != len(steps):
        fail(f"trace run: {PROFILER.sampled} steps attributed, {PROFILER.sample_failures} "
             f"failures, of {len(steps)} working steps")
    got = [list(r.tokens(timeout=5.0)) for r in reqs]
    tids = [r.trace_id for r in reqs]
    if len(set(tids)) != len(reqs) or min(tids) < 1:
        fail(f"trace ids {tids}: one id > 0 a request wanted")
    spans = []
    for i, r in enumerate(reqs):
        span = TRACER.by_id(r.trace_id)
        kinds = [e["kind"] for e in span]
        if any(e["tid"] != r.trace_id for e in span) or not _in_order(kinds, SPAN_ORDER):
            fail(f"request {i}: span {kinds} under trace id {r.trace_id}")
        spans.append(kinds)
    print(f"[trace] 8 requests x 32 tokens in {wall:.3f} s with --trace and --profile-sample "
          f"1: every span in order under its own trace id, e.g. request 0: "
          f"{' > '.join(spans[0])}")
    timeline = TRACER.step_timeline()
    for comp, row in timeline.items():
        print(f"[trace] step timeline: {comp[0]} decode rows, {comp[1]} prefill rows, chunk "
              f"{comp[2]}: {row['n']} steps, wall p50 {row['p50_ms']:.3f} ms, p99 "
              f"{row['p99_ms']:.3f}, mean {row['mean_ms']:.3f} [{card}]")
    by_n = {r["step"]: r for r in PROFILER.recent_steps}
    rows = []
    for ev, n in zip(steps, sorted(by_n)):
        r = by_n[n]
        rows.append(dict(dec=ev["dec"], pre=ev["pre"], wall_ms=r["wall_ms"],
                         device_ms=r["device_ms"], span_ms=r["span_ms"],
                         host_gap_ms=r["wall_ms"] - r["device_ms"],
                         by_entry={k: round(v, 4) for k, v in r["by_entry"].items()}))
    for k, r in enumerate(rows[:8]):
        print(f"[trace] sampled step {k} ({r['dec']} decode, {r['pre']} prefill rows): wall "
              f"{r['wall_ms']:.3f} ms, device {r['device_ms']:.3f} ms {r['by_entry']}, host gap "
              f"{r['host_gap_ms']:.3f} ms [{card}]")
    groups: dict = {}
    for r in rows:
        groups.setdefault((r["dec"], r["pre"]), []).append(r)
    summary = {}
    for (dec, pre), rs in sorted(groups.items()):
        med = {f: float(np.median([r[f] for r in rs]))
               for f in ("wall_ms", "device_ms", "host_gap_ms", "span_ms")}
        entries = {k: float(np.median([r["by_entry"].get(k, 0.0) for r in rs]))
                   for k in sorted({k for r in rs for k in r["by_entry"]})}
        summary[f"dec{dec}_pre{pre}"] = dict(n=len(rs), by_entry=entries, **med)
        print(f"[trace] sampled steps, {dec} decode + {pre} prefill rows ({len(rs)}): median "
              f"wall {med['wall_ms']:.3f} ms, device {med['device_ms']:.3f} ms "
              f"({', '.join(f'{k} {v:.3f}' for k, v in entries.items())}), host gap "
              f"{med['host_gap_ms']:.3f} ms = {med['host_gap_ms'] / med['wall_ms']:.3f} of the "
              f"wall; device span first to last event {med['span_ms']:.3f} ms [{card}]")
    captured = sorted(map(str, set(eng.graphs) - graphs0))
    after = COMPILES.summary()["after_warmup"] - warm0
    print(f"[trace] graphs captured after warmup with tracing and sampling on: {after} "
          f"({captured or 'none'})")
    if after or captured:
        fail(f"tracing captured graphs after warmup: {captured}")
    parity = batch1_parity(one, prompts, got, near_tie, "[trace] request")
    return dict(wall_s=wall, spans=spans, timeline={f"dec{k[0]}_pre{k[1]}_c{k[2]}": v
                                                    for k, v in timeline.items()},
                sampled=rows, by_composition=summary, parity=parity)


def trace_overhead(spec, sched, card: str) -> dict:
    """(a): ms a scheduler step with 4 live decode rows, the flight
    recorder off and on in turns (ABBA, TRACE_PAIRS pairs): the medians and
    their spread; tracing must cost at most TRACE_BOUND of the step."""
    from distributed_llama_tpu_torch.runtime.trace import TRACER
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    rng = np.random.default_rng(19)
    reqs = [sched.submit([1] + rng.integers(3, vocab, 99).tolist(), 2 * TRACE_PAIRS + 24,
                         Sampler(vocab, 0.0, 0.9, 1)) for _ in range(SERVE_B)]
    while not all(r.stats.t_first is not None for r in reqs):
        sched.step()
    for _ in range(4):
        sched.step()
    ms: dict = {False: [], True: []}
    try:
        for i in range(TRACE_PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                TRACER.enabled = on
                t0 = time.perf_counter()
                sched.step()
                ms[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        TRACER.enabled = True
        for r in reqs:
            r.cancel()
        while sched.step():
            pass
    off, on = _ms_stats(ms[False]), _ms_stats(ms[True])
    share = on["median"] / off["median"] - 1
    p = {k: [float(np.percentile(ms[k], q)) for q in (10, 90)] for k in ms}
    print(f"[trace] scheduler step, 4 live decode rows, {TRACE_PAIRS} pairs in turns: tracing off "
          f"{off['median']:.4f} ms median (p10 {p[False][0]:.4f}, p90 {p[False][1]:.4f}), on "
          f"{on['median']:.4f} ms (p10 {p[True][0]:.4f}, p90 {p[True][1]:.4f}): "
          f"{share * 100:+.2f}% (bound {TRACE_BOUND * 100:.0f}%) [{card}]")
    if share > TRACE_BOUND:
        fail(f"tracing costs {share * 100:.2f}% of a batch step, over {TRACE_BOUND * 100:.0f}%")
    return dict(off=off, on=on, share=share, pairs=TRACE_PAIRS, p10_p90=p)


def _timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def _host_batch_sampled(eng, prompts: list, n: int, temperature: float, topp: float,
                        seed: int) -> tuple:
    """generate_batch_device's host twin: the same prefill and the same
    (B, 1) forward (the slot decode graph), each row sampled on the host
    by its own recording Sampler seeded seed + i."""
    b, s = eng.batch, eng.seq_len
    recs = [_recording_sampler(eng.spec.vocab_size, temperature, topp, seed + i)
            for i in range(b)]
    lg = eng.fetch_logits(eng._batch_prefill(prompts))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    out = [[] for _ in range(b)]
    for _ in range(n):
        live = pos < s
        if not live.any():
            break
        tok = np.zeros((b, 1), np.int32)
        for i in np.nonzero(live)[0]:
            tok[i, 0] = recs[i].sample(lg[i])
            out[i].append(int(tok[i, 0]))
        lg = eng.fetch_logits(eng.slot_decode_step(tok, np.where(live, pos, s)))
        pos = pos + 1
    return out, recs


def batch_generators(spec, one, eng, near_tie: float, card: str) -> dict:
    """(d): the batch generators on the B = 4 engine over 4 prompts of
    300/213/97/256 tokens, BATCH_N tokens a row: generate_batch greedy
    against batch-1 generate; generate_batch_device at 0.8 / top-p 0.9
    against its host twin (each row's own seed, the same forward): equal,
    or a CDF neighbour within the f32 bound; generate_batch_lookup against
    generate_batch; generate_batch at 0.8 / top-p 0.9 too, for the host
    loop's cost at the device loop's sampler. Each run twice (the first
    captures), timed: wall ms, the prefill's share, ms a decode forward
    and decode tok/s."""
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab, n = spec.vocab_size, BATCH_N
    rng = np.random.default_rng(23)
    prompts = [[1] + rng.integers(3, vocab, m - 1).tolist() for m in (300, 213, 97, 256)]
    graphs0 = set(eng.graphs)
    pre_ms = min(_timed_ms(lambda: eng._batch_prefill(prompts))[1] for _ in range(2))
    runs = {
        "generate_batch": lambda: eng.generate_batch(prompts, n, Sampler(vocab, 0.0, 0.9, 1)),
        # the host loop at the device loop's sampler settings, for its cost
        "generate_batch T=0.8": lambda: eng.generate_batch(prompts, n,
                                                         Sampler(vocab, 0.8, 0.9, 11)),
        "generate_batch_device": lambda: eng.generate_batch_device(
            prompts, n, temperature=0.8, topp=0.9, seed=11),
        "generate_batch_lookup": lambda: eng.generate_batch_lookup(prompts, n, draft_len=SPEC_K),
    }
    out: dict = {"prefill_ms": pre_ms}
    toks: dict = {}
    for name, fn in runs.items():
        first, _ = _timed_ms(fn)
        got, ms = _timed_ms(fn)
        if got != first:
            fail(f"{name}: a second run gave other tokens")
        toks[name] = got
        forwards = (eng.last_accept_stats[0] if name == "generate_batch_lookup"
                    else eng.last_device_steps if name == "generate_batch_device" else n)
        n_tok = sum(len(r) for r in got)
        dec_ms = ms - pre_ms
        out[name] = dict(wall_ms=ms, tokens=n_tok, forwards=forwards,
                         decode_ms_per_forward=dec_ms / max(forwards - 1, 1),
                         decode_tok_s=(n_tok - len(got)) / dec_ms * 1e3)
        r = out[name]
        print(f"[batch] {name}: {n_tok} tokens over 4 rows in {ms:.3f} ms (prefill "
              f"{pre_ms:.3f}), {forwards} forwards: {r['decode_ms_per_forward']:.3f} ms a decode "
              f"forward, {r['decode_tok_s']:.1f} decode tok/s [{card}]")
    out["generate_batch"]["parity"] = batch1_parity(
        one, prompts, toks["generate_batch"], near_tie, "[batch] generate_batch row", n)
    host, recs = _host_batch_sampled(eng, prompts, n, 0.8, 0.9, 11)
    diffs = []
    for i, (d, h) in enumerate(zip(toks["generate_batch_device"], host)):
        k = next((j for j, (x, y) in enumerate(zip(d, h)) if x != y),
                 None if len(d) == len(h) else min(len(d), len(h)))
        if k is None:
            continue
        lg, state = recs[i].seen[k] if k < len(recs[i].seen) else (None, None)
        m = (cdf_margin(lg, state, 0.8, 0.9, h[k], d[k])
             if lg is not None and k < len(d) else None)
        diffs.append(dict(row=i, first_difference=k, cdf=m))
        if m is None or not m["adjacent"] or m["margin"] > m["f32_bound"]:
            fail(f"generate_batch_device row {i} differs from its host twin at {k}: {m}")
    print(f"[batch] generate_batch_device T=0.8 top-p 0.9, row i seeded 11 + i: "
          + ("every row equal to the host twin's tokens" if not diffs else
             f"rows differ from the host twin only at CDF neighbours within the f32 bound: "
             f"{diffs}"))
    out["generate_batch_device"]["host_differences"] = diffs
    same = toks["generate_batch_lookup"] == toks["generate_batch"]
    out["generate_batch_lookup"]["equal_to_generate_batch"] = same
    if not same:
        out["generate_batch_lookup"]["parity"] = batch1_parity(
            one, prompts, toks["generate_batch_lookup"], near_tie,
            "[batch] generate_batch_lookup row", n)
    minted = sorted(map(str, set(eng.graphs) - graphs0))
    print(f"[batch] generate_batch_lookup equal to generate_batch on every greedy row: {same}; "
          f"{eng.last_accept_stats[1] / max(eng.last_accept_stats[0], 1):.2f} tokens a forward; "
          f"graphs minted by the batch generators: {minted}")
    out["graphs_minted"] = minted
    return out


def _kernel_counts(path: str) -> dict:
    """Kernel events of a torch.profiler Chrome trace: K1 (q40_*), K3
    (flash_*) and all, each with how many ran inside a CUDA graph replay
    (correlated with a cudaGraphLaunch)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    graph = {e.get("args", {}).get("correlation") for e in events
             if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch"}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {}
    for tag, pick in (("K1", lambda k: "q40_" in k), ("K3", lambda k: "flash_" in k),
                      ("all", lambda k: True)):
        ks = [e for e in kernels if pick(e.get("name", ""))]
        out[tag] = dict(n=len(ks), in_graph=sum(e.get("args", {}).get("correlation") in graph
                                                for e in ks))
    return out


def trace_http(spec, one, card: str) -> dict:
    """(b) and (d): `dllama api --serve-batch 4` in-process: POST
    /admin/profile?ms=200 while 3 streams decode and a 4th is admitted,
    its trace file's K1 and K3 kernels (inside graph replays too); then
    POST /v1/batch/completions with 4 prompts, whose texts must equal
    generate_batch's on the same engine."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from distributed_llama_tpu_torch.apps import api_server
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    tokenizer = _tokenizer(vocab)
    rng = np.random.default_rng(31)

    def words(k):
        return " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5)) for _ in range(k))

    def post(addr, route, body):
        conn = http.client.HTTPConnection(*addr, timeout=180)
        conn.request("POST", route, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()

    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        state = api_server.ApiState(one, tokenizer, Sampler(vocab, 0.0, 0.9, 3),
                                    model_name="llama2-7b-synthetic", serve_batch=SERVE_B,
                                    serve_chunk=SERVE_C, profile_dir=d)
        server = ThreadingHTTPServer(("127.0.0.1", 0), api_server.make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        addr = server.server_address[:2]
        try:
            res: dict = {}

            def call(key, route, body):
                res[key] = post(addr, route, body)
            bodies = [{"prompt": words(40), "max_tokens": 96, "temperature": 0, "stream": True}
                      for _ in range(SERVE_B)]
            threads = [threading.Thread(target=call, args=(i, "/v1/completions", bodies[i]))
                       for i in range(SERVE_B)]
            for t in threads[:3]:
                t.start()
            time.sleep(0.5)          # the 3 streams past their prefill
            prof = threading.Thread(target=call, args=("profile", "/admin/profile?ms=200", {}))
            prof.start()
            time.sleep(0.05)         # the 4th's prefill chunk inside the window
            threads[3].start()
            for t in (*threads, prof):
                t.join(timeout=180)
            status, raw = res["profile"]
            if status != 200 or any(res[i][0] != 200 for i in range(SERVE_B)):
                fail(f"/admin/profile {status} {raw[:200]}; streams "
                     f"{[res[i][0] for i in range(SERVE_B)]}")
            reply = json.loads(raw)
            if not Path(reply["trace"]).is_file():
                fail(f"/admin/profile wrote no trace: {reply}")
            counts = _kernel_counts(reply["trace"])
            out["profile"] = dict(reply=reply, kernels=counts,
                                  bytes=Path(reply["trace"]).stat().st_size)
            print(f"[trace] POST /admin/profile?ms=200 while 4 streams run: "
                  f"{out['profile']['bytes']} bytes of trace; kernels {counts['all']['n']} "
                  f"({counts['all']['in_graph']} inside graph replays), K1 {counts['K1']['n']} "
                  f"({counts['K1']['in_graph']} in replays), K3 {counts['K3']['n']} "
                  f"({counts['K3']['in_graph']} in replays) [{card}]")
            if not counts["all"]["n"]:
                fail("the /admin/profile trace holds no kernel")
            if not (counts["K1"]["in_graph"] and counts["K3"]["in_graph"]):
                print("[trace] the /admin/profile trace names no K1 or no K3 kernel inside the "
                      "graph replays: the CUDA-event attribution carries those numbers")

            # the batch endpoint against generate_batch on the same engine
            texts = [words(int(k)) for k in rng.integers(10, 60, SERVE_B)]
            (status, raw), ms = _timed_ms(lambda: post(addr, "/v1/batch/completions", {
                "prompts": texts, "max_tokens": BATCH_N, "temperature": 0}))
            if status != 200:
                fail(f"/v1/batch/completions: {status} {raw[:200]}")
            reply = json.loads(raw)
            got = [c["message"]["content"] for c in reply["choices"]]
            rows = [tokenizer.encode(t) for t in texts]
            with state._scheduler.exclusive() as eng:
                eng.reset()
                outs = eng.generate_batch(rows, BATCH_N, Sampler(vocab, 0.0, 0.9, 1))
                eng.reset()
            want = []
            for r, toks in zip(rows, outs):
                scan = api_server._piece_scanner(tokenizer, r[-1], (), [])
                text = ""
                for t in toks:
                    piece = scan(t)
                    if piece is None:
                        break
                    text += piece
                want.append(text)
            n_tok = reply["usage"]["completion_tokens"]
            print(f"[batch] POST /v1/batch/completions, 4 prompts x {BATCH_N} tokens: "
                  f"{ms:.3f} ms, {n_tok / ms * 1e3:.1f} tok/s; texts equal to generate_batch's: "
                  f"{got == want}; finish reasons "
                  f"{[c['finish_reason'] for c in reply['choices']]} [{card}]")
            if got != want:
                fail(f"batch endpoint texts {got} differ from generate_batch's {want}")
            out["batch_endpoint"] = dict(ms=ms, tokens=n_tok, equal=True)
        finally:
            server.shutdown()
            server.server_close()
            api_server.finish(state, drain_timeout=30.0)
            if state._scheduler is not None:
                state._scheduler.engine.release()
    return out


def trace_cli(card: str) -> dict:
    """(c) and (e): the port's CLI on the card on the tiny Llama Q40
    fixture, three processes side by side: `generate --profile DIR` (its
    trace must hold K1 kernels), the KV-header file, and the same file
    with the reference's legacy header and --weights-float-type q40, whose
    tokens must equal the KV-header file's."""
    from distributed_llama_tpu_torch.testing import write_fixture, write_legacy_copy

    with tempfile.TemporaryDirectory() as d:
        m, t = write_fixture(d, seed=5)
        legacy = write_legacy_copy(m, f"{d}/legacy.m")
        common = ["generate", "--tokenizer", t, "--prompt", "Hello", "--steps", "12",
                  "--temperature", "0", "--seed", "3", "--device", "cuda"]
        runs = {"profile": ["--model", m, "--profile", f"{d}/prof"], "kv": ["--model", m],
                "legacy": ["--model", legacy, "--weights-float-type", "q40"]}
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama", *common, *a],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(Path(__file__).resolve().parent)) for k, a in runs.items()}
        outs = {}
        try:
            for k, p in procs.items():
                o, e = p.communicate(timeout=180)
                if p.returncode:
                    fail(f"dllama generate ({k}) exited {p.returncode}: {e[-600:]}")
                outs[k] = o
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()

        def text(o):
            lines = o.splitlines()
            return lines[next(i for i, ln in enumerate(lines) if ln.startswith("💡")):]
        trace = Path(f"{d}/prof/trace.json")
        if not trace.is_file():
            fail("dllama generate --profile wrote no trace")
        counts = _kernel_counts(str(trace))
        equal = text(outs["legacy"]) == text(outs["kv"])
    print(f"[trace] dllama generate --profile DIR on the tiny fixture: trace with "
          f"{counts['all']['n']} kernels, K1 {counts['K1']['n']} ({counts['K1']['in_graph']} "
          f"inside graph replays), K3 {counts['K3']['n']} [{card}]")
    print(f"[F3] the legacy-header Q40 fixture with --weights-float-type q40: tokens equal to "
          f"the KV-header file's: {equal}")
    if not counts["K1"]["n"]:
        fail(f"the --profile trace holds no K1 kernel: {counts}")
    if not equal:
        fail(f"F3: legacy-header tokens {text(outs['legacy'])} differ from {text(outs['kv'])}")
    return dict(profile_kernels=counts, legacy_equal=equal)


def phase_trace_batch(card: str, params, near_tie: float) -> dict:
    """Phase 10 (`[trace]`, `[batch]`, `[F3]` lines) over phase 7's 7B
    engines (B = 4, C = 256, bf16 cache, Q80 on): the traced run, the
    tracer's cost, the batch generators, /admin/profile and the batch
    endpoint, then the CLI's --profile and the legacy header on the tiny
    fixture. near_tie: phase 9's bound (batch and verify logits against
    the batch-1 step's)."""
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.profiler import PROFILER
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
    from distributed_llama_tpu_torch.runtime.trace import TRACER

    t_start = time.perf_counter()
    spec = _spec("llama2_7b")
    one = Engine(spec, params, device="cuda", activation_q80=True)
    eng = Engine(spec, params, device="cuda", batch=SERVE_B, activation_q80=True)
    sched = Scheduler(eng, chunk=SERVE_C)
    sched.warmup()
    out: dict = {}
    try:
        out["trace"] = trace_run(spec, one, sched, near_tie, card)
        out["overhead"] = trace_overhead(spec, sched, card)
    finally:
        TRACER.reset()
        PROFILER.reset()
    out["batch"] = batch_generators(spec, one, eng, near_tie, card)
    eng.release()
    del eng, sched
    torch.cuda.empty_cache()
    out["http"] = trace_http(spec, one, card)
    one.release()
    del one
    torch.cuda.empty_cache()
    out["cli"] = trace_cli(card)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[trace] phase 10 in {out['seconds']:.1f} s")
    return out


# -- phase 11: the SLO admission ladder, auto-sizing from the card's own
# calibration, --freeze-compiles, and the native tokenizer and sampler ------

ADM_N, ADM_RATE = 50, 5.0     # phase 7's load, 50 requests at 5 a second
ADM_SLO_ITL_MS = 50.0         # the adaptive run's ITL SLO
SPEC_SLO_ITL_MS = 8.0         # below a 7B verify forward (8.1-9.7 ms)
AUTOSIZE_SLO_ITL_MS = 50.0    # the third decision's SLO: a 10 ms step budget
AUTOSIZE_N = 8                # greedy requests on the auto-sized engine


def admission_autotune(card: str) -> dict:
    """[autotune]: the calibration tool at its defaults on Llama-2-7B
    (batches 2-128, chunk 32, 32 steps, seq 256, synthetic Q40 weights of
    its own); the artifact goes to OUT_DIR/AUTOTUNE.cuda.json."""
    from distributed_llama_tpu_torch.runtime.profiler import load_autotune
    from distributed_llama_tpu_torch.tools import autotune

    t0 = time.perf_counter()
    art = autotune.calibrate(model="7b", device="cuda",
                             log=lambda *a, **k: print("[autotune]", *a))
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "AUTOTUNE.cuda.json"
    path.write_text(json.dumps(art, indent=1) + "\n")
    load_autotune(str(path))   # the server's loader accepts it
    for p in art["knee"]["curve"]:
        print(f"[autotune] decode curve: {p['rows']} rows, step p50 {p['p50_ms']:.4f} ms, "
              f"{p['rows_per_s']:.1f} rows/s [{card}]")
    k, rec = art["knee"], art["recommendation"]
    print(f"[autotune] knee {k['knee_rows']} rows ({k['method']})"
          + (f": {k['note']}" if k.get("note") else ""))
    print("[autotune] ladder (B = 128, chunk 32), CUDA events, best of 5: "
          + ", ".join(f"width {w} {ms:.4f} ms" for w, ms in art["prefill_ms_by_width"].items())
          + f" [{card}]")
    print(f"[autotune] recommendation: --serve-batch {rec['serve_batch']} ({rec['basis']}); "
          f"HBM cap {rec['hbm_cap_rows']}; artifact {path.name}, device {art['device']}; "
          f"in {time.perf_counter() - t0:.1f} s")
    return {"artifact": art, "path": str(path), "seconds": time.perf_counter() - t0}


def _decision_line(tag: str, dec: dict, card: str) -> int:
    """Print one decision record and the bytes it would allocate; returns
    those bytes."""
    from distributed_llama_tpu_torch.runtime.profiler import decision_bytes

    inp = dec["inputs"]
    need = decision_bytes(dec)
    print(f"[autosize] {tag}: --serve-batch {dec['serve_batch']} ({dec['serve_batch_basis']}), "
          f"--prefix-blocks {dec['prefix_blocks']} ({dec['prefix_blocks_basis']}); knee "
          f"{inp['knee_rows']} [{inp['knee_basis']}], rows under the ITL SLO "
          f"{inp['rows_under_itl_slo']}; per slot {inp['per_slot_bytes'] / 2 ** 30:.3f} GiB, per "
          f"block {inp['per_block_bytes'] / 2 ** 20:.1f} MiB; headroom "
          f"{inp['headroom_bytes'] / 2 ** 30:.2f} GiB, slots addable {inp['slots_addable']}, "
          f"blocks addable {inp['prefix_blocks_addable']}; the decision's KV slots + arena "
          f"{need / 2 ** 30:.2f} GiB of the {inp['headroom_bytes'] / 2 ** 30:.2f} GiB headroom "
          f"[{card}]")
    return need


def admission_autosize(spec, params, one, art: dict, near_tie: float, card: str) -> dict:
    """[autosize]: three decisions against the 7B template engine (no
    artifact, the card's artifact, the artifact with an ITL SLO), each
    with --prefix-blocks auto; then the no-artifact decision without an
    arena built through the API server's state (warmed, --freeze-compiles
    on), serving AUTOSIZE_N greedy requests against batch-1 generate with
    no capture after warmup."""
    from distributed_llama_tpu_torch.apps.api_server import ApiState
    from distributed_llama_tpu_torch.runtime.profiler import (COMPILES, hbm_ledger,
                                                              resolve_auto_shape)
    from distributed_llama_tpu_torch.sampler import Sampler

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"ledger": hbm_ledger(one)}
    for tag, kw in (("no artifact", {}), ("card's artifact", dict(autotune=art)),
                    (f"card's artifact, ITL SLO {AUTOSIZE_SLO_ITL_MS:g} ms",
                     dict(autotune=art, slo_itl_ms=AUTOSIZE_SLO_ITL_MS))):
        dec = resolve_auto_shape(one, serve_batch="auto", prefix_blocks="auto", **kw)
        need = _decision_line(tag, dec, card)
        out[tag] = dict(decision=dec, bytes=need,
                        fits=need <= dec["inputs"]["headroom_bytes"])
    dec = resolve_auto_shape(one, serve_batch="auto")
    b = dec["serve_batch"]
    _decision_line("built (no artifact, no arena)", dec, card)
    if b * dec["inputs"]["per_slot_bytes"] > dec["inputs"]["headroom_bytes"]:
        fail(f"autosize: the built decision's {b} slots do not fit the headroom")
    vocab = spec.vocab_size
    before = COMPILES.summary()["after_warmup"]
    COMPILES.freeze = True
    try:
        state = ApiState(one, _tokenizer(vocab), Sampler(vocab, 0.0, 0.9, 3),
                         serve_batch=b, serve_chunk=SERVE_C, autosize=dec)
        sup = state._scheduler
        rng = np.random.default_rng(17)
        prompts = [[1] + rng.integers(3, vocab, n - 1).tolist()
                   for n in rng.integers(16, 301, AUTOSIZE_N)]
        t1 = time.perf_counter()
        reqs = [sup.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts]
        got = [list(r.tokens(timeout=120)) for r in reqs]
        wall = time.perf_counter() - t1
        summ = sup.summary()
        sup.close()
    finally:
        COMPILES.freeze = False
    captures = COMPILES.summary()["after_warmup"] - before
    print(f"[autosize] built B = {b}: {AUTOSIZE_N} greedy requests x 32 tokens in {wall:.3f} s; "
          f"captures after warmup under --freeze-compiles: {captures}; engine KV "
          f"{summ['hbm']['kv_slot_bytes'] / 2 ** 30:.2f} GiB, headroom after "
          f"{summ['hbm']['headroom_bytes'] / 2 ** 30:.2f} GiB [{card}]")
    if captures:
        fail(f"autosize: {captures} captures after warmup")
    out["built"] = dict(serve_batch=b, decision=dec, wall_s=wall, captures_after_warmup=captures,
                        parity=batch1_parity(one, prompts, got, near_tie, "[autosize] request"))
    del state, sup
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _rung_counts() -> dict:
    """Steps with prefill rows, by chunk width, from the step timeline."""
    from distributed_llama_tpu_torch.runtime.trace import TRACER

    counts: dict = {}
    for (dec, pre, chunk), row in TRACER.step_timeline().items():
        if pre:
            counts[chunk] = counts.get(chunk, 0) + row["n"]
    return dict(sorted(counts.items(), reverse=True))


def admission_load(spec, params, card: str) -> dict:
    """[admission]: B = 4, C = 256, phase 7's seeded Poisson load of ADM_N
    requests, static then with ITL SLO ADM_SLO_ITL_MS on one engine, both
    under --freeze-compiles, kernels counted from 0 around each run; the
    ladder's (4, w) chunks timed with CUDA events and named by route."""
    from distributed_llama_tpu_torch.ops.cuda_q40 import MAX_T
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.profiler import COMPILES
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
    from distributed_llama_tpu_torch.runtime.trace import TRACER
    from distributed_llama_tpu_torch.tools.autotune import prefill_ladder_ms

    eng = Engine(spec, params, device="cuda", batch=SERVE_B, activation_q80=True)
    out: dict = {}
    for label, slo in (("static", None), ("adaptive", ADM_SLO_ITL_MS)):
        sched = Scheduler(eng, chunk=SERVE_C, slo_itl_ms=slo)
        sched.warmup()
        before = COMPILES.summary()["after_warmup"]
        COMPILES.freeze = True
        TRACER.configure(capacity=1 << 16, decode_every=1 << 30)
        zero_counts()
        try:
            ld = serving_load(spec, sched, n_req=ADM_N, rate=ADM_RATE)
        finally:
            counts = read_counts()
            rungs = _rung_counts()
            TRACER.reset()
            COMPILES.freeze = False
            sched.close()
        adm = sched.stats.summary().get("admission") or {}
        ld.update(rungs=rungs, launches=counts, admission=adm,
                  captures_after_warmup=COMPILES.summary()["after_warmup"] - before)
        out[label] = ld
        print(f"[admission] {label}{'' if slo is None else f' (ITL SLO {slo:g} ms)'}: "
              f"{ld['requests']} requests x 32 tokens at {ld['rate_per_s']:g}/s, B = {SERVE_B}, "
              f"C = {SERVE_C}: {ld['tok_s']:.1f} tok/s; TTFT p50 {ld['ttft_p50_ms']:.1f} ms, "
              f"p95 {ld['ttft_p95_ms']:.1f}; ITL p50 {ld['itl_p50_ms']:.3f} ms, p95 "
              f"{ld['itl_p95_ms']:.3f}, p99 {ld['itl_p99_ms']:.3f}; shrinks "
              f"{adm.get('shrinks', 0)}, widens {adm.get('widens', 0)}; prefill steps by width "
              f"{rungs}; launches {counts}; captures after warmup {ld['captures_after_warmup']} "
              f"[{card}]")
        if ld["captures_after_warmup"]:
            fail(f"admission ({label}): captures after warmup")
        for k in ("K1", "K3", "Q80"):
            if not counts[k]:
                fail(f"admission ({label}): {k} never launched in the load run")
    ladder = prefill_ladder_ms(eng, SERVE_C)
    out["ladder_ms"] = ladder
    print("[admission] (4, w) prefill chunks, CUDA events, best of 5: " + ", ".join(
        f"w {w}: {ms:.4f} ms ({'dequantize + torch.matmul' if SERVE_B * int(w) > MAX_T else 'K1'}"
        f", t = {SERVE_B * int(w)})" for w, ms in ladder.items()) + f" [{card}]")
    eng.release()
    del eng
    torch.cuda.empty_cache()
    return out


def admission_spec(spec, params, one, near_tie: float, card: str) -> dict:
    """[admission] spec: --draft self:4 (draft length 7) over a B = 4 engine
    with an ITL SLO below a verify forward: the actuator turns drafting off
    (spec_disables >= 1) and counts degraded steps; greedy tokens against
    batch-1 generate."""
    from distributed_llama_tpu_torch.runtime.draft import build_draft
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
    from distributed_llama_tpu_torch.sampler import Sampler

    vocab = spec.vocab_size
    eng = Engine(spec, params, device="cuda", batch=SERVE_B, activation_q80=True)
    sched = Scheduler(eng, chunk=SERVE_C, slo_itl_ms=SPEC_SLO_ITL_MS,
                      draft_factory=lambda e: build_draft(e, "self:4"), draft_len=SPEC_K,
                      draft_vocab=vocab)
    sched.warmup()
    rng = np.random.default_rng(23)
    prompts = [[1] + rng.integers(3, vocab, n - 1).tolist() for n in rng.integers(16, 301, 4)]
    reqs = [sched.submit(p, 32, Sampler(vocab, 0.0, 0.9, 1)) for p in prompts]
    for _ in range(2000):
        if all(r.finished.is_set() for r in reqs):
            break
        sched.step()
    got = [list(r.tokens(timeout=60)) for r in reqs]
    summ = sched.stats.summary()
    sched.close()
    eng.release()
    del eng, sched
    torch.cuda.empty_cache()
    sp, adm = summ["spec"], summ["admission"]
    print(f"[admission] spec: --draft self:4, draft length {SPEC_K}, ITL SLO "
          f"{SPEC_SLO_ITL_MS:g} ms: spec_disables {adm['spec_disables']}, spec_enables "
          f"{adm['spec_enables']}, degraded_steps {sp['degraded_steps']}, verify forwards "
          f"{sp['verify_forwards']}, ITL EWMA {adm['itl_ewma_ms']} ms [{card}]")
    if adm["spec_disables"] < 1 or sp["degraded_steps"] < 1:
        fail(f"admission spec: the actuator did not fire: {adm} {sp}")
    return dict(spec=sp, admission=adm,
                parity=batch1_parity(one, prompts, got, near_tie, "[admission] spec request"))


def admission_native() -> dict:
    """[native]: `dllama generate` on the tiny fixture with the Python
    tokenizer and sampler (no library built), then `make -C native` and
    the same run with the native ones (backend "auto" loads the library);
    in-process, the native tokenizer and sampler against the Python ones
    on the fixture's tokenizer."""
    from distributed_llama_tpu_torch import native
    from distributed_llama_tpu_torch.io.tokenizer_file import read_tokenizer_file
    from distributed_llama_tpu_torch.sampler import Sampler
    from distributed_llama_tpu_torch.testing import write_fixture
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    root = Path(__file__).resolve().parent

    def make(*target):
        res = subprocess.run(["make", "-C", str(root / "native"), *target],
                             capture_output=True, text=True, timeout=180)
        if res.returncode:
            fail(f"make -C native {' '.join(target)}: {res.stderr[-600:]}")

    def generate(m, t):
        res = subprocess.run(
            [sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama", "generate",
             "--model", m, "--tokenizer", t, "--prompt", "Hello world", "--steps", "16",
             "--temperature", "0.8", "--seed", "5", "--device", "cuda"],
            capture_output=True, text=True, timeout=180, cwd=str(root))
        if res.returncode:
            fail(f"dllama generate exited {res.returncode}: {res.stderr[-600:]}")
        lines = res.stdout.splitlines()
        return lines[next(i for i, ln in enumerate(lines) if ln.startswith("💡")):]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        m, t = write_fixture(d, seed=5)
        make("clean")
        native._lib = None
        if native.available():
            fail("a native library loads after `make -C native clean`")
        python_run = generate(m, t)
        make()
        if not native.available():
            fail("the port's loader does not load native/libdllama_native.so")
        native_run = generate(m, t)
        data = read_tokenizer_file(t)
        nat, py = Tokenizer(data, backend="native"), Tokenizer(data, backend="python")
        texts = ["Hello world", "héllo \N{SNOWMAN} ab", "", "a" * 64, "\x00\x7f tail"]
        tok_equal = all(nat.encode(s) == py.encode(s) for s in texts)
        ids = py.encode("Hello world and more")
        dec_equal = all(nat.decode_piece(p, x) == py.decode_piece(p, x)
                        for p, x in zip([py.bos_id] + ids, ids))
    rng = np.random.default_rng(3)
    smp_equal = True
    for temp, topp in ((0.0, 0.9), (0.8, 0.0), (0.7, 0.9), (1.3, 0.5)):
        a = Sampler(512, temp, topp, 123, backend="native")
        b = Sampler(512, temp, topp, 123, backend="python")
        for _ in range(50):
            x = rng.standard_normal(512).astype(np.float32) * 3
            smp_equal &= a.sample(x.copy()) == b.sample(x.copy()) and a.rng_state == b.rng_state
    gen_equal = python_run == native_run
    secs = time.perf_counter() - t0
    print(f"[native] make -C native; native tokenizer == Python: encode {tok_equal}, decode "
          f"{dec_equal}; native sampler == Python (indices and xorshift state, 200 draws): "
          f"{smp_equal}; dllama generate (T 0.8) on the tiny fixture, Python then native "
          f"backends: tokens equal {gen_equal}; in {secs:.1f} s")
    if not (tok_equal and dec_equal and smp_equal and gen_equal):
        fail(f"native parity: {python_run} vs {native_run}")
    return dict(tokenizer=tok_equal and dec_equal, sampler=smp_equal, generate=gen_equal,
                seconds=secs)


def phase_admission(card: str, params, near_tie: float) -> dict:
    """Phase 11 (`[autotune]`, `[autosize]`, `[admission]`, `[native]`)."""
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t_start = time.perf_counter()
    spec = _spec("llama2_7b")
    out = {"autotune": admission_autotune(card)}
    torch.cuda.empty_cache()
    one = Engine(spec, params, device="cuda", activation_q80=True)
    out["autosize"] = admission_autosize(spec, params, one, out["autotune"]["artifact"],
                                         near_tie, card)
    out["load"] = admission_load(spec, params, card)
    out["spec"] = admission_spec(spec, params, one, near_tie, card)
    one.release()
    del one
    torch.cuda.empty_cache()
    out["native"] = admission_native()
    out["seconds"] = time.perf_counter() - t_start
    print(f"[admission] phase 11 in {out['seconds']:.1f} s")
    return out


# -- phase 12: tensor parallelism over ranks (--tp), on the one card ----------

# the ranks of phase 12: gloo processes sharing the card (one GPU: NCCL needs
# a card a rank), each bounded: a collective a rank never joins fails after
TP_TIMEOUT_S = 180.0
# greedy tokens after the main paths' 300-token prompt (two chunks, 256 and
# 44), and decode steps timed a tp
TP_DECODE, TP_TIMED = 8, 8
# the shard shapes of Llama-2-7B a rank holds: row shards (wqkv, w13, wcls)
# cut the output rows, column shards (wo, w2) the input columns
TP_COL = ("wo", "w2")
# the data axis on the card: rows of 7B generate_batch over dp = 2 ranks
# (prompt lengths: one or two prefill chunks), tokens a row
DP_PROMPTS, DP_DECODE = (300, 213, 97, 256), 16


def _shard_shape(name: str, tp: int) -> tuple[int, int]:
    d, n = K1_SHAPES[name]
    return (d, n // tp) if name in TP_COL else (d // tp, n)


def _greedy_trace(engine, prompt: list[int], n: int):
    """Greedy tokens after the prompt (n of them), each step's top-2 logit
    gap and each step's logits (f32, host; the prompt's first)."""
    engine.reset()
    lg = engine.fetch_logits(engine.prefill(prompt))[0]
    lgs, toks, gaps = [lg], [], []
    for i in range(n):
        toks.append(int(np.argmax(lg)))
        gaps.append(_top2_gap(lg))
        if i + 1 < n:
            lg = engine.fetch_logits(engine.step(np.asarray([[toks[-1]]], np.int32),
                                                 engine.pos))[0]
            lgs.append(lg)
    return toks, gaps, lgs


# a rank's Llama-2-7B shard from phase 12's job, kept for phase 13's (the
# same pool of 2 ranks), keyed (name, layers, tp, seed)
_RANK_SHARDS: dict = {}


def tp_rank_job(name: str, n_layers: int, tp: int, seed: int, prompt: list[int],
                routes: list | None) -> dict:
    """One rank of a tp group on the card (RankPool job): the synthetic Q40
    weights of `name` from `seed` built on the card, the rank's shard kept
    (Engine(mesh=) cuts it), Q80 activations and collectives and a bf16
    cache as the CLI builds a Q40 engine. Its greedy trace after the
    prompt (MoE routing replayed from `routes`) with launches counted from
    0, then one 256-token chunk and TP_TIMED decode steps timed with the
    host seconds of the collectives and of the host staging."""
    import dataclasses

    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.parallel.mesh import describe, make_mesh
    from distributed_llama_tpu_torch.runtime.engine import Engine

    mesh = make_mesh(tp=tp, device_type="cuda")
    torch.cuda.reset_peak_memory_stats(mesh.device)
    spec = dataclasses.replace(_spec(name), n_layers=n_layers)
    t0 = time.perf_counter()
    params = synthetic_q40_params(spec, seed=seed, device=mesh.device)
    eng = Engine(spec, params, mesh=mesh, activation_q80=True)
    del params
    if name == "llama2_7b":
        _RANK_SHARDS[(name, n_layers, tp, seed)] = eng.params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rec = ([torch.from_numpy(r).to(mesh.device) for r in routes] if routes else None)
    with replayed_routes(rec) if rec else contextlib.nullcontext():
        zero_counts()
        mesh.reset_stats()
        toks, gaps, lgs = _greedy_trace(eng, prompt, TP_DECODE)
        torch.cuda.synchronize()
        counts, run_stats = read_counts(), dict(mesh.stats)
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step(np.asarray([prompt[:256]], np.int32), 0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    mesh.reset_stats()
    t0 = time.perf_counter()
    for i in range(TP_TIMED):
        eng.step(np.asarray([[toks[i % len(toks)]]], np.int32), eng.pos)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / TP_TIMED
    st = dict(mesh.stats)
    return dict(rank=mesh.rank, backend=mesh.backend, describe=describe(mesh),
                graphs=eng.cuda_graphs, tokens=toks, gaps=gaps,
                logits=lgs if mesh.rank == 0 else None, counts=counts,
                run_stats=run_stats, build_s=build_s, prefill_ms=prefill_ms,
                decode_ms=decode_ms,
                collective_ms=st["collective_s"] * 1e3 / TP_TIMED,
                staging_ms=st["staging_s"] * 1e3 / TP_TIMED,
                collectives_per_step=st["collectives"] / TP_TIMED,
                staged_bytes_per_step=st["staged_bytes"] / TP_TIMED,
                memory_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9)


def _held_steps(label: str, got: list, want: list) -> list[dict]:
    """Each step's logits against one GPU's at the same history, held to
    the script's LOGITS_TOL (of max |one-GPU logit|) and LOGITS_REL_L2_TOL."""
    rows = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.isfinite(g).all():
            fail(f"{label}: step {i} logits not finite")
        diff, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        rel_l2 = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if diff > LOGITS_TOL * scale or rel_l2 > LOGITS_REL_L2_TOL:
            fail(f"{label}: step {i} logits max abs diff {diff:.4g} (tol "
                 f"{LOGITS_TOL * scale:.4g}), rel L2 {rel_l2:.3g} (tol {LOGITS_REL_L2_TOL})")
        rows.append(dict(step=i, max_abs_diff=diff, tol=LOGITS_TOL * scale, rel_l2=rel_l2))
    return rows


def _held_tp(label: str, res: list, toks1: list, gaps1: list, lgs1: list,
             counts1: dict, card: str, want_counts: dict | None = None,
             tag: str = "[tp]", prefill: str = "one 256-token chunk") -> dict:
    """Every rank's tokens equal; rank 0's against one device's: each
    step's logits, up to and including the first token difference (the
    same history on both sides), within LOGITS_TOL and LOGITS_REL_L2_TOL;
    tokens the same up to the first step whose one-GPU top-2 gap is
    within the near-tie bound those tolerances allow (2 x LOGITS_TOL x
    max |logit|); launches equal to one device's, K1 and K3 launched, or
    with `want_counts` every rank's K1, K2 and K3 equal to those (a
    rank's share of the work; K1 launched)."""
    r0 = res[0]
    for r in res[1:]:
        if r["tokens"] != r0["tokens"]:
            fail(f"{tag} {label}: rank {r['rank']} tokens {r['tokens']} differ from rank 0's")
    mismatch = next((i for i, (a, b) in enumerate(zip(r0["tokens"], toks1)) if a != b), None)
    upto = len(toks1) if mismatch is None else mismatch + 1
    steps = _held_steps(f"{tag} {label}", r0["logits"][:upto], lgs1[:upto])
    near_tie = 2 * LOGITS_TOL * float(np.abs(lgs1[0]).max())
    tie = next((i for i, g in enumerate(gaps1) if g <= near_tie), None)
    worst = max(steps, key=lambda r: r["rel_l2"])
    print(f"{tag} {label}: {r0['describe']}; logits vs one GPU at {len(steps)} steps: prompt "
          f"max abs diff {steps[0]['max_abs_diff']:.4g} (tol {steps[0]['tol']:.4g}), rel L2 "
          f"{steps[0]['rel_l2']:.3g} (tol {LOGITS_REL_L2_TOL}); worst step {worst['step']} "
          f"max abs diff {worst['max_abs_diff']:.4g}, rel L2 {worst['rel_l2']:.3g}; near-tie "
          f"bound {near_tie:.4g}; first one-GPU gap within it at step {tie}; first token "
          f"difference at step {mismatch} [{card}]")
    if mismatch is not None and (tie is None or mismatch < tie):
        fail(f"{tag} {label}: token {mismatch} differs from one GPU's "
             f"({r0['tokens']} vs {toks1}) before any near tie")
    if want_counts is None:
        if r0["counts"] != counts1 or not (r0["counts"]["K1"] and r0["counts"]["K3"]):
            fail(f"{tag} {label}: launches {r0['counts']} != one GPU's {counts1}")
        what = "one GPU's: equal"
    else:
        for r in res:
            got = {k: r["counts"][k] for k in want_counts}
            if got != want_counts or not got["K1"]:
                fail(f"{tag} {label}: rank {r['rank']} launches {got} != its share "
                     f"{want_counts}")
        what = f"every rank's K1/K2/K3 its share {want_counts}; one GPU's {counts1}"
    share = lambda x: x / r0["decode_ms"]   # noqa: E731
    print(f"{tag} {label}: launches {r0['counts']} ({what}); decode "
          f"{r0['decode_ms']:.3f} ms/token eager (graphs {r0['graphs']}): collectives "
          f"{r0['collective_ms']:.3f} ms ({share(r0['collective_ms']):.3f}), host staging "
          f"{r0['staging_ms']:.3f} ms ({share(r0['staging_ms']):.3f}), "
          f"{r0['collectives_per_step']:.0f} collectives and "
          f"{r0['staged_bytes_per_step'] / 1e6:.3f} MB staged a step; {prefill} "
          f"{r0['prefill_ms']:.2f} ms; build {r0['build_s']:.1f} s, peak "
          f"{max(r['memory_gb'] for r in res):.2f} GB a rank [{card}]")
    out = {k: v for k, v in r0.items() if k != "logits"}
    out.update(logits_max_abs_diff=steps[0]["max_abs_diff"],
               logits_rel_l2=steps[0]["rel_l2"], steps_held=steps, near_tie_bound=near_tie,
               first_near_tie=tie, first_mismatch=mismatch, one_gpu_tokens=toks1)
    return out


def _batch_draws(engine, prompts: list, temperature: float, seed: int) -> dict:
    """engine.generate_batch over `prompts` (DP_DECODE tokens a row) with a
    recording Sampler: the rows, the logits and RNG state of each draw the
    shared sampler makes (in the JAX order: step by step, rows in order),
    and the host seconds. A greedy engine over ranks draws nothing on the
    host (only the tokens meet), so its rows' logits are recorded where
    its argmax reads them: each rank's own rows, in `local`."""
    rec = _recording_sampler(engine.spec.vocab_size, temperature, 0.9, seed)
    local = []
    greedy_rows = engine._greedy_rows

    def recording_greedy_rows(lg, n_vocab):
        local.append(lg.float().cpu().numpy())
        return greedy_rows(lg, n_vocab)

    engine._greedy_rows = recording_greedy_rows
    try:
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = engine.generate_batch(prompts, DP_DECODE, rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine._greedy_rows
    return dict(rows=rows, draws=rec.seen, local=local, wall_s=wall)


def dp_rank_job(prompts: list, temps: list) -> dict:
    """One rank of a dp = 2 mesh on the card (RankPool job): the 7B
    synthetic Q40 weights from seed 0 built on the card, Q80 activations
    and a bf16 cache, batch = len(prompts) rows, this rank holding half of
    them; generate_batch at each temperature, launches counted from 0."""
    import gc

    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.parallel.mesh import describe, make_mesh
    from distributed_llama_tpu_torch.runtime.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(dp=2, device_type="cuda")
    spec = _spec("llama2_7b")
    params = synthetic_q40_params(spec, seed=0, device=mesh.device)
    eng = Engine(spec, params, mesh=mesh, activation_q80=True, batch=len(prompts),
                 max_seq_len=512)
    del params
    out = dict(rank=mesh.rank, describe=describe(mesh), row0=eng._row0, runs={})
    zero_counts()
    mesh.reset_stats()
    for t in temps:
        out["runs"][t] = _batch_draws(eng, prompts, t, seed=11)
    torch.cuda.synchronize()
    out.update(counts=read_counts(), stats=dict(mesh.stats))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flip_explained(want: np.ndarray, got: np.ndarray, state: int, temperature: float,
                    topp: float, tok_want: int, tok_got: int) -> dict:
    """A sampled token that differs at equal RNG state: where the coin fell
    in the one-GPU CDF (cdf_margin) beside how far the two logit vectors'
    probabilities lie apart (L1 at the temperature). Explained when the
    margin is within 2 x L1: the coin's point and every CDF boundary move
    by at most L1 between the two distributions."""
    def probs(lg):
        x = lg.astype(np.float64) / temperature
        x = np.exp(x - x.max())
        return x / x.sum()

    l1 = float(np.abs(probs(want) - probs(got)).sum())
    m = cdf_margin(want, state, temperature, topp, tok_want, tok_got)
    return dict(margin=m["margin"], l1=l1, nucleus=m["nucleus"],
                explained=m["margin"] <= 2 * l1)


def _held_dp(res: list, one: dict, card: str) -> dict:
    """The dp = 2 rows against one GPU's generate_batch over the same
    weights. Every rank holds every row's tokens, the same. Each draw's
    logits, while its row's history is one GPU's (up to and including the
    row's first token difference), within LOGITS_TOL and LOGITS_REL_L2_TOL
    of one GPU's: sampled rows take them from the shared sampler's
    record, whose RNG state at every draw must equal one GPU's (one
    sampler, rows in order); greedy rows from each rank's own rows. A
    greedy row's tokens equal one GPU's up to its first top-2 gap within
    the near-tie bound (2 x LOGITS_TOL x max |logit|); a sampled row's
    first difference must lie at a draw whose logits are held and be
    explained by them (_flip_explained)."""
    out = {}
    for t, want in one.items():
        runs = [r["runs"][t] for r in res]
        for r, run in zip(res[1:], runs[1:]):
            if run["rows"] != runs[0]["rows"]:
                fail(f"[dp] T={t}: rank {r['rank']} rows differ from rank 0's")
        got, n_rows = runs[0], len(want["rows"])
        first = [next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
                 for g, w in zip(got["rows"], want["rows"])]
        if t == 0.0:
            # each rank's local (rows, V) logits a step, rows side by side
            lg_got = [np.concatenate(x) for x in zip(*(r["runs"][t]["local"] for r in res))]
            draws = [(s, i, lg_got[s][i]) for s in range(len(lg_got)) for i in range(n_rows)]
        else:
            draws = [(k // n_rows, k % n_rows, lg) for k, (lg, _) in enumerate(got["draws"])]
            states = [st for _, st in got["draws"]]
            if states != [st for _, st in want["draws"]]:
                fail(f"[dp] T={t}: the shared sampler's RNG states differ from one GPU's")
        if len(draws) != len(want["draws"]):
            fail(f"[dp] T={t}: {len(draws)} draws, one GPU made {len(want['draws'])}")
        held = []
        for (s, i, g), (w, _) in zip(draws, want["draws"]):
            if first[i] is None or s <= first[i]:
                held += _held_steps(f"[dp] T={t} row {i} step {s}", [g], [w])
        worst = max(held, key=lambda r: r["rel_l2"])
        near_tie = 2 * LOGITS_TOL * max(float(np.abs(w).max()) for w, _ in want["draws"])
        gaps = [[_top2_gap(w) for k, (w, _) in enumerate(want["draws"]) if k % n_rows == i]
                for i in range(n_rows)]
        print(f"[dp] T={t}: Llama-2-7B generate_batch over {res[0]['describe']}, "
              f"{n_rows} rows x {DP_DECODE} tokens, rows equal on every rank; {len(held)} "
              f"draws held to one GPU's (worst rel L2 {worst['rel_l2']:.3g}, max abs diff "
              f"{worst['max_abs_diff']:.4g}){'; RNG states equal' if t else ''}; first token "
              f"difference a row {first} (near-tie bound {near_tie:.4g}); {got['wall_s']:.2f} s "
              f"(one GPU {want['wall_s']:.2f} s) [{card}]")
        flips = {}
        for i, k in enumerate(first):
            if k is None:
                continue
            if t == 0.0:
                tie = next((j for j, g in enumerate(gaps[i]) if g <= near_tie), None)
                if tie is None or k < tie:
                    fail(f"[dp] row {i}: greedy token {k} differs from one GPU's before "
                         "any near tie")
                continue
            (w, state), g = want["draws"][k * n_rows + i], got["draws"][k * n_rows + i][0]
            flips[i] = _flip_explained(w, g, state, t, 0.9, want["rows"][i][k],
                                       got["rows"][i][k])
            print(f"[dp] T={t} row {i}: first token difference at draw {k}: the coin "
                  f"{flips[i]['margin']:.3g} from a one-GPU CDF boundary, the two "
                  f"distributions {flips[i]['l1']:.3g} apart (L1), nucleus "
                  f"{flips[i]['nucleus']} tokens")
            if not flips[i]["explained"]:
                fail(f"[dp] T={t} row {i}: token {k} differs from one GPU's with the coin "
                     f"{flips[i]['margin']:.3g} from any CDF boundary, beyond 2 x L1 "
                     f"{flips[i]['l1']:.3g}")
        out[f"T{t}"] = dict(rows=got["rows"], one_gpu_rows=want["rows"], first_difference=first,
                            draws_held=len(held), worst=worst, near_tie_bound=near_tie,
                            flips=flips,
                            wall_s=got["wall_s"], one_gpu_wall_s=want["wall_s"])
    counts = res[0]["counts"]
    print(f"[dp] rank 0 launches {counts}; {res[0]['stats']['collectives']} collectives, "
          f"{res[0]['stats']['staged_bytes'] / 1e6:.3f} MB staged [{card}]")
    if not (counts["K1"] and counts["K3"]):
        fail(f"[dp] rank 0 launched {counts}")
    out["counts"] = counts
    return out


def nccl_world1_job(prompt: list[int]) -> dict:
    """A 1-rank NCCL group (RankPool job): the 7B engine with the shard path
    forced at tp = 1 (force_mesh_kernels: marked weights, the column
    splits' exact all-reduce over the group of one) beside the plain
    engine over the same weights; its decode step captured as a CUDA graph
    with the all-reduce inside; greedy tokens of both, and each one's
    decode ms/token through its graph, in turns."""
    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.parallel.mesh import make_mesh
    from distributed_llama_tpu_torch.runtime.engine import Engine

    mesh = make_mesh(tp=1, device_type="cuda")
    spec = _spec("llama2_7b")
    params = synthetic_q40_params(spec, seed=0, device=mesh.device)
    plain = Engine(spec, params, device=mesh.device, activation_q80=True)
    forced = Engine(spec, params, mesh=mesh, force_mesh_kernels=True,
                    activation_q80=True)
    want, _, (first_want, *_) = _greedy_trace(plain, prompt, TP_DECODE)
    mesh.reset_stats()
    got, _, (first_got, *_) = _greedy_trace(forced, prompt, TP_DECODE)
    at_capture = dict(mesh.stats)
    ms = {"plain": [], "forced": []}
    for _ in range(3):
        for key, eng in (("plain", plain), ("forced", forced)):
            eng.reset()
            eng.prefill(prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(32):
                eng.step(np.asarray([[want[i % len(want)]]], np.int32), eng.pos)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3 / 32)
    g = forced.graphs.get(1)
    return dict(backend=mesh.backend, tokens=got, plain_tokens=want,
                logits_max_abs_diff=float(np.abs(first_got - first_want).max()),
                captured=g is not None, graph_tally=list(g.tally) if g else None,
                collectives_at_capture=at_capture["collectives"],
                marked=type(forced.params["layers"][0]["wo"]).__name__,
                ms_per_token=ms)


def tp_kernels(gen) -> dict:
    """K1, K2, K3 and the Q80 round trip at the shard shapes of the tp
    paths, each against its plain version and timed beside its plain
    version, its library call and its bound (phases 2-4's rows): K1 at
    the 7B tp = 2 and tp = 4 row and column shards, t = 1 with the Q80
    round trip fused (a decode step) and t = 256 (a chunk; wcls at t = 1
    only); K2 at the Mixtral tp = 2 expert shards (t = 1, fused Q80); K3
    over 16/16, 8/8 (7B tp 2, 4) and 16/4 (Mixtral tp 2) local heads,
    decode at fill 512 and a 256-token chunk; the standalone Q80 round
    trip at the column shards' chunk inputs."""
    bf16 = torch.bfloat16
    k1, k2, k3, q80 = [], [], [], []
    for tp in (2, 4):
        for name in K1_SHAPES:
            d, n = _shard_shape(name, tp)
            wbytes = d * n // 2 + d * n // 32 * 2
            ws = rotating(lambda: random_q40(gen, d, n), wbytes)
            w0 = ws()
            for t, fq in ((1, True), (256, False)) if name != "wcls" else ((1, True),):
                row = k1_row(gen, f"[tp] [K1] tp={tp} ", name, d, n, t, bf16, ws, w0,
                             q80=fq)
                row["tp"] = tp
                k1.append(row)
            del ws, w0
            torch.cuda.empty_cache()
        for name in TP_COL:
            n = _shard_shape(name, tp)[1]
            row = q80_row(gen, f"[tp] [Q80] tp={tp} {name} input ", 256, n, bf16, bf16)
            row.update(tp=tp, shape=name)
            q80.append(row)
    for name, (d, n) in (("mixtral_gate_up_tp2", (14336 // 2, 4096)),
                         ("mixtral_down_tp2", (4096, 14336 // 2))):
        w = random_q40(gen, N_EXPERTS, d, n)
        k2.append(k2_row(gen, "[tp] [K2] ", name, w, 1, bf16, q80=True))
        del w
        torch.cuda.empty_cache()
    for h, kvh, what in ((16, 16, "llama2_7b_tp2"), (8, 8, "llama2_7b_tp4"),
                         (16, 4, "mixtral_tp2")):
        for t, p0 in ((1, 511), (256, 1792)):
            row = k3_row(gen, f"[tp] [K3] {what} ", bf16, bf16,
                         (1, h, kvh, t, [p0], 128, 2048))
            row["what"] = what
            k3.append(row)
    torch.cuda.empty_cache()
    return dict(k1=k1, k2=k2, k3=k3, q80=q80)


def tp_cli(card: str) -> dict:
    """`dllama generate --tp 2` and `inference --dp 2` on the tiny Llama
    fixture, this process as rank 0 and one spawned rank on the same card
    (gloo): f32 text at --tp 2 equal to one GPU's (the CPU's --tp 2 text
    is held to the JAX CLI's by tests/test_torch_tp.py), rank 0's K1 and
    K3 launched, the backend printed; --dp 2 at the CLI's defaults counts
    both rows."""
    from distributed_llama_tpu_torch.apps import dllama
    from distributed_llama_tpu_torch.testing import write_fixture

    def run(argv) -> list[str]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dllama.main(argv)
        return buf.getvalue().splitlines()

    def text(lines):
        return lines[next(i for i, l in enumerate(lines) if l.startswith("💡")):]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = write_fixture(d, seed=77)
        f32 = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt",
               "hello world", "--steps", "16", "--seed", "3", "--temperature", "0",
               "--compute-dtype", "f32", "--cache-dtype", "f32",
               "--buffer-float-type", "f32"]
        one = run(f32 + ["--device", "cuda"])
        zero_counts()
        gpu = run(f32 + ["--device", "cuda", "--tp", "2"])
        counts = read_counts()
        rows = run(["inference", "--model", mpath, "--tokenizer", tpath, "--prompt",
                    "hello world", "--steps", "8", "--seed", "3", "--device", "cuda",
                    "--dp", "2"])
    backend = next((l for l in gpu if "mesh dp=" in l), "")
    ok = (text(gpu) == text(one) and "gloo" in backend
          and counts["K1"] > 0 and counts["K3"] > 0)
    both = any("(2 sequences)" in l for l in rows)
    print(f"[tp] CLI: generate --tp 2 on cuda: {backend.strip()}; f32 text equal to one "
          f"GPU's: {text(gpu) == text(one)}; rank 0 "
          f"launches {counts}; inference --dp 2 at the defaults counts both rows: {both}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not (ok and both):
        fail(f"[tp] CLI over ranks: --tp 2 {text(gpu)} vs one GPU {text(one)}, launches "
             f"{counts}, --dp 2 {rows[-3:]}")
    return dict(counts=counts, backend=backend, text=text(gpu), dp_rows=rows[-3:])


def phase_tp(card: str, params_7b, pool) -> dict:
    """Phase 12 (`[tp]` and `[dp]` lines): Llama-2-7B at full width and depth
    over tp = 2 and tp = 4 ranks, its generate_batch rows over dp = 2
    ranks, Mixtral 8x7B at full width and 2 layers over tp = 2, each held
    against one GPU over the same weights; the NCCL path at world size 1
    with its decode step captured; the kernels at the shard shapes. `pool`
    is the group of 2 ranks phase 13 goes on with."""
    import dataclasses

    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.parallel.launch import RankPool
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, 32000, 299).tolist()
    out = {}
    spec = _spec("llama2_7b")
    one = Engine(spec, params_7b, device="cuda", activation_q80=True)
    _greedy_trace(one, prompt, 2)     # captures the decode step (its warm-up counts)
    zero_counts()
    toks1, gaps1, lgs1 = _greedy_trace(one, prompt, TP_DECODE)
    torch.cuda.synchronize()
    counts1 = read_counts()
    del one
    # the dp rows' reference: one GPU's generate_batch, eager, so that every
    # draw's logits reach the recording sampler
    prompts = [[1] + rng.integers(3, 32000, n - 1).tolist() for n in DP_PROMPTS]
    one = Engine(spec, params_7b, device="cuda", activation_q80=True,
                 batch=len(prompts), max_seq_len=512, cuda_graphs=False)
    one_rows = {t: _batch_draws(one, prompts, t, seed=11) for t in (0.0, 0.8)}
    del one
    torch.cuda.empty_cache()
    # Mixtral at 2 layers: the one-GPU run eager, so each routing decision
    # is recorded; the ranks replay them
    spec_m = dataclasses.replace(_spec("mixtral_8x7b"), n_layers=2)
    params_m = synthetic_q40_params(spec_m, seed=1, device="cuda")
    one = Engine(spec_m, params_m, device="cuda", activation_q80=True, cuda_graphs=False)
    with recorded_routes() as rec:
        zero_counts()
        toks_m, gaps_m, lgs_m = _greedy_trace(one, prompt, TP_DECODE)
        torch.cuda.synchronize()
        counts_m = read_counts()
    routes = [r.cpu().numpy() for r in rec]
    del one, params_m, rec
    torch.cuda.empty_cache()
    # one group of 2 ranks runs the three 2-rank jobs (a group's start is
    # most of a short job's seconds) and phase 13's, then one of 4
    res = pool.run("chip_smoke:tp_rank_job", "llama2_7b", spec.n_layers, 2, 0, prompt, None)
    out["llama2_7b_tp2"] = _held_tp("Llama-2-7B tp=2", res, toks1, gaps1, lgs1, counts1,
                                    card)
    del res
    res = pool.run("chip_smoke:dp_rank_job", prompts, list(one_rows))
    out["llama2_7b_dp2"] = _held_dp(res, one_rows, card)
    del res
    res = pool.run("chip_smoke:tp_rank_job", "mixtral_8x7b", 2, 2, 1, prompt, routes)
    out["mixtral_2l_tp2"] = _held_tp("Mixtral 8x7B (2 layers) tp=2", res, toks_m, gaps_m,
                                     lgs_m, counts_m, card)
    del res
    with RankPool(4, device_type="cuda", timeout_s=TP_TIMEOUT_S) as pool:
        res = pool.run("chip_smoke:tp_rank_job", "llama2_7b", spec.n_layers, 4, 0, prompt, None)
        out["llama2_7b_tp4"] = _held_tp("Llama-2-7B tp=4", res, toks1, gaps1, lgs1, counts1,
                                        card)
        del res
    with RankPool(1, device_type="cuda", timeout_s=TP_TIMEOUT_S) as pool:
        w1 = pool.run("chip_smoke:nccl_world1_job", prompt)[0]
    ms = {k: _ms_stats(v) for k, v in w1["ms_per_token"].items()}
    print(f"[tp] NCCL world 1: backend {w1['backend']}, weights marked ({w1['marked']}), "
          f"decode step captured {w1['captured']} with {w1['collectives_at_capture']} "
          f"collectives run through warm-up and capture, graph tally {w1['graph_tally']}; "
          f"tokens equal to the plain engine's {w1['tokens'] == w1['plain_tokens']}, "
          f"prompt logits max abs diff {w1['logits_max_abs_diff']:.4g}; decode ms/token "
          f"through the graph: forced {ms['forced']['median']:.3f} [{ms['forced']['min']:.3f}, "
          f"{ms['forced']['max']:.3f}], plain {ms['plain']['median']:.3f} "
          f"[{ms['plain']['min']:.3f}, {ms['plain']['max']:.3f}] [{card}]")
    if w1["backend"] != "nccl" or not w1["captured"] or not w1["collectives_at_capture"]:
        fail("[tp] NCCL world 1: the decode step was not captured with its all-reduce")
    if w1["tokens"] != w1["plain_tokens"]:
        fail(f"[tp] NCCL world 1: tokens {w1['tokens']} != plain {w1['plain_tokens']}")
    out["nccl_world1"] = w1
    out["cli"] = tp_cli(card)
    t_k = time.perf_counter()
    out["kernels"] = tp_kernels(torch.Generator(device="cuda").manual_seed(12))
    out["kernels_s"] = time.perf_counter() - t_k
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[tp] phase 12 in {out['seconds']:.1f} s (kernel rows {out['kernels_s']:.1f} s)")
    return out


# -- phase 13: serving over ranks -------------------------------------------

# the scheduler over tp = 2 at Llama-2-7B full width: B slots, the self
# draft's layers and draft length (a verify forward of B x (1 + K) rows),
# requests sharing a 32-token prefix (the last one sampled), new tokens
# each, the prefix cache's blocks of 16 tokens, and the slot decode and
# verify steps timed after the run
SERVE_TP_B, SERVE_TP_DEPTH, SERVE_TP_K = 2, 2, 3
SERVE_TP_N, SERVE_TP_NEW, SERVE_TP_CHUNK = 4, 12, 64
SERVE_TP_BLOCK, SERVE_TP_TIMED = 16, 4


def serve_tp_requests(vocab: int) -> list:
    """(prompt, new tokens, temperature, top-p, seed) of phase 13's
    requests: a shared 32-token prefix and 8 tokens of each one's own;
    greedy but the last, at temperature 0.8."""
    rng = np.random.default_rng(31)
    prefix = [1] + rng.integers(3, vocab, 31).tolist()
    return [(prefix + rng.integers(3, vocab, 8).tolist(), SERVE_TP_NEW,
             0.8 if i == SERVE_TP_N - 1 else 0.0, 0.9, 100 + i)
            for i in range(SERVE_TP_N)]


def serve_tp_job(requests: list) -> dict | None:
    """One rank of 7B serving over tp = 2 ranks sharing the card (gloo),
    as `dllama api --serve-batch --tp 2` runs it (RankPool job): phase
    12's shard of the rank, the control channel; rank 0 runs the
    scheduler (B slots, the prefix cache, a self-draft) against the
    mirrored engine with launches counted from 0, then times the slot
    decode and verify steps; rank 1 follows."""
    from distributed_llama_tpu_torch.parallel import jobs
    from distributed_llama_tpu_torch.parallel.control import Control
    from distributed_llama_tpu_torch.parallel.mesh import make_mesh
    from distributed_llama_tpu_torch.runtime.engine import Engine

    mesh = make_mesh(tp=2, device_type="cuda")
    ctl = Control(mesh, TP_TIMEOUT_S)
    spec = _spec("llama2_7b")
    eng = Engine(spec, _RANK_SHARDS[("llama2_7b", spec.n_layers, 2, 0)], mesh=mesh,
                 activation_q80=True)
    ctl.attach(eng)
    if not ctl.is_root:
        ctl.follow()
        return None
    try:
        zero_counts()
        mesh.reset_stats()
        t0 = time.perf_counter()
        out = jobs.serve_requests(
            eng, requests, batch=SERVE_TP_B, chunk=SERVE_TP_CHUNK,
            prefix=(64, SERVE_TP_BLOCK), draft=f"self:{SERVE_TP_DEPTH}",
            draft_len=SERVE_TP_K)
        torch.cuda.synchronize()
        out.update(wall_s=time.perf_counter() - t0, counts=read_counts(),
                   mesh=dict(mesh.stats), control=dict(ctl.stats))
        # the slot steps alone: every row live at its own position
        slots = eng.spawn(SERVE_TP_B)
        pos = np.asarray([48, 56][:SERVE_TP_B], np.int32)
        timed = {"decode": [], "verify": []}
        for i in range(SERVE_TP_TIMED + 1):
            c0 = dict(ctl.stats)
            t1 = time.perf_counter()
            slots.slot_decode_step(np.full((SERVE_TP_B, 1), 7, np.int32), pos + i)
            t2 = time.perf_counter()
            slots.slot_verify_step(np.full((SERVE_TP_B, 1 + SERVE_TP_K), 7, np.int32),
                                   pos + i, spec.vocab_size)
            t3 = time.perf_counter()
            if i:      # the first of each warms the eager path
                timed["decode"].append((t2 - t1) * 1e3)
                timed["verify"].append((t3 - t2) * 1e3)
                timed.setdefault("control_ms", []).append(
                    (ctl.stats["control_s"] - c0["control_s"]) * 1e3 / 2)
        out["timed"] = timed
        out["graphs"] = slots.cuda_graphs
        return out
    finally:
        ctl.close()


def serve_tp_kernels(gen, spec) -> dict:
    """K1, K3 and the standalone Q80 round trip at one rank's shapes of the
    tp = 2 slot decode step (t = B) and verify step (t = B x (1 + K)),
    each against its plain version and timed beside it, its library call
    and its bound, as phase 12 times its rows: K1 at the four layer shards
    and the wcls shard, the Q80 round trip at each shard's input width,
    K3 over 16/16 local heads at the B rows' fills."""
    bf16 = torch.bfloat16
    ts = {"slot": SERVE_TP_B, "verify": SERVE_TP_B * (1 + SERVE_TP_K)}
    k1, k3, q80 = [], [], []
    for name in K1_SHAPES:
        d, n = _shard_shape(name, 2)
        wbytes = d * n // 2 + d * n // 32 * 2
        ws = rotating(lambda: random_q40(gen, d, n), wbytes)
        w0 = ws()
        for what, t in ts.items():
            row = k1_row(gen, f"[serve-tp] [K1] {what} ", name, d, n, t, bf16, ws, w0)
            row["step"] = what
            k1.append(row)
        del ws, w0
        torch.cuda.empty_cache()
    for n in sorted({_shard_shape(name, 2)[1] for name in K1_SHAPES}):
        for what, t in ts.items():
            row = q80_row(gen, f"[serve-tp] [Q80] {what} n={n} ", t, n, bf16, bf16)
            row["step"] = what
            q80.append(row)
    for what, t in (("slot", 1), ("verify", 1 + SERVE_TP_K)):
        row = k3_row(gen, f"[serve-tp] [K3] {what} ", bf16, bf16,
                     (SERVE_TP_B, 16, 16, t, [48, 56][:SERVE_TP_B], 128, spec.seq_len))
        row["step"] = what
        k3.append(row)
    torch.cuda.empty_cache()
    return dict(k1=k1, k3=k3, q80=q80)


def _ranks_api(argv: list, batch: bool) -> tuple:
    """`dllama api --tp 2 ...` as a process (rank 0 binds, one rank
    spawned): three completions (and a batch), /healthz, SIGTERM; its
    answers, health, exit code and output."""
    import os
    import signal
    import threading
    import urllib.request

    proc = subprocess.Popen([sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
                             *argv, "--tp", "2"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines = []
    try:
        timer = threading.Timer(TP_TIMEOUT_S, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        timer.cancel()
        port = int(lines[-1].rsplit(":", 1)[1])
        texts = _api_texts(port, batch)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=TP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return texts, health, proc.returncode, "".join(lines) + rest


def _api_texts(port: int, batch: bool) -> list:
    import urllib.request

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TP_TIMEOUT_S) as r:
            return json.loads(r.read())
    out = []
    for i in range(3):
        c = post("/v1/completions", {"prompt": f"hello world {i}", "max_tokens": 12,
                                     "temperature": 0})["choices"][0]
        out.append(c["text"])
    if batch:
        r = post("/v1/batch/completions", {"prompts": ["a b c", "d e"], "max_tokens": 8,
                                           "temperature": 0})
        out.append([c["message"]["content"] for c in r["choices"]])
    return out


def serve_tp_cli(card: str) -> dict:
    """(b) on the tiny Llama fixture, f32: `dllama api --serve-batch 2 --tp
    2` (the prefix cache, a self:1 draft) over loopback HTTP gives the
    one-rank server's text and exits 0 on SIGTERM, every rank joined; a
    session round trip through chat: turn 1 over tp = 2 (`dllama chat --tp
    2`, stdin piped, this process rank 0) saved, turn 2 resumed on one
    rank, equal to one rank's two-turn chat."""
    import threading

    from distributed_llama_tpu_torch.apps import api_server, dllama
    from distributed_llama_tpu_torch.testing import write_fixture

    def chat(argv, turns) -> list[str]:
        buf, old = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO(turns)
        try:
            with contextlib.redirect_stdout(buf):
                dllama.main(argv)
        finally:
            sys.stdin = old
        return buf.getvalue().splitlines()

    def replies(lines: list[str]) -> list[str]:
        return [l for i, l in enumerate(lines) if i and lines[i - 1] == "🤖 Assistant"]

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        mpath, tpath = write_fixture(d, seed=77)
        f32 = ["--compute-dtype", "f32", "--cache-dtype", "f32", "--buffer-float-type", "f32",
               "--temperature", "0", "--seed", "3", "--device", "cuda"]
        api = ["api", "--model", mpath, "--tokenizer", tpath, "--host", "127.0.0.1",
               "--port", "0", *f32, "--serve-batch", "2", "--prefix-cache", "--draft",
               "self:1", "--draft-len", "3"]
        server, state = api_server.build_server(dllama.build_argparser().parse_args(api))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            want = _api_texts(server.server_address[1], True)
        finally:
            server.shutdown()
            server.server_close()
            api_server.finish(state, drain_timeout=10.0)
        got, health, rc, text = _ranks_api(api, True)
        ok = got == want and health["status"] == "ok" and rc == 0
        print(f"[serve-tp] CLI: api --serve-batch 2 --tp 2 on cuda (prefix cache, self:1 "
              f"draft): texts equal to one rank's {got == want}, /healthz {health['status']}, "
              f"exit {rc} after SIGTERM [{card}]")
        if not ok:
            fail(f"[serve-tp] api --tp 2: {got} vs one rank {want}, health {health}, exit "
                 f"{rc}: {text[-2000:]}")
        out["api"] = dict(equal=got == want, exit=rc)
        chat_argv = ["chat", "--model", mpath, "--tokenizer", tpath, *f32, "--steps", "12",
                     "--system-prompt", "be brief"]
        whole = chat(chat_argv, "hello there\nand again\n")
        sess = str(Path(d) / "s.npz")
        turn1 = chat(chat_argv + ["--tp", "2", "--session", sess], "hello there\n")
        turn2 = chat(chat_argv + ["--session", sess], "and again\n")
    got = [replies(turn1)[0], replies(turn2)[0]]
    ok = got == replies(whole)[:2]
    print(f"[serve-tp] CLI: chat --tp 2 turn 1 saved to a session, turn 2 resumed on one rank: "
          f"replies equal to one rank's two-turn chat {ok} [{card}]")
    if not ok:
        fail(f"[serve-tp] chat over tp = 2 with a session: {got} vs {replies(whole)[:2]}")
    out["chat"] = dict(equal=ok)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_serve_tp(card: str, params_7b, pool, tp12: dict, serving_bound: float) -> dict:
    """Phase 13 (`[serve-tp]` lines): serving over ranks on the one card.
    (a) the scheduler at Llama-2-7B full width over tp = 2 (phase 12's
    pool and shards, gloo): B = 2 slots, the prefix cache and a self:2
    draft, 4 requests sharing a 32-token prefix, 12 tokens each, the last
    sampled; greedy rows held to one GPU's scheduler on the same weights
    and to batch-1 generate, a first difference allowed only at a near
    tie (phase 12's tp bound plus phase 7's batch bound); the sharded
    vocab path, a seeded prefix hit, K1, K3 and Q80 launched; the slot
    decode and verify steps timed under gloo. (b) the CLI over ranks. Then
    K1, K3 and Q80 at one rank's step shapes."""
    from distributed_llama_tpu_torch.parallel import jobs
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    spec = _spec("llama2_7b")
    reqs = serve_tp_requests(spec.vocab_size)
    res = pool.run("chip_smoke:serve_tp_job", reqs)
    got = res[0]
    one = Engine(spec, params_7b, device="cuda", activation_q80=True)
    want = jobs.serve_requests(one, reqs, batch=SERVE_TP_B, chunk=SERVE_TP_CHUNK,
                               prefix=(64, SERVE_TP_BLOCK), draft=f"self:{SERVE_TP_DEPTH}",
                               draft_len=SERVE_TP_K)
    greedy = [i for i, r in enumerate(reqs) if r[2] == 0.0]
    near_tie = tp12["llama2_7b_tp2"]["near_tie_bound"] + serving_bound
    equal = [got["tokens"][i] == want["tokens"][i] for i in greedy]
    parity = batch1_parity(one, [reqs[i][0] for i in greedy],
                           [got["tokens"][i] for i in greedy], near_tie,
                           "[serve-tp] greedy request", n=SERVE_TP_NEW)
    del one
    torch.cuda.empty_cache()
    sampled = got["tokens"][-1]
    c, vs, pc, sp = got["counts"], got["vocab_sample_stats"], got["prefix"], got["spec"]
    print(f"[serve-tp] 7B scheduler over tp = 2 (gloo, ranks share the card): "
          f"{SERVE_TP_N} requests x {SERVE_TP_NEW} tokens in {got['wall_s']:.2f} s; greedy rows "
          f"equal to one GPU's scheduler {equal}; near-tie bound {near_tie:.4g}; sampled row "
          f"{len(sampled)} tokens; vocab sampler {vs}; prefix hits {pc['hits']} of "
          f"{pc['lookups']}; drafted {sp['drafted']} accepted {sp['accepted']}; rank 0 launches "
          f"{c}; {got['control']['ops']} ops, control {got['control']['control_s']:.3f} s of "
          f"{got['control']['op_s']:.3f} s; {got['mesh']['collectives']} collectives "
          f"{got['mesh']['collective_s']:.3f} s, staging {got['mesh']['staging_s']:.3f} s "
          f"[{card}]")
    if len(sampled) != SERVE_TP_NEW or not all(0 <= t < spec.vocab_size for t in sampled):
        fail(f"[serve-tp] sampled row {sampled}")
    if vs["sharded"] <= 0 or pc["hits"] < 1 or not (c["K1"] and c["K3"] and c["Q80"]):
        fail(f"[serve-tp] vocab sampler {vs}, prefix {pc}, launches {c}")
    tm = {k: _ms_stats(v) for k, v in got["timed"].items()}
    print(f"[serve-tp] gloo step ms at tp = 2, B = {SERVE_TP_B} (eager, graphs "
          f"{got['graphs']}): slot decode {tm['decode']['median']:.1f} [{tm['decode']['min']:.1f}, "
          f"{tm['decode']['max']:.1f}], verify t = {SERVE_TP_B}x{1 + SERVE_TP_K} "
          f"{tm['verify']['median']:.1f} [{tm['verify']['min']:.1f}, {tm['verify']['max']:.1f}]; "
          f"the control channel's share a step {tm['control_ms']['median']:.2f} ms [{card}]")
    out = dict(scheduler={k: v for k, v in got.items() if k != "timed"}, timed=tm,
               one_gpu_tokens=want["tokens"], equal_to_one_gpu=equal, parity=parity,
               near_tie_bound=near_tie)
    out["cli"] = serve_tp_cli(card)
    t_k = time.perf_counter()
    out["kernels"] = serve_tp_kernels(torch.Generator(device="cuda").manual_seed(13), spec)
    out["kernels_s"] = time.perf_counter() - t_k
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[serve-tp] phase 13 in {out['seconds']:.1f} s (CLI {out['cli']['seconds']:.1f} s, "
          f"kernel rows {out['kernels_s']:.1f} s) [{card}]")
    return out


# -- phase 14: the other mesh axes (--pp, --sp, --ep), on the one card -------

# greedy tokens after the 300-token prompt, and decode steps timed a job
AXES_DECODE, AXES_TIMED = 8, 8
# phase 14's jobs: (label, model, layers, grid, weight seed, Q80 activations).
# pp at the CLI's pp defaults (Q80 off, exact collectives); sp and ep at
# the CLI's defaults (Q80 on; under ep the experts skip it, as in JAX)
AXES_JOBS = (("Llama-2-7B pp=2", "llama2_7b", 32, dict(pp=2), 0, False),
             ("Llama-2-7B sp=2", "llama2_7b", 32, dict(sp=2), 0, True),
             ("Mixtral 8x7B (2 layers) ep=2", "mixtral_8x7b", 2, dict(ep=2), 1, True))


def axes_rank_job(name: str, n_layers: int, grid: dict, seed: int, q80: bool,
                  prompt: list[int], routes: list | None) -> dict:
    """One rank of a pp, sp or ep group on the card (RankPool job): the
    synthetic Q40 weights of `name` from `seed` built on the card, the
    rank's share kept (Engine(mesh=) picks its stage, its experts; sp keeps
    every weight and S/sp of the cache), a bf16 cache, Q80 activations as
    the CLI's defaults for the axis give them. Its greedy trace after the
    prompt (MoE routing replayed from `routes`) with launches counted from
    0, its parameter and cache bytes; then the whole prompt's prefill and
    AXES_TIMED decode steps timed, with the host ms of the collectives and
    of the host staging."""
    import dataclasses

    from distributed_llama_tpu_torch.models.loader import param_bytes
    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.parallel.mesh import describe, make_mesh
    from distributed_llama_tpu_torch.runtime.engine import Engine

    mesh = make_mesh(**grid, device_type="cuda")
    torch.cuda.reset_peak_memory_stats(mesh.device)
    spec = dataclasses.replace(_spec(name), n_layers=n_layers)
    t0 = time.perf_counter()
    params = synthetic_q40_params(spec, seed=seed, device=mesh.device)
    eng = Engine(spec, params, mesh=mesh, activation_q80=q80)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lw = eng.params["layers"][0]
    cache = sum(t.numel() * t.element_size() for t in (*eng.cache.k, *eng.cache.v))
    rec = ([torch.from_numpy(r).to(mesh.device) for r in routes] if routes else None)
    with replayed_routes(rec) if rec else contextlib.nullcontext():
        zero_counts()
        mesh.reset_stats()
        toks, gaps, lgs = _greedy_trace(eng, prompt, AXES_DECODE)
        torch.cuda.synchronize()
        counts, run_stats = read_counts(), dict(mesh.stats)
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    mesh.reset_stats()
    t0 = time.perf_counter()
    for i in range(AXES_TIMED):
        eng.step(np.asarray([[toks[i % len(toks)]]], np.int32), eng.pos)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / AXES_TIMED
    st = dict(mesh.stats)
    return dict(rank=mesh.rank, coords=mesh.coords, describe=describe(mesh),
                graphs=eng.cuda_graphs, tokens=toks, gaps=gaps,
                logits=lgs if mesh.rank == 0 else None, counts=counts,
                run_stats=run_stats, build_s=build_s, prefill_ms=prefill_ms,
                decode_ms=decode_ms, layers=len(eng.params["layers"]),
                experts=lw["moe_up"].shape[0] if "moe_up" in lw else 0,
                param_bytes=param_bytes(eng.params), cache_bytes=cache,
                collective_ms=st["collective_s"] * 1e3 / AXES_TIMED,
                staging_ms=st["staging_s"] * 1e3 / AXES_TIMED,
                collectives_per_step=st["collectives"] / AXES_TIMED,
                staged_bytes_per_step=st["staged_bytes"] / AXES_TIMED,
                memory_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9)


def axes_launches(spec, grid: dict, prompt_len: int, chunk: int = 256) -> dict:
    """K1, K2 and K3 launches one rank of `grid` makes in axes_rank_job's
    greedy trace (the prompt, then AXES_DECODE - 1 decode steps), counted
    from the path each forward takes: every Q40 projection of a layer one
    K1, K3 once a layer, the head (wcls) one K1 a forward on every rank.
    pp: a stage runs its L/pp layers once for every microbatch of a chunk
    (GPipe, parallel/pp.gpipe_microbatches) or once for a short chunk and
    a decode step. sp (no pp): the prompt is one ring segment; attention
    over the sequence-sharded cache is plain torch (no K3). ep: every local
    expert's gate, up and down through K1 in every forward (no K2)."""
    from distributed_llama_tpu_torch.parallel.pp import gpipe_microbatches

    pp, sp, ep = (grid.get(a, 1) for a in ("pp", "sp", "ep"))
    chunks = [min(chunk, prompt_len - i) for i in range(0, prompt_len, chunk)]
    steps = AXES_DECODE - 1
    if sp > 1:
        chunks = [prompt_len + (-prompt_len) % sp]
    heads = len(chunks) + steps                     # forwards reaching wcls
    stage = sum(gpipe_microbatches(c, pp) for c in chunks) + steps
    layers = spec.n_layers // pp
    per_layer = (2 + 3 * spec.n_experts // ep) if ep > 1 else 4
    return dict(K1=layers * per_layer * stage + heads, K2=0,
                K3=0 if sp > 1 else layers * stage)


def axes_kernels(gen) -> dict:
    """The new shapes the axes run, each against its plain version and
    timed beside its plain version, library call and bound (phases 2-4's
    rows): K1 at t = 32 on the 7B layer shapes (a GPipe microbatch, the
    tensor-core path), Q80 off as the pp job runs; K1 at t = 1 on a
    Mixtral local expert (14336x4096, 4096x14336) without the fused Q80
    round trip (the ep path) and, beside it, with it (what one GPU's K2
    decode fuses); K3 over a 32-token microbatch at pos0 32*m, m = 0..7
    (the 256-token chunk's 8 microbatches on a stage)."""
    bf16 = torch.bfloat16
    k1, ep, k3 = [], [], []
    for name in ("wqkv", "wo", "w13", "w2"):
        d, n = K1_SHAPES[name]
        ws = rotating(lambda: random_q40(gen, d, n), d * n // 2 + d * n // 32 * 2)
        w0 = ws()
        k1.append(k1_row(gen, "[axes] [K1] gpipe ", name, d, n, 32, bf16, ws, w0))
        del ws, w0
        torch.cuda.empty_cache()
    for name, (d, n) in K1_MOE_SHAPES.items():
        ws = rotating(lambda: random_q40(gen, d, n), d * n // 2 + d * n // 32 * 2)
        w0 = ws()
        for fq in (False, True):
            row = k1_row(gen, "[axes] [K1] ep local expert ", name, d, n, 1, bf16, ws,
                         w0, q80=fq)
            row["q80"] = fq
            ep.append(row)
        del ws, w0
        torch.cuda.empty_cache()
    for m in range(8):
        row = k3_row(gen, "[axes] [K3] gpipe microbatch ", bf16, bf16,
                     (1, 32, 32, 32, [32 * m], 128, 2048))
        row["m"] = m
        k3.append(row)
    torch.cuda.empty_cache()
    return dict(k1_gpipe=k1, k1_ep=ep, k3_gpipe=k3)


def phase_axes(card: str, params_7b, pool) -> dict:
    """Phase 14 (`[axes]` lines): the other mesh axes on the one card, each
    job a pool of 2 gloo ranks sharing it (phase 12's pool), held against
    one GPU over the same weights: Llama-2-7B at full width and depth over
    pp = 2 (the CLI's pp defaults: Q80 off; the 300-token prompt's 256
    chunk on GPipe with 8 microbatches, its 44-token tail and decode on
    the stage relay) and over sp = 2 (the prompt one ring segment, decode
    over the sequence-sharded cache), Mixtral 8x7B at full width and 2
    layers over ep = 2 (4 experts a rank; routing replayed from the
    one-GPU run). Each: every rank's tokens equal; rank 0's logits and
    tokens held as phase 12 holds them (LOGITS_TOL, LOGITS_REL_L2_TOL, the
    near-tie rule); each rank's K1, K2 and K3 launches equal to its share
    (axes_launches); a rank's parameter bytes against one GPU's (pp: half
    the layers; ep: half of every expert stack) and cache bytes (sp: half
    the positions); collectives and staged bytes a decode step, decode
    ms/token and the prompt's prefill ms. Then the new kernel rows."""
    import dataclasses

    from distributed_llama_tpu_torch.models.loader import param_bytes
    from distributed_llama_tpu_torch.models.params import synthetic_q40_params
    from distributed_llama_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(3, 32000, 299).tolist()
    out = {}
    for label, name, n_layers, grid, seed, q80 in AXES_JOBS:
        spec = dataclasses.replace(_spec(name), n_layers=n_layers)
        if name == "llama2_7b":
            params, routes = params_7b, None
            one = Engine(spec, params, device="cuda", activation_q80=q80)
            _greedy_trace(one, prompt, 2)     # captures the decode step
            zero_counts()
            toks1, gaps1, lgs1 = _greedy_trace(one, prompt, AXES_DECODE)
        else:
            params = synthetic_q40_params(spec, seed=seed, device="cuda")
            one = Engine(spec, params, device="cuda", activation_q80=q80,
                         cuda_graphs=False)
            with recorded_routes() as rec:
                zero_counts()
                toks1, gaps1, lgs1 = _greedy_trace(one, prompt, AXES_DECODE)
            routes = [r.cpu().numpy() for r in rec]
        torch.cuda.synchronize()
        counts1 = read_counts()
        one_params = param_bytes(one.params)
        one_cache = sum(t.numel() * t.element_size() for t in (*one.cache.k, *one.cache.v))
        one_head = param_bytes(dict(one.params, layers=[]))
        one_experts = param_bytes(dict(one.params, layers=[
            {k: lw[k] for k in ("moe_up", "moe_gate", "moe_down") if k in lw}
            for lw in one.params["layers"]])) - one_head
        del one, params
        torch.cuda.empty_cache()
        res = pool.run("chip_smoke:axes_rank_job", name, n_layers, grid, seed, q80,
                       prompt, routes)
        want = axes_launches(spec, grid, len(prompt))
        held = _held_tp(label, res, toks1, gaps1, lgs1, counts1, card, want_counts=want,
                        tag="[axes]", prefill=f"the {len(prompt)}-token prompt's prefill")
        r0 = res[0]
        axis = next(iter(grid))
        # a rank's share against one GPU's: pp half the layers' bytes and
        # half the cache, sp every weight and half the cache, ep half of
        # every expert stack and the whole cache
        want_params = {"pp": one_head + (one_params - one_head) // 2,
                       "sp": one_params, "ep": one_params - one_experts // 2}[axis]
        want_cache = one_cache // 2 if axis in ("pp", "sp") else one_cache
        share_params = (r0["param_bytes"] - one_head) / (one_params - one_head)
        share_cache = r0["cache_bytes"] / one_cache
        print(f"[axes] {label}: a rank holds {r0['layers']} of {spec.n_layers} layers, "
              f"{r0['experts']} of {spec.n_experts} experts a stack, "
              f"{r0['param_bytes'] / 1e9:.3f} GB of parameters (one GPU "
              f"{one_params / 1e9:.3f} GB; of the layers' bytes {share_params:.4f}), cache "
              f"{r0['cache_bytes'] / 1e6:.1f} MB (one GPU {one_cache / 1e6:.1f} MB: "
              f"{share_cache:.4f}); launches each rank {[r['counts'] for r in res]} "
              f"[{card}]")
        shares = {"pp": (r0["layers"] * 2, spec.n_layers), "sp": (1, 1),
                  "ep": (r0["experts"] * 2, spec.n_experts)}[axis]
        for r in res:
            if (r["param_bytes"], r["cache_bytes"]) != (want_params, want_cache) \
                    or shares[0] != shares[1]:
                fail(f"[axes] {label}: rank {r['rank']} holds {r['layers']} layers, "
                     f"{r['experts']} experts, {r['param_bytes']} parameter bytes (want "
                     f"{want_params}), {r['cache_bytes']} cache bytes (want {want_cache})")
        held.update(share_params=share_params, share_cache=share_cache,
                    one_gpu_param_bytes=one_params, one_gpu_cache_bytes=one_cache,
                    want_counts=want, ranks=[{k: v for k, v in r.items() if k != "logits"}
                                             for r in res])
        out[f"{name}_{axis}{grid[axis]}"] = held
        del res
        torch.cuda.empty_cache()
    t_k = time.perf_counter()
    out["kernels"] = axes_kernels(torch.Generator(device="cuda").manual_seed(14))
    out["kernels_s"] = time.perf_counter() - t_k
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[axes] phase 14 in {out['seconds']:.1f} s (kernel rows {out['kernels_s']:.1f} s) "
          f"[{card}]")
    return out


def _bound_by(rows) -> str:
    """What bounds a sum of rows: the label whose rows hold the larger
    share of the summed bound."""
    share = {}
    for r in rows:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["bound_ms"]
    return max(share, key=share.get)


def axes_entries(ax: dict) -> list[dict]:
    """The new shapes' kernel rows, each summed over what ONE rank runs:
    K1 over a GPipe microbatch on a 7B stage (16 layers x 4 projections at
    t = 32); K1 over a Mixtral ep = 2 rank's local experts in a decode
    step (32 layers x 4 experts x gate, up, down at t = 1, no fused Q80),
    with the fused call's sum beside it; K3 over the 256-token chunk's 8
    microbatches on a stage (16 layers x m = 0..7). Launches: the pp job's
    and the ep job's rank 0."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    kr, src1 = ax["kernels"], "distributed_llama_tpu_torch/csrc/q40_matmul.cu"
    pp_run, ep_run = ax["llama2_7b_pp2"]["counts"], ax["mixtral_8x7b_ep2"]["counts"]
    g = {r["shape"]: r for r in kr["k1_gpipe"]}
    e = {(r["shape"], r["q80"]): r for r in kr["k1_ep"]}
    ep_sum = {q: {k: 32 * 4 * (2 * e[("moe_gate_up", q)][k] + e[("moe_down", q)][k])
                  for k in keys} for q in (False, True)}
    return [
        dict(name="q40_matmul_gpipe_t32", route="cuda", source=src1,
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (per stage, "
                      "parallel/pp.py:308 pp_layers_gpipe)",
             launches=pp_run["K1"], max_abs_err=max(r["max_abs_err"] for r in g.values()),
             **{k: 16 * sum(r[k] for r in g.values()) for k in keys},
             bound_by=_bound_by(g.values()),
             path=sorted({r["path"] for r in g.values()}),
             at="one 7B stage (pp=2) over one GPipe microbatch: 16x(wqkv,wo,w13,w2) at "
                "t=32, no Q80 (the CLI's pp default), bf16; launches: the pp run's rank 0"),
        dict(name="q40_matmul_ep_local_experts", route="cuda", source=src1,
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (per local expert, "
                      "parallel/ep_moe.py:154 _ep_body)",
             launches=ep_run["K1"],
             max_abs_err=max(e[(s, False)]["max_abs_err"] for s in K1_MOE_SHAPES),
             **ep_sum[False], bound_by="bytes",
             fused_q80_ms=ep_sum[True]["ms"],
             at="one Mixtral rank's decode step at ep=2 (32 layers): 4 local experts x "
                "(gate, up 14336x4096; down 4096x14336) at t=1 through K1's GEMV without "
                "the fused Q80 (the JAX ep body's local_matmul); fused_q80_ms: the same "
                "calls with the round trip fused; launches: the 2-layer ep run's rank 0"),
        dict(name="flash_attention_gpipe_microbatches", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233 (per stage)",
             launches=pp_run["K3"],
             max_abs_err=max(r["max_abs_err"] for r in kr["k3_gpipe"]),
             **{k: 16 * sum(r[k] for r in kr["k3_gpipe"]) for k in keys},
             bound_by=_bound_by(kr["k3_gpipe"]),
             at="one 7B stage (pp=2) over a 256-token chunk's 8 GPipe microbatches: 16 "
                "layers x t=32 at pos0 32*m, m=0..7, 32/32 heads, bf16 cache; launches: "
                "the pp run's rank 0"),
    ]


def serve_tp_entries(s13: dict) -> list[dict]:
    """The kernels at one rank's shapes of the tp = 2 slot decode step
    (t = B) and verify step (t = B x (1 + K)), each summed over the
    launches of ONE step (32 layers x 4 shards + wcls; 129 standalone Q80
    inputs; 32 K3); launches: rank 0's counts over phase 13's scheduler
    run."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    kr, run = s13["kernels"], s13["scheduler"]["counts"]
    out = []
    for step, label in (("slot", f"slot decode step, t={SERVE_TP_B}"),
                        ("verify", f"verify step, t={SERVE_TP_B}x{1 + SERVE_TP_K}")):
        rows = {r["shape"]: r for r in kr["k1"] if r["step"] == step}
        k1 = {k: 32 * sum(rows[s][k] for s in ("wqkv", "wo", "w13", "w2")) + rows["wcls"][k]
              for k in keys}
        q = {r["n"]: r for r in kr["q80"] if r["step"] == step}
        ns = [_shard_shape(s, 2)[1] for s in ("wqkv", "wo", "w13", "w2")]
        q80 = {k: 32 * sum(q[n][k] for n in ns) + q[_shard_shape("wcls", 2)[1]][k]
               for k in ("ms", "plain_ms", "bound_ms")}
        a = next(r for r in kr["k3"] if r["step"] == step)
        out += [
            dict(name=f"q40_matmul_{step}_tp2", route="cuda",
                 source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
                 replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (per shard)",
                 launches=run["K1"], max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 **k1, bound_by="bytes",
                 at=f"one rank's 7B {label} at tp=2: 32x(wqkv,wo,w13,w2 shards)+wcls shard, "
                    "bf16; launches: phase 13's scheduler run, rank 0"),
            dict(name=f"q80_roundtrip_{step}_tp2", route="cuda",
                 source="distributed_llama_tpu_torch/csrc/q80_roundtrip.cu",
                 replaces="distributed_llama_tpu/ops/matmul.py:93 (no pallas_call)",
                 launches=run["Q80"], max_abs_err=max(r["max_abs_err"] for r in q.values()),
                 **q80, bound_by="bytes", library_ms=None,
                 at=f"one rank's 7B {label} at tp=2: the 129 standalone inputs, bf16; "
                    "launches: phase 13's scheduler run, rank 0"),
            dict(name=f"flash_attention_{step}_tp2", route="cuda",
                 source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
                 replaces="distributed_llama_tpu/ops/pallas_attention.py:233 (per shard)",
                 launches=run["K3"], max_abs_err=a["max_abs_err"],
                 **{k: 32 * a[k] for k in keys}, bound_by=a["bound_by"],
                 at=f"one rank's 7B {label} at tp=2: 32 layers, 16/16 local heads, "
                    f"fills {a['pos0']}, bf16"),
        ]
    return out


def tp_entries(tp: dict) -> list[dict]:
    """The kernels at the tp paths' shard shapes, each for ONE rank's step
    (the sums of phase 12's rows a step runs); launches: rank 0's counts
    over each tp path's run (its prompt's two chunks and its decode
    steps)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    kr = tp["kernels"]
    out = []
    src1 = "distributed_llama_tpu_torch/csrc/q40_matmul.cu"
    for n in (2, 4):
        run = tp[f"llama2_7b_tp{n}"]["counts"]
        rows = {(r["shape"], r["t"]): r for r in kr["k1"] if r["tp"] == n}
        dec = {k: 32 * sum(rows[(s, 1)][k] for s in ("wqkv", "wo", "w13", "w2"))
               + rows[("wcls", 1)][k] for k in keys}
        pre = {k: 32 * sum(rows[(s, 256)][k] for s in ("wqkv", "wo", "w13", "w2"))
               + rows[("wcls", 1)][k] for k in keys}
        off_tc = [s for s in ("wo", "w2") if rows[(s, 256)]["path"] != "tc"]
        out += [
            dict(name=f"q40_matmul_tp{n}", route="cuda", source=src1,
                 replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (per shard, "
                          "parallel/tp_q80.py:99 and :228)",
                 launches=run["K1"],
                 max_abs_err=max(r["max_abs_err"] for (s, t), r in rows.items() if t == 1),
                 **dec, bound_by="bytes",
                 at=f"one rank's 7B decode step at tp={n}: 32x(wqkv,wo,w13,w2 shards)+wcls "
                    "shard, t=1, Q80 fused, bf16; launches: the tp run's rank 0"),
            dict(name=f"q40_matmul_prefill_tp{n}", route="cuda", source=src1,
                 replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (per shard)",
                 launches=run["K1"],
                 max_abs_err=max(r["max_abs_err"] for (s, t), r in rows.items() if t == 256),
                 **pre, bound_by="operations", off_tensor_core_path=off_tc,
                 at=f"one rank's 7B 256-token chunk at tp={n}: 32x(4 shards) at t=256 + wcls "
                    "shard at t=1, bf16; launches: the tp run's rank 0"),
        ]
        q = {r["shape"]: r for r in kr["q80"] if r["tp"] == n}
        out.append(dict(
            name=f"q80_roundtrip_tp{n}", route="cuda",
            source="distributed_llama_tpu_torch/csrc/q80_roundtrip.cu",
            replaces="distributed_llama_tpu/ops/matmul.py:93 (no pallas_call)",
            launches=run["Q80"],
            max_abs_err=max(r["max_abs_err"] for r in q.values()),
            **{k: 32 * (q["wo"][k] + q["w2"][k]) for k in ("ms", "plain_ms", "bound_ms")},
            bound_by="bytes", library_ms=None,
            at=f"one rank's 7B chunk at tp={n}: the 64 column-shard inputs (wo, w2) at t=256, "
               "bf16; launches: the tp run's rank 0 (every standalone input)"))
        for t, tag in ((1, ""), (256, "_prefill")):
            a = next(r for r in kr["k3"] if r["what"] == f"llama2_7b_tp{n}" and r["t"] == t)
            out.append(dict(
                name=f"flash_attention{tag}_tp{n}", route="cuda",
                source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
                replaces="distributed_llama_tpu/ops/pallas_attention.py:233 (per shard, "
                         "parallel/tp_q80.py:135)",
                launches=run["K3"], max_abs_err=a["max_abs_err"],
                **{k: 32 * a[k] for k in keys}, bound_by=a["bound_by"],
                at=f"one rank's 7B {'decode step' if t == 1 else '256-token chunk'} at "
                   f"tp={n}: 32 layers, {a['h']}/{a['kvh']} local heads, bf16"))
    k2 = {r["shape"]: r for r in kr["k2"]}
    out.append(dict(
        name="q40_expert_matmul_tp2", route="cuda", source=src1,
        replaces="distributed_llama_tpu/ops/pallas_q40.py:319 (per shard)",
        launches=tp["mixtral_2l_tp2"]["counts"]["K2"],
        max_abs_err=max(r["max_abs_err"] for r in k2.values()),
        **{k: 32 * (2 * k2["mixtral_gate_up_tp2"][k] + k2["mixtral_down_tp2"][k])
           for k in keys}, bound_by="bytes",
        at="one rank's Mixtral decode step at tp=2 (32 layers): gate/up (8, 7168, 4096) "
           "and down (8, 4096, 7168) shards, 2 of 8 experts, t=1, Q80 fused, bf16; "
           "launches: the 2-layer tp run's rank 0"))
    return out


def spec_entries(k1: dict, q80: dict, k3: dict, spec: dict) -> list[dict]:
    """The kernels of one 7B verify forward at T = 8 (draft_len 7): K1 on
    its tensor-core path (phase 2's path rows at t = 8 for the layers, wcls
    timed in phase 9), the 129 standalone Q80 round trips
    (phase 2b's t = 8 rows), K3 over 8 query rows at fill 308 (phase 4).
    Launches: counted over phase 9's batch-1 speculative streams."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    kp = {r["shape"]: r for r in k1["paths"] if r["t"] == 1 + SPEC_K}
    w = spec["k1_wcls"]
    layer = ("wqkv", "wo", "w13", "w2")
    k1s = {key: 32 * sum(kp[sh]["tc_ms" if key == "ms" else key] for sh in layer) + w[key]
           for key in keys}
    qr = {(r["t"], r["n"]): r for r in q80["rows"]
          if r["dtype"] == "bfloat16" and r["out"] == "bfloat16"}
    t = 1 + SPEC_K
    q80s = {key: 97 * qr[(t, 4096)][key] + 32 * qr[(t, 11008)][key]
            for key in ("ms", "plain_ms", "bound_ms")}
    a = next(r for r in k3["rows"] if r["b"] == 1 and r["t"] == t and r["cache"] == "bfloat16"
             and r["dtype"] == "bfloat16" and r["kvh"] == 32)
    counts = spec["streams"]["launches"]
    return [
        dict(name="q40_matmul_verify", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matmul.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:258 (t = 1 + k = 8: wgmma with "
                      "the weight dequantized into registers, one 64-token tile)",
             launches=counts["K1"],
             max_abs_err=max([kp[sh]["tc_err"] for sh in layer] + [w["max_abs_err"]]),
             **k1s, bound_by="bytes",
             at="one 7B verify forward: 32x(wqkv,wo,w13,w2)+wcls at t=8, bf16; launches: "
                "phase 9's batch-1 speculative streams"),
        dict(name="q80_roundtrip_verify", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q80_roundtrip.cu",
             replaces="distributed_llama_tpu/ops/matmul.py:93 (quantize_q80_jax / "
                      "dequantize_q80_jax before every matmul; no pallas_call)",
             launches=counts["Q80"],
             max_abs_err=max(qr[(t, n)]["max_abs_err"] for n in (4096, 11008)),
             **q80s, bound_by="bytes", library_ms=None,
             at="one 7B verify forward: 97 inputs at 8x4096 + 32 at 8x11008, bf16; launches: "
                "phase 9's batch-1 speculative streams"),
        dict(name="flash_attention_verify", route="cuda",
             source="distributed_llama_tpu_torch/csrc/flash_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:233",
             launches=counts["K3"], max_abs_err=a["max_abs_err"],
             ms=32 * a["ms"], plain_ms=32 * a["plain_ms"], bound_ms=32 * a["bound_ms"],
             bound_by=a["bound_by"], library_ms=32 * a["library_ms"],
             at=f"one 7B verify forward: 32 layers, T=8 at pos0 {a['pos0'][0]}, H=KVH=32, "
                "bf16; launches: phase 9's batch-1 speculative streams"),
    ]


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


# a run still going after WATCHDOG_S (the script's limit is 1200 s) prints
# every thread's stack to stderr, its ranks' too, stops every process it
# started and exits nonzero: a stall names its place. That watchdog is a
# Python thread, which a stall holding the interpreter lock never lets run,
# so a process of its own (tools/watchdog.py) backs it up at WATCHDOG_HARD_S:
# SIGUSR1 to this process (faulthandler prints every thread's stack from
# C) and to each process below it, then every one of them killed
WATCHDOG_S = 1100.0
WATCHDOG_HARD_S = 1140.0


def start_watchdog() -> subprocess.Popen:
    """Start both watchdogs; returns the backstop's process, which ends
    when its stdin (this process's pipe) closes."""
    import faulthandler
    import os
    import signal
    import threading

    from distributed_llama_tpu_torch.tools.watchdog import descendants, signal_tree

    def fire():
        print(f"chip_smoke FAILED: still running after {WATCHDOG_S:.0f} s; the stacks:",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        signal_tree(descendants(os.getpid()))  # the ranks print their stacks on SIGUSR1
        os._exit(3)

    timer = threading.Timer(WATCHDOG_S, fire)
    timer.daemon = True
    timer.start()
    faulthandler.register(signal.SIGUSR1, file=sys.stderr, all_threads=True)
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_llama_tpu_torch.tools.watchdog",
         str(os.getpid()), str(WATCHDOG_HARD_S)],
        stdin=subprocess.PIPE, cwd=str(Path(__file__).resolve().parent))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    watchdog = start_watchdog()

    def mark(what: str) -> None:
        print(f"[chip_smoke] {what} done at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr, flush=True)

    card = phase_card()
    build_s = phase_build()
    mark("phase 1 (build)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    k1 = phase_k1(gen)
    q80 = phase_q80(gen)
    k2 = phase_k2(gen)
    edges = gemv1_edges(gen)
    fused = phase_gemv1_q80(gen)
    k3 = phase_k3(gen)
    mark("phases 2-4 (K1, Q80, K2, K3)")
    probes = phase_probes()
    t_p2 = time.perf_counter()
    probes2 = phase_probes_p2_p6()
    probes2["seconds"] = time.perf_counter() - t_p2
    print(f"[probe] P2, P3, P5, P6 in {probes2['seconds']:.1f} s")
    mark("phase 4b (probes)")
    t_main = time.perf_counter()
    main_paths, params_7b = phase_main_paths(card)
    main_s = time.perf_counter() - t_main
    print(f"[main] main paths and their graph phases in {main_s:.1f} s")
    mark("phase 5 (main paths)")
    serving = phase_serving(card, params_7b)
    mark("phase 7 (serving)")
    spec9 = phase_spec(card, params_7b, serving["scheduler"]["near_tie_bound"], gen)
    mark("phase 9 (speculation)")
    trace10 = phase_trace_batch(card, params_7b, spec9["near_tie_bound"])
    mark("phase 10 (trace, batch)")
    admission11 = phase_admission(card, params_7b, spec9["near_tie_bound"])
    mark("phase 11 (admission)")
    from distributed_llama_tpu_torch.parallel.launch import RankPool

    with RankPool(2, device_type="cuda", timeout_s=TP_TIMEOUT_S) as pool2:
        tp12 = phase_tp(card, params_7b, pool2)
        mark("phase 12 (tp, dp)")
        serve13 = phase_serve_tp(card, params_7b, pool2, tp12,
                                 serving["scheduler"]["near_tie_bound"])
        mark("phase 13 (serving over ranks)")
        axes14 = phase_axes(card, params_7b, pool2)
        mark("phase 14 (pp, sp, ep)")
    del params_7b
    torch.cuda.empty_cache()
    phase_file_path()
    mark("phase 6 (file path)")
    chat = phase_chat()
    mark("phase 8 (chat)")
    kernels = summarize(k1, q80, fused, k2, k3, probes, probes2, main_paths)
    kernels["kernels"] += serving_entries(k1, q80, k3, serving)
    kernels["kernels"] += spec_entries(k1, q80, k3, spec9)
    kernels["kernels"] += tp_entries(tp12)
    kernels["kernels"] += serve_tp_entries(serve13)
    kernels["kernels"] += axes_entries(axes14)
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
    for tag, name, what in (("K1", "q40_matmul_verify", "one 7B verify forward, t = 8, bf16, "
                                                        "the tensor-core path"),
                            ("Q80", "q80_roundtrip_verify", "one 7B verify forward's 129 "
                                                            "standalone launches, t = 8"),
                            ("K3", "flash_attention_verify", "one 7B verify forward, 8 query "
                                                             "rows at fill 308")):
        e = next(k for k in kernels["kernels"] if k["name"] == name)
        lib = ("none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms")
        print(f"[spec] [{tag}] {what}: {e['ms']:.4f} ms against a bound of {e['bound_ms']:.4f} "
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
        serving=serving, chat=chat, spec=spec9, trace=trace10, admission=admission11,
        tp=tp12, serve_tp=serve13, axes=axes14,
        kernels=kernels["kernels"], total_s=time.perf_counter() - t_start), indent=1))
    watchdog.stdin.close()
    watchdog.wait(timeout=10)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
