"""dllama CLI of the port — modes `inference`, `generate`, `chat` and `api`.

Counterpart of the JAX package's apps/dllama.py (ref:
src/apps/dllama/dllama.cpp):

  inference  prompt completion with a per-token benchmark line and end-of-run
             averages (ref: dllama.cpp:43-91)
  generate   plain streaming completion (ref: dllama.cpp:96-131)
  chat       interactive chat with the Llama-2 [INST]/<<SYS>> template
             (ref: dllama.cpp:133-178); --session FILE resumes the
             conversation's KV cache and saves it after every turn
  api        the OpenAI-compatible HTTP server (apps/api_server.py); with
             --serve-batch B, the continuous-batching scheduler over B
             slots under its supervisor, and --prefix-cache the radix
             prefix cache over them; without it, --session FILE resumes
             and saves the one engine's cached prefix

    python -m distributed_llama_tpu_torch.apps.dllama inference \\
        --model m.m --tokenizer t.t --prompt "Hello" --steps 32
    python -m distributed_llama_tpu_torch.apps.dllama api \\
        --model m.m --tokenizer t.t --port 9990 --serve-batch 4

Runs Llama, Mixtral and Grok-1 `.m` files on `--device cuda` (the
default) or `--device cpu`; `--cache-dtype f8` keeps the KV cache in fp8
(e4m3). `--buffer-float-type` defaults to q80, as in the JAX CLI: for a
Q40 model every matmul input goes through the Q80 round trip (the
reference's quantized activation buffers); `f32` turns it off. On the card
every decode step replays one captured CUDA graph; `--device-sampling`
runs the whole sampled decode loop on the device (Engine.generate_device)
and prints its tokens when the loop ends, as the JAX CLI does.
`--lookup-decode K` (prompt lookup) and `--draft self:D|model:PATH` with
`--draft-len K` (a real draft) speculate in inference, generate and chat:
each verify forward feeds the last token and up to K drafted ones and
emits the accepted prefix plus one token (runtime/speculative.py,
runtime/draft.py); greedy output equals the plain stream, sampled output
is distribution-exact by rejection resampling. In api mode they speculate
on the legacy path, and --draft per slot on the scheduler.

Observability, as in the JAX CLI: `--profile DIR` writes a torch.profiler
trace (CPU and CUDA activities, Chrome format, DIR/trace.json) of the
generation in inference, generate and chat. In api mode `--trace` turns on
the flight recorder (request spans and the step timeline; `--trace-buffer`,
`--trace-dir`, `--trace-sample`, `--trace-decode-every`), `--profile-sample
N` times every Nth scheduler step's entry points on the card, and
`--profile-dir` and `--admin-token` serve POST /admin/profile and the
admin guard (apps/api_server.py). Admission and sizing, as in the JAX CLI:
`--slo-ttft-ms`/`--slo-itl-ms` arm the scheduler's admission ladder,
`--serve-batch auto`/`--prefix-blocks auto` size the server from the
memory ledger and the `--autotune FILE` knee, `--freeze-compiles` refuses a
graph capture after warmup (check_admission_flags holds the JAX parse-time
refusals). `--weights-float-type` names the weight
type of a legacy-header `.m`, which does not store it (ref: app.cpp:47-48);
`--nthreads` is accepted and ignored, as in the JAX CLI.

Over ranks, as in the JAX CLI: `--tp N` splits the model over N
tensor-parallel ranks and `--dp N` runs N batch rows on N data-parallel
ranks (row 0 streams, `inference` counts every row; with `--lookup-decode
K` at temperature 0 the rows speculate through generate_batch_lookup);
`--shard-vocab` (auto, on, off) splits the embedding and the head over tp
(over pp and tp with stages, when pp*tp divides the vocab). `--pp N`
places the layers in N pipeline stages (a long prompt chunk runs GPipe;
as in the JAX CLI, `--buffer-float-type q80` is then ignored with a
notice and the run goes without Q80 activations), `--ep N` places a MoE
model's experts over N ranks and `--sp N` shards the KV cache's sequence
over N ranks (the prompt prefills as one ring-attention segment); these
three run in `inference` and `generate`, and `chat` and the legacy `api`
run over `--ep` and `--pp`. The CLI starts its ranks itself
(parallel/launch.py: this process is rank 0 and alone prints, the others
are spawned): one process a rank, NCCL when
every rank has a GPU of its own, gloo on the CPU and when ranks share a
GPU (the choice is printed). With `--buffer-float-type q80` (the default)
the column splits' partial sums cross the ranks as Q80 blocks.
`inference` and `generate` run the same program on every rank. `chat` and
`api` over `--tp` (and the legacy `api` and `chat` over `--ep` and `--pp`)
serve from rank 0, which reads stdin or binds the port
and runs every host layer, while the other ranks run the engine calls it
mirrors to them (parallel/control.py); speculation, sessions, the prefix
cache and `--profile` (one trace a rank, DIR/rank<r>/trace.json) run over
ranks too.

Flags of features the port does not have yet — the worker mode, chat and
the legacy api over the sp axis, clusters, and the features listed in
UNPORTED_FLAGS — are
accepted by the parser only to be refused with a message naming their
ROADMAP item, never silently ignored; what the JAX CLI itself refuses is
refused in its words.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CACHE_DTYPES = {**DTYPES, "f8": torch.float8_e4m3fn}
PORTED_MODES = ("inference", "generate", "chat", "api")
# serving flags of the JAX CLI that the port does not have yet, with the
# ROADMAP item that brings each (refused with that message when given)
_FLEET = "replicas and the fleet (ROADMAP item 16)"
_CLUSTER = "the multi-node control plane (ROADMAP item 15)"
UNPORTED_FLAGS = {
    "--replicas": _FLEET, "--retry-budget": _FLEET, "--route-policy": _FLEET,
    "--replica-procs": _FLEET, "--replica-hosts": _FLEET,
    "--kv-transfer": _FLEET, "--tier": _FLEET, "--min-replicas": _FLEET,
    "--max-replicas": _FLEET, "--tenant-budgets": _FLEET,
    "--coordinator": _CLUSTER, "--node-rank": _CLUSTER,
    "--connect-timeout": _CLUSTER, "--heartbeat-interval": _CLUSTER,
    "--worker-timeout": _CLUSTER, "--push-weights": _CLUSTER,
}
_FLAG_SWITCHES = ("--kv-transfer", "--push-weights")
# every rendezvous and collective of a run over ranks, in seconds: a rank
# that dies leaves the others failing after this long, not hanging
RANK_TIMEOUT_S = 600.0
# the mesh axes, in the JAX mesh's order; the three the scheduler does not
# run over (the JAX server refuses them)
AXES = ("dp", "sp", "ep", "pp", "tp")
NEW_AXES = ("sp", "ep", "pp")


def world_size(args) -> int:
    """The ranks a run takes: the product of the mesh axes."""
    return math.prod(getattr(args, a) for a in AXES)


def _int_or_auto(v: str):
    """argparse type for --serve-batch/--prefix-blocks: a plain int, or
    the literal 'auto', resolved at engine build from the memory ledger's
    headroom capped by the calibrated batch knee (runtime/profiler.
    resolve_auto_shape; JAX apps/dllama.py:34)."""
    s = v.strip().lower()
    if s == "auto":
        return "auto"
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}")


def _serve_batch(v: str):
    n = _int_or_auto(v)
    if n != "auto" and n < 0:
        raise argparse.ArgumentTypeError("--serve-batch must be >= 0")
    return n


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama",
        description="distributed-llama on one NVIDIA GPU (PyTorch/CUDA "
                    "port): run Llama-family and MoE inference from "
                    "reference-format .m/.t files.")
    p.add_argument("mode", choices=["inference", "generate", "chat", "api",
                                    "worker"])
    p.add_argument("--model", help="path to .m model file")
    p.add_argument("--tokenizer", help="path to .t tokenizer file")
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0,
                   help="max tokens to generate (0 = until seq_len)")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None,
                   help="sampler seed (default: time)")
    p.add_argument("--weights-float-type", default=None,
                   choices=["f32", "f16", "q40", "q80"],
                   help="must match the model file (ref: app.cpp:47-48); "
                        "a legacy-header .m stores no weight type and "
                        "needs it")
    p.add_argument("--nthreads", type=int, default=None,
                   help="accepted for reference CLI parity; the card "
                        "manages its own parallelism (ref: app.cpp:84)")
    p.add_argument("--workers", nargs="*", default=None,
                   help="n/a on a GPU; refused (ref: app.cpp:51-74)")
    p.add_argument("--pallas", action="store_true", default=None,
                   help="the JAX CLI's kernel switch; refused: the port "
                        "always runs its Hopper kernels on the card")
    p.add_argument("--no-pallas", dest="pallas", action="store_false",
                   help="refused, as --pallas")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="inference/generate/chat: write a torch.profiler "
                        "trace (CPU and CUDA activities, Chrome format) of "
                        "the generation to DIR/trace.json; over ranks one "
                        "trace a rank, DIR/rank<r>/trace.json")
    p.add_argument("--compute-dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--cache-dtype", default="bf16",
                   choices=["bf16", "f32", "f8"])
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--buffer-float-type", default="q80", choices=["f32", "q80"],
                   help="activation buffers: q80 (the default) round-trips "
                        "every matmul input of a Q40 model through Q80")
    p.add_argument("--system-prompt", default=None,
                   help="chat mode system prompt")
    p.add_argument("--session", default=None, metavar="FILE",
                   help="chat/api modes: persist the KV-cache session to "
                        "FILE (chat: after every turn; api without "
                        "--serve-batch: on shutdown) and resume from it on "
                        "start, without re-prefilling its history")
    p.add_argument("--device-sampling", action="store_true",
                   help="run the whole sampled decode loop on the device "
                        "(temperature/top-p and the reference's xorshift "
                        "stream in a replayed CUDA graph that stops at eos; "
                        "no host round trip per token). Output prints "
                        "after the loop")
    p.add_argument("--lookup-decode", type=int, default=0, metavar="K",
                   help="speculative decoding: draft up to K tokens a step "
                        "from the context's own n-grams and verify them in "
                        "ONE forward (prompt lookup). At --temperature 0 "
                        "the tokens are exactly the greedy stream; above "
                        "it tokens are accepted or resampled by rejection, "
                        "distribution-exact against the host sampler (on "
                        "another RNG stream)")
    p.add_argument("--draft", default=None, metavar="self:D|model:PATH",
                   help="real-draft speculative decoding: 'self:D' drafts "
                        "with the model's own first D layers and logits "
                        "head (no extra weights; a D-layer KV cache), "
                        "'model:PATH' with a separate draft .m of the same "
                        "vocab. Greedy output equals the plain stream; "
                        "temperature > 0 accepts with min(1, p/q) against "
                        "the draft's own distribution. In api mode with "
                        "--serve-batch every slot drafts through one "
                        "fixed-width verify forward. Exclusive with "
                        "--lookup-decode")
    p.add_argument("--draft-len", type=int, default=None, metavar="K",
                   help="with --draft: tokens proposed a draft pass "
                        "(default 7); the verify width is 1 + K")
    # api mode (JAX apps/dllama.py's defaults)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--serve-batch", type=_serve_batch, default=0,
                   metavar="B|auto",
                   help="api: serve through the continuous-batching "
                        "scheduler with B KV slots (0 = requests serialize "
                        "on one engine). 'auto' sizes B at startup from "
                        "the memory ledger's headroom capped by the batch "
                        "knee (--autotune artifact, or a conservative "
                        "default); the decision is logged and exported on "
                        "/stats and /metrics")
    p.add_argument("--serve-chunk", type=int, default=0, metavar="C",
                   help="api: the scheduler's prefill chunk (0 = the "
                        "engine's, 256). With --slo-ttft-ms/--slo-itl-ms "
                        "this is the WIDEST rung of the adaptive width "
                        "ladder")
    # SLO-aware admission (api mode, with --serve-batch; runtime/
    # scheduler.AdmissionPolicy): either flag arms the policy
    p.add_argument("--slo-ttft-ms", type=float, default=None, metavar="MS",
                   help="api mode, with --serve-batch: time-to-first-token "
                        "target. The admission policy widens the chunked-"
                        "prefill width (toward --serve-chunk) when the "
                        "live TTFT EWMA endangers this bound and inter-"
                        "token latency has headroom")
    p.add_argument("--slo-itl-ms", type=float, default=None, metavar="MS",
                   help="api mode, with --serve-batch: inter-token-latency "
                        "target. Every scheduler iteration with prefill "
                        "work stretches running streams' token gap by one "
                        "chunk forward; the admission policy shrinks the "
                        "chunk width one warmed rung at a time when the "
                        "live step-time EWMA approaches this bound, widens "
                        "again when decode rows idle, and turns "
                        "speculation off while the bound is endangered. "
                        "Host-side only: the width ladder is warmed up "
                        "front, so --freeze-compiles holds while it adapts")
    p.add_argument("--autotune", default=None, metavar="FILE",
                   help="api mode, with --serve-batch auto or "
                        "--prefix-blocks auto: calibration artifact "
                        "(python -m distributed_llama_tpu_torch.tools."
                        "autotune) supplying the measured batch knee that "
                        "caps the auto-sizing; without it a conservative "
                        "default knee applies. tools/dlprof.py reads the "
                        "same artifact offline")
    p.add_argument("--queue-depth", type=int, default=0, metavar="N",
                   help="api: admission queue bound (0 = 4 x --serve-batch); "
                        "past it requests get 429 with Retry-After")
    p.add_argument("--request-deadline", type=float, default=0.0,
                   metavar="S", help="api: per-request end-to-end budget in "
                                     "seconds (0 = none)")
    p.add_argument("--stall-timeout", type=float, default=0.0, metavar="S",
                   help="api: watchdog bound on one scheduler step in "
                        "seconds (0 = 10)")
    p.add_argument("--drain-timeout", type=float, default=30.0, metavar="S",
                   help="api: on SIGTERM, how long in-flight requests may "
                        "finish")
    p.add_argument("--prefix-cache", action="store_true",
                   help="api, with --serve-batch: the radix prefix cache "
                        "(runtime/prefix_cache.py): an admission seeds the "
                        "longest cached token prefix from a block arena on "
                        "the device and prefills only the suffix; finished "
                        "prompts publish their blocks; /stats gains a "
                        "prefix_cache block")
    p.add_argument("--prefix-blocks", type=_int_or_auto, default=0,
                   metavar="N|auto",
                   help="prefix-cache arena size in blocks (0 = 2 x "
                        "serve-batch x context tokens; 'auto' = that target "
                        "capped at half the measured headroom; startup "
                        "refuses a decision whose slots and arena together "
                        "exceed the headroom; the decision is on /stats "
                        "like --serve-batch auto). Arena bytes = N x "
                        "2 x layers x kv_heads x block_len x head_size x "
                        "the cache dtype's size")
    p.add_argument("--prefix-block-len", type=int, default=None, metavar="L",
                   help="prefix-cache block length in tokens (default 32): "
                        "reuse is whole blocks only")
    # the flight recorder and the device profiler (runtime/trace.py,
    # runtime/profiler.py; JAX apps/dllama.py:410-465)
    p.add_argument("--admin-token", default=None, metavar="TOKEN",
                   help="api mode: bearer token accepted on /admin/* as an "
                        "alternative to the loopback-only default "
                        "(constant-time compare)")
    p.add_argument("--trace", action="store_true",
                   help="api mode: the flight recorder — per-request "
                        "lifecycle spans and the per-iteration step "
                        "timeline in a fixed-capacity ring, served by "
                        "/admin/trace and the dllama_step_ms /metrics "
                        "family. Host-side; off it records nothing")
    p.add_argument("--trace-buffer", type=int, default=None, metavar="N",
                   help="ring capacity in events (default 8192; oldest "
                        "events fall off first)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="also persist events as rotating JSONL files under "
                        "DIR (16 MB x 8 files)")
    p.add_argument("--trace-sample", type=float, default=None, metavar="R",
                   help="fraction of request spans persisted to --trace-dir "
                        "(deterministic per trace id; the ring and /metrics "
                        "see everything). Default 1.0")
    p.add_argument("--trace-decode-every", type=int, default=None,
                   metavar="N",
                   help="decode progress event cadence in tokens (default "
                        "8): bounds how much ring one long stream takes")
    p.add_argument("--freeze-compiles", action="store_true",
                   help="api mode (needs --serve-batch): after warmup "
                        "captures the serving set of CUDA graphs, any NEW "
                        "graph key is refused with a structured error "
                        "instead of captured. Covers everything captured "
                        "after warmup, the batch endpoint's graphs "
                        "included (warm those shapes first or leave the "
                        "freeze off)")
    p.add_argument("--profile-sample", type=int, default=None, metavar="N",
                   help="api mode (needs --serve-batch): time every Nth "
                        "scheduler step's entry points on the card with "
                        "CUDA events (/stats device_time, dllama_device_ms "
                        "/metrics). Off by default")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="where POST /admin/profile captures land (default: "
                        "a fresh temp dir a capture)")
    for flag in UNPORTED_FLAGS:
        if flag in _FLAG_SWITCHES:
            p.add_argument(flag, action="store_true", default=None,
                           help="not ported yet")
        else:
            p.add_argument(flag, default=None, help="not ported yet")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (one process each)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: the batch rows, one a rank")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (ring-attention prefill; "
                        "each holds seq_len/sp of the KV cache)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks (MoE models: each holds "
                        "n_experts/ep experts)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel ranks (each holds n_layers/pp "
                        "layers and their KV cache). --session is refused "
                        "and --buffer-float-type q80 is ignored in favor of "
                        "exact collectives")
    p.add_argument("--shard-vocab", default="auto",
                   choices=["auto", "on", "off"],
                   help="row-split the embedding table and logits head "
                        "over tp: auto = whenever tp divides the vocab; "
                        "off keeps them replicated")
    p.add_argument("--nnodes", type=int, default=1,
                   help="cluster size; only 1 is ported")
    return p


def refusals(args) -> list[str]:
    """Every flag of a feature the port does not have yet, as a message."""
    out = []
    if args.pallas is not None:
        out.append("--pallas/--no-pallas: the port has no kernel switch; "
                   "on the card every Q40 matmul and the attention run "
                   "their Hopper kernels, on the CPU their plain versions, "
                   "and nothing falls back from one to the other (ROADMAP "
                   "North star)")
    if args.mode not in PORTED_MODES:
        out.append(f"mode {args.mode!r} is not ported yet (ported: "
                   f"{', '.join(PORTED_MODES)}; the worker mode is the "
                   "multi-node control plane, ROADMAP item 15)")
    for axis in AXES:
        if getattr(args, axis) < 1:
            out.append(f"--{axis} must be >= 1")
    if args.mode in ("chat", "api") and not args.serve_batch and args.sp > 1:
        # chat and the legacy api run over ep and pp through the control
        # channel's existing ops; the ring prefill is no op yet. api
        # --serve-batch over any of them is refused in the JAX words
        # (check_serve_flags)
        out.append(f"mode {args.mode!r} with --sp {args.sp}: serving over "
                   "sp is ROADMAP item 19 and is not ported yet (inference "
                   "and generate run over every axis; chat and api over ep "
                   "and pp)")
    if args.dp > 1 and (args.mode == "chat" or (
            args.mode == "api" and not args.serve_batch)):
        # the JAX engine crashes here rather than refusing: its chat and
        # legacy api generate() on the dp engine's batch rows stops at
        # `assert self.batch == 1` (JAX runtime/engine.py:838)
        out.append(f"--dp {args.dp} in mode {args.mode!r}: prefill() is "
                   "single-sequence; use step() for batches (the JAX "
                   "engine's assert self.batch == 1, runtime/engine.py:838, "
                   f"which its {args.mode} reaches on a --dp engine)")
    if args.nnodes != 1:
        out.append("--nnodes: multi-host clusters are the multi-node "
                   "control plane (ROADMAP item 15) and are not ported yet")
    for flag, why in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            out.append(f"{flag} in mode {args.mode!r}: {why} is not ported "
                       "yet")
    if args.mode != "api" and (args.serve_batch or args.serve_chunk
                               or args.queue_depth or args.request_deadline
                               or args.stall_timeout or args.freeze_compiles):
        out.append("--serve-batch/--serve-chunk/--queue-depth/"
                   "--request-deadline/--stall-timeout/--freeze-compiles "
                   "are api-mode flags")
    if args.serve_batch == 0 and (args.serve_chunk or args.queue_depth
                                  or args.request_deadline
                                  or args.stall_timeout):
        out.append("--serve-chunk/--queue-depth/--request-deadline/"
                   "--stall-timeout configure the scheduler and need "
                   "--serve-batch B")
    out += _prefix_and_session_refusals(args)
    return out


def _prefix_and_session_refusals(args) -> list[str]:
    """The JAX server's prefix-cache and session refusals, in its words
    (JAX apps/api_server.py:1695-1745, :1992-2003)."""
    out = []
    if args.prefix_blocks != "auto" and args.prefix_blocks < 0:
        out.append("--prefix-blocks must be >= 0 (0 = the 2xBxcontext "
                   "default, or 'auto')")
    if args.prefix_cache and not args.serve_batch:
        out.append("--prefix-cache requires --serve-batch N (the radix "
                   "cache serves the slot scheduler; the legacy path "
                   "already reuses its single session's prefix)")
    if not args.prefix_cache and (args.prefix_blocks
                                  or args.prefix_block_len is not None):
        out.append("--prefix-blocks/--prefix-block-len have no effect "
                   "without --prefix-cache")
    if args.session and args.serve_batch:
        out.append("--serve-batch (continuous-batching scheduler) does not "
                   "compose with --session prefix persistence")
    if args.session and args.mode not in ("chat", "api"):
        out.append("--session is a chat/api-mode flag")
    return out


def check_admission_flags(args) -> dict | None:
    """The JAX server's parse-time refusals of the SLO and auto-sizing
    flags, in its words and order (JAX apps/api_server.py:1700-1730,
    :1788-1796): an SLO nobody enforces or an artifact nobody reads is an
    error before any engine work. Returns the loaded --autotune artifact
    (None without the flag)."""
    serve_batch = args.serve_batch
    slo_ttft, slo_itl = args.slo_ttft_ms, args.slo_itl_ms
    if (slo_ttft is not None or slo_itl is not None) and not serve_batch:
        sys.exit("error: --slo-ttft-ms/--slo-itl-ms require "
                 "--serve-batch N|auto (the SLO-aware admission policy "
                 "adapts the scheduler's chunked-prefill width)")
    for name, v in (("--slo-ttft-ms", slo_ttft), ("--slo-itl-ms", slo_itl)):
        if v is not None and not v > 0:
            sys.exit(f"error: {name} must be > 0 "
                     "(omit the flag to disable)")
    auto = serve_batch == "auto" or args.prefix_blocks == "auto"
    if args.autotune and not auto:
        sys.exit("error: --autotune has no effect without --serve-batch "
                 "auto or --prefix-blocks auto (tools/dlprof.py consumes "
                 "the artifact offline)")
    art = None
    if args.autotune:
        from ..runtime.profiler import load_autotune

        try:
            art = load_autotune(args.autotune)
        except (OSError, ValueError) as e:
            sys.exit(f"error: --autotune {args.autotune}: {e}")
    return art


def check_spec_flags(args) -> None:
    """The JAX CLI's parse-time refusals of --draft, --draft-len and
    --lookup-decode, in its words (JAX apps/dllama.py:796-807, 1044,
    1296-1327; the mesh-less model draft, apps/api_server.py:1978-1986):
    every one fails before any model load."""
    if args.draft_len is not None and not args.draft:
        sys.exit("error: --draft-len has no effect without --draft "
                 "(self:<depth> or model:<path>)")
    if args.draft_len is not None and args.draft_len < 1:
        sys.exit("error: --draft-len must be >= 1")
    if args.draft:
        if args.lookup_decode:
            sys.exit("error: --draft and --lookup-decode both pick the "
                     "draft source — use one (the real draft pays on "
                     "arbitrary text; prompt lookup only on repetitive)")
        from ..runtime.draft import parse_draft_spec
        try:
            kind, arg = parse_draft_spec(args.draft)
        except ValueError as e:
            sys.exit(f"error: {e}")
        if kind == "model" and world_size(args) > 1:
            sys.exit("error: --draft model:PATH needs a mesh-less engine "
                     "(use --draft self:<depth>, which shares the target's "
                     "sharded buffers)")
        if kind == "model" and not os.path.exists(arg):
            sys.exit(f"error: --draft model:{arg}: no such file")
        if args.nnodes > 1:
            sys.exit("error: --draft does not compose with --nnodes "
                     "(the worker protocol has no draft replay)")
        if args.pp > 1:
            sys.exit("error: --draft does not compose with --pp "
                     "(stage-stacked layers cannot be depth-sliced)")
        if args.dp > 1:
            sys.exit("error: --draft is single-sequence outside api "
                     "mode and per-slot inside it; it does not compose "
                     "with --dp")
        if args.device_sampling:
            sys.exit("error: --draft is host-loop decoding; it does "
                     "not compose with --device-sampling")
    if args.lookup_decode:
        if args.nnodes > 1:
            sys.exit("error: --lookup-decode does not compose with --nnodes")
        if args.device_sampling and args.mode in ("inference", "generate"):
            sys.exit("error: --lookup-decode is host-loop decoding; it "
                     "does not compose with --device-sampling")
        if args.dp > 1 and args.temperature != 0:
            sys.exit("error: --lookup-decode with --dp is greedy-only "
                     "(Engine.generate_batch_lookup); set --temperature 0")


def check_mesh_flags(args) -> None:
    """The JAX CLI's parse-time refusal of a vocab split with nothing to
    split over, in its words (JAX apps/dllama.py:1328-1335)."""
    if args.shard_vocab == "on" and args.tp <= 1 and args.nnodes <= 1:
        sys.exit("error: --shard-vocab on needs a tensor-parallel mesh "
                 "(--tp > 1) to split the vocab over; 'auto' enables it "
                 "whenever the mesh allows")


def check_serve_flags(args) -> None:
    """The JAX server's refusal of a scheduler over more than the tp axis,
    in its words (JAX apps/api_server.py:1684-1686): the slot scheduler's
    engine composes with --tp only."""
    if args.mode == "api" and args.serve_batch and max(
            getattr(args, a) for a in ("dp", *NEW_AXES)) > 1:
        sys.exit("error: --serve-batch needs a single-process engine "
                 "(no --dp/--sp/--ep/--pp; --tp composes)")


def check_session_flags(args) -> None:
    """--session needs a host-fetchable, stage-flat KV cache: save_session
    fetches it to the host, which a multi-process mesh or a stage-stacked
    pp cache cannot give. Fails before any engine work (JAX
    apps/dllama.py:716)."""
    if getattr(args, "session", None) and (args.nnodes > 1 or args.pp > 1):
        sys.exit("error: --session does not compose with --nnodes or --pp")


def build_engine(args, mesh=None):
    """model file -> (engine, tokenizer, sampler); over a mesh, this rank's
    engine from its shard of the file (JAX apps/dllama.py:609-660)."""
    from ..io.model_file import content_fingerprint, read_spec
    from ..models.loader import load_params_streamed
    from ..parallel.mesh import describe
    from ..parallel.sharding import (check_axis_constraints,
                                     loader_placement, vocab_splits)
    from ..quants.types import FloatType
    from ..runtime.engine import Engine, resolve_device
    from ..sampler import Sampler
    from ..tokenizer import Tokenizer

    if not args.model or not args.tokenizer:
        sys.exit("error: --model and --tokenizer are required")
    device = resolve_device(args.device)
    wft = (FloatType[args.weights_float_type.upper()]
           if args.weights_float_type else None)
    spec = read_spec(args.model, weights_float_type=wft)
    print(f"⏩ {args.model}: arch={spec.arch.name} dim={spec.dim} "
          f"layers={spec.n_layers} heads={spec.n_heads}/{spec.n_kv_heads} "
          f"seq={spec.seq_len} device={device}")
    cdt = DTYPES[args.compute_dtype]
    q80 = args.buffer_float_type == "q80"
    if q80 and args.pp > 1:
        # JAX apps/dllama.py:617-622: the stages reduce exactly, and the
        # whole run goes without Q80 activations
        print("⏩ --pp uses exact collectives; ignoring --buffer-float-type q80")
        q80 = False
    tp = mesh.tp if mesh is not None else 1
    # ONE resolution of --shard-vocab, shared by the loader and the engine
    # (JAX apps/dllama.py:632-640): the loader keeps the rows the engine
    # expects
    shard_vocab = {"auto": vocab_splits(spec, tp), "on": True,
                   "off": False}[args.shard_vocab]
    try:
        # the JAX engine's placement rules, before any weight is read
        check_axis_constraints(
            spec, sp=args.sp, ep=args.ep, pp=args.pp,
            seq_len=min(args.max_seq_len or spec.seq_len, spec.seq_len),
            q80_collectives=q80 and tp > 1)
    except ValueError as e:
        sys.exit(f"error: {e}")
    place = {}
    if mesh is not None:
        device = mesh.device
        print(f"⏩ {describe(mesh)}")
        place = loader_placement(mesh, spec, shard_vocab)
    t0 = time.perf_counter()
    try:
        params, lstats = load_params_streamed(spec, args.model, device,
                                              dtype=cdt, **place)
    except ValueError as e:
        sys.exit(f"error: {e}")
    per_rank = (f", {lstats.device_bytes / 1e6:.0f} MB on each rank's device"
                if mesh is not None else "")
    print(f"⏩ loaded {lstats.total_bytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f}s (peak host "
          f"{lstats.peak_host_bytes / 1e6:.0f} MB{per_rank})")
    engine = _new_engine(spec, params, device=device, mesh=mesh,
                    batch=mesh.dp if mesh is not None else 1,
                    q80_collectives=q80, shard_vocab=shard_vocab,
                    max_seq_len=args.max_seq_len, compute_dtype=cdt,
                    cache_dtype=CACHE_DTYPES[args.cache_dtype],
                    # JAX apps/dllama.py:651: Q80 activations for Q40 weights
                    activation_q80=(q80 and spec.weights_float_type
                                    == FloatType.Q40),
                    # the weights file's content hash, folded into the
                    # session fingerprint (JAX apps/dllama.py:559)
                    model_fingerprint=content_fingerprint(args.model))
    tokenizer = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(tokenizer.vocab_size, args.temperature, args.topp, seed)
    return engine, tokenizer, sampler


def _new_engine(*args, **kw):
    """Engine(...), its refusals (the JAX engine's asserts, in their
    words) as the CLI's error exit."""
    from ..runtime.engine import Engine

    try:
        return Engine(*args, **kw)
    except ValueError as e:
        sys.exit(f"error: {e}")


def _steps(args, engine) -> int:
    s = args.steps if args.steps > 0 else engine.seq_len
    return min(s, engine.seq_len)


def _safe_print(piece: str) -> None:
    """Print only printable pieces (ref: safePrintf, src/tokenizer.cpp:18-36)."""
    out = "".join(c for c in piece if c.isprintable() or c in "\n\t ")
    print(out, end="", flush=True)


def _stream_pieces(tokenizer, prev_token: int, toks: list[int]) -> None:
    """Print a token list as decoded text (JAX apps/dllama.py:783)."""
    for tok in toks:
        _safe_print(tokenizer.decode_piece(prev_token, tok).decode(
            "utf-8", errors="replace"))
        prev_token = tok
    print()


@contextlib.contextmanager
def _maybe_profile(args, mesh=None):
    """A torch.profiler trace of what runs inside, with --profile DIR (JAX
    apps/dllama.py:769 _maybe_profile): CPU activities, and the card's
    kernels on a CUDA engine, written as DIR/trace.json (Chrome trace
    format); over ranks each rank writes DIR/rank<r>/trace.json and rank
    0 says where they are."""
    if not args.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if args.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = args.profile
    if mesh is not None and mesh.world > 1:
        out = os.path.join(args.profile, f"rank{mesh.rank}")
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    if mesh is not None and mesh.world > 1:
        print(f"📈 profiler traces written to {args.profile}/rank<r>/"
              f"trace.json, one a rank (ranks 0-{mesh.world - 1})")
    else:
        print(f"📈 profiler trace written to {args.profile}")


def cmd_generate(args, benchmark: bool, mesh=None) -> None:
    engine, tokenizer, sampler = build_engine(args, mesh)
    tokens = tokenizer.encode(args.prompt or "Hello")
    print(f"💡 prompt tokens: {len(tokens)}")
    with _maybe_profile(args, mesh):
        if engine.batch > 1:
            _generate_rows(args, engine, tokenizer, sampler, tokens,
                           benchmark)
        else:
            _generate(args, engine, tokenizer, sampler, tokens, benchmark)


def _generate_rows(args, engine, tokenizer, sampler, tokens: list[int],
                   benchmark: bool) -> None:
    """The dp branch (JAX apps/dllama.py:814-845): the batch rows generate
    the same prompt independently, one shared sampler drawing every row's
    coin in row order (with --device-sampling, row i on the device stream
    seed + i; with --lookup-decode, greedy through generate_batch_lookup:
    per-row drafts, one verify forward a step); row 0 streams,
    `inference` counts every row."""
    t0 = time.perf_counter()
    if args.lookup_decode:
        outs = engine.generate_batch_lookup(
            [tokens] * engine.batch, _steps(args, engine),
            eos_id=tokenizer.stop_token_ids(), draft_len=args.lookup_decode,
            vocab_size=tokenizer.vocab_size)
    elif args.device_sampling:
        outs = engine.generate_batch_device(
            [tokens] * engine.batch, _steps(args, engine),
            temperature=args.temperature, topp=args.topp,
            seed=sampler.rng_state, eos_id=tokenizer.stop_token_ids(),
            vocab_size=tokenizer.vocab_size)
    else:
        outs = engine.generate_batch([tokens] * engine.batch,
                                     _steps(args, engine), sampler,
                                     eos_id=tokenizer.stop_token_ids())
    dt = time.perf_counter() - t0
    _stream_pieces(tokenizer, tokens[-1], outs[0])
    if benchmark:
        n = sum(len(o) for o in outs)
        print(f"Generated tokens:    {n} ({engine.batch} sequences)")
        print(f"Avg tokens / second: {n / max(dt, 1e-9):.2f}")


def rank_main(argv: list[str]) -> None:
    """One rank of a run over ranks. `inference|generate --tp N --dp M`:
    its mesh, its shard of the model, the same run as every other rank.
    `chat|api --tp N`: rank 0 serves through the mirrored engine
    (parallel/control.py) and closes the channel when it ends (EOF, the
    server's drain); every other rank builds its shard and follows until
    then."""
    from ..parallel.control import Control
    from ..parallel.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    mesh = make_mesh(tp=args.tp, dp=args.dp, sp=args.sp, ep=args.ep,
                     pp=args.pp, device_type=args.device)
    if args.mode in ("inference", "generate"):
        cmd_generate(args, benchmark=args.mode == "inference", mesh=mesh)
        return
    control = Control(mesh, RANK_TIMEOUT_S)
    if mesh.rank != 0:
        engine, _, _ = build_engine(args, mesh)
        control.attach(engine)
        if args.freeze_compiles:
            # rank 0's sentinel refuses a late capture; each follower
            # refuses the same capture, so the refusal keeps them in step
            from ..runtime.profiler import COMPILES

            COMPILES.freeze = True
        # chat's --profile traces every rank (api mode has none)
        with _maybe_profile(args, mesh) if args.mode == "chat" \
                else contextlib.nullcontext():
            control.follow()
        return
    try:
        if args.mode == "chat":
            cmd_chat(args, mesh=mesh, control=control)
        else:
            from .api_server import serve

            serve(args, mesh=mesh, control=control)
    finally:
        control.close()


def _generate(args, engine, tokenizer, sampler, tokens: list[int],
              benchmark: bool) -> None:
    if args.device_sampling:     # JAX apps/dllama.py:850-867
        t0 = time.perf_counter()
        out = engine.generate_device(
            tokens, _steps(args, engine), temperature=args.temperature,
            topp=args.topp, seed=sampler.rng_state,
            eos_id=tokenizer.stop_token_ids(), vocab_size=tokenizer.vocab_size)
        dt = time.perf_counter() - t0
        _stream_pieces(tokenizer, tokens[-1], out)
        if benchmark:
            # the wall time includes the prefill and, on a first call on
            # the card, the loop's capture: no per-token rate is claimed
            capture = " and one-time graph capture" if engine.cuda_graphs else ""
            print(f"Generated tokens:    {len(out)} (on-device loop, "
                  f"{engine.last_device_steps} device steps)")
            print(f"Wall time:           {dt:.2f} s (includes the prefill"
                  f"{capture})")
        return
    prev = [tokens[-1]]

    def on_token(tok: int) -> None:
        _safe_print(tokenizer.decode_piece(prev[0], tok).decode(
            "utf-8", errors="replace"))
        prev[0] = tok

    if args.draft or args.lookup_decode:
        _generate_spec(args, engine, tokenizer, sampler, tokens, on_token,
                       benchmark)
        return
    res = engine.generate(tokens, _steps(args, engine), sampler,
                          eos_id=tokenizer.stop_token_ids(), on_token=on_token)
    print()
    if benchmark:
        _print_benchmark(res)


def _build_draft(args, engine):
    from ..runtime.draft import build_draft
    try:
        return build_draft(engine, args.draft)
    except ValueError as e:
        sys.exit(f"error: {e}")


def _speculate(args, engine, tokens, budget, sampler, stops, on_token,
               vocab, draft=None, history=None, f32: bool = True):
    """One speculative run in the mode the flags pick (JAX
    apps/dllama.py:875-937, :1102-1136): a real draft or prompt lookup,
    greedy at temperature 0, rejection-resampled above it on a numpy
    stream seeded from the sampler's state. With f32, temperature and
    top-p go through float32 first, as the JAX CLI's generate rounds them
    (its chat does not)."""
    common = dict(eos_id=stops, on_token=on_token, vocab_size=vocab,
                  history=history)
    rnd = (lambda v: float(np.float32(v))) if f32 else float  # noqa: E731
    sampled = dict(temperature=rnd(args.temperature), topp=rnd(args.topp),
                   seed=sampler.rng_state)
    if draft is not None:
        dl = args.draft_len or 7
        if args.temperature > 0:
            return engine.generate_draft_sampled(
                tokens, budget, draft=draft, draft_len=dl, **sampled,
                **common)
        return engine.generate_draft(tokens, budget, draft=draft,
                                     draft_len=dl, **common)
    if args.temperature > 0:
        return engine.generate_lookup_sampled(
            tokens, budget, draft_len=args.lookup_decode, **sampled, **common)
    return engine.generate_lookup(tokens, budget,
                                  draft_len=args.lookup_decode, **common)


def _generate_spec(args, engine, tokenizer, sampler, tokens, on_token,
                   benchmark: bool) -> None:
    draft = _build_draft(args, engine) if args.draft else None
    t0 = time.perf_counter()
    _speculate(args, engine, tokens, _steps(args, engine), sampler,
               tokenizer.stop_token_ids(), on_token, tokenizer.vocab_size,
               draft=draft)
    dt = time.perf_counter() - t0
    print()
    if benchmark:
        fwd, n = engine.last_accept_stats
        what = f", draft {args.draft}" if draft is not None else ""
        print(f"Generated tokens:    {n} in {fwd} forwards "
              f"({n / max(fwd, 1):.2f} tokens/forward{what})")
        capture = (" and the graphs' capture" if engine.cuda_graphs else "")
        print(f"Wall time:           {dt:.2f} s (includes the prefill"
              f"{capture})")


def _print_benchmark(res) -> None:
    """Per-token G/I/H lines + averages (ref: dllama.cpp:47-48,74-91). One
    device, so the reference's transfer columns T/S have nothing to show."""
    for s in res.stats.steps:
        print(f"🔶 G {s.generation_ms:7.2f} ms I {s.device_ms:7.2f} ms "
              f"H {s.host_ms:5.2f} ms")
    avg = res.stats.averages()
    print(f"Generated tokens:    {len(res.tokens)}")
    print(f"Avg tokens / second: {1000.0 / max(avg.generation_ms, 1e-9):.2f}")
    print(f"Avg generation time: {avg.generation_ms:.2f} ms")
    print(f"Avg inference time:  {avg.device_ms:.2f} ms")
    print(f"Avg sampling time:   {avg.host_ms:.2f} ms")


def cmd_chat(args, mesh=None, control=None) -> None:
    """Interactive chat with the Llama-2 template (ref: dllama.cpp:133-178;
    JAX apps/dllama.py:1040). Each turn runs Engine.generate on the one
    engine, continuing at its position; with --session the cache and the
    conversation's tokens load before the first turn and save after
    every turn; with --profile DIR the turns run under one torch.profiler
    trace. Over --tp ranks this is rank 0: it reads stdin, samples and
    prints, and every engine call is an op of `control`."""
    engine, tokenizer, sampler = build_engine(args, mesh)
    if control is not None:
        control.attach(engine)
    chat_draft = _build_draft(args, engine) if args.draft else None
    # the whole conversation's tokens: the n-gram miner's source and the
    # real draft's catch-up stream (the token at position i is convo[i])
    convo: list[int] = []
    resumed = False
    if args.session and os.path.exists(args.session):
        convo = engine.load_session(args.session)
        resumed = True
        print(f"💾 resumed session from {args.session} "
              f"({engine.pos} cached positions)")
    system = args.system_prompt
    if system is None and not resumed:
        try:
            system = input("💻 System prompt (optional): ")
        except EOFError:
            system = ""
    first = not resumed
    stops = tokenizer.stop_token_ids()
    with _maybe_profile(args, mesh):
        while True:
            try:
                user = input("\n👱 User\n> ")
            except EOFError:
                break
            if not user:
                continue
            if first and system:
                text = f"[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{user} [/INST]"
            else:
                text = f"[INST] {user} [/INST]"
            first = False
            tokens = tokenizer.encode(text, add_bos=True)
            print("\n🤖 Assistant")
            prev = [tokens[-1]]

            def on_token(tok: int) -> None:
                if tok not in stops:
                    _safe_print(tokenizer.decode_piece(prev[0], tok).decode(
                        "utf-8", errors="replace"))
                prev[0] = tok

            # the prompt itself must fit before any generation can start
            remaining = engine.seq_len - engine.pos - len(tokens)
            if remaining <= 1:
                print("(context window full)")
                break
            budget = min(_steps(args, engine), remaining)
            convo.extend(tokens)
            if chat_draft is not None or args.lookup_decode:
                # a turn speculates over the whole conversation so far
                res = _speculate(args, engine, tokens, budget, sampler, stops,
                                 on_token, tokenizer.vocab_size,
                                 draft=chat_draft, history=convo, f32=False)
                if args.temperature > 0:
                    # the next turn draws afresh (JAX apps/dllama.py:1111)
                    sampler.set_seed(sampler.rng_state + len(res.tokens) + 1)
            else:
                res = engine.generate(tokens, budget, sampler, eos_id=stops,
                                      on_token=on_token)
            convo.extend(res.tokens)
            print()
            if args.session:
                engine.save_session(args.session, tokens=convo)


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.workers:
        # the JAX CLI's refusal (apps/dllama.py:1286-1290), for a GPU
        sys.exit("error: --workers is not applicable on a GPU — the "
                 "reference's TCP root/worker star has no counterpart "
                 "here; use --tp N and --dp M, which start one rank "
                 "process a GPU of this host (or ranks sharing one), or "
                 "--nnodes/--coordinator + `dllama worker` processes for a "
                 "multi-host cluster (ROADMAP item 15)")
    check_admission_flags(args)
    check_spec_flags(args)
    check_mesh_flags(args)
    check_serve_flags(args)
    check_session_flags(args)
    refused = refusals(args)
    if refused:
        sys.exit("error: " + "; ".join(refused))
    world = world_size(args)
    if world == 1 and args.mode == "api":
        from .api_server import serve

        serve(args)
        return
    if world == 1 and args.mode == "chat":
        cmd_chat(args)
        return
    if world > 1:
        from ..parallel.launch import run_ranks
        from ..utils.device import resolve_device

        resolve_device(args.device)     # no card: raise before any spawn
        run_ranks(world, args.device,
                  "distributed_llama_tpu_torch.apps.dllama:rank_main",
                  (list(argv if argv is not None else sys.argv[1:]),),
                  RANK_TIMEOUT_S)
        return
    cmd_generate(args, benchmark=args.mode == "inference")


if __name__ == "__main__":
    main()
