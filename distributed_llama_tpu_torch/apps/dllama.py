"""dllama CLI of the port — modes `inference`, `generate`, `chat`, `api` and
`worker`.

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
  worker     join a multi-node cluster as a non-root node (below)

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
run over them too. The CLI starts its ranks itself
(parallel/launch.py: this process is rank 0 and alone prints, the others
are spawned): one process a rank, NCCL when
every rank has a GPU of its own, gloo on the CPU and when ranks share a
GPU (the choice is printed). With `--buffer-float-type q80` (the default)
the column splits' partial sums cross the ranks as Q80 blocks.
`inference` and `generate` run the same program on every rank. `chat` and
`api` over `--tp` (and the legacy `api` and `chat` over `--sp`, `--ep`
and `--pp`) serve from rank 0, which reads stdin or binds the port
and runs every host layer, while the other ranks run the engine calls it
mirrors to them (parallel/control.py); speculation, sessions, the prefix
cache and `--profile` (one trace a rank, DIR/rank<r>/trace.json) run over
ranks too.

Over nodes, as in the JAX CLI (parallel/multihost.py): start the root with
any mode and `--nnodes N --node-rank 0 --coordinator host:port`, and one
`dllama worker --nnodes N --node-rank r --coordinator host:port` on each
other node, every one with the same model, tokenizer and mesh flags (a
worker with `--push-weights` needs no `--model`: the root broadcasts the
spec and every tensor's bytes, and every node passes the flag). The nodes
first form the control star (a versioned handshake on the coordinator's
port + 1, heartbeats every `--heartbeat-interval`, a node silent past
`--worker-timeout` is lost), then every rank joins one process group at
the coordinator's address. A node runs world / N of the mesh's ranks
(with the default axes tp spans the cluster, one rank a node); the
node's first is the process started here, and it spawns the others. The
root runs the mode; a worker replays each run, request and benchmark
sequence the root announces (RUN, API, XFER_BENCH, SHUTDOWN). A lost
node ends every node with one `🔴 cluster: {...}` line and exit code 43;
a cluster that never forms, exit code 44. `inference` prints the JAX
CLI's per-token G/I/T/H/S lines: S the modeled kB a rank sends a token
(runtime/netstats.py), T the transfer time of the collectives timed on
the mesh (`Engine.measure_transfer_ms`).

The replica tier and the fleet, as in the JAX CLI (api mode, with
--serve-batch): `--replicas N` thread replicas over shared weights behind
the cache-aware failover router, `--replica-procs N` worker processes,
`--replica-hosts H:P,...` pre-started workers, `--kv-transfer` and
`--tier` the block-transfer plane and its prefill/decode roles,
`--min-replicas`/`--max-replicas` the fleet controller's autoscaling window
and `--tenant-budgets` weighted-fair queueing (check_fleet_flags holds the
JAX server's refusals, in its words). What the JAX CLI itself refuses is
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
# every rendezvous and collective of a run over ranks, in seconds: a rank
# that dies leaves the others failing after this long, not hanging
RANK_TIMEOUT_S = 600.0
# the mesh axes, in the JAX mesh's order; the three the scheduler does not
# run over (the JAX server refuses them)
AXES = ("dp", "sp", "ep", "pp", "tp")
NEW_AXES = ("sp", "ep", "pp")


def mesh_axes(args) -> dict:
    """The mesh's axis sizes. Over nodes with the default --tp, tp spans
    the cluster's ranks (JAX apps/dllama.py:610-613): one rank a node
    beside the other axes."""
    axes = {a: getattr(args, a) for a in AXES}
    rest = math.prod(v for a, v in axes.items() if a != "tp")
    if args.nnodes > 1 and args.tp == 1 and args.nnodes % rest == 0:
        axes["tp"] = args.nnodes // rest
    return axes


def world_size(args) -> int:
    """The ranks a run takes: the product of the mesh axes."""
    return math.prod(mesh_axes(args).values())


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
    # the replica tier and the fleet (api mode; runtime/router.py,
    # runtime/replica_worker.py, runtime/kv_transfer.py, runtime/fleet.py;
    # the JAX CLI's flags and help)
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="api mode, with --serve-batch: run N supervised "
                        "engine replicas behind a cache-aware failover "
                        "router (runtime/router.py) — weights SHARED, "
                        "each replica its own KV cache + prefix arena. "
                        "A crashed/stalled/broken replica is invisible "
                        "to clients: not-yet-streamed requests retry on "
                        "a healthy sibling (token-identical for greedy), "
                        "/readyz stays ready while any replica serves, "
                        "and replicas drain/restart one at a time "
                        "(POST /admin/drain_replica) with zero failed "
                        "requests")
    p.add_argument("--retry-budget", type=int, default=None, metavar="K",
                   help="api mode, with --replicas: automatic failover "
                        "resubmits per request (default 1). Only "
                        "requests that have not streamed a token are "
                        "retried; mid-stream failures surface a "
                        "structured non-retryable error frame instead")
    p.add_argument("--route-policy", default=None,
                   choices=["cache_aware", "least_loaded", "round_robin"],
                   help="api mode, with --replicas: placement policy "
                        "(default cache_aware — route to the replica "
                        "whose radix tree caches the longest prompt "
                        "prefix, fall back to least-loaded; the SGLang "
                        "cache-aware routing idea). Session affinity "
                        "(body `session`/`user` field) applies under "
                        "every policy")
    p.add_argument("--replica-procs", type=int, default=0, metavar="N",
                   help="api mode, with --serve-batch: run N replicas as "
                        "supervised OS PROCESSES (each its own "
                        "interpreter + weights, served over the framed "
                        "replica protocol) instead of threads — the real "
                        "fault boundary: a segfault, OOM kill, or "
                        "SIGKILL costs ONE replica, the router fails "
                        "not-yet-streamed requests over to a sibling "
                        "(token-identical for greedy), and the process "
                        "supervisor respawns the dead worker under "
                        "backoff with exit-code classification. "
                        "Mutually exclusive with --replicas")
    p.add_argument("--replica-hosts", default=None, metavar="H:P,...",
                   help="api mode, with --serve-batch: comma-separated "
                        "host:port list of PRE-STARTED replica workers "
                        "(python -m distributed_llama_tpu_torch.runtime."
                        "replica_worker on each host) — the cross-host "
                        "tier. No spawn supervision: each worker's "
                        "lifetime belongs to its host's operator. "
                        "Mutually exclusive with --replica-procs")
    p.add_argument("--kv-transfer", action="store_true",
                   help="api mode, with --prefix-cache and a replica "
                        "tier: let replicas SHIP published KV blocks to "
                        "each other (RMSG_BLOCK_* over the framed "
                        "codec) — a replica placed cold on a prefix a "
                        "sibling caches FETCHES the blocks and seeds "
                        "them instead of re-prefilling (greedy outputs "
                        "bit-identical, transfer failures degrade to a "
                        "plain re-prefill). Also the carrier of --tier "
                        "disaggregation. Block frames ride the wire "
                        "ledger (dllama_kv_transfer_* on /metrics)")
    p.add_argument("--tier", default=None, metavar="T[,T...]",
                   help="api mode, with --kv-transfer: per-replica "
                        "disaggregation roles (prefill|decode|mixed; "
                        "one value applies to all, or a comma list "
                        "matching the replica count). prefill-tier "
                        "replicas run ONLY prompt prefills (big "
                        "chunks, no decode occupancy) and stream their "
                        "blocks to decode-tier replicas, which admit "
                        "already-seeded — the vLLM-lineage split that "
                        "kills prefill/decode interference. The router "
                        "falls back to the unified mixed path when no "
                        "prefill replica is routable. Not with "
                        "--replica-hosts (set `tier` in each worker's "
                        "own config; the router learns it from the "
                        "health PONG)")
    p.add_argument("--min-replicas", type=int, default=0, metavar="N",
                   help="api mode, with a replica tier: floor of the "
                        "fleet controller's autoscaling window (default: "
                        "the boot replica count — autoscaling off). The "
                        "controller drains + reaps sustained-idle "
                        "replicas down to this floor, folding their "
                        "lifetime counters into the router totals")
    p.add_argument("--max-replicas", type=int, default=0, metavar="N",
                   help="api mode, with a replica tier: ceiling of the "
                        "autoscaling window (default: the boot count — "
                        "autoscaling off). Under sustained queue growth "
                        "the controller spawns replicas up to N, hard-"
                        "capped by the HBM ledger's slots_addable "
                        "headroom; fresh replicas warm their caches "
                        "from siblings via --kv-transfer fills before "
                        "taking traffic")
    p.add_argument("--tenant-budgets", default=None,
                   metavar="NAME=W[:TPS],...",
                   help="api mode, with --serve-batch: per-tenant "
                        "weighted-fair queueing + token budgets. Each "
                        "entry names a tenant with fair-share weight W "
                        "and optional sustained tokens/sec budget (e.g. "
                        "'gold=4:2000,free=1:100'). Tenants come from "
                        "the request body `tenant` field or X-Tenant "
                        "header (unknown tenants get weight 1, no "
                        "budget); an over-budget tenant is served only "
                        "when no in-budget tenant waits, so a hog's "
                        "overage can never move a victim's p99")
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
    # the multi-node cluster (parallel/multihost.py; JAX
    # apps/dllama.py:467-508). The root's --heartbeat-interval and
    # --worker-timeout are authoritative: workers adopt them from the
    # HELLO ack
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of nodes in the cluster (node 0 is the "
                        "root; the others run `dllama worker`)")
    p.add_argument("--node-rank", type=int, default=0,
                   help="this node's rank (0..nnodes-1)")
    p.add_argument("--coordinator", default=None,
                   help="the process group's address host:port (rank 0's "
                        "TCP store; the control star listens on port + 1), "
                        "reachable from every node (required with "
                        "--nnodes)")
    p.add_argument("--push-weights", action="store_true",
                   help="cluster weight distribution: rank 0 streams the "
                        ".m and broadcasts each tensor's bytes, so workers "
                        "need NO local model file (the reference root's "
                        "per-worker TCP weight push, transformer.cpp:562-"
                        "591). Pass on EVERY process; workers may omit "
                        "--model")
    p.add_argument("--connect-timeout", type=float, default=30.0,
                   metavar="SECS",
                   help="cluster formation budget: workers retry the "
                        "root's control port with exponential backoff "
                        "until this deadline, and the root waits this "
                        "long for every worker's versioned HELLO — past "
                        "it, a structured formation error (exit 44), "
                        "never a silent hang")
    p.add_argument("--heartbeat-interval", type=float, default=2.0,
                   metavar="SECS",
                   help="root->worker MSG_PING cadence on the control "
                        "channel (workers answer MSG_PONG; both sides "
                        "time out silent peers)")
    p.add_argument("--worker-timeout", type=float, default=10.0,
                   metavar="SECS",
                   help="peer-loss detection bound: a node silent on the "
                        "control channel this long (dead, wedged, or "
                        "partitioned) is declared lost with a structured "
                        "ClusterPeerLost diagnostic (exit 43) instead of "
                        "hanging a collective; must comfortably exceed "
                        "--heartbeat-interval")
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
    for axis in AXES:
        if getattr(args, axis) < 1:
            out.append(f"--{axis} must be >= 1")
    if args.dp > 1 and (args.mode == "chat" or (
            args.mode == "api" and not args.serve_batch)):
        # the JAX engine crashes here rather than refusing: its chat and
        # legacy api generate() on the dp engine's batch rows stops at
        # `assert self.batch == 1` (JAX runtime/engine.py:838)
        out.append(f"--dp {args.dp} in mode {args.mode!r}: prefill() is "
                   "single-sequence; use step() for batches (the JAX "
                   "engine's assert self.batch == 1, runtime/engine.py:838, "
                   f"which its {args.mode} reaches on a --dp engine)")
    if args.mode != "api" and (
            args.replicas != 1 or args.replica_procs or args.replica_hosts
            or args.retry_budget is not None
            or args.route_policy is not None or args.kv_transfer
            or args.tier is not None or args.min_replicas
            or args.max_replicas or args.tenant_budgets is not None):
        out.append("--replicas/--replica-procs/--replica-hosts/"
                   "--retry-budget/--route-policy/--kv-transfer/--tier/"
                   "--min-replicas/--max-replicas/--tenant-budgets are "
                   "api-mode flags")
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
    """The JAX server's refusals of a scheduler over a cluster or over more
    than the tp axis, in its words (JAX apps/api_server.py:1680-1693): the
    slot scheduler's engine is single-process and composes with --tp
    only, on the single-supervisor tier."""
    if args.mode == "api" and args.serve_batch and args.nnodes > 1:
        sys.exit("error: --serve-batch does not compose with --nnodes")
    if args.mode == "api" and args.serve_batch and max(
            getattr(args, a) for a in ("dp", *NEW_AXES)) > 1:
        sys.exit("error: --serve-batch needs a single-process engine "
                 "(no --dp/--sp/--ep/--pp; --tp composes)")
    if args.mode == "api" and args.serve_batch and args.tp > 1 and (
            args.replicas > 1 or args.replica_procs or args.replica_hosts):
        sys.exit("error: --serve-batch with --tp serves the "
                 "single-supervisor tier only (no --replicas/"
                 "--replica-procs/--replica-hosts)")


def check_fleet_flags(args) -> dict:
    """The JAX server's refusals of the replica tier, the transfer plane
    and the fleet flags, in its words and order (JAX
    apps/api_server.py:1747-1900), before any engine work. Returns the
    resolved tier: replicas, replica_procs, replica_hosts [(host, port)]
    or None, kv_transfer, tiers (a role a replica) or None."""
    serve_batch = args.serve_batch
    slo = args.slo_ttft_ms is not None or args.slo_itl_ms is not None
    replicas = 1 if args.replicas is None else args.replicas
    if replicas < 1:
        sys.exit("error: --replicas must be >= 1")
    replica_procs = args.replica_procs or 0
    hosts_raw = args.replica_hosts
    if replica_procs < 0:
        sys.exit("error: --replica-procs must be >= 1")
    if replica_procs and hosts_raw:
        sys.exit("error: --replica-procs (local spawn) and "
                 "--replica-hosts (connect to pre-started workers) are "
                 "mutually exclusive")
    process_tier = bool(replica_procs or hosts_raw)
    if process_tier and replicas > 1:
        sys.exit("error: --replicas (thread tier) does not compose with "
                 "--replica-procs/--replica-hosts (process tier) — pick "
                 "one replication boundary")
    if process_tier and args.nnodes > 1:
        sys.exit("error: --replica-procs/--replica-hosts do not compose "
                 "with --nnodes (each worker is its own single-host "
                 "engine; see ROADMAP item 2 for the composition)")
    if hosts_raw and args.draft:
        sys.exit("error: --draft does not reach --replica-hosts workers "
                 "(their configs are their operators'): pass --draft in "
                 "each worker's own config instead")
    if hosts_raw and slo:
        sys.exit("error: --slo-ttft-ms/--slo-itl-ms do not reach "
                 "--replica-hosts workers (their configs are their "
                 "operators'): set the SLOs in each worker's own config "
                 "instead")
    if (serve_batch == "auto" or args.prefix_blocks == "auto") \
            and process_tier:
        sys.exit("error: --serve-batch/--prefix-blocks 'auto' need a "
                 "ledger-capable local engine; the process tier's "
                 "workers own their engines — pass explicit sizes "
                 "(calibrate with tools/autotune.py and use its "
                 "recommendation)")
    if not serve_batch and (replicas > 1 or process_tier
                            or args.retry_budget is not None
                            or args.route_policy is not None):
        sys.exit("error: --replicas/--replica-procs/--replica-hosts/"
                 "--retry-budget/--route-policy require --serve-batch N "
                 "(the failover router fronts the continuous-batching "
                 "scheduler)")
    if replicas == 1 and not process_tier and (
            args.retry_budget is not None or args.route_policy is not None):
        sys.exit("error: --retry-budget/--route-policy have no effect "
                 "without --replicas N > 1 or a process tier")
    kv_transfer = bool(args.kv_transfer)
    if kv_transfer and not args.prefix_cache:
        sys.exit("error: --kv-transfer moves published prefix-cache "
                 "blocks and requires --prefix-cache")
    n_fleet = (int(replica_procs) if replica_procs
               else len(str(hosts_raw).split(",")) if hosts_raw
               else int(replicas))
    if kv_transfer and n_fleet < 2:
        sys.exit("error: --kv-transfer needs >= 2 replicas "
                 "(--replicas N, --replica-procs N, or --replica-hosts "
                 "h:p,...) — one replica has no sibling to transfer "
                 "with")
    tiers = None
    if args.tier is not None:
        if not kv_transfer:
            sys.exit("error: --tier requires --kv-transfer (a prefill-"
                     "tier replica is useless unless its blocks can "
                     "move to the decode tier)")
        if hosts_raw:
            sys.exit("error: --tier does not reach --replica-hosts "
                     "workers (their configs are their operators'): "
                     "set `tier` in each worker's own config — the "
                     "router adopts it from the health PONG")
        n_rep = int(replica_procs) if replica_procs else int(replicas)
        tiers = [t.strip() for t in str(args.tier).split(",")]
        if len(tiers) == 1:
            tiers = tiers * n_rep
        if len(tiers) != n_rep:
            sys.exit(f"error: --tier lists {len(tiers)} roles for "
                     f"{n_rep} replicas (one value, or one per replica)")
        bad = [t for t in tiers if t not in ("prefill", "decode", "mixed")]
        if bad:
            sys.exit(f"error: --tier roles must be prefill|decode|"
                     f"mixed (got {bad[0]!r})")
        if all(t == "prefill" for t in tiers):
            sys.exit("error: --tier needs at least one decode or mixed "
                     "replica (prefill-tier replicas never serve "
                     "requests)")
    min_reps, max_reps = args.min_replicas or 0, args.max_replicas or 0
    if min_reps < 0 or max_reps < 0:
        sys.exit("error: --min-replicas/--max-replicas must be >= 1")
    if (min_reps or max_reps) and not serve_batch:
        sys.exit("error: --min-replicas/--max-replicas require "
                 "--serve-batch N (the fleet controller scales the "
                 "replica set behind the scheduler front door)")
    if min_reps and max_reps and min_reps > max_reps:
        sys.exit(f"error: --min-replicas {min_reps} exceeds "
                 f"--max-replicas {max_reps}")
    if max_reps and hosts_raw:
        sys.exit("error: autoscaling does not reach --replica-hosts "
                 "workers (their lifetimes are their operators'): the "
                 "controller can only spawn/reap locally supervised "
                 "replicas (--replicas/--replica-procs)")
    if max_reps and max_reps > n_fleet and not (replicas > 1
                                                or replica_procs):
        sys.exit("error: --max-replicas needs a replica tier to grow "
                 "(--replicas N or --replica-procs N)")
    if args.tenant_budgets is not None:
        if not serve_batch:
            sys.exit("error: --tenant-budgets requires --serve-batch N "
                     "(weighted-fair queueing replaces the scheduler's "
                     "FIFO admission queue)")
        if hosts_raw:
            sys.exit("error: --tenant-budgets does not reach "
                     "--replica-hosts workers (their configs are their "
                     "operators'): set tenant_budgets in each worker's "
                     "own config instead")
        from ..runtime.fleet import parse_tenant_budgets

        try:
            parse_tenant_budgets(args.tenant_budgets)
        except ValueError as e:
            sys.exit(f"error: --tenant-budgets: {e}")
    replica_hosts = None
    if hosts_raw:
        replica_hosts = []
        for spec in str(hosts_raw).split(","):
            host, _, port = spec.strip().rpartition(":")
            if not host or not port.isdigit():
                sys.exit(f"error: --replica-hosts entry {spec.strip()!r} "
                         "is not host:port")
            replica_hosts.append((host, int(port)))
    return {"replicas": replicas, "replica_procs": replica_procs,
            "replica_hosts": replica_hosts, "kv_transfer": kv_transfer,
            "tiers": tiers}


def check_cluster_flags(args) -> None:
    """The JAX CLI's cluster refusals, in its words and order (JAX
    apps/dllama.py:793-808, :1044, :1341-1385), before any model load or
    cluster work; and a mesh whose ranks do not split evenly over the
    nodes."""
    if args.session and args.nnodes > 1:
        sys.exit("error: --session does not compose with --nnodes > 1 — "
                 "a multi-process mesh's cache shards are not addressable "
                 "from one host")
    if args.nnodes <= 1:
        if args.mode == "worker":
            sys.exit("error: worker mode needs a cluster — pass --nnodes N "
                     "--node-rank r --coordinator host:port (single-host "
                     "multi-device runs need no workers: use --tp N)")
        return
    if not args.coordinator:
        sys.exit("error: --nnodes > 1 requires --coordinator host:port")
    if args.mode == "worker" and args.node_rank == 0:
        sys.exit("error: rank 0 is the root — run a non-worker mode")
    if args.mode != "worker" and args.node_rank != 0:
        sys.exit("error: non-root ranks must run `dllama worker`")
    if args.heartbeat_interval <= 0 or args.worker_timeout <= 0:
        sys.exit("error: --heartbeat-interval and --worker-timeout "
                 "must be positive")
    if args.worker_timeout < 2 * args.heartbeat_interval:
        # healthy workers produce frames only in answer to PINGs: a bound
        # under ~2 pings declares live nodes dead on one late heartbeat
        sys.exit(f"error: --worker-timeout {args.worker_timeout:g} "
                 "must be at least 2x --heartbeat-interval "
                 f"({args.heartbeat_interval:g}) — a node is only "
                 "expected to produce a frame per heartbeat, so a "
                 "tighter bound declares healthy peers lost "
                 "(recommended: 3-5x)")
    if args.mode in ("inference", "generate"):
        if args.device_sampling:
            sys.exit("error: --device-sampling does not compose with "
                     "--nnodes (the worker protocol drives generate())")
        if args.lookup_decode and args.dp > 1:
            # the worker's lookup replay is single-row
            sys.exit("error: --lookup-decode with --dp does not compose "
                     "with --nnodes")
    if args.mode == "chat" and args.lookup_decode:
        sys.exit("error: --lookup-decode does not compose with --nnodes")
    world = world_size(args)
    if world % args.nnodes:
        sys.exit(f"error: the mesh's {world} ranks do not split evenly "
                 f"over --nnodes {args.nnodes} (each node runs the same "
                 "number of ranks)")


def check_session_flags(args) -> None:
    """--session needs a host-fetchable, stage-flat KV cache: save_session
    fetches it to the host, which a multi-process mesh or a stage-stacked
    pp cache cannot give. Fails before any engine work (JAX
    apps/dllama.py:716)."""
    if getattr(args, "session", None) and (args.nnodes > 1 or args.pp > 1):
        sys.exit("error: --session does not compose with --nnodes or --pp")


class FrontDoorTemplate:
    """The slice of the Engine surface a PROCESS-TIER api front end reads
    (the spec, the context, the device its workers use; no mesh, no
    cache), built by ``build_front_template`` WITHOUT loading weights: the
    worker processes own the model (JAX apps/dllama.py:675)."""

    mesh = None

    def __init__(self, spec, max_seq_len=None, device=None):
        self.spec = spec
        self.seq_len = min(max_seq_len or spec.seq_len, spec.seq_len)
        self.device = device


def build_front_template(args):
    """model file -> (shape template, tokenizer, sampler) for the process
    replica tier (api --replica-procs/--replica-hosts): reads only the .m
    header, no weights and no engine (JAX apps/dllama.py:688). The
    device is the workers': `cuda` raises here without a card, before
    any worker is spawned."""
    from ..io.model_file import read_spec
    from ..quants.types import FloatType
    from ..runtime.engine import resolve_device
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
          f"seq={spec.seq_len} (front door: spec only, workers own the "
          "weights)")
    tokenizer = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(tokenizer.vocab_size, args.temperature, args.topp,
                      seed)
    return (FrontDoorTemplate(spec, args.max_seq_len, device), tokenizer,
            sampler)


def build_engine(args, mesh=None):
    """model file -> (engine, tokenizer, sampler); over a mesh, this rank's
    engine from its shard of the file (JAX apps/dllama.py:609-660). Over
    nodes, the JAX startup on every rank, in one order whatever the
    rank's flags (JAX :524-582, :628-669): the spec broadcast, the config
    fingerprint check, the weights (with --push-weights from rank 0's
    broadcast), then the sampler seed from the root."""
    from ..io.model_file import content_fingerprint, read_spec
    from ..models.loader import load_params_streamed
    from ..parallel import multihost as mh
    from ..parallel.mesh import describe
    from ..parallel.sharding import (check_axis_constraints,
                                     loader_placement, vocab_splits)
    from ..quants.types import FloatType
    from ..runtime.engine import Engine, resolve_device
    from ..sampler import Sampler
    from ..tokenizer import Tokenizer

    multihost = mh.is_multihost(mesh)
    # root-push: only rank 0 reads the .m; the workers get the spec and
    # the weights over the broadcast
    pushed_worker = args.push_weights and multihost and mh.cluster_rank() > 0
    if (not args.model and not pushed_worker) or not args.tokenizer:
        sys.exit("error: --model and --tokenizer are required "
                 "(--model optional for --push-weights workers)")
    device = resolve_device(args.device)
    wft = (FloatType[args.weights_float_type.upper()]
           if args.weights_float_type else None)
    if multihost:
        # on every cluster startup, push or not, so the collective sequence
        # does not depend on a rank's flags (multihost.bcast_spec)
        if mh.cluster_rank() == 0:
            spec = read_spec(args.model, weights_float_type=wft)
            model_fp = content_fingerprint(args.model)
            mh.bcast_spec(spec, model_fp, push=args.push_weights)
        else:
            rspec, rfp, _ = mh.bcast_spec(None)
            if pushed_worker:
                spec, model_fp = rspec, rfp
            else:
                spec = read_spec(args.model, weights_float_type=wft)
                model_fp = content_fingerprint(args.model)
        _check_cluster_config(args, spec, model_fp)
    else:
        spec = read_spec(args.model, weights_float_type=wft)
        model_fp = content_fingerprint(args.model)
    print(f"⏩ {args.model or '<pushed>'}: arch={spec.arch.name} "
          f"dim={spec.dim} layers={spec.n_layers} "
          f"heads={spec.n_heads}/{spec.n_kv_heads} seq={spec.seq_len} "
          f"device={device}")
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
    # with --push-weights over nodes, rank 0 streams its file into the
    # broadcast and every rank keeps its shards of the same stream
    tensors = (mh.bcast_model_tensors(spec, args.model or None)
               if args.push_weights and multihost else None)
    try:
        params, lstats = load_params_streamed(spec, args.model, device,
                                              dtype=cdt, tensors=tensors,
                                              **place)
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
                    model_fingerprint=model_fp)
    tokenizer = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    if multihost:
        # one sampler stream cluster-wide: every rank reproduces the root's
        # draws (the default seed is the clock, which differs per node)
        seed = mh.broadcast_seed(seed)
    sampler = Sampler(tokenizer.vocab_size, args.temperature, args.topp, seed)
    return engine, tokenizer, sampler


def _check_cluster_config(args, spec, model_fp: int) -> None:
    """Every rank's model, tokenizer and engine flags against rank 0's, as
    the JAX CLI checks them (apps/dllama.py:568-606): a node with other
    files or flags would compute other shapes and wait in a mismatched
    collective, so a mismatch is an error on every rank at once."""
    import dataclasses
    import zlib

    from ..parallel.multihost import check_config

    spec_fp = zlib.crc32(repr(dataclasses.astuple(spec)).encode())
    with open(args.tokenizer, "rb") as f:
        tok_fp = zlib.crc32(f.read())
    check_config([spec_fp, model_fp, tok_fp,
                  args.tp, args.dp, args.sp, args.ep, args.pp,
                  int(args.buffer_float_type == "q80"),
                  int(args.compute_dtype == "bf16"),
                  ["bf16", "f32", "f8"].index(args.cache_dtype),
                  args.max_seq_len if args.max_seq_len is not None else -1,
                  # the JAX CLI's kernel switch, always its default here
                  2,
                  # api mode samples with each node's own flags
                  int(np.float32(args.temperature).view(np.int32)),
                  int(np.float32(args.topp).view(np.int32)),
                  # and speculates with each node's own --lookup-decode
                  args.lookup_decode,
                  int(args.push_weights)])


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
        _announce_run(engine, tokens, _steps(args, engine), sampler=sampler,
                      lookup=args.lookup_decode)
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
        _announce_run(engine, tokens, _steps(args, engine), sampler=sampler)
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
    _announce_run(engine, tokens, _steps(args, engine), sampler=sampler)
    res = engine.generate(tokens, _steps(args, engine), sampler,
                          eos_id=tokenizer.stop_token_ids(), on_token=on_token)
    print()
    if benchmark:
        _print_benchmark(engine, res)


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
    if draft is None:
        # a cluster's workers replay the lookup run from its header
        _announce_run(engine, tokens, _steps(args, engine), sampler=sampler,
                      lookup=args.lookup_decode)
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


def _print_benchmark(engine, res) -> None:
    """Per-token G/I/T/H/S lines and the averages, in the JAX CLI's text
    (apps/dllama.py:975-1037; ref: dllama.cpp:47-48,74-91): S the modeled
    kB a rank sends a decoded token (Engine.wire_estimate), T the timed
    collectives' estimate (Engine.measure_transfer_ms; the first line,
    the prefill, measure_prefill_transfer_ms), then the kB by collective.
    On one device both are 0, as in the JAX text. A cluster's workers run
    the same measure sequence (MSG_XFER_BENCH carries n_prompt): a measure
    the workers skipped would leave the root waiting in a collective."""
    from ..parallel import multihost as mh

    wire = engine.wire_estimate()
    n_prompt = max(engine.pos - (len(res.tokens) - 1), 1)
    if mh.is_multihost(engine.mesh):
        mh.set_phase("bench")
        mh.send_xfer_bench(n_prompt)
    t_ms = engine.measure_transfer_ms()
    t_pre_ms = engine.measure_prefill_transfer_ms(n_prompt)
    for i, s in enumerate(res.stats.steps):
        tv = t_pre_ms if i == 0 else t_ms
        print(f"🔶 G {s.generation_ms:7.2f} ms I {s.device_ms:7.2f} ms "
              f"T {tv:6.2f} ms H {s.host_ms:5.2f} ms "
              f"S {wire.sent_kb_per_token:7.1f} kB")
    avg = res.stats.averages()
    print(f"Generated tokens:    {len(res.tokens)}")
    print(f"Avg tokens / second: {1000.0 / max(avg.generation_ms, 1e-9):.2f}")
    print(f"Avg generation time: {avg.generation_ms:.2f} ms")
    print(f"Avg inference time:  {avg.device_ms:.2f} ms")
    print(f"Avg transfer (est):  {t_ms:.2f} ms, "
          f"{wire.sent_kb_per_token:.1f} kB/token/device")
    for kname, kb in wire.breakdown.items():
        print(f"  {kname}: {kb:.1f} kB")
    print(f"Avg sampling time:   {avg.host_ms:.2f} ms")


def _announce_run(engine, tokens: list[int], max_tokens: int,
                  sampler=None, lookup: int = 0, reset: bool = False) -> None:
    """The root's side of the cluster protocol (JAX apps/dllama.py:737):
    tell the workers to enter the same run — the prompt, the budget, the
    sampler's temperature, top-p and current RNG state, the lookup draft
    length (0: plain) — before the root enters it. With the flight
    recorder on, the run rides one minted trace id, under which the
    workers ship their spans back (MSG_TRACE). No-op off a cluster."""
    from ..parallel import multihost as mh
    from ..runtime.trace import TRACER

    if not mh.is_multihost(engine.mesh):
        return
    tid = 0
    if TRACER.enabled:
        tid = TRACER.new_id()
        link = mh.get_link()
        if link is not None:
            link.trace_tid = tid
        TRACER.event("cluster_tick", tid, phase="run", role="root", rank=0,
                     n_prompt=len(tokens))
    mh.set_phase("run")
    mh.send_run(tokens, max_tokens, sampler.rng_state if sampler else 0,
                sampler.temperature if sampler else 0.0,
                sampler.topp if sampler else 0.0, reset, lookup=lookup,
                trace_tid=tid)


def cmd_worker(args, mesh) -> None:
    """A rank of a cluster other than the root (JAX apps/dllama.py:1152):
    build this rank's engine, then replay what the root announces until it
    shuts down — RUN (a plain, lookup or sampled generate, with the root's
    sampler parameters and RNG state from the header), API (the root's
    request, replayed from its body through the legacy completion loop),
    XFER_BENCH (the benchmark's measure sequence). Per-token sync is not
    needed: every rank reads the same logits and draws the same tokens."""
    from ..parallel import multihost as mh
    from ..runtime.trace import TRACER
    from ..sampler import Sampler

    if args.trace:
        # a ring only: the spans ship root-ward after each run
        TRACER.configure(capacity=args.trace_buffer or 8192, enabled=True)
    engine, tokenizer, sampler = build_engine(args, mesh)
    stops = tokenizer.stop_token_ids()
    api_state = None
    node, nnodes = mh.cluster_rank() * args.nnodes // mesh.world, args.nnodes
    print(f"⏳ worker rank {node} of {nnodes} ready", flush=True)
    while True:
        mh.set_phase("idle")
        # a root that dies or wedges surfaces as ClusterPeerLost within
        # --worker-timeout (the link's receiver thread exits 43 itself when
        # this thread waits in a collective)
        msg = mh.recv_msg()
        if msg.kind == mh.MSG_SHUTDOWN:
            print("🔌 root shut down — exiting", flush=True)
            return
        if msg.kind == mh.MSG_RUN:
            mh.set_phase("run")
            tid = msg.trace_tid
            t_run = time.perf_counter()
            if TRACER.enabled and tid:
                TRACER.reserve(tid)
                link = mh.get_link()
                if link is not None:
                    link.trace_tid = tid
                TRACER.event("cluster_tick", tid, phase="run", role="worker",
                             rank=node, n_prompt=len(msg.tokens or ()))
            if msg.reset:
                engine.reset()
            if msg.lookup and msg.temperature > 0:
                engine.generate_lookup_sampled(
                    msg.tokens, msg.max_tokens, temperature=msg.temperature,
                    topp=msg.topp, seed=msg.seed, eos_id=stops,
                    draft_len=msg.lookup, vocab_size=tokenizer.vocab_size)
            elif msg.lookup:
                engine.generate_lookup(msg.tokens, msg.max_tokens,
                                       eos_id=stops, draft_len=msg.lookup,
                                       vocab_size=tokenizer.vocab_size)
            else:
                run_sampler = Sampler(tokenizer.vocab_size, msg.temperature,
                                      msg.topp, msg.seed)
                if engine.batch > 1:
                    engine.generate_batch([msg.tokens] * engine.batch,
                                          msg.max_tokens, run_sampler,
                                          eos_id=stops)
                else:
                    engine.generate(msg.tokens, msg.max_tokens, run_sampler,
                                    eos_id=stops)
            if TRACER.enabled and tid:
                TRACER.event("cluster_tick", tid, phase="run_done",
                             role="worker", rank=node,
                             ms=round((time.perf_counter() - t_run) * 1e3, 3))
                link = mh.get_link()
                if link is not None and hasattr(link, "ship_trace"):
                    link.ship_trace(TRACER.export_span(tid))
        elif msg.kind == mh.MSG_API:
            mh.set_phase("api")
            import json

            from .api_server import ApiState, PromptTooLong, _completion_chunks

            if api_state is None:
                api_state = ApiState(engine, tokenizer, sampler,
                                     lookup_decode=args.lookup_decode)
            try:
                for _ in _completion_chunks(api_state, json.loads(msg.body)):
                    pass
            except (PromptTooLong, json.JSONDecodeError, KeyError,
                    TypeError) as e:
                # the root raised the same error at the same point
                print(f"⚠️  request failed: {type(e).__name__}: {e}")
            # any other failure is this node's alone (a kernel, memory):
            # the root may be inside this request's collectives, where no
            # resync can line them up again, so it ends this process and
            # the root's link reports ClusterPeerLost (exit 43 everywhere)
        elif msg.kind == mh.MSG_XFER_BENCH:
            # the root's _print_benchmark sequence: decode, then prefill
            # for the header's n_prompt
            mh.set_phase("bench")
            engine.measure_transfer_ms()
            engine.measure_prefill_transfer_ms(max(msg.max_tokens, 1))
            mh.set_phase("idle")


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
                _announce_run(engine, tokens, budget, sampler=sampler)
                res = engine.generate(tokens, budget, sampler, eos_id=stops,
                                      on_token=on_token)
            convo.extend(res.tokens)
            print()
            if args.session:
                engine.save_session(args.session, tokens=convo)


def node_main(argv: list[str]) -> None:
    """One rank of a cluster (every rank of every node runs this once the
    process group is joined): its mesh, then the root (global rank 0) runs
    the mode and every other rank the worker loop. The root's clean end
    sends SHUTDOWN, which reaches the workers wherever they wait (after a
    crash the heartbeat's EOF tells them instead)."""
    from ..parallel import multihost as mh
    from ..parallel.mesh import make_mesh

    args = build_argparser().parse_args(argv)
    mh.set_phase("load")
    mesh = make_mesh(**mesh_axes(args), device_type=args.device)
    if mh.cluster_rank() != 0:
        cmd_worker(args, mesh)
        return
    if args.mode in ("inference", "generate"):
        cmd_generate(args, benchmark=args.mode == "inference", mesh=mesh)
    elif args.mode == "chat":
        cmd_chat(args, mesh=mesh)
    else:
        from .api_server import serve

        serve(args, mesh=mesh)
    mh.send_shutdown()


def _run_cluster(args, argv: list[str]) -> None:
    """This node of a cluster (JAX apps/dllama.py:1366-1421): form the star
    and join the process group, then run this node's ranks. A formation
    failure prints one `🔴 cluster formation failed` line and exits 44; a
    lost node, one `🔴 cluster: {...}` line and exit 43 (from the link's
    detection thread, armed before the rendezvous, or here when the
    driving thread saw it first)."""
    import json

    from ..parallel import multihost as mh
    from ..parallel.launch import run_node
    from ..utils.device import resolve_device

    resolve_device(args.device)         # no card: raise before any spawn
    try:
        run_node(args.nnodes, args.node_rank, world_size(args),
                 args.coordinator, args.device,
                 "distributed_llama_tpu_torch.apps.dllama:node_main",
                 (argv,), RANK_TIMEOUT_S,
                 connect_timeout=args.connect_timeout,
                 heartbeat_interval=args.heartbeat_interval,
                 worker_timeout=args.worker_timeout)
    except mh.ClusterProtocolError as e:
        print(f"🔴 cluster formation failed: {e}", flush=True)
        sys.exit(mh.EXIT_FORMATION)
    except Exception as e:
        # a collective over a dead peer's socket fails about as fast as
        # the link sees the EOF: the link's verdict decides whether this
        # is a lost node (exit 43) or a failure of this one
        lost = (e if isinstance(e, mh.ClusterPeerLost) else
                mh.await_peer_lost(args.worker_timeout
                                   + args.heartbeat_interval))
        if lost is None:
            raise
        print("🔴 cluster: " + json.dumps(lost.summary()), flush=True)
        sys.exit(mh.EXIT_PEER_LOST)
    finally:
        mh.close_link()


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.workers:
        # the JAX CLI's refusal (apps/dllama.py:1286-1290), for a GPU
        sys.exit("error: --workers is not applicable on a GPU — the "
                 "reference's TCP root/worker star has no counterpart "
                 "here; use --tp N and --dp M, which start one rank "
                 "process a GPU of this host (or ranks sharing one), or "
                 "--nnodes/--coordinator + `dllama worker` processes for a "
                 "multi-host cluster")
    check_admission_flags(args)
    check_spec_flags(args)
    check_mesh_flags(args)
    check_serve_flags(args)
    check_cluster_flags(args)
    check_session_flags(args)
    refused = refusals(args)
    if refused:
        sys.exit("error: " + "; ".join(refused))
    if args.mode == "api":
        check_fleet_flags(args)
    if args.nnodes > 1:
        _run_cluster(args, list(argv if argv is not None else sys.argv[1:]))
        return
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
