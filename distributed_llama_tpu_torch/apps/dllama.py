"""dllama CLI of the port — modes `inference`, `generate` and `api`.

Counterpart of the JAX package's apps/dllama.py (ref:
src/apps/dllama/dllama.cpp):

  inference  prompt completion with a per-token benchmark line and end-of-run
             averages (ref: dllama.cpp:43-91)
  generate   plain streaming completion (ref: dllama.cpp:96-131)
  api        the OpenAI-compatible HTTP server (apps/api_server.py); with
             --serve-batch B, the continuous-batching scheduler over B
             slots under its supervisor

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
and prints its tokens when the loop ends, as the JAX CLI does. Flags of
features the port does not have yet — the chat and worker modes, mesh
axes, clusters, and the serving features listed in UNPORTED_FLAGS — are
accepted by the parser only to be refused with a message, never silently
ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CACHE_DTYPES = {**DTYPES, "f8": torch.float8_e4m3fn}
PORTED_MODES = ("inference", "generate", "api")
# serving flags of the JAX CLI that the port does not have yet, with the
# ROADMAP item that brings each (refused with that message when given)
_SPEC = "speculation (ROADMAP item 12)"
_FLEET = "replicas and the fleet (ROADMAP item 16)"
_EXTRAS = "serving extras (ROADMAP item 10c)"
UNPORTED_FLAGS = {
    "--lookup-decode": _SPEC, "--draft": _SPEC, "--draft-len": _SPEC,
    "--session": "session files (ROADMAP item 12)",
    "--prefix-cache": "the prefix cache (ROADMAP item 9)",
    "--prefix-blocks": "the prefix cache (ROADMAP item 9)",
    "--prefix-block-len": "the prefix cache (ROADMAP item 9)",
    "--replicas": _FLEET, "--retry-budget": _FLEET, "--route-policy": _FLEET,
    "--replica-procs": _FLEET, "--replica-hosts": _FLEET,
    "--kv-transfer": _FLEET, "--tier": _FLEET, "--min-replicas": _FLEET,
    "--max-replicas": _FLEET, "--tenant-budgets": _FLEET,
    "--slo-ttft-ms": _EXTRAS, "--slo-itl-ms": _EXTRAS, "--autotune": _EXTRAS,
    "--admin-token": _EXTRAS, "--trace": _EXTRAS, "--trace-buffer": _EXTRAS,
    "--trace-dir": _EXTRAS, "--trace-sample": _EXTRAS,
    "--trace-decode-every": _EXTRAS, "--freeze-compiles": _EXTRAS,
    "--profile-sample": _EXTRAS, "--profile-dir": _EXTRAS,
}
_FLAG_SWITCHES = ("--prefix-cache", "--kv-transfer", "--trace",
                  "--freeze-compiles")


def _serve_batch(v: str) -> int:
    if v == "auto":
        raise argparse.ArgumentTypeError(
            "--serve-batch auto is not ported yet (auto-sizing, ROADMAP "
            "item 10c): give the number of slots")
    n = int(v)
    if n < 0:
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
    p.add_argument("--compute-dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--cache-dtype", default="bf16",
                   choices=["bf16", "f32", "f8"])
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--buffer-float-type", default="q80", choices=["f32", "q80"],
                   help="activation buffers: q80 (the default) round-trips "
                        "every matmul input of a Q40 model through Q80")
    p.add_argument("--device-sampling", action="store_true",
                   help="run the whole sampled decode loop on the device "
                        "(temperature/top-p and the reference's xorshift "
                        "stream in a replayed CUDA graph that stops at eos; "
                        "no host round trip per token). Output prints "
                        "after the loop")
    # api mode (JAX apps/dllama.py's defaults)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--serve-batch", type=_serve_batch, default=0, metavar="B",
                   help="api: serve through the continuous-batching "
                        "scheduler with B KV slots (0 = requests serialize "
                        "on one engine)")
    p.add_argument("--serve-chunk", type=int, default=0, metavar="C",
                   help="api: the scheduler's prefill chunk (0 = the "
                        "engine's, 256)")
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
    for flag in UNPORTED_FLAGS:
        if flag in _FLAG_SWITCHES:
            p.add_argument(flag, action="store_true", default=None,
                           help="not ported yet")
        else:
            p.add_argument(flag, default=None, help="not ported yet")
    for axis in ("tp", "dp", "sp", "ep", "pp"):
        p.add_argument(f"--{axis}", type=int, default=1,
                       help="mesh axis; only 1 is ported")
    p.add_argument("--nnodes", type=int, default=1,
                   help="cluster size; only 1 is ported")
    return p


def refusals(args) -> list[str]:
    """Every flag of a feature the port does not have yet, as a message."""
    out = []
    if args.mode not in PORTED_MODES:
        out.append(f"mode {args.mode!r} is not ported yet (ported: "
                   f"{', '.join(PORTED_MODES)})")
    for axis in ("tp", "dp", "sp", "ep", "pp"):
        if getattr(args, axis) != 1:
            out.append(f"--{axis} {getattr(args, axis)}: meshes are not "
                       "ported yet (one device only)")
    if args.nnodes != 1:
        out.append("--nnodes: multi-host clusters are not ported yet")
    for flag, why in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            out.append(f"{flag}: {why} is not ported yet")
    if args.mode != "api" and (args.serve_batch or args.serve_chunk
                               or args.queue_depth or args.request_deadline
                               or args.stall_timeout):
        out.append("--serve-batch/--serve-chunk/--queue-depth/"
                   "--request-deadline/--stall-timeout are api-mode flags")
    if args.serve_batch == 0 and (args.serve_chunk or args.queue_depth
                                  or args.request_deadline
                                  or args.stall_timeout):
        out.append("--serve-chunk/--queue-depth/--request-deadline/"
                   "--stall-timeout configure the scheduler and need "
                   "--serve-batch B")
    return out


def build_engine(args):
    """model file -> (engine, tokenizer, sampler)."""
    from ..io.model_file import read_spec
    from ..models.loader import load_params_streamed
    from ..quants.types import FloatType
    from ..runtime.engine import Engine, resolve_device
    from ..sampler import Sampler
    from ..tokenizer import Tokenizer

    if not args.model or not args.tokenizer:
        sys.exit("error: --model and --tokenizer are required")
    device = resolve_device(args.device)
    spec = read_spec(args.model)
    print(f"⏩ {args.model}: arch={spec.arch.name} dim={spec.dim} "
          f"layers={spec.n_layers} heads={spec.n_heads}/{spec.n_kv_heads} "
          f"seq={spec.seq_len} device={device}")
    cdt = DTYPES[args.compute_dtype]
    t0 = time.perf_counter()
    params, lstats = load_params_streamed(spec, args.model, device, dtype=cdt)
    print(f"⏩ loaded {lstats.total_bytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f}s (peak host "
          f"{lstats.peak_host_bytes / 1e6:.0f} MB)")
    engine = Engine(spec, params, device=device,
                    max_seq_len=args.max_seq_len, compute_dtype=cdt,
                    cache_dtype=CACHE_DTYPES[args.cache_dtype],
                    # JAX apps/dllama.py:651: Q80 activations for Q40 weights
                    activation_q80=(args.buffer_float_type == "q80"
                                    and spec.weights_float_type == FloatType.Q40))
    tokenizer = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(tokenizer.vocab_size, args.temperature, args.topp, seed)
    return engine, tokenizer, sampler


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


def cmd_generate(args, benchmark: bool) -> None:
    engine, tokenizer, sampler = build_engine(args)
    tokens = tokenizer.encode(args.prompt or "Hello")
    print(f"💡 prompt tokens: {len(tokens)}")
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

    res = engine.generate(tokens, _steps(args, engine), sampler,
                          eos_id=tokenizer.stop_token_ids(), on_token=on_token)
    print()
    if benchmark:
        _print_benchmark(res)


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


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    refused = refusals(args)
    if refused:
        sys.exit("error: " + "; ".join(refused))
    if args.mode == "api":
        from .api_server import serve

        serve(args)
        return
    cmd_generate(args, benchmark=args.mode == "inference")


if __name__ == "__main__":
    main()
