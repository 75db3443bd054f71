"""dllama CLI of the port — modes `inference` and `generate`.

Counterpart of the JAX package's apps/dllama.py (ref:
src/apps/dllama/dllama.cpp):

  inference  prompt completion with a per-token benchmark line and end-of-run
             averages (ref: dllama.cpp:43-91)
  generate   plain streaming completion (ref: dllama.cpp:96-131)

    python -m distributed_llama_tpu_torch.apps.dllama inference \\
        --model m.m --tokenizer t.t --prompt "Hello" --steps 32

Runs Llama, Mixtral and Grok-1 `.m` files on `--device cuda` (the
default) or `--device cpu`; `--cache-dtype f8` keeps the KV cache in fp8
(e4m3). Flags of features the port does not have yet — the chat/api/worker
modes, mesh axes, --buffer-float-type q80, clusters — are accepted by the
parser only to be refused with a message, never silently ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CACHE_DTYPES = {**DTYPES, "f8": torch.float8_e4m3fn}
PORTED_MODES = ("inference", "generate")


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
    p.add_argument("--buffer-float-type", default="f32", choices=["f32", "q80"],
                   help="activation dtype between layers; only f32 is ported")
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
    if args.buffer_float_type == "q80":
        out.append("--buffer-float-type q80: the Q80 activation round trip "
                   "is not ported yet")
    return out


def build_engine(args):
    """model file -> (engine, tokenizer, sampler)."""
    from ..io.model_file import read_spec
    from ..models.loader import load_params_streamed
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
                    cache_dtype=CACHE_DTYPES[args.cache_dtype])
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


def cmd_generate(args, benchmark: bool) -> None:
    engine, tokenizer, sampler = build_engine(args)
    tokens = tokenizer.encode(args.prompt or "Hello")
    print(f"💡 prompt tokens: {len(tokens)}")
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
    cmd_generate(args, benchmark=args.mode == "inference")


if __name__ == "__main__":
    main()
