"""Where a decode token's time goes on the card, kernel by kernel.

Counterpart of the JAX repository's tools/exp_decode_profile.py: after a
FILL-token prompt, N_STEPS decode steps of a Q40 model (Engine.step, each
a replay of the captured decode graph, then its logits read as generate
reads them) run under torch.profiler, and the device time of every kernel
is summed by group (`group`, rewritten for CUDA kernel names):

  K1        the Q40 matmul (q40_gemv1_kernel, q40_gemv_mma_kernel, q40_matmul_wgmma_kernel,
            q40_matmul_kernel)
  K3        flash attention (flash_mma_kernel, flash_f32_kernel and the
            split's flash_merge_kernel)
  Q80       the standalone Q80 round trip (q80_roundtrip_kernel; at t = 1
            the round trip runs inside K1)
  torch:*   PyTorch's own kernels, split by what they do (elementwise,
            reduce, index/copy of the cache, gemm, cat, argmax/sort, ...)
  memcpy    device copies and sets (the logits read, the step's inputs)
  gaps      the steps' time between CUDA events, timed without the
            profiler, less the kernels' busy time under it: where the
            device waits for the host

    python -m distributed_llama_tpu_torch.tools.exp_decode_profile [--device cuda|cpu]

The engine is the CLI's for a Q40 model (bf16, Q80 activations). On the
CPU the profiler sees no device: the tool prints the host ms/token only.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from ..models import bench_specs
from ..models.params import synthetic_q40_params
from ..runtime.engine import Engine
from ..utils.device import resolve_device
from .timing import card_label

N_STEPS = 32
FILL = 256

# PyTorch kernel families, by a piece of their CUDA names (checked in order)
_TORCH_GROUPS = (
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas", "sm90_", "splitk")),
    ("index/copy", ("index", "scatter", "gather", "copy_", "direct_copy")),
    ("cat", ("cat", "catarray")),
    ("argmax/sort", ("argmax", "arg_max", "sort", "topk", "radix")),
    ("reduce", ("reduce", "norm", "softmax", "sum_", "mean")),
    ("rope/trig", ("sin", "cos", "polar")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
    ("fill", ("fill",)),
)


def group(name: str) -> str:
    """Collapse a CUDA kernel name into a readable bucket."""
    n = name.lower()
    if "q40_" in n:
        return "K1"
    if "flash_" in n:
        return "K3"
    if "q80_roundtrip" in n:
        return "Q80"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    for label, keys in _TORCH_GROUPS:
        if any(k in n for k in keys):
            return f"torch:{label}"
    return "torch:other"


def _steps(engine, toks: list[int], n: int) -> None:
    for i in range(n):
        engine.fetch_logits(engine.step(np.asarray([[toks[i % len(toks)]]], np.int32),
                                        engine.pos))


def run(*, spec=None, params=None, device: str = "cuda", card: str | None = None,
        n_steps: int = N_STEPS, fill: int = FILL) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    card = card or card_label(dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    spec = spec or bench_specs.LLAMA2_7B
    if params is None:
        params = synthetic_q40_params(spec, seed=0, device=dev, dtype=dtype)
    engine = Engine(spec, params, device=dev, compute_dtype=dtype, cache_dtype=dtype,
                    max_seq_len=min(spec.seq_len, fill + 3 * n_steps + 8),
                    activation_q80=True)
    prompt = np.random.default_rng(0).integers(1, spec.vocab_size, fill).tolist()
    engine.prefill(prompt)
    _steps(engine, prompt, 2)                   # capture, off the clock
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])

    def timed(run) -> float:
        """ms a step of n_steps steps: CUDA events on the card, the host
        clock on the CPU."""
        if on_card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n_steps
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3 / n_steps
    # the step's time without the profiler; the split under it (the
    # profiler's own host work widens the gaps it sees)
    wall_ms = timed(lambda: _steps(engine, prompt, n_steps))
    with profile(activities=activities) as prof:
        profiled_ms = timed(lambda: _steps(engine, prompt, n_steps))
    per_group: collections.Counter = collections.Counter()
    per_kernel: collections.Counter = collections.Counter()
    launches: collections.Counter = collections.Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3 / n_steps
        per_group[group(e.key)] += ms
        per_kernel[e.key[:100]] += ms
        launches[group(e.key)] += e.count / n_steps
    busy = sum(per_group.values())
    torch_ms = sum(v for k, v in per_group.items() if k.startswith("torch:"))
    out = {"ms_per_token": wall_ms, "ms_per_token_profiled": profiled_ms,
           "device_busy_ms": busy if busy else None,
           "gaps_ms": (wall_ms - busy) if busy else None,
           "torch_kernels_ms": torch_ms if busy else None,
           "groups": dict(per_group), "launches_per_step": dict(launches),
           "top": per_kernel.most_common(15), "steps": n_steps, "fill": fill,
           "device": dev.type, "card": card}
    print(f"[exp_decode_profile] decode: {wall_ms:.3f} ms/token over {n_steps} steps at "
          f"fill {fill} ({profiled_ms:.3f} under the profiler) [{card}]", flush=True)
    if not busy:
        print("[exp_decode_profile] the profiler recorded no device time: "
              "split not measured", flush=True)
    else:
        print(f"[exp_decode_profile] device busy {busy:.3f} ms/token, gaps "
              f"{wall_ms - busy:.3f} ms/token without the profiler, PyTorch's own "
              f"kernels {torch_ms:.3f} ms/token [{card}]", flush=True)
        for g, v in per_group.most_common():
            print(f"[exp_decode_profile]   {g:22s} {v:7.3f} ms/token  "
                  f"x{launches[g]:7.1f} launches", flush=True)
        for k, v in per_kernel.most_common(15):
            print(f"[exp_decode_profile]   {v:7.4f}  {k}", flush=True)
    engine.release()
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="LLAMA2_7B", choices=sorted(bench_specs.BENCH_SPECS))
    args = ap.parse_args(argv)
    return run(spec=bench_specs.BENCH_SPECS[args.model], device=args.device)


if __name__ == "__main__":
    main()
