"""autotune — the card's own batch-knee calibration, written as a versioned
artifact: the port of the repo's tools/autotune.py onto the port's Engine,
Scheduler, PrefixCache and TRACER.

For each batch size B the sweep serves B concurrent requests through a
fresh B-slot scheduler (one full-width prefill chunk each, then a pure
decode phase at occupancy B) and reads the flight recorder's
per-composition step windows; the decode-only composition
``dec{B}_pre0_c0`` is the curve point, and tools/dlprof.py's knee
estimator fits the knee. On the largest batch it also measures:

  * the adaptive chunk-width ladder (``scheduler.chunk_ladder``): each
    width's prefill forward, all rows gated, timed with CUDA events on the
    card (host clock on the CPU): the data behind the SLO policy's
    shrink/widen trade;
  * the prefix-cache pass: the same trace served again with a shared
    prefix through a radix cache.

The artifact keeps the JAX package's schema (``validate_autotune`` in
runtime/profiler.py and tools/dlprof.py accept it). ``backend`` is
``"cuda"`` or ``"cpu"``; where the JAX artifact has ``"jax"``, this one
has ``"torch"`` (the version) and ``"device"`` (the device's name and, on
the card, its power limit). ``dllama api --serve-batch auto --autotune
FILE`` sizes the server from it; ``tools/dlprof.py --autotune FILE``
compares it with a live trace.

Weights are synthetic Q40 (step time does not depend on their values),
built once from a seed at the packed-byte level on the device and shared
by every batch size. ``--model 7b`` and ``--model moe`` are the full-width
Llama-2-7B and a 4-layer Mixtral 8x7B; ``--model tiny`` is a small model
for the CPU (``--device cpu``).

Usage (on the card):
  python -m distributed_llama_tpu_torch.tools.autotune --model 7b \\
      --out AUTOTUNE.cuda.json
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from . import dlprof

AUTOTUNE_KIND = dlprof.AUTOTUNE_KIND
AUTOTUNE_VERSION = dlprof.AUTOTUNE_VERSION
DEFAULT_BATCHES = (2, 4, 8, 16, 32, 64, 128)
# small batches anchor the knee criterion: dlprof's marginal-throughput
# test references the SMALL-batch per-row throughput, so a grid that
# starts at an amortized batch calls the knee one rung early


def model_spec(model: str):
    """The calibration's model table (models/bench_specs.py: TINY,
    LLAMA2_7B and MIXTRAL_MOE)."""
    from ..models import bench_specs

    table = {"7b": bench_specs.LLAMA2_7B, "moe": bench_specs.MIXTRAL_MOE,
             "tiny": bench_specs.TINY}
    if model not in table:
        raise ValueError(f"unknown model {model!r} (tiny, 7b, moe)")
    return table[model]


def device_info(device) -> dict:
    """The device's name and, on the card, its power limit as nvidia-smi
    reports it (None where nvidia-smi does not answer)."""
    import torch

    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    limit = None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        limit = res.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(device), "power_limit": limit}


def build_artifact(*, model: str, backend: str, torch_version: str,
                   device: dict, chunk: int, seq_len: int,
                   steps_per_batch: int, decode_curve: list[dict],
                   prefill_ms_by_width: dict | None = None,
                   prefix: dict | None = None, hbm: dict | None = None,
                   created_unix: float | None = None) -> dict:
    """Fit the knee to the measured points and assemble the artifact (pure:
    the tests build one from synthetic timings)."""
    curve = [(int(p["rows"]), float(p["p50_ms"])) for p in decode_curve
             if p.get("p50_ms")]
    knee = dlprof.knee_estimate(sorted(curve))
    art = {
        "kind": AUTOTUNE_KIND,
        "version": AUTOTUNE_VERSION,
        "created_unix": (time.time() if created_unix is None
                         else created_unix),
        "model": model,
        "backend": backend,
        "torch": torch_version,
        "device": device,
        "chunk": int(chunk),
        "seq_len": int(seq_len),
        "steps_per_batch": int(steps_per_batch),
        "decode_curve": decode_curve,
        "prefill_ms_by_width": prefill_ms_by_width or {},
        "prefix": prefix or {},
        "knee": knee,
        "recommendation": dlprof.serve_batch_recommendation(knee, hbm),
        "hbm": hbm,
    }
    problems = dlprof.validate_autotune(art)
    if problems:
        raise ValueError("calibration produced an invalid artifact: "
                         + "; ".join(problems))
    return art


def _sweep_batch(spec, params, b: int, *, chunk: int, steps: int, device,
                 dtype, seq: int, prefix_block_len: int = 16,
                 with_prefix: bool = False) -> dict:
    """Serve one batch size through a real scheduler and return its
    per-composition step timeline (and the prefix cache's stats when
    asked). With `with_prefix` the engine and its cache come back too: the
    caller ledgers them and times the ladder on them."""
    import numpy as np

    from ..runtime.engine import Engine
    from ..runtime.prefix_cache import PrefixCache
    from ..runtime.scheduler import Scheduler
    from ..runtime.trace import TRACER
    from ..sampler import Sampler

    eng = Engine(spec, params, device=device, compute_dtype=dtype,
                 cache_dtype=dtype, max_seq_len=seq, batch=b,
                 activation_q80=True)
    pc = None
    if with_prefix:
        pc = PrefixCache(eng, num_blocks=max(2 * b, 8)
                         * (chunk // prefix_block_len + 1),
                         block_len=prefix_block_len)
    sched = Scheduler(eng, chunk=chunk, prefix_cache=pc)
    sched.warmup()

    def greedy():
        return Sampler(spec.vocab_size, temperature=0.0, topp=0.9, seed=7)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, spec.vocab_size, chunk).tolist()
    if with_prefix:
        # a shared-prefix trace: request 0 publishes, the rest seed
        prompts = [shared + rng.integers(1, spec.vocab_size, 4).tolist()
                   for _ in range(b)]
        prime = sched.submit(prompts[0], 2, greedy())
        while not prime.finished.is_set():
            sched.step()
    else:
        # one full-width chunk each: every request prefills in one
        # (B, chunk) forward, then decodes `steps` tokens at occupancy B
        prompts = [rng.integers(1, spec.vocab_size, chunk).tolist()
                   for _ in range(b)]

    TRACER.reset()
    TRACER.configure(capacity=8192, decode_every=1 << 30)
    try:
        live = [sched.submit(p, steps, greedy()) for p in prompts]
        guard = 0
        while not all(r.finished.is_set() for r in live):
            sched.step()
            guard += 1
            if guard >= 100 * (steps + chunk):
                raise RuntimeError(f"batch {b}: the sweep did not drain")
        timeline = TRACER.steps.summary_json()
    finally:
        TRACER.reset()
        sched.close()
    out = {"timeline": timeline}
    if pc is not None:
        out["prefix_stats"] = pc.stats.summary()
    if with_prefix:
        out["engine"], out["pc"] = eng, pc
    else:
        eng.release()
    return out


def prefill_ladder_ms(engine, chunk: int, repeats: int = 5) -> dict:
    """The best of `repeats` times of each ladder width's prefill forward,
    all rows gated (the cache is untouched; the work is a live chunk's):
    {str(width): ms}. On the card each call is timed between CUDA events
    on the current stream; on the CPU by the host clock (the call returns
    when its work is done)."""
    import numpy as np
    import torch

    from ..runtime.scheduler import chunk_ladder

    gate = np.full((engine.batch,), engine.seq_len, np.int32)
    zl = np.zeros((engine.batch,), np.int32)
    on_card = engine.device.type == "cuda"
    out = {}
    for w in chunk_ladder(chunk):
        tok = np.zeros((engine.batch, w), np.int32)
        engine.slot_prefill_chunk(tok, gate, zl)  # warm, off the clock
        best = None
        for _ in range(repeats):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                engine.slot_prefill_chunk(tok, gate, zl)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                engine.slot_prefill_chunk(tok, gate, zl)
                dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        out[str(w)] = round(best, 4)
    return out


def calibrate(*, model: str = "tiny", batches=DEFAULT_BATCHES,
              chunk: int = 32, steps: int = 32, seq: int | None = None,
              device: str = "cuda", spec=None, params=None,
              seed: int = 0, log=print) -> dict:
    """Run the sweep and return the artifact. `spec`/`params` override
    the model table and the synthetic weights."""
    import torch

    from ..models.params import synthetic_q40_params
    from ..runtime.engine import resolve_device
    from ..runtime.profiler import hbm_ledger

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if spec is None:
        spec = model_spec(model)
    if params is None:
        params = synthetic_q40_params(spec, seed=seed, device=dev,
                                      dtype=dtype)
    seq = int(seq or min(256, spec.seq_len))
    batches = sorted({int(b) for b in batches})
    decode_curve = []
    largest = None
    for b in batches:
        t0 = time.perf_counter()
        res = _sweep_batch(spec, params, b, chunk=chunk, steps=steps,
                           device=dev, dtype=dtype, seq=seq,
                           with_prefix=(b == batches[-1]))
        comp = res["timeline"].get(f"dec{b}_pre0_c0")
        if comp:
            decode_curve.append({"rows": b, "p50_ms": comp["p50_ms"],
                                 "mean_ms": comp["mean_ms"],
                                 "n": comp["n"]})
        log(f"autotune: batch {b}: "
            f"{comp['p50_ms'] if comp else None} ms/step p50 "
            f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
        if b == batches[-1]:
            largest = res
    eng = largest["engine"]
    hbm = hbm_ledger(eng, largest.get("pc"))
    ladder_ms = prefill_ladder_ms(eng, chunk)
    art = build_artifact(
        model=model, backend=dev.type, torch_version=torch.__version__,
        device=device_info(dev), chunk=chunk, seq_len=seq,
        steps_per_batch=steps, decode_curve=decode_curve,
        prefill_ms_by_width=ladder_ms,
        prefix={"timeline": largest["timeline"],
                "stats": largest.get("prefix_stats")},
        hbm=hbm)
    eng.release()
    del largest, eng
    gc.collect()
    return art


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="autotune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="tiny", choices=["tiny", "7b", "moe"],
                    help="model table entry (synthetic Q40 weights: step "
                         "time does not depend on their values)")
    ap.add_argument("--batches", default=",".join(map(str,
                                                      DEFAULT_BATCHES)),
                    help="comma list of batch sizes to sweep")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk width (the adaptive ladder's "
                         "widest rung)")
    ap.add_argument("--steps", type=int, default=32,
                    help="decode steps measured per batch size")
    ap.add_argument("--seq", type=int, default=None,
                    help="engine context for the sweep (default: "
                         "min(256, model seq_len))")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", required=True,
                    help="artifact path (AUTOTUNE.json is the JAX "
                         "package's calibration; write the card's "
                         "elsewhere, e.g. AUTOTUNE.cuda.json)")
    args = ap.parse_args(argv)
    batches = [int(x) for x in str(args.batches).split(",") if x.strip()]
    if not batches:
        ap.error("--batches must name at least one batch size")
    art = calibrate(model=args.model, batches=batches, chunk=args.chunk,
                    steps=args.steps, seq=args.seq, device=args.device)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
        f.write("\n")
    rec = art["recommendation"]
    print(f"autotune: wrote {args.out} — knee={art['knee']['knee_rows']} "
          f"rows ({art['knee']['method']}), recommended --serve-batch "
          f"{rec['serve_batch']}"
          + (f" (HBM caps at {rec['hbm_cap_rows']})"
             if rec.get("hbm_cap_rows") is not None else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
