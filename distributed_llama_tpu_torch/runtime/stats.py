"""Per-step timing stats and the serving counters.

Parity with the reference's benchmark surface: per-token G/I lines and
end-of-run averages (ref: src/apps/dllama/dllama.cpp:47-91). The port's copy
of the JAX package's runtime/stats.py, for what the port runs: StepStats and
RunStats (generation wall ms (G), device-step ms (I, the step up to its
logits on the host — the copy is the sync point), host overhead ms), and the
serving records of the scheduler, its supervisor, the radix prefix
cache and speculative decoding (RequestStats, ServeStats, SupervisorStats,
PrefixCacheStats, SpecStats, percentile), and the flight recorder's step
timeline (StepTimelineStats, owned by runtime/trace.Tracer). The router,
cluster, transfer and fleet records are not ported: the port serves none
of those yet.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque


@dataclasses.dataclass
class StepStats:
    generation_ms: float = 0.0  # wall time of the whole token step (G)
    device_ms: float = 0.0      # device execution + logits D2H transfer (I) —
                                # the transfer is the sync point, so it cannot
                                # be separated from device time
    host_ms: float = 0.0        # host-side sampling/bookkeeping


@dataclasses.dataclass
class RunStats:
    steps: list[StepStats] = dataclasses.field(default_factory=list)

    def add(self, s: StepStats) -> None:
        self.steps.append(s)

    def averages(self, skip_first: int = 1) -> StepStats:
        """Average over steps, skipping warmup/compile steps (the reference
        averages all 16 samples; we exclude the compile step)."""
        body = self.steps[skip_first:] or self.steps
        n = len(body)
        return StepStats(
            generation_ms=sum(s.generation_ms for s in body) / n,
            device_ms=sum(s.device_ms for s in body) / n,
            host_ms=sum(s.host_ms for s in body) / n,
        )


# -- serving (continuous-batching scheduler) counters ----------------------


def percentile(xs: list, p: float):
    """Nearest-rank percentile over a small sample (None when empty): p50
    of [1, 2] is one of the observed values, never an invented 1.5. p is
    clamped to [0, 100]: p0 is the min, p100 the max."""
    if not xs:
        return None
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
    return xs[k]


@dataclasses.dataclass
class RequestStats:
    """One request's serving latencies (runtime/scheduler.py): TTFT is
    submit -> first emitted token (queue wait and prefill included — what a
    client sees), ITL the mean gap between its later tokens."""

    n_prompt: int = 0
    n_out: int = 0
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None
    # the request's speculative record (runtime/draft.py): verify forwards
    # it rode, draft tokens proposed for it and how many were accepted
    # (the aggregate twin: SpecStats)
    spec_forwards: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def ttft_ms(self) -> float | None:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3

    @property
    def itl_ms(self) -> float | None:
        if self.t_first is None or self.t_done is None or self.n_out < 2:
            return None
        return (self.t_done - self.t_first) / (self.n_out - 1) * 1e3


@dataclasses.dataclass
class SpecStats:
    """Aggregate speculative-decoding counters (the `spec` /stats block and
    the dllama_spec_* /metrics family), owned by the Scheduler, or by the
    API server's legacy path. Attached even with drafting off (mode "off",
    zeros): a tier never loses a metric family to a launch flag. Lifetime:
    one scheduler generation, like ServeStats."""

    mode: str = "off"          # off | self<d> | model | lookup | the --draft
    draft_len: int = 0
    verify_forwards: int = 0   # verify forwards dispatched
    draft_forwards: int = 0    # draft dispatches (a proposal or a chunk)
    drafted: int = 0           # draft tokens proposed (speculating rows)
    accepted: int = 0          # draft tokens the verify confirmed
    emitted_spec: int = 0      # tokens emitted by speculating rows
    # decode iterations run without speculation although a draft is
    # armed: the SLO admission policy's "no speculation" actuator
    # (runtime/scheduler.AdmissionPolicy.spec_allowed) held it off
    degraded_steps: int = 0

    def summary(self) -> dict:
        return {
            "mode": self.mode,
            "draft_len": self.draft_len,
            "verify_forwards": self.verify_forwards,
            "draft_forwards": self.draft_forwards,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "emitted_spec": self.emitted_spec,
            "accept_rate": (round(self.accepted / self.drafted, 4)
                            if self.drafted else None),
            "tokens_per_verify": (round(self.emitted_spec
                                        / self.verify_forwards, 3)
                                  if self.verify_forwards else None),
            "degraded_steps": self.degraded_steps,
        }


class StepTimelineStats:
    """Per-batch-composition step-duration windows (owned by
    runtime/trace.Tracer): every scheduler iteration records its wall ms
    keyed by (decode_rows, prefill_rows, chunk), the ``dllama_step_ms``
    /metrics family and the ``step_timeline`` /stats block. Bounded:
    ``window`` samples a composition, at most ``max_keys`` compositions."""

    def __init__(self, window: int = 4096, max_keys: int = 256):
        self.window = int(window)
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        self._hist: dict[tuple, deque] = {}  # guarded by self._lock
        self.overflow = 0  # samples dropped past max_keys

    def record(self, decode_rows: int, prefill_rows: int, chunk: int,
               wall_ms: float) -> None:
        key = (int(decode_rows), int(prefill_rows), int(chunk))
        with self._lock:
            d = self._hist.get(key)
            if d is None:
                if len(self._hist) >= self.max_keys:
                    self.overflow += 1
                    return
                d = self._hist[key] = deque(maxlen=self.window)
            d.append(wall_ms)

    def summary(self) -> dict:
        """{(dec, pre, chunk): {n, p50_ms, p99_ms, mean_ms}} over the
        windows, busiest composition first."""
        with self._lock:
            items = [(k, list(d)) for k, d in self._hist.items()]
        out = {}
        for key, xs in sorted(items, key=lambda kv: -len(kv[1])):
            out[key] = {
                "n": len(xs),
                "p50_ms": round(percentile(xs, 50), 4),
                "p99_ms": round(percentile(xs, 99), 4),
                "mean_ms": round(sum(xs) / len(xs), 4),
            }
        return out

    def summary_json(self) -> dict:
        """summary() with string keys ("dec4_pre1_c16"): tuple keys do not
        survive json.dumps."""
        return {f"dec{k[0]}_pre{k[1]}_c{k[2]}": v
                for k, v in self.summary().items()}


@dataclasses.dataclass
class ServeStats:
    """Scheduler-level serving counters: lifetime totals plus bounded
    sliding windows (`window` newest entries) of per-iteration occupancy
    and queue depth and of per-request latency records."""

    window: int = 10_000
    requests_submitted: int = 0
    requests_finished: int = 0
    tokens_out: int = 0
    steps: int = 0
    # failed/expired also count toward requests_finished (every submitted
    # request gets exactly one terminal event); rejected = refused at
    # submit() by the queue bound, so not in requests_submitted
    requests_failed: int = 0
    requests_expired: int = 0
    requests_rejected: int = 0
    # attached by the Scheduler when the radix prefix cache is on: its
    # summary rides the same /stats payload as a `prefix_cache` block
    prefix: "PrefixCacheStats | None" = None
    # attached by the Scheduler when an SLO arms the admission policy
    # (runtime/scheduler.AdmissionPolicy): its chunk width, EWMAs and
    # transition counters ride /stats as an `admission` block
    admission: object | None = None
    # always attached by the Scheduler (mode "off" without a draft)
    spec: SpecStats | None = None

    def __post_init__(self):
        self.requests = deque(maxlen=self.window)   # RequestStats records
        self.occupancy = deque(maxlen=self.window)  # live slots, per step
        self.queue_depth = deque(maxlen=self.window)

    def summary(self) -> dict:
        """JSON-ready snapshot (GET /stats): percentiles and occupancy over
        the window, totals over the lifetime."""
        ttfts = [r.ttft_ms for r in self.requests if r.ttft_ms is not None]
        itls = [r.itl_ms for r in self.requests if r.itl_ms is not None]
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        out = {
            "requests_submitted": self.requests_submitted,
            "requests_finished": self.requests_finished,
            "requests_failed": self.requests_failed,
            "requests_expired": self.requests_expired,
            "requests_rejected": self.requests_rejected,
            "tokens_out": self.tokens_out,
            "ttft_p50_ms": rnd(percentile(ttfts, 50)),
            "ttft_p99_ms": rnd(percentile(ttfts, 99)),
            "itl_p50_ms": rnd(percentile(itls, 50)),
            "itl_p99_ms": rnd(percentile(itls, 99)),
            "mean_slot_occupancy": rnd(sum(self.occupancy)
                                       / len(self.occupancy))
            if self.occupancy else 0.0,
            "max_queue_depth": max(self.queue_depth, default=0),
            "steps": self.steps,
        }
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.summary()
        if self.admission is not None:
            out["admission"] = self.admission.summary()
        if self.spec is not None:
            out["spec"] = self.spec.summary()
        return out


@dataclasses.dataclass
class PrefixCacheStats:
    """Counters owned by runtime/prefix_cache.PrefixCache. Lifetime = one
    (engine, scheduler) generation: the arena dies with the engine, so a
    supervisor rebuild starts these at zero (a fresh empty tree reads as
    a 0% hit rate until it re-warms)."""

    num_blocks: int = 0
    block_len: int = 0
    lookups: int = 0           # admissions checked against the tree
    hits: int = 0              # admissions seeded from >= 1 cached block
    tokens_saved: int = 0      # prompt tokens seeded instead of prefilled
    tokens_prefilled: int = 0  # prompt tokens actually prefilled
    blocks_published: int = 0
    evictions: int = 0         # unreferenced LRU leaves freed for reuse
    publish_drops: int = 0     # publishes cut short: the pool held only
    # referenced blocks (eviction never frees a pinned block)
    invalidations: int = 0     # whole-tree resets (abort, rebuild, close)
    blocks_in_use: int = 0     # gauge: pool blocks the tree references

    def summary(self) -> dict:
        rnd = lambda v: None if v is None else round(v, 4)  # noqa: E731
        seen = self.tokens_saved + self.tokens_prefilled
        return {
            "num_blocks": self.num_blocks,
            "block_len": self.block_len,
            "blocks_in_use": self.blocks_in_use,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": rnd(self.hits / self.lookups) if self.lookups
            else None,
            "tokens_saved": self.tokens_saved,
            # not in the JAX summary, whose /metrics so never shows the
            # tokens_prefilled family it declares
            "tokens_prefilled": self.tokens_prefilled,
            "prefill_saved_frac": rnd(self.tokens_saved / seen) if seen
            else None,
            "blocks_published": self.blocks_published,
            "evictions": self.evictions,
            "publish_drops": self.publish_drops,
            "invalidations": self.invalidations,
        }


@dataclasses.dataclass
class SupervisorStats:
    """Resilience counters owned by runtime/resilience.EngineSupervisor;
    they survive rebuilds (each recovery makes a fresh Scheduler and
    ServeStats, these accumulate across generations)."""

    crashes: int = 0          # step-loop exceptions caught
    watchdog_trips: int = 0   # stalls detected by the watchdog
    recoveries: int = 0       # successful rebuilds back to ready
    consecutive_failures: int = 0
    rejected_unready: int = 0  # submits refused while recovering/broken

    def __post_init__(self):
        # failure-detected -> ready-again latency
        self.recovery_ms = deque(maxlen=1000)

    def summary(self) -> dict:
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        return {
            "crashes": self.crashes,
            "watchdog_trips": self.watchdog_trips,
            "recoveries": self.recoveries,
            "consecutive_failures": self.consecutive_failures,
            "rejected_unready": self.rejected_unready,
            "recovery_p50_ms": rnd(percentile(list(self.recovery_ms), 50)),
            "recovery_p99_ms": rnd(percentile(list(self.recovery_ms), 99)),
        }
