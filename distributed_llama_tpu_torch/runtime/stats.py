"""Per-step timing stats and the serving counters.

Parity with the reference's benchmark surface: per-token G/I lines and
end-of-run averages (ref: src/apps/dllama/dllama.cpp:47-91). The port's copy
of the JAX package's runtime/stats.py, for what the port runs: StepStats and
RunStats (generation wall ms (G), device-step ms (I, the step up to its
logits on the host — the copy is the sync point), host overhead ms), and the
serving records of the scheduler and its supervisor (RequestStats,
ServeStats, SupervisorStats, percentile). The step timeline (it belongs to
the flight recorder, which comes with the --trace flags) and the
speculative, prefix-cache, router, cluster, transfer and fleet records are
not ported: the port serves none of those yet.
"""

from __future__ import annotations

import dataclasses
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
        return {
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
