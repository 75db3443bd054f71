"""Per-step timing stats and the serving counters.

Parity with the reference's benchmark surface: per-token G/I lines and
end-of-run averages (ref: src/apps/dllama/dllama.cpp:47-91). The port's copy
of the JAX package's runtime/stats.py, for what the port runs: StepStats and
RunStats (generation wall ms (G), device-step ms (I, the step up to its
logits on the host — the copy is the sync point), host overhead ms), and the
serving records of the scheduler, its supervisor, the radix prefix
cache and speculative decoding (RequestStats, ServeStats, SupervisorStats,
PrefixCacheStats, SpecStats, percentile), and the flight recorder's step
timeline (StepTimelineStats, owned by runtime/trace.Tracer), and the
multi-node control star's records (WireStats, the measured wire ledger,
and ClusterStats, owned by parallel/multihost's links), and the fleet's
records: RouterStats (runtime/router.Router), ProcStats (a process
replica's supervision), KVTransferStats (the block-transfer plane,
runtime/kv_transfer.py) and FleetStats (runtime/fleet.FleetController).
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
        self._hist: dict[tuple, deque] = {}  # dlrace: guarded-by(self._lock)
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
    cluster_losses: int = 0    # a cluster node lost (trip_cluster)

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
            "cluster_losses": self.cluster_losses,
            "recovery_p50_ms": rnd(percentile(list(self.recovery_ms), 50)),
            "recovery_p99_ms": rnd(percentile(list(self.recovery_ms), 99)),
        }


class WireStats:
    """Measured control-plane wire ledger bytes and frames per
    (peer, MSG kind, direction) plus per-peer PING→PONG round-trip
    histograms and the midpoint clock-offset estimate — owned by
    parallel/multihost's link objects, which account every codec
    send/recv through :meth:`account`. MEASURED, not modeled: a torn
    frame counts exactly the bytes that actually crossed the socket
    (the fault sites fire inside the codec, so the ledger sees the same
    partial writes the peer does). Kind labels are the MSG_* names (a
    small closed set), peers are ranks — cardinality is bounded by
    protocol design, but a ``max_keys`` bound backs that up. Rendered
    as the ``wire`` block of the cluster /stats summary and the
    ``dllama_wire_bytes_total{peer,kind,dir}`` /
    ``dllama_heartbeat_rtt_ms{peer}`` /metrics families (the JAX
    package's runtime/stats.py WireStats, copied)."""

    def __init__(self, window: int = 512, max_keys: int = 64,
                 recent: int = 32):
        import threading
        from collections import deque  # noqa: F401 — used in rtt()

        self.window = int(window)
        self.max_keys = int(max_keys)
        self.recent = int(recent)
        self._lock = threading.Lock()
        # peer -> {"tx"|"rx" -> {kind_name -> [frames, bytes]}}
        self._counts: dict[int, dict] = {}  # dlrace: guarded-by(self._lock)
        self._rtt: dict[int, object] = {}  # dlrace: guarded-by(self._lock)
        self._offset: dict[int, float] = {}  # dlrace: guarded-by(self._lock)
        self._best_rtt: dict[int, float] = {}  # dlrace: guarded-by(self._lock)
        self.key_overflow = 0

    def account(self, peer: int, kind: str, direction: str,
                nbytes: int, frames: int = 1) -> None:
        """One codec send/recv: ``nbytes`` actually moved (0 is skipped —
        nothing crossed the wire). Cheap by design: a dict walk and two
        int adds under one lock, on control-plane frames only (heartbeat
        cadence, never per decoded token)."""
        if nbytes <= 0:
            return
        with self._lock:
            dirs = self._counts.setdefault(int(peer), {})
            kinds = dirs.setdefault(direction, {})
            rec = kinds.get(kind)
            if rec is None:
                if len(kinds) >= self.max_keys:
                    self.key_overflow += 1
                    return
                rec = kinds[kind] = [0, 0]
            rec[0] += int(frames)
            rec[1] += int(nbytes)

    def rtt(self, peer: int, ms: float,
            offset_s: float | None = None) -> None:
        """One PING→PONG round trip. The clock offset rides the BEST
        (minimum-RTT) sample seen so far — the standard NTP-style pick:
        the smaller the round trip, the tighter the midpoint bounds the
        remote clock."""
        from collections import deque

        with self._lock:
            d = self._rtt.get(int(peer))
            if d is None:
                d = self._rtt[int(peer)] = deque(maxlen=self.window)
            d.append(float(ms))
            if offset_s is not None:
                best = self._best_rtt.get(int(peer))
                if best is None or ms <= best:
                    self._best_rtt[int(peer)] = float(ms)
                    self._offset[int(peer)] = float(offset_s)

    def clock_offset_s(self, peer: int) -> float | None:
        """Best-sample estimate of (peer wall clock − local wall clock),
        seconds — what MSG_TRACE ingestion subtracts to rebase a worker's
        wall-stamped span onto the root timeline."""
        with self._lock:
            return self._offset.get(int(peer))

    def total_bytes(self, direction: str) -> int:
        with self._lock:
            return sum(rec[1]
                       for dirs in self._counts.values()
                       for kind in (dirs.get(direction) or {},)
                       for rec in kind.values())

    def peer_bytes(self, peer: int, kind: str, direction: str) -> int:
        """Exact measured bytes for one (peer, kind, dir) — the
        reconciliation tests compare this against frame-size
        arithmetic."""
        with self._lock:
            rec = ((self._counts.get(int(peer)) or {})
                   .get(direction) or {}).get(kind)
            return rec[1] if rec else 0

    def summary(self) -> dict:
        with self._lock:
            peers = {}
            for peer in sorted(set(self._counts) | set(self._rtt)):
                rec: dict = {}
                dirs = self._counts.get(peer) or {}
                for d in ("tx", "rx"):
                    kinds = dirs.get(d)
                    if kinds:
                        rec[d] = {k: {"frames": v[0], "bytes": v[1]}
                                  for k, v in sorted(kinds.items())}
                rtts = list(self._rtt.get(peer) or ())
                if rtts:
                    rec["rtt_ms"] = {
                        "n": len(rtts),
                        "p50_ms": round(percentile(rtts, 50), 4),
                        "p99_ms": round(percentile(rtts, 99), 4),
                        "mean_ms": round(sum(rtts) / len(rtts), 4),
                        # a short raw tail so offline consumers (the bench
                        # cluster row's step_timeline) can re-histogram
                        "recent": [round(v, 4) for v in rtts[-self.recent:]],
                    }
                off = self._offset.get(peer)
                if off is not None:
                    rec["clock_offset_ms"] = round(off * 1e3, 4)
                    rec["best_rtt_ms"] = round(self._best_rtt[peer], 4)
                peers[str(peer)] = rec
            out = {"peers": peers, "key_overflow": self.key_overflow}
        out["tx_bytes"] = self.total_bytes("tx")
        out["rx_bytes"] = self.total_bytes("rx")
        return out


@dataclasses.dataclass
class ClusterStats:
    """Control-plane counters owned by parallel/multihost's link objects
    (RootLink / WorkerLink): heartbeat traffic, formation retries, the
    measured wire ledger (:class:`WireStats`), startup data-plane
    broadcast timings, and the structured record of every peer loss.
    Surfaced as the ``cluster`` block of GET /stats on a multihost api
    root, and by the chaos harness (parallel/cluster_harness.py). The
    phase label is attached live by ``multihost.cluster_summary()`` — it
    belongs to the link, not here."""

    nnodes: int = 1
    node_rank: int = 0
    protocol_version: int = 0
    heartbeat_interval_s: float = 0.0
    worker_timeout_s: float = 0.0
    connect_retries: int = 0   # worker side: backoff attempts at formation
    pings_sent: int = 0        # root side
    pongs_received: int = 0    # root side
    pongs_sent: int = 0        # worker side
    frames_sent: int = 0       # protocol frames (excl. pings)
    frames_received: int = 0   # every frame (incl. heartbeat traffic)
    # startup data-plane timings (parallel/multihost.bcast_spec /
    # bcast_model_tensors — the collective weight push the heartbeat
    # covers but the wire ledger cannot count: torch.distributed owns
    # those bytes): wall ms per phase, plus the tensor bytes rank 0
    # streamed
    bcast_spec_ms: float | None = None
    bcast_tensors_ms: float | None = None
    bcast_tensors_bytes: int = 0

    def __post_init__(self):
        # ClusterPeerLost.summary() dicts, in detection order
        self.peers_lost: list = []
        self.wire = WireStats()

    def summary(self) -> dict:
        return {
            "nnodes": self.nnodes,
            "node_rank": self.node_rank,
            "protocol_version": self.protocol_version,
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "worker_timeout_s": self.worker_timeout_s,
            "connect_retries": self.connect_retries,
            "pings_sent": self.pings_sent,
            "pongs_received": self.pongs_received,
            "pongs_sent": self.pongs_sent,
            "frames_sent": self.frames_sent,
            "frames_received": self.frames_received,
            "bcast_spec_ms": self.bcast_spec_ms,
            "bcast_tensors_ms": self.bcast_tensors_ms,
            "bcast_tensors_bytes": self.bcast_tensors_bytes,
            "wire": self.wire.summary(),
            "peers_lost": list(self.peers_lost),
        }


@dataclasses.dataclass
class KVTransferStats:
    """Counters for the cross-replica KV block transfer plane
    (runtime/kv_transfer.py): cache FILLs on miss (a replica imports a
    sibling's published arena blocks instead of re-prefilling), the
    donor-side export serving, and the router's prefill/decode
    disaggregation handoffs. Owned by the party that does the work —
    the Router for thread-tier fills + disaggregation decisions, each
    worker's ReplicaServer for its own wire serving/fills — and surfaced
    as the ``kv_transfer`` /stats block + the ``dllama_kv_transfer_*``
    /metrics family in EVERY tier incl. idle (enabled=False, zeros:
    a tier must never lose a metric family to a launch flag).

    ``wire`` is a :class:`WireStats` ledger accounting the RMSG_BLOCK_*
    frames per (peer, kind, dir) — the same measured-bytes discipline as
    the cluster control plane, so ``netstats.reconcile_wire``
    can close measured-vs-modeled over block transfers too."""

    enabled: bool = False
    tier: str = "mixed"        # this party's role: prefill|decode|mixed
    block_len: int = 0
    block_bytes: int = 0       # one block's K+V payload bytes (exact)
    # importer side (cache FILL on miss)
    fills_requested: int = 0   # fill decisions / attempts
    fills_ok: int = 0          # >= 1 block actually imported
    fill_fallbacks: int = 0    # error/timeout/donor death -> re-prefill
    fill_misses: int = 0       # donor answered shorter than expected
    tokens_filled: int = 0     # prompt tokens imported instead of prefilled
    blocks_filled: int = 0
    bytes_rx: int = 0          # block payload bytes received
    # donor side (export serving)
    queries_served: int = 0
    query_misses: int = 0      # QUERY answered with nothing fetchable
    blocks_exported: int = 0
    bytes_tx: int = 0          # block payload bytes sent
    donor_aborts: int = 0      # exports cut short (peer death, error)
    # prefill/decode disaggregation (router-side)
    prefill_passes: int = 0          # prefill-tier passes completed
    prefill_pass_fallbacks: int = 0  # no prefill worker / pass failed ->
    #                                  unified mixed path
    shadow_truncates: int = 0        # stale shadow entries cleared by a
    #                                  QUERY miss answer (donor eviction)

    def __post_init__(self):
        import threading
        from collections import deque

        # whole-fill wall ms (connect -> last block imported)
        self.transfer_ms = deque(maxlen=1000)  # dlrace: guarded-by(self.lock)
        self.wire = WireStats()
        # counter mutations ride this lock (concurrent fills/donor
        # connections all write here; += on a dataclass int is a
        # read-modify-write that can drop counts under contention —
        # the same discipline RouterStats keeps via the router lock)
        self.lock = threading.Lock()

    def note_transfer_ms(self, ms: float) -> None:
        with self.lock:
            self.transfer_ms.append(float(ms))

    def summary(self) -> dict:
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        xs = list(self.transfer_ms)
        out = {
            "enabled": self.enabled,
            "tier": self.tier,
            "block_len": self.block_len,
            "block_bytes": self.block_bytes,
            "fills_requested": self.fills_requested,
            "fills_ok": self.fills_ok,
            "fill_fallbacks": self.fill_fallbacks,
            "fill_misses": self.fill_misses,
            "tokens_filled": self.tokens_filled,
            "blocks_filled": self.blocks_filled,
            "bytes_rx": self.bytes_rx,
            "queries_served": self.queries_served,
            "query_misses": self.query_misses,
            "blocks_exported": self.blocks_exported,
            "bytes_tx": self.bytes_tx,
            "donor_aborts": self.donor_aborts,
            "prefill_passes": self.prefill_passes,
            "prefill_pass_fallbacks": self.prefill_pass_fallbacks,
            "shadow_truncates": self.shadow_truncates,
            "transfer_p50_ms": rnd(percentile(xs, 50)),
            "transfer_p99_ms": rnd(percentile(xs, 99)),
        }
        wire = self.wire.summary()
        if wire.get("tx_bytes") or wire.get("rx_bytes"):
            out["wire"] = wire
        return out

    @staticmethod
    def merge(blocks: list) -> dict:
        """Sum a list of summary() dicts into one aggregate (the router's
        top-level block over its own counters + every worker's). Counters
        add; enabled/tier describe the aggregate; percentiles are not
        mergeable and report None unless exactly one side has them."""
        keys = ("fills_requested", "fills_ok", "fill_fallbacks",
                "fill_misses", "tokens_filled", "blocks_filled",
                "bytes_rx", "queries_served", "query_misses",
                "blocks_exported", "bytes_tx", "donor_aborts",
                "prefill_passes", "prefill_pass_fallbacks",
                "shadow_truncates")
        blocks = [b for b in blocks if isinstance(b, dict)]
        out = {k: sum(int(b.get(k) or 0) for b in blocks) for k in keys}
        out["enabled"] = any(b.get("enabled") for b in blocks)
        out["tier"] = "aggregate"
        out["block_len"] = max((int(b.get("block_len") or 0)
                                for b in blocks), default=0)
        out["block_bytes"] = max((int(b.get("block_bytes") or 0)
                                  for b in blocks), default=0)
        with_ms = [b for b in blocks
                   if b.get("transfer_p50_ms") is not None]
        out["transfer_p50_ms"] = (with_ms[0]["transfer_p50_ms"]
                                  if len(with_ms) == 1 else None)
        out["transfer_p99_ms"] = (with_ms[0].get("transfer_p99_ms")
                                  if len(with_ms) == 1 else None)
        return out


@dataclasses.dataclass
class FleetStats:
    """Counters owned by runtime/fleet.FleetController — the
    measurement→decision loop over the serving fleet: autoscale
    decisions (spawns, reaps, HBM-blocked refusals, spawn failures +
    backoff), the overload ladder's position, and door-level sheds by
    reason. Surfaced as the ``fleet`` /stats block + the
    ``dllama_fleet_*`` /metrics family in EVERY tier incl. idle
    (enabled=False, zeros: a tier must never lose a metric family to a
    launch flag); the per-tenant admitted/shed/budget ledger rides the
    same block from the controller's TenantLedger."""

    enabled: bool = False
    ticks: int = 0             # controller observation rounds
    pressure: float = 0.0      # last observed serve-tier pressure
    rung: int = 0              # overload ladder position (0 = healthy)
    target_replicas: int = 0   # what the controller wants
    scale_ups: int = 0         # replicas spawned into rotation
    scale_downs: int = 0       # replicas drained + reaped
    scale_blocked_hbm: int = 0  # spawns refused by the HBM ceiling
    spawn_failures: int = 0    # scale-up spawns that died (→ backoff)
    warm_fills: int = 0        # sibling KV fills into fresh replicas
    sheds: int = 0             # door rejections by the ladder
    clamped: int = 0           # admissions with max_tokens clamped

    def __post_init__(self):
        import threading

        # shed rejections keyed by ladder reason ("shed"/"prefix_only")
        self.sheds_by_reason: dict[str, int] = {}
        # counter mutations ride this lock (the controller thread, its
        # spawn/reap worker threads, and the API door all write here)
        self.lock = threading.Lock()

    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "ticks": self.ticks,
            "pressure": self.pressure,
            "rung": self.rung,
            "target_replicas": self.target_replicas,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_blocked_hbm": self.scale_blocked_hbm,
            "spawn_failures": self.spawn_failures,
            "warm_fills": self.warm_fills,
            "sheds": self.sheds,
            "clamped": self.clamped,
            "sheds_by_reason": dict(self.sheds_by_reason),
        }


@dataclasses.dataclass
class RouterStats:
    """Counters owned by runtime/router.Router — placement decisions,
    failover retries, and per-replica breaker events, surfaced as the
    ``router`` block of GET /stats (the per-replica supervisor summaries
    ride the same payload as a ``replicas`` list)."""

    replicas: int = 0
    policy: str = ""
    routed: int = 0             # successful placements (incl. retries)
    routed_cache_hit: int = 0   # placements won by a radix prefix match
    routed_affinity: int = 0    # placements won by session stickiness
    routed_fallback: int = 0    # least-loaded / round-robin placements
    retries: int = 0            # failover resubmits (pre-first-token)
    failovers_ok: int = 0       # retried requests that then completed
    midstream_failures: int = 0  # streams killed after >= 1 token: the
    # structured NON-retryable frame the client saw (the router never
    # silently replays a partially-delivered stream)
    breaker_trips: int = 0      # router-level circuit opens
    breaker_probes: int = 0     # half-open probe placements
    drains: int = 0             # per-replica drains (rolling restart)
    restarts: int = 0           # per-replica supervisor rebuilds
    no_replica_rejections: int = 0  # submits with NO routable replica

    def summary(self) -> dict:
        return {k: getattr(self, k) for k in (
            "replicas", "policy", "routed", "routed_cache_hit",
            "routed_affinity", "routed_fallback", "retries",
            "failovers_ok", "midstream_failures", "breaker_trips",
            "breaker_probes", "drains", "restarts",
            "no_replica_rejections")}


@dataclasses.dataclass
class ProcStats:
    """Process-supervision counters owned by
    runtime/router.RemoteReplicaHandle (local-spawn mode): every worker
    exit is CLASSIFIED (``classify_exit`` — ``signal:SIGKILL``,
    ``config_error``, ``fault_exit``, ...) and the respawn-to-routable
    latency distribution is what the process-kill chaos tests assert their
    bound against. Surfaced
    as the ``proc`` block of each replica's /stats summary."""

    respawns: int = 0         # successful respawn-to-routable cycles
    spawn_failures: int = 0   # spawn attempts that died/hung pre-ready
    exits: int = 0            # deaths of READY (post-handshake) workers

    def __post_init__(self):
        from collections import deque

        # death-detected -> port-handshake-complete (warmed) latency
        self.respawn_ms = deque(maxlen=1000)
        # classes of ALL process deaths — ready-worker exits AND failed
        # spawn attempts (a crash-looping `config_error` shows up here
        # even though it never got far enough to count as an `exit`)
        self.exit_classes: dict[str, int] = {}

    def note_exit(self, cls: str) -> None:
        self.exits += 1
        self.exit_classes[cls] = self.exit_classes.get(cls, 0) + 1

    def note_spawn_failure(self, cls: str | None) -> None:
        self.spawn_failures += 1
        if cls is not None:
            self.exit_classes[cls] = self.exit_classes.get(cls, 0) + 1

    def summary(self) -> dict:
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        return {
            "exits": self.exits,
            "exit_classes": dict(self.exit_classes),
            "respawns": self.respawns,
            "spawn_failures": self.spawn_failures,
            "respawn_p50_ms": rnd(percentile(list(self.respawn_ms), 50)),
            "respawn_p99_ms": rnd(percentile(list(self.respawn_ms), 99)),
        }


