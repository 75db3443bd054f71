"""Flight recorder and the /metrics plane — the port of the JAX package's
runtime/trace.py for one GPU.

  * **Per-request spans**: ``Tracer`` (the singleton ``TRACER``) records
    each request's lifecycle (``enqueue -> admit -> seed -> prefill ->
    first_token -> decode/N -> spec -> finish|error``) and the events that
    explain a timeline (``engine_failure``, ``circuit``, ``recovery``,
    ``fault``, ``compile``, ``compile_after_warmup``, ``profile``,
    ``sync``) into a fixed-capacity ring. Appends take no lock
    (``deque.append`` is atomic under the GIL); the span index, the step
    windows and the sink take their own. Off (the default) it records
    nothing and allocates nothing: call sites check ``TRACER.enabled``
    before they build any kwargs, so a server launched without --trace
    pays one attribute read a site.
  * **Step timeline**: every scheduler iteration records its batch
    composition (decode rows, prefill rows, chunk width), its queue depth
    and its wall ms, kept a composition in ``stats.StepTimelineStats``:
    the ``dllama_step_ms`` /metrics family and the /stats
    ``step_timeline`` block.
  * **Export**: ``render_prometheus`` turns the /stats summary dict and
    the tracer's windows into Prometheus text (GET /metrics);
    GET /admin/trace serves the ring as JSONL; ``--trace-dir`` attaches a
    rotating JSONL sink with a per-request sample rate.

One clock: every timestamp is ``time.perf_counter()``, the clock of the
scheduler's deadlines, TTFT/ITL and the supervisor's watchdog; one
(wall, mono) anchor pair converts to wall time at export only.

Every event is host code between device launches: none is recorded inside
a captured CUDA graph, and none reads a device value. ``EVENT_KINDS`` is
the JAX tuple whole. The multi-node control star (parallel/multihost.py)
records ``cluster_tick``, ``cluster_lost``, ``handshake`` and ``bcast``,
and its cross-process span methods are here: a worker ``reserve``s the
root's trace ids and ships ``export_span`` in MSG_TRACE frames, which the
root ``ingest``s onto its timeline, rebased by the heartbeat's clock-offset
estimate. The router, the KV transfer and the fleet record ``route``,
``kv_fill``, ``failover``, ``circuit``, ``worker_exit``, ``respawn``,
``scale_up``/``scale_down``, ``shed`` and ``degrade`` (runtime/router.py,
runtime/kv_transfer.py, runtime/fleet.py), and a replica worker process
ships its spans in RMSG_TRACE frames (runtime/replica_worker.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .stats import StepTimelineStats

# event kinds a span may contain, in rough lifecycle order (the JAX tuple)
EVENT_KINDS = (
    "enqueue",        # scheduler door: request queued (n_prompt, rid)
    "admit",          # slot leased (slot, queue_ms)
    "seed",           # prefix-cache seed (hit = tokens seeded)
    "prefill",        # one prefill chunk dispatched for this row (off, n)
    "first_token",    # TTFT edge
    "decode",         # every Nth decode token (n_out)
    "finish",         # terminal: natural finish (reason, n_out)
    "error",          # terminal: structured error frame (code, retryable)
    "route",          # router placement (replica, reason, attempt)
    "kv_fill",        # cross-replica KV block fill
    "failover",       # retryable pre-stream failure -> re-place
    "circuit",        # breaker transition (scope, state)
    "fault",          # an armed fault site actually fired (site, key)
    "engine_failure",  # supervisor caught a crash/stall (failure, gen)
    "recovery",       # supervisor rebuilt to ready (ms, gen)
    "cluster_lost",   # cluster peer lost
    "worker_exit",    # replica worker process died
    "respawn",        # worker respawned to routable
    "spec",           # terminal speculative accept record for one request
    #                   (forwards, drafted, accepted)
    "step",           # scheduler iteration (timeline record)
    "handshake",      # cluster control star formed
    "cluster_tick",   # one cluster protocol frame handled
    "bcast",          # startup data-plane broadcast timed
    "sync",           # one sampled step's collective vs total device ms
    #                   (runtime/profiler.py)
    "compile",        # a CUDA graph was captured (key, ms, warm) —
    #                   runtime/profiler.CompileLedger
    "compile_after_warmup",  # the recompile sentinel fired (key, frozen)
    "profile",        # an /admin/profile capture completed (dir, ms)
    "scale_up",       # fleet controller added a replica
    "scale_down",     # fleet controller drained and reaped a replica
    "shed",           # overload door refused/degraded a request
    "degrade",        # shed ladder moved a rung
)


def _sampled(tid: int, rate: float) -> bool:
    """Deterministic per-request sink sampling: a trace id is always in or
    always out, so a span is never half persisted (Knuth's multiplicative
    hash: ids are sequential, and ``tid % k`` would follow arrival
    order)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((tid * 2654435761) & 0xFFFFFFFF) / 4294967296.0 < rate


class TraceSink:
    """Rotating JSONL sink (``trace-00000001.jsonl`` ...): a file rotates
    past ``max_bytes``, the oldest files go past ``max_files``, so the
    disk footprint is bounded by ``max_bytes * max_files``. Line-buffered
    writes under one lock; the Tracer has already decided sampling."""

    def __init__(self, directory: str, *, max_bytes: int = 16 << 20,
                 max_files: int = 8):
        self.directory = directory
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self._lock = threading.Lock()
        self._fh = None  # dlrace: guarded-by(self._lock)
        self._n = 0  # dlrace: guarded-by(self._lock)
        self._seq = 0  # dlrace: guarded-by(self._lock)
        os.makedirs(directory, exist_ok=True)

    def _open_next(self) -> None:  # dlrace: holds(self._lock)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._seq += 1
        path = os.path.join(self.directory, f"trace-{self._seq:08d}.jsonl")
        self._fh = open(path, "a", buffering=1)  # line-buffered
        self._n = self._fh.tell()
        old = sorted(f for f in os.listdir(self.directory)
                     if f.startswith("trace-") and f.endswith(".jsonl"))
        for f in old[:-self.max_files] if len(old) > self.max_files else ():
            try:
                os.unlink(os.path.join(self.directory, f))
            except OSError:
                pass

    def write(self, line: str) -> None:
        with self._lock:
            if self._fh is None or self._n >= self.max_bytes:
                self._open_next()
            self._fh.write(line + "\n")
            self._n += len(line) + 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


class Tracer:
    """Host-side flight recorder (module singleton: ``TRACER``). Off by
    default; hot call sites check ``if TRACER.enabled:`` before building
    event kwargs. On, ``event()`` appends one small dict to a bounded ring
    and, for sampled spans, to the JSONL sink; ``step()`` also feeds the
    per-composition step windows."""

    def __init__(self):
        self.enabled = False
        self.decode_every = 8     # decode progress event cadence (tokens)
        self.sample = 1.0         # sink sampling rate (the ring keeps all)
        self._capacity = 8192
        self._ring: deque = deque(maxlen=self._capacity)  # dlrace: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._next_id = 0  # dlrace: guarded-by(self._lock)
        self._sink: TraceSink | None = None
        self.steps = StepTimelineStats()
        self.dropped = 0          # sink write failures (disk full ...)
        # per-tid span index: by_id is O(span), not O(ring)
        self._spans: dict[int, list] = {}  # dlrace: guarded-by(self._span_lock)
        self._span_order: deque = deque()  # dlrace: guarded-by(self._span_lock)
        self._span_lock = threading.Lock()
        self._anchor()

    @property
    def _span_cap(self) -> int:
        return max(self._capacity // 8, 64)  # distinct live spans

    def _anchor(self) -> None:
        # one (wall, mono) pair: every stored ts is perf_counter; wall
        # conversion happens at export only
        self.anchor_mono = time.perf_counter()
        self.anchor_wall = time.time()

    # -- configuration ------------------------------------------------------

    def configure(self, *, capacity: int | None = None,
                  sample: float | None = None,
                  decode_every: int | None = None,
                  sink_dir: str | None = None,
                  sink_max_bytes: int = 16 << 20,
                  sink_max_files: int = 8,
                  enabled: bool = True) -> None:
        """(Re)configure and enable. A capacity change replaces the ring
        (its eviction order cannot carry over); the sink is replaced."""
        with self._lock:
            if capacity is not None:
                self._capacity = max(int(capacity), 16)
                self._ring = deque(maxlen=self._capacity)
                with self._span_lock:
                    self._spans = {}
                    self._span_order = deque()
            if sample is not None:
                assert 0.0 <= sample <= 1.0, sample
                self.sample = float(sample)
            if decode_every is not None:
                self.decode_every = max(int(decode_every), 1)
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            if sink_dir is not None:
                self._sink = TraceSink(sink_dir, max_bytes=sink_max_bytes,
                                       max_files=sink_max_files)
            self._anchor()
            self.enabled = bool(enabled)

    def reset(self) -> None:
        """Disable and drop all state (test teardown). The singleton
        survives: call sites keep their reference."""
        with self._lock:
            self.enabled = False
            self._ring = deque(maxlen=self._capacity)
            with self._span_lock:
                self._spans = {}
                self._span_order = deque()
            self.steps = StepTimelineStats()
            self._next_id = 0
            self.dropped = 0
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            self._anchor()

    def new_id(self) -> int:
        """Mint one trace id (sequential, > 0: 0 means untraced)."""
        with self._lock:
            self._next_id += 1
            return self._next_id

    def reserve(self, tid: int) -> None:
        """Adopt a trace id minted by another process (the cluster root):
        advance the local counter past it, so this process's own mints
        never collide with it."""
        with self._lock:
            if tid > self._next_id:
                self._next_id = int(tid)

    # -- recording ----------------------------------------------------------

    def event(self, kind: str, tid: int = 0, **fields) -> None:
        """Append one event. Hot call sites check ``enabled`` first; this
        check covers a race with a concurrent reset()."""
        if not self.enabled:
            return
        rec = {"ts": time.perf_counter(), "kind": kind, "tid": tid}
        if fields:
            rec.update(fields)
        self._ring.append(rec)
        if tid:
            self._index(tid, rec)
        sink = self._sink
        if sink is not None and (tid == 0 or _sampled(tid, self.sample)):
            try:
                sink.write(json.dumps(
                    {**rec, "ts_wall": self.to_wall(rec["ts"])}))
            except (OSError, ValueError):
                self.dropped += 1

    def step(self, *, decode_rows: int, prefill_rows: int, chunk: int,
             queue_depth: int, wall_ms: float,
             key: str | None = None) -> None:
        """One scheduler iteration: a ring record and the
        per-composition window."""
        if not self.enabled:
            return
        rec = {"ts": time.perf_counter(), "kind": "step", "tid": 0,
               "dec": decode_rows, "pre": prefill_rows, "chunk": chunk,
               "queue": queue_depth, "ms": round(wall_ms, 4)}
        if key is not None:
            rec["key"] = key
        self._ring.append(rec)
        self.steps.record(decode_rows, prefill_rows, chunk, wall_ms)
        sink = self._sink
        if sink is not None:
            try:
                sink.write(json.dumps(
                    {**rec, "ts_wall": self.to_wall(rec["ts"])}))
            except (OSError, ValueError):
                self.dropped += 1

    def ingest(self, events: list[dict], origin: str,
               anchor_wall: float | None = None) -> None:
        """Merge another process's span events (a worker's MSG_TRACE
        payload) onto this timeline. They arrive wall-stamped
        (``ts_wall``: monotonic clocks do not transfer between processes)
        and are rebased onto this process's perf_counter through the
        local anchor; each gains ``origin``."""
        if not self.enabled:
            return
        for e in events:
            rec = dict(e)
            wall = rec.pop("ts_wall", None)
            if wall is None and anchor_wall is not None and "ts" in rec:
                wall = anchor_wall + rec["ts"]
            rec["ts"] = (self.anchor_mono + (wall - self.anchor_wall)
                         if wall is not None else time.perf_counter())
            rec["origin"] = origin
            self._ring.append(rec)
            if rec.get("tid"):
                self._index(rec["tid"], rec)

    # -- export -------------------------------------------------------------

    def to_wall(self, ts_mono: float) -> float:
        return self.anchor_wall + (ts_mono - self.anchor_mono)

    def recent(self, n: int = 200) -> list[dict]:
        """The last n events (0: all), oldest first."""
        evs = list(self._ring)
        return evs[-n:] if n else evs

    def _index(self, tid: int, rec: dict) -> None:
        """Append one span event to the per-tid index (past the cap the
        oldest SPAN goes whole; a span keeps its first 1024 events)."""
        with self._span_lock:
            lst = self._spans.get(tid)
            if lst is None:
                while len(self._spans) >= self._span_cap:
                    old = self._span_order.popleft()
                    self._spans.pop(old, None)
                lst = self._spans[tid] = []
                self._span_order.append(tid)
            if len(lst) < 1024:
                lst.append(rec)

    def by_id(self, tid: int) -> list[dict]:
        """One request's span, in order (the /admin/trace?id=N view)."""
        with self._span_lock:
            return list(self._spans.get(tid, ()))

    def export_span(self, tid: int) -> list[dict]:
        """The span as a cross-process payload: each event gains
        ``ts_wall``, so the receiving tracer can rebase it (``ingest``)."""
        return [{**e, "ts_wall": self.to_wall(e["ts"])}
                for e in self.by_id(tid)]

    def step_timeline(self) -> dict:
        """Per-composition step-ms summary (p50/p99/mean/n)."""
        return self.steps.summary()

    def summary(self) -> dict:
        """The tracer's own block (the /stats ``trace`` block)."""
        return {"enabled": self.enabled,
                "events": len(self._ring),
                "capacity": self._capacity,
                "next_id": self._next_id,
                "sample": self.sample,
                "sink_dropped": self.dropped,
                "sink": (self._sink.directory
                         if self._sink is not None else None)}


TRACER = Tracer()


# -- Prometheus text exposition ---------------------------------------------

# /stats summary counters -> Prometheus counters (same payload every tier
# already emits, so the three serving tiers export identically by
# construction)
_COUNTERS = (
    ("requests_submitted", "dllama_requests_submitted_total",
     "Requests accepted at the serving door"),
    ("requests_finished", "dllama_requests_finished_total",
     "Requests that received a terminal event"),
    ("requests_failed", "dllama_requests_failed_total",
     "Requests failed with a structured error frame"),
    ("requests_expired", "dllama_requests_expired_total",
     "Requests killed by deadline or queue-time budget"),
    ("requests_rejected", "dllama_requests_rejected_total",
     "Requests refused at submit (queue bound)"),
    ("tokens_out", "dllama_tokens_out_total", "Tokens emitted"),
    ("steps", "dllama_scheduler_steps_total", "Scheduler iterations"),
)

_GAUGES = (
    ("ttft_p50_ms", "dllama_ttft_ms", {"quantile": "0.5"},
     "Time to first token, sliding window"),
    ("ttft_p99_ms", "dllama_ttft_ms", {"quantile": "0.99"}, None),
    ("itl_p50_ms", "dllama_itl_ms", {"quantile": "0.5"},
     "Inter-token latency, sliding window"),
    ("itl_p99_ms", "dllama_itl_ms", {"quantile": "0.99"}, None),
    ("mean_slot_occupancy", "dllama_slot_occupancy_mean", {},
     "Mean live slots per scheduler iteration (window)"),
    ("max_queue_depth", "dllama_queue_depth_max", {},
     "Max admission-queue depth (window)"),
)

_RESILIENCE = (
    ("crashes", "dllama_supervisor_crashes_total"),
    ("watchdog_trips", "dllama_supervisor_watchdog_trips_total"),
    ("recoveries", "dllama_supervisor_recoveries_total"),
    ("rejected_unready", "dllama_supervisor_rejected_unready_total"),
    ("cluster_losses", "dllama_supervisor_cluster_losses_total"),
)

_ROUTER = (
    ("routed", "dllama_router_routed_total"),
    ("routed_cache_hit", "dllama_router_routed_cache_hit_total"),
    ("routed_affinity", "dllama_router_routed_affinity_total"),
    ("routed_fallback", "dllama_router_routed_fallback_total"),
    ("retries", "dllama_router_retries_total"),
    ("failovers_ok", "dllama_router_failovers_ok_total"),
    ("midstream_failures", "dllama_router_midstream_failures_total"),
    ("breaker_trips", "dllama_router_breaker_trips_total"),
    ("breaker_probes", "dllama_router_breaker_probes_total"),
    ("no_replica_rejections", "dllama_router_no_replica_rejections_total"),
)

_PREFIX = (
    ("lookups", "dllama_prefix_cache_lookups_total"),
    ("hits", "dllama_prefix_cache_hits_total"),
    ("tokens_saved", "dllama_prefix_cache_tokens_saved_total"),
    ("tokens_prefilled", "dllama_prefix_cache_tokens_prefilled_total"),
    ("blocks_published", "dllama_prefix_cache_blocks_published_total"),
    ("evictions", "dllama_prefix_cache_evictions_total"),
    ("publish_drops", "dllama_prefix_cache_publish_drops_total"),
)
# blocks_in_use is a LEVEL (drops when blocks free/evict) — emitted as a
# gauge, never through the counter table: rate() over a shrinking
# "counter" reads every drop as a counter reset
_PREFIX_GAUGES = (
    ("blocks_in_use", "dllama_prefix_cache_blocks_in_use"),
)


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class _Prom:
    """Tiny exposition-format writer: groups samples per metric name so
    each name gets exactly one # HELP/# TYPE header (the format
    requirement scrapers enforce)."""

    def __init__(self):
        self._meta: dict[str, tuple[str, str]] = {}
        self._samples: dict[str, list[str]] = {}

    def add(self, name: str, value, labels: dict | None = None,
            help_: str | None = None, type_: str = "gauge") -> None:
        if value is None:
            return
        if name not in self._meta:
            self._meta[name] = (help_ or name, type_)
            self._samples[name] = []
        lab = ""
        if labels:
            lab = "{" + ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in labels.items()) + "}"
        self._samples[name].append(f"{name}{lab} {value}")

    def render(self) -> str:
        out = []
        for name, (help_, type_) in self._meta.items():
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {type_}")
            out.extend(self._samples[name])
        return "\n".join(out) + "\n"


def _add_block(p: _Prom, block: dict | None, table, *, type_: str,
               labels: dict | None = None) -> None:
    if not block:
        return
    for row in table:
        key, name = row[0], row[1]
        p.add(name, block.get(key), labels=labels, type_=type_)


def _add_device_blocks(p: _Prom, summary: dict,
                       labels: dict | None = None) -> None:
    """The device-tier families (runtime/profiler.py): compile ledger,
    HBM ledger, sampled device-time attribution — rendered from the
    same /stats blocks every tier already carries, top-level AND
    per-replica (labelled)."""
    pre = "dllama_replica_" if labels else "dllama_"
    comp = summary.get("compiles")
    if comp:
        p.add(pre + "compiles_after_warmup_total",
              comp.get("after_warmup"), labels, type_="counter",
              help_="Compiles minted after the serving set was warm "
                    "(the recompile sentinel)")
        for key, rec in (comp.get("by_key") or {}).items():
            lab = {**(labels or {}), "key": _esc(key)}
            p.add(pre + "compiles_total", rec.get("count"), lab,
                  type_="counter", help_="Executable mints by compile key")
            p.add(pre + "compile_ms", rec.get("ms"), lab,
                  type_="counter",
                  help_="Cumulative trace+compile wall ms by compile key")
    hbm = summary.get("hbm")
    if hbm:
        for cat, field in (("weights", "weights_bytes"),
                           ("vocab", "vocab_bytes"),
                           ("kv_slots", "kv_slot_bytes"),
                           ("prefix_arena", "prefix_arena_bytes"),
                           ("logits_workspace", "logits_workspace_bytes")):
            p.add(pre + "hbm_bytes", hbm.get(field),
                  {**(labels or {}), "category": cat},
                  help_="Live HBM bytes by category (known array shapes)")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_in_use"),
              {**(labels or {}), "kind": "in_use"},
              help_="Backend allocator stats, where provided")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_limit"),
              {**(labels or {}), "kind": "limit"})
        p.add(pre + "hbm_slots_addable", hbm.get("slots_addable"), labels,
              help_="KV slots that still fit free HBM (headroom)")
        p.add(pre + "hbm_prefix_blocks_addable",
              hbm.get("prefix_blocks_addable"), labels,
              help_="Prefix-arena blocks that still fit free HBM")
    dev = summary.get("device_time")
    if dev:
        p.add(pre + "profile_sampled_steps_total",
              dev.get("sampled_steps"), labels, type_="counter",
              help_="Scheduler steps captured for device-time attribution")
        for entry, rec in (dev.get("by_entry") or {}).items():
            lab = {**(labels or {}), "entry": _esc(entry)}
            p.add(pre + "device_ms", rec.get("p50_ms"),
                  {**lab, "quantile": "0.5"},
                  help_="Sampled per-step device ms by entry point")
            p.add(pre + "device_samples_total", rec.get("n"), lab,
                  type_="counter")
        sync = dev.get("sync")
        if sync and sync.get("n"):
            # the reference's I/T/S split reborn: per sampled step,
            # device collective (sync) ms vs total device ms
            p.add(pre + "step_sync_ms", sync.get("sync_p50_ms"),
                  {**(labels or {}), "quantile": "0.5"},
                  help_="Sampled per-step device collective ms (the "
                        "sync half of the sync/compute split)")
            p.add(pre + "step_sync_ms", sync.get("sync_p99_ms"),
                  {**(labels or {}), "quantile": "0.99"})
            p.add(pre + "step_sync_share", sync.get("sync_share"),
                  labels,
                  help_="Collective share of sampled device step time "
                        "(window mean)")


_CLUSTER_COUNTERS = (
    ("pings_sent", "dllama_cluster_pings_sent_total"),
    ("pongs_received", "dllama_cluster_pongs_received_total"),
    ("pongs_sent", "dllama_cluster_pongs_sent_total"),
    ("frames_sent", "dllama_cluster_frames_sent_total"),
    ("frames_received", "dllama_cluster_frames_received_total"),
    ("connect_retries", "dllama_cluster_connect_retries_total"),
)


def _add_cluster(p: _Prom, cluster: dict | None) -> None:
    """The cluster-plane families (parallel/multihost ClusterStats +
    its wire ledger): every counter the /stats block carries, the
    phase label, the startup broadcast timings, and the measured wire
    ledger — tier-invariant like every other family (the api server
    attaches the cluster block in every tier, so a launch flag can
    never drop these from a scrape)."""
    if not cluster:
        return
    p.add("dllama_cluster_peers_lost_total",
          len(cluster.get("peers_lost") or ()), type_="counter",
          help_="Structured ClusterPeerLost detections")
    for key, name in _CLUSTER_COUNTERS:
        p.add(name, cluster.get(key), type_="counter")
    p.add("dllama_cluster_nnodes", cluster.get("nnodes"),
          help_="Configured cluster size")
    ph = cluster.get("phase")
    if ph:
        p.add("dllama_cluster_phase", 1, {"phase": _esc(ph)},
              help_="Current cluster phase (info-style: constant 1, "
                    "phase in the label)")
    p.add("dllama_cluster_bcast_ms", cluster.get("bcast_spec_ms"),
          {"what": "spec"},
          help_="Startup data-plane broadcast wall ms by phase")
    p.add("dllama_cluster_bcast_ms", cluster.get("bcast_tensors_ms"),
          {"what": "tensors"})
    if cluster.get("bcast_tensors_bytes"):
        p.add("dllama_cluster_bcast_bytes_total",
              cluster.get("bcast_tensors_bytes"), {"what": "tensors"},
              type_="counter",
              help_="Tensor bytes streamed through the startup broadcast")
    wire = cluster.get("wire") or {}
    for peer, rec in (wire.get("peers") or {}).items():
        for dirn in ("tx", "rx"):
            for kind, kb in (rec.get(dirn) or {}).items():
                lab = {"peer": str(peer), "kind": _esc(kind), "dir": dirn}
                p.add("dllama_wire_bytes_total", kb.get("bytes"), lab,
                      type_="counter",
                      help_="Measured control-plane bytes by peer, MSG "
                            "kind, and direction (the wire ledger)")
                p.add("dllama_wire_frames_total", kb.get("frames"), lab,
                      type_="counter",
                      help_="Measured control-plane frames")
        rtt = rec.get("rtt_ms") or {}
        p.add("dllama_heartbeat_rtt_ms", rtt.get("p50_ms"),
              {"peer": str(peer), "quantile": "0.5"},
              help_="PING→PONG round trip per peer (window)")
        p.add("dllama_heartbeat_rtt_ms", rtt.get("p99_ms"),
              {"peer": str(peer), "quantile": "0.99"})
        p.add("dllama_cluster_clock_offset_ms",
              rec.get("clock_offset_ms"), {"peer": str(peer)},
              help_="PING/PONG-midpoint clock-offset estimate (peer wall "
                    "minus local wall, at the best-RTT sample)")


_SPEC_COUNTERS = (
    ("verify_forwards", "spec_verify_forwards_total",
     "Fixed-width speculative verify forwards dispatched"),
    ("draft_forwards", "spec_draft_forwards_total",
     "Draft dispatches (one k-token scan or prefill chunk == one)"),
    ("drafted", "spec_drafted_tokens_total",
     "Draft tokens proposed to the verifier"),
    ("accepted", "spec_accepted_tokens_total",
     "Draft tokens the verify forward confirmed"),
    ("emitted_spec", "spec_emitted_tokens_total",
     "Tokens emitted by speculating rows"),
    ("degraded_steps", "spec_degraded_steps_total",
     "Iterations the SLO admission policy ran with drafting disabled"),
)


def _add_spec(p: _Prom, spec: dict | None, *, labels: dict | None = None,
              prefix: str = "dllama_") -> None:
    """The speculative-decoding family (runtime/draft.py accept record,
    stats.SpecStats summary): honest accept-rate observability in every
    tier — the block is attached even with drafting off (mode "off",
    zeros), so the family can never vanish off a launch flag. One
    renderer for the top-level summary and each replica's block
    (`dllama_replica_spec_*`, replica-labelled)."""
    if not spec:
        return
    per = " (per replica)" if prefix != "dllama_" else ""
    p.add(f"{prefix}spec_mode", 1,
          {**(labels or {}), "mode": _esc(spec.get("mode", "off")),
           "draft_len": str(spec.get("draft_len", 0))},
          help_=f"Draft mode in effect (info-style: constant 1){per}")
    for key, name, help_ in _SPEC_COUNTERS:
        p.add(f"{prefix}{name}", spec.get(key), labels, type_="counter",
              help_=help_ + per)
    p.add(f"{prefix}spec_accept_rate", spec.get("accept_rate"), labels,
          help_="Accepted / drafted over the scheduler generation — the "
                "number that says whether speculation pays on this "
                f"traffic (docs/operations.md){per}")
    p.add(f"{prefix}spec_tokens_per_verify", spec.get("tokens_per_verify"),
          labels,
          help_=f"Mean tokens emitted per verify forward{per}")


_KVX_COUNTERS = (
    ("fills_requested", "kv_transfer_fills_requested_total",
     "Cache-fill attempts (a sibling's cache led the placed replica's)"),
    ("fills_ok", "kv_transfer_fills_total",
     "Fills that imported >= 1 block (the re-prefill actually avoided)"),
    ("fill_fallbacks", "kv_transfer_fallbacks_total",
     "Fills degraded to a plain local re-prefill (donor death, torn "
     "frame, deadline — never a request failure)"),
    ("fill_misses", "kv_transfer_fill_misses_total",
     "Donor answered shorter than the shadow promised (eviction)"),
    ("tokens_filled", "kv_transfer_tokens_filled_total",
     "Prompt tokens imported instead of re-prefilled"),
    ("blocks_filled", "kv_transfer_blocks_filled_total",
     "Arena blocks imported"),
    ("blocks_exported", "kv_transfer_blocks_exported_total",
     "Arena blocks served to siblings (donor side)"),
    ("queries_served", "kv_transfer_queries_total",
     "RMSG_BLOCK_QUERY connections served (donor side)"),
    ("prefill_passes", "kv_transfer_prefill_passes_total",
     "Disaggregated prefill-tier passes completed"),
    ("prefill_pass_fallbacks", "kv_transfer_prefill_fallbacks_total",
     "Requests that fell back to the unified mixed path"),
    ("shadow_truncates", "kv_transfer_shadow_truncates_total",
     "Stale shadow-index paths cleared by a QUERY miss answer"),
)


def _add_kv_transfer(p: _Prom, kvx: dict | None, *,
                     labels: dict | None = None,
                     prefix: str = "dllama_") -> None:
    """The KV block transfer family (runtime/kv_transfer.py,
    stats.KVTransferStats summary): fills, fallbacks, bytes, and
    transfer-time tails in every tier incl. idle — the block is attached
    even with transfer off (enabled=False, zeros), so the family can
    never vanish off a launch flag. One renderer for the top-level
    aggregate and each replica's block (`dllama_replica_kv_transfer_*`,
    replica-labelled)."""
    if not kvx:
        return
    per = " (per replica)" if prefix != "dllama_" else ""
    p.add(f"{prefix}kv_transfer_info", 1,
          {**(labels or {}), "enabled": str(bool(kvx.get("enabled"))),
           "tier": _esc(kvx.get("tier", "mixed"))},
          help_=f"Transfer plane identity (constant 1){per}")
    for key, name, help_ in _KVX_COUNTERS:
        p.add(f"{prefix}{name}", kvx.get(key), labels, type_="counter",
              help_=help_ + per)
    for key, dirn in (("bytes_rx", "rx"), ("bytes_tx", "tx")):
        p.add(f"{prefix}kv_transfer_bytes_total", kvx.get(key),
              {**(labels or {}), "dir": dirn}, type_="counter",
              help_=f"Block K/V payload bytes moved{per} (frame-exact "
                    "wire bytes live in the per-replica wire ledger)")
    p.add(f"{prefix}kv_transfer_ms", kvx.get("transfer_p50_ms"),
          {**(labels or {}), "quantile": "0.5"},
          help_=f"Whole-fill wall ms (connect to last import){per}")
    p.add(f"{prefix}kv_transfer_ms", kvx.get("transfer_p99_ms"),
          {**(labels or {}), "quantile": "0.99"})


def _add_admission(p: _Prom, adm: dict | None, *,
                   labels: dict | None = None,
                   prefix: str = "dllama_") -> None:
    """The SLO-aware admission family (runtime/scheduler.AdmissionPolicy
    summary): live chunk width + the EWMAs the policy steers on. One
    renderer for both homes — the top-level supervisor summary and each
    replica's block (`dllama_replica_admission_*`, replica-labelled)."""
    if not adm:
        return
    per = " (per replica)" if prefix != "dllama_" else ""
    p.add(f"{prefix}admission_chunk_width", adm.get("chunk_width"),
          labels,
          help_=f"Current adaptive chunked-prefill width (tokens){per}")
    p.add(f"{prefix}admission_chunk_changes_total", adm.get("shrinks"),
          {**(labels or {}), "direction": "shrink"}, type_="counter",
          help_=f"Adaptive chunk-width rung transitions{per}")
    p.add(f"{prefix}admission_chunk_changes_total", adm.get("widens"),
          {**(labels or {}), "direction": "widen"}, type_="counter")
    p.add(f"{prefix}admission_itl_ewma_ms", adm.get("itl_ewma_ms"),
          labels,
          help_=f"Live inter-token-latency EWMA the policy steers on{per}")
    p.add(f"{prefix}admission_ttft_ewma_ms", adm.get("ttft_ewma_ms"),
          labels, help_=f"Live time-to-first-token EWMA{per}")


_FLEET_COUNTERS = (
    ("scale_ups", "fleet_scale_ups_total",
     "Replicas added by the autoscaler"),
    ("scale_downs", "fleet_scale_downs_total",
     "Replicas drained and reaped by the autoscaler"),
    ("scale_blocked_hbm", "fleet_scale_blocked_hbm_total",
     "Scale-ups refused by the HBM ledger's slots_addable ceiling"),
    ("spawn_failures", "fleet_spawn_failures_total",
     "Scale-up spawns that failed (controller backs off)"),
    ("warm_fills", "fleet_warm_fills_total",
     "KV warm-fills replayed into fresh replicas from siblings"),
    ("sheds", "fleet_sheds_total",
     "Requests refused by the overload ladder"),
    ("clamped", "fleet_clamped_total",
     "Requests admitted with max_tokens clamped by the ladder"),
)


def _add_fleet(p: _Prom, fleet: dict | None, *,
               labels: dict | None = None,
               prefix: str = "dllama_") -> None:
    """The fleet-brain family (runtime/fleet.py, stats.FleetStats +
    FleetController summary): autoscale decisions, ladder rung, and
    per-tenant fairness in every tier incl. idle — like kv_transfer,
    the block is attached even with the controller off (enabled=False,
    zeros), so the family can never vanish off a launch flag."""
    if not fleet:
        return
    p.add(f"{prefix}fleet_info", 1,
          {**(labels or {}), "enabled": str(bool(fleet.get("enabled"))),
           "autoscaling": str(bool(fleet.get("autoscaling")))},
          help_="Fleet controller identity (constant 1)")
    p.add(f"{prefix}fleet_ticks_total", fleet.get("ticks"), labels,
          type_="counter", help_="Controller decision ticks")
    p.add(f"{prefix}fleet_pressure", fleet.get("pressure"), labels,
          help_="Smoothed occupancy pressure the scaler steers on (0-1)")
    p.add(f"{prefix}fleet_replicas", fleet.get("actual_replicas"),
          {**(labels or {}), "kind": "actual"},
          help_="Replica counts as the controller sees them")
    p.add(f"{prefix}fleet_replicas", fleet.get("target_replicas"),
          {**(labels or {}), "kind": "target"})
    p.add(f"{prefix}fleet_replicas", fleet.get("min_replicas"),
          {**(labels or {}), "kind": "min"})
    p.add(f"{prefix}fleet_replicas", fleet.get("max_replicas"),
          {**(labels or {}), "kind": "max"})
    for key, name, help_ in _FLEET_COUNTERS:
        p.add(f"{prefix}{name}", fleet.get(key), labels, type_="counter",
              help_=help_)
    for reason, n in (fleet.get("sheds_by_reason") or {}).items():
        p.add(f"{prefix}fleet_sheds_by_reason_total", n,
              {**(labels or {}), "reason": _esc(reason)}, type_="counter",
              help_="Ladder refusals by rung reason")
    ladder = fleet.get("ladder")
    if ladder:
        p.add(f"{prefix}fleet_ladder_rung", ladder.get("rung"),
              {**(labels or {}), "name": _esc(ladder.get("name"))},
              help_="Current shed-ladder rung (0 = healthy)")
        p.add(f"{prefix}fleet_ladder_moves_total",
              ladder.get("escalations"),
              {**(labels or {}), "direction": "escalate"},
              type_="counter", help_="Ladder rung transitions")
        p.add(f"{prefix}fleet_ladder_moves_total", ladder.get("recoveries"),
              {**(labels or {}), "direction": "recover"}, type_="counter")
        p.add(f"{prefix}fleet_retry_after_seconds",
              ladder.get("retry_after_s"), labels,
              help_="Live drain-rate-derived Retry-After hint")
    for name, row in (fleet.get("tenants") or {}).items():
        lab = {**(labels or {}), "tenant": _esc(name)}
        p.add(f"{prefix}fleet_tenant_weight", row.get("weight"), lab,
              help_="Configured weighted-fair share")
        p.add(f"{prefix}fleet_tenant_admitted_total", row.get("admitted"),
              lab, type_="counter", help_="Requests admitted per tenant")
        p.add(f"{prefix}fleet_tenant_shed_total", row.get("shed"), lab,
              type_="counter", help_="Requests shed per tenant")
        p.add(f"{prefix}fleet_tenant_tokens_charged_total",
              row.get("tokens_charged"), lab, type_="counter",
              help_="Token cost charged against the tenant budget")
        if row.get("budget_remaining") is not None:
            p.add(f"{prefix}fleet_tenant_budget_remaining",
                  row.get("budget_remaining"), lab,
                  help_="Token-bucket balance (absent = unlimited)")


def render_prometheus(summary: dict | None, *, tracer: Tracer | None = None,
                      model: str = "dllama", mode: str = "scheduler",
                      state: str | None = None,
                      build: dict | None = None) -> str:
    """The GET /metrics body: the /stats summary dict (supervisor- or
    router-shaped; None while the front door is unbuilt or in legacy
    mode) + the tracer's step-timeline histograms, as Prometheus text
    exposition format. Every serving tier hands its EXISTING summary
    here, so the metric names are tier-invariant and a replica's
    counters appear both aggregated and per-replica (labelled)."""
    p = _Prom()
    p.add("dllama_up", 1, {"model": model, "mode": mode},
          help_="The serving process is up", type_="gauge")
    if build:
        # the build-info idiom: constant 1, identity in the labels —
        # join on it to annotate every other series with version/backend
        p.add("dllama_build_info", 1,
              {k: _esc(v) for k, v in build.items()},
              help_="Build identity (constant 1; info in the labels)")
    states = ("ready", "recovering", "broken", "draining", "closed",
              "degraded", "off", "idle")
    st = state or (summary or {}).get("state")
    if st is not None:
        for s in states:
            p.add("dllama_state", int(st == s), {"state": _esc(s)},
                  help_="Serving front-door state (one-hot)")
        if st not in states:
            p.add("dllama_state", 1, {"state": _esc(st)})
    if summary:
        for key, name, help_ in _COUNTERS:
            p.add(name, summary.get(key), help_=help_, type_="counter")
        for key, name, labels, help_ in _GAUGES:
            p.add(name, summary.get(key), labels=labels, help_=help_)
        _add_block(p, summary.get("prefix_cache"), _PREFIX, type_="counter")
        _add_block(p, summary.get("prefix_cache"), _PREFIX_GAUGES,
                   type_="gauge")
        _add_block(p, summary.get("resilience"), _RESILIENCE,
                   type_="counter")
        res = summary.get("resilience") or {}
        p.add("dllama_supervisor_recovery_ms", res.get("recovery_p50_ms"),
              {"quantile": "0.5"},
              help_="Failure-detected to ready-again latency")
        p.add("dllama_supervisor_recovery_ms", res.get("recovery_p99_ms"),
              {"quantile": "0.99"})
        _add_block(p, summary.get("router"), _ROUTER, type_="counter")
        auto = summary.get("autosize")
        if auto:
            # the startup auto-sizing decision (runtime/profiler.
            # resolve_auto_shape): what was chosen and why, as gauges an
            # operator can alert on (a knee drifting under live load
            # shows up as dllama_step_ms disagreeing with these)
            p.add("dllama_autosize_serve_batch", auto.get("serve_batch"),
                  {"basis": _esc(auto.get("serve_batch_basis"))},
                  help_="Auto-resolved --serve-batch (KV slots)")
            if auto.get("prefix_blocks_basis") != "static":
                p.add("dllama_autosize_prefix_blocks",
                      auto.get("prefix_blocks"),
                      {"basis": _esc(auto.get("prefix_blocks_basis"))},
                      help_="Auto-resolved --prefix-blocks (arena blocks)")
            p.add("dllama_autosize_knee_rows",
                  (auto.get("inputs") or {}).get("knee_rows"),
                  {"basis": _esc((auto.get("inputs") or {})
                                 .get("knee_basis"))},
                  help_="Batch knee that capped the auto-sizing")
        _add_admission(p, summary.get("admission"))
        _add_spec(p, summary.get("spec"))
        _add_kv_transfer(p, summary.get("kv_transfer"))
        _add_fleet(p, summary.get("fleet"))
        _add_device_blocks(p, summary)
        for rep in summary.get("replicas") or ():
            lab = {"replica": str(rep.get("replica"))}
            p.add("dllama_replica_up",
                  int(rep.get("state") == "ready"
                      and not rep.get("draining")
                      and not rep.get("breaker_open")), lab,
                  help_="Replica is routable")
            for key, name, help_ in _COUNTERS:
                p.add(name.replace("dllama_", "dllama_replica_"),
                      rep.get(key), lab, type_="counter",
                      help_=help_ and f"{help_} (per replica)")
            _add_block(p, rep.get("prefix_cache"), tuple(
                (k, n.replace("dllama_", "dllama_replica_"))
                for k, n in _PREFIX), type_="counter", labels=lab)
            _add_block(p, rep.get("prefix_cache"), tuple(
                (k, n.replace("dllama_", "dllama_replica_"))
                for k, n in _PREFIX_GAUGES), type_="gauge", labels=lab)
            # per-replica admission policy state (the router's aggregate
            # summary carries none — each replica's scheduler owns its
            # own policy, so the family must ride the replica label or a
            # multi-replica tier would lose it entirely)
            _add_admission(p, rep.get("admission"), labels=lab,
                           prefix="dllama_replica_")
            # per-replica accept record (each replica's scheduler owns
            # its own SpecStats — on router tiers the family rides the
            # replica label, same rule as admission)
            _add_spec(p, rep.get("spec"), labels=lab,
                      prefix="dllama_replica_")
            # per-replica transfer record (a worker's donor serving +
            # its own fills — the aggregate block sums these)
            _add_kv_transfer(p, rep.get("kv_transfer"), labels=lab,
                             prefix="dllama_replica_")
            _add_device_blocks(p, rep, labels=lab)
            proc = rep.get("proc")
            if proc:
                p.add("dllama_replica_proc_exits_total", proc.get("exits"),
                      lab, type_="counter",
                      help_="Deaths of ready worker processes")
                p.add("dllama_replica_proc_respawns_total",
                      proc.get("respawns"), lab, type_="counter")
                p.add("dllama_replica_proc_spawn_failures_total",
                      proc.get("spawn_failures"), lab, type_="counter")
                for cls, n in (proc.get("exit_classes") or {}).items():
                    p.add("dllama_replica_proc_exit_class_total", n,
                          {**lab, "class": _esc(cls)}, type_="counter",
                          help_="Classified worker exits")
                p.add("dllama_replica_proc_respawn_ms",
                      proc.get("respawn_p50_ms"),
                      {**lab, "quantile": "0.5"},
                      help_="Death-detected to routable-again latency")
        _add_cluster(p, summary.get("cluster"))
    if tracer is not None and tracer.enabled:
        t = tracer.summary()
        p.add("dllama_trace_events", t["events"],
              help_="Events in the flight-recorder ring")
        p.add("dllama_trace_next_id", t["next_id"], type_="counter",
              help_="Trace ids minted")
        p.add("dllama_trace_sink_dropped_total", t["sink_dropped"],
              type_="counter")
        for comp, row in tracer.step_timeline().items():
            lab = {"decode_rows": str(comp[0]),
                   "prefill_rows": str(comp[1]), "chunk": str(comp[2])}
            p.add("dllama_step_ms", row["p50_ms"],
                  {**lab, "quantile": "0.5"},
                  help_="Scheduler step wall ms by batch composition")
            p.add("dllama_step_ms", row["p99_ms"],
                  {**lab, "quantile": "0.99"})
            p.add("dllama_steps_by_composition_total", row["n"], lab,
                  type_="counter",
                  help_="Scheduler iterations by batch composition")
    return p.render()
