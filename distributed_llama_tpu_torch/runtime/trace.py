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
the JAX tuple whole; the kinds of the router, KV transfer, cluster and
fleet (``route``, ``kv_fill``, ``failover``, ``cluster_*``,
``worker_exit``, ``respawn``, ``handshake``, ``bcast``, ``scale_*``,
``shed``, ``degrade``) come with those layers (ROADMAP items 15 and 16),
and so do the cross-process span methods (``reserve``, ``ingest``,
``export_span``).
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
        self._fh = None  # guarded by self._lock
        self._n = 0
        self._seq = 0
        os.makedirs(directory, exist_ok=True)

    def _open_next(self) -> None:  # holds self._lock
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
        self._ring: deque = deque(maxlen=self._capacity)
        self._lock = threading.Lock()
        self._next_id = 0  # guarded by self._lock
        self._sink: TraceSink | None = None
        self.steps = StepTimelineStats()
        self.dropped = 0          # sink write failures (disk full ...)
        # per-tid span index: by_id is O(span), not O(ring)
        self._spans: dict[int, list] = {}  # guarded by self._span_lock
        self._span_order: deque = deque()
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

# /stats summary counters -> Prometheus counters
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

_PREFIX = (
    ("lookups", "dllama_prefix_cache_lookups_total"),
    ("hits", "dllama_prefix_cache_hits_total"),
    ("tokens_saved", "dllama_prefix_cache_tokens_saved_total"),
    ("tokens_prefilled", "dllama_prefix_cache_tokens_prefilled_total"),
    ("blocks_published", "dllama_prefix_cache_blocks_published_total"),
    ("evictions", "dllama_prefix_cache_evictions_total"),
    ("publish_drops", "dllama_prefix_cache_publish_drops_total"),
)
# blocks_in_use is a level (it drops as blocks free or evict): a gauge,
# never a counter, which rate() would read as a reset at every drop
_PREFIX_GAUGES = (
    ("blocks_in_use", "dllama_prefix_cache_blocks_in_use"),
)

_RESILIENCE = (
    ("crashes", "dllama_supervisor_crashes_total"),
    ("watchdog_trips", "dllama_supervisor_watchdog_trips_total"),
    ("recoveries", "dllama_supervisor_recoveries_total"),
    ("rejected_unready", "dllama_supervisor_rejected_unready_total"),
)


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class _Prom:
    """Exposition-format builder: one # HELP/# TYPE header a name."""

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


def _add_block(p: _Prom, block: dict | None, table, *, type_: str) -> None:
    if not block:
        return
    for key, name in table:
        p.add(name, block.get(key), type_=type_)


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
    """The speculative-decoding family (the SpecStats summary), attached
    even with drafting off (mode "off", zeros), so the family never
    vanishes off a launch flag. `labels` and `prefix` serve a per-replica
    block (dllama_replica_spec_*), as the JAX renderer's do."""
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


def _add_device_blocks(p: _Prom, summary: dict) -> None:
    """The device-tier families (runtime/profiler.py): the ledger of
    captured graphs, the memory ledger, the sampled step device time."""
    pre = "dllama_"
    comp = summary.get("compiles")
    if comp:
        p.add(pre + "compiles_after_warmup_total",
              comp.get("after_warmup"), type_="counter",
              help_="Compiles minted after the serving set was warm "
                    "(the recompile sentinel)")
        for key, rec in (comp.get("by_key") or {}).items():
            lab = {"key": _esc(key)}
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
            p.add(pre + "hbm_bytes", hbm.get(field), {"category": cat},
                  help_="Live HBM bytes by category (known array shapes)")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_in_use"),
              {"kind": "in_use"},
              help_="Backend allocator stats, where provided")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_limit"),
              {"kind": "limit"})
        p.add(pre + "hbm_slots_addable", hbm.get("slots_addable"),
              help_="KV slots that still fit free HBM (headroom)")
        p.add(pre + "hbm_prefix_blocks_addable",
              hbm.get("prefix_blocks_addable"),
              help_="Prefix-arena blocks that still fit free HBM")
    dev = summary.get("device_time")
    if dev:
        p.add(pre + "profile_sampled_steps_total",
              dev.get("sampled_steps"), type_="counter",
              help_="Scheduler steps captured for device-time attribution")
        for entry, rec in (dev.get("by_entry") or {}).items():
            lab = {"entry": _esc(entry)}
            p.add(pre + "device_ms", rec.get("p50_ms"),
                  {**lab, "quantile": "0.5"},
                  help_="Sampled per-step device ms by entry point")
            p.add(pre + "device_samples_total", rec.get("n"), lab,
                  type_="counter")
        sync = dev.get("sync")
        if sync and sync.get("n"):
            # per sampled step, device collective (sync) ms against total
            # device ms: 0 on one GPU, where no collective runs
            p.add(pre + "step_sync_ms", sync.get("sync_p50_ms"),
                  {"quantile": "0.5"},
                  help_="Sampled per-step device collective ms (the "
                        "sync half of the sync/compute split)")
            p.add(pre + "step_sync_ms", sync.get("sync_p99_ms"),
                  {"quantile": "0.99"})
            p.add(pre + "step_sync_share", sync.get("sync_share"),
                  help_="Collective share of sampled device step time "
                        "(window mean)")


def _add_admission(p: _Prom, adm: dict | None) -> None:
    """The SLO admission family (runtime/scheduler.AdmissionPolicy's
    summary): the live chunk width and the EWMAs the policy steers on."""
    if not adm:
        return
    p.add("dllama_admission_chunk_width", adm.get("chunk_width"),
          help_="Current adaptive chunked-prefill width (tokens)")
    p.add("dllama_admission_chunk_changes_total", adm.get("shrinks"),
          {"direction": "shrink"}, type_="counter",
          help_="Adaptive chunk-width rung transitions")
    p.add("dllama_admission_chunk_changes_total", adm.get("widens"),
          {"direction": "widen"}, type_="counter")
    p.add("dllama_admission_itl_ewma_ms", adm.get("itl_ewma_ms"),
          help_="Live inter-token-latency EWMA the policy steers on")
    p.add("dllama_admission_ttft_ewma_ms", adm.get("ttft_ewma_ms"),
          help_="Live time-to-first-token EWMA")


def render_prometheus(summary: dict | None, *, tracer: Tracer | None = None,
                      model: str = "dllama", mode: str = "scheduler",
                      state: str | None = None,
                      build: dict | None = None) -> str:
    """The GET /metrics body: the /stats summary dict (None while the
    legacy mode) and, with tracing on, the tracer's step-timeline windows,
    as Prometheus text exposition format."""
    p = _Prom()
    p.add("dllama_up", 1, {"model": model, "mode": mode},
          help_="The serving process is up", type_="gauge")
    if build:
        p.add("dllama_build_info", 1,
              {k: _esc(v) for k, v in build.items()},
              help_="Build identity (constant 1; info in the labels)")
    states = ("ready", "recovering", "broken", "draining", "closed", "off")
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
        auto = summary.get("autosize")
        if auto:
            # the startup auto-sizing decision (runtime/profiler.
            # resolve_auto_shape): what was chosen and why
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
        _add_device_blocks(p, summary)
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
