"""Device-tier observability — the port's counterpart of the JAX package's
runtime/profiler.py, for what the scheduler and the server call:

  * ``COMPILES``: the ledger of captured CUDA graphs, the port's
    counterpart of the JAX compile ledger. Every graph an engine captures
    (runtime/engine.py ``_captured``) records one key with its capture
    wall ms. After ``Scheduler.warmup()`` marks an engine warm, a capture
    of a new key counts in ``compile_after_warmup``, and with
    ``freeze`` set it raises a structured ``RequestError`` before the
    capture runs. The warm flag lives on the engine, so a rebuilt engine's
    own warmup captures are not counted against it.
  * ``hbm_ledger``: live bytes by category from the engine's known tensor
    shapes (weights, vocab, KV slots, the prefix cache's arena, the
    modelled logits workspace), reconciled against
    ``torch.cuda.memory_stats`` on the card (device fields None on the
    CPU), with the headroom in KV slots and in arena blocks.
  * ``build_info``: torch, CUDA and the card, for /healthz and the
    ``dllama_build_info`` series.
  * ``PROFILER``: sampled per-entry device time and the on-demand
    capture. Every ``sample_every``-th working scheduler step
    (``--profile-sample N``) records a pair of CUDA events on the current
    stream around each entry point it runs: every captured graph's replay
    (under its key's ``compile_key_str``: ``slot_decode``,
    ``slot_verify:8:32000``, the draft's ``draft_scan:...``), the eager
    slot prefill chunk (``slot_prefill:C``), the draft's catch-up chunk
    (``draft_prefill:C``), the prefix cache's seed (``prefix_seed``) and
    publish (``prefix_publish``). A daemon thread waits for the step's
    last event and records each entry's summed device ms
    (``device_time``), the step's wall and device ms (``sync``: one GPU
    runs no collective, so its sync ms are 0, the JAX package's
    single-device meaning) and a ``sync`` trace event. The events are
    recorded between launches, never inside a captured graph, and no
    device value is read on the scheduler thread. Off (the default) a
    step costs one attribute read. ``capture(directory, ms)`` (the
    ``POST /admin/profile`` body) writes one ``torch.profiler`` Chrome
    trace, CPU and CUDA activities, of the next ms milliseconds.

Auto-sizing (``resolve_auto_shape`` and the autotune artifact) is not
ported (ROADMAP item 10c, second half).
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque

import torch

from ..quants.torch_codec import QuantizedTensor
from .stats import percentile
from .trace import TRACER

# -- the ledger of captured graphs -----------------------------------------


def _key_elem(x) -> str:
    if isinstance(x, tuple):
        return "x".join(_key_elem(e) for e in x)
    return str(x)


def compile_key_str(key) -> str:
    """A graph key as a bounded, label-safe string (the ``key=`` label of
    ``dllama_compiles_total``): tuples join with ':', a bare int is a
    forward-segment width ("seg:1", the decode step)."""
    if isinstance(key, tuple):
        s = ":".join(_key_elem(x) for x in key)
    elif isinstance(key, int):
        s = f"seg:{key}"
    else:
        s = str(key)
    return re.sub(r"[^0-9A-Za-z_:.x-]", "_", s)[:120]


class CompileLedger:
    """Process-wide record of every captured graph (singleton
    ``COMPILES``)."""

    MAX_KEYS = 256  # label-cardinality bound on by_key

    def __init__(self):
        self._lock = threading.Lock()
        self.freeze = False
        self.total = 0
        self.total_ms = 0.0
        self.after_warmup = 0      # captures on an already-warm engine
        self.key_overflow = 0
        self.by_key: dict[str, dict] = {}  # guarded by self._lock

    def pre_compile(self, engine, key) -> None:
        """The recompile sentinel, before a capture on a WARM engine: a
        counter always, a structured error under freeze."""
        if not getattr(engine, "_compile_warm", False):
            return
        ks = compile_key_str(key)
        with self._lock:
            self.after_warmup += 1
        if TRACER.enabled:
            TRACER.event("compile_after_warmup", 0, key=ks,
                         frozen=self.freeze)
        if self.freeze:
            from .scheduler import RequestError

            raise RequestError(
                "compile_after_warmup",
                f"new graph key {ks!r} after warmup with the serving set "
                "frozen", retryable=False)

    def record(self, engine, key, ms: float) -> None:
        ks = compile_key_str(key)
        warm = bool(getattr(engine, "_compile_warm", False))
        with self._lock:
            self.total += 1
            self.total_ms += ms
            rec = self.by_key.get(ks)
            if rec is None:
                if len(self.by_key) >= self.MAX_KEYS:
                    self.key_overflow += 1
                else:
                    rec = self.by_key[ks] = {"count": 0, "ms": 0.0}
            if rec is not None:
                rec["count"] += 1
                rec["ms"] = round(rec["ms"] + ms, 3)
                rec["last_ms"] = round(ms, 3)
        if TRACER.enabled:
            TRACER.event("compile", 0, key=ks, ms=round(ms, 3), warm=warm)

    def summary(self) -> dict:
        """The ``compiles`` /stats block."""
        with self._lock:
            return {"total": self.total,
                    "total_ms": round(self.total_ms, 3),
                    "after_warmup": self.after_warmup,
                    "frozen": self.freeze,
                    "key_overflow": self.key_overflow,
                    "by_key": {k: dict(v) for k, v in self.by_key.items()}}

    def reset(self) -> None:
        with self._lock:
            self.freeze = False
            self.total = 0
            self.total_ms = 0.0
            self.after_warmup = 0
            self.key_overflow = 0
            self.by_key = {}


COMPILES = CompileLedger()


# -- memory ledger ----------------------------------------------------------


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples (a
    QuantizedTensor counts its packed bytes and scales)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, QuantizedTensor):
        return _tensor_bytes([tree.packed, tree.scales])
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def device_memory_stats(device) -> dict | None:
    """{bytes_in_use, bytes_limit} of a CUDA device from the caching
    allocator and the card's total memory; None on the CPU."""
    if device.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}


def hbm_ledger(engine, prefix_cache=None) -> dict:
    """Live bytes by category for one engine (the ``hbm`` /stats block):
    weights (every param but the vocab tables), vocab (tok_emb and wcls),
    KV slots (the whole (B, KVH, S, hs) cache), the prefix cache's K/V
    arena, the modelled logits workspace ((B, vocab) f32 logits and one
    (B, chunk, dim) activation). ``per_block_bytes`` is one more arena
    block (of the cache's block length; 32 tokens without a cache). On the
    card: the allocator's bytes in use and the card's memory, the
    unaccounted rest, and the headroom in KV slots and arena blocks."""
    spec = engine.spec
    params = engine.params
    vocab_b = _tensor_bytes([params[k] for k in ("tok_emb", "wcls")
                             if k in params])
    weights = _tensor_bytes({k: v for k, v in params.items()
                             if k not in ("tok_emb", "wcls")})
    kv = _tensor_bytes([engine.cache.k, engine.cache.v])
    arena, n_blocks, bl = 0, 0, 32
    if prefix_cache is not None:
        arena = _tensor_bytes([prefix_cache.arena_k, prefix_cache.arena_v])
        n_blocks, bl = prefix_cache.num_blocks, prefix_cache.block_len
    cache_itemsize = torch.empty((), dtype=engine.cache_dtype).element_size()
    compute_itemsize = torch.empty((), dtype=engine.compute_dtype).element_size()
    logits_ws = (engine.batch * spec.vocab_size * 4
                 + engine.batch * engine.prefill_chunk * spec.dim
                 * compute_itemsize)
    per_slot = kv // engine.batch
    per_block = (arena // n_blocks if n_blocks else
                 2 * spec.n_layers * spec.n_kv_heads * bl
                 * spec.head_size * cache_itemsize)
    accounted = weights + vocab_b + kv + arena + logits_ws
    out = {
        "weights_bytes": weights,
        "vocab_bytes": vocab_b,
        "kv_slot_bytes": kv,
        "prefix_arena_bytes": arena,
        "logits_workspace_bytes": logits_ws,
        "accounted_bytes": accounted,
        "per_slot_bytes": per_slot,
        "per_block_bytes": per_block,
        "device_bytes_in_use": None,
        "device_bytes_limit": None,
        "unaccounted_bytes": None,
        "headroom_bytes": None,
        "slots_addable": None,
        "prefix_blocks_addable": None,
    }
    dev = device_memory_stats(engine.device)
    if dev is not None:
        free = max(dev["bytes_limit"] - dev["bytes_in_use"], 0)
        out.update(device_bytes_in_use=dev["bytes_in_use"],
                   device_bytes_limit=dev["bytes_limit"],
                   unaccounted_bytes=max(dev["bytes_in_use"] - accounted, 0),
                   headroom_bytes=free,
                   slots_addable=free // per_slot if per_slot else None,
                   prefix_blocks_addable=free // per_block if per_block else None)
    return out


# -- build info -------------------------------------------------------------


def build_info(engine=None) -> dict:
    """The ``dllama_build_info`` label set and the /healthz ``build``
    block: package version, torch and CUDA versions, the engine's device
    and the card's name."""
    from .. import __version__

    device = getattr(engine, "device", None)
    card = (torch.cuda.get_device_name(device)
            if device is not None and device.type == "cuda" else "none")
    return {"version": __version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "none",
            "device": str(device) if device is not None else "none",
            "card": card}


# -- sampled per-entry device time and the on-demand capture ----------------


class DeviceTimeStats:
    """Per-entry device-ms windows fed by the sampled steps: {entry name:
    bounded window of the entry's summed device ms within one sampled
    step}."""

    def __init__(self, window: int = 512, max_keys: int = 64):
        self.window = int(window)
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        self._hist: dict[str, deque] = {}  # guarded by self._lock
        self.overflow = 0

    def record(self, name: str, ms: float) -> None:
        with self._lock:
            d = self._hist.get(name)
            if d is None:
                if len(self._hist) >= self.max_keys:
                    self.overflow += 1
                    return
                d = self._hist[name] = deque(maxlen=self.window)
            d.append(ms)

    def summary(self) -> dict:
        with self._lock:
            items = [(k, list(d)) for k, d in self._hist.items()]
        out = {}
        for name, xs in sorted(items, key=lambda kv: -len(kv[1])):
            out[name] = {"n": len(xs),
                         "p50_ms": round(percentile(xs, 50), 4),
                         "mean_ms": round(sum(xs) / len(xs), 4)}
        return out


class SyncStats:
    """Per-sampled-step device sync/compute split (the JAX package's
    ``SyncStats``): one (sync_ms, device_ms, wall_ms) record a sampled
    step. sync_ms is the device time of collectives, which one GPU never
    runs: 0, as the JAX package reports a single device. The summary is
    the ``sync`` half of the ``device_time`` /stats block."""

    def __init__(self, window: int = 512):
        self.window = int(window)
        self._lock = threading.Lock()
        self._sync = deque(maxlen=self.window)  # guarded by self._lock
        self._device = deque(maxlen=self.window)
        self._wall = deque(maxlen=self.window)

    def record(self, sync_ms: float, device_ms: float,
               wall_ms: float | None = None) -> None:
        with self._lock:
            self._sync.append(float(sync_ms))
            self._device.append(float(device_ms))
            if wall_ms is not None:
                self._wall.append(float(wall_ms))

    def summary(self) -> dict:
        with self._lock:
            sync = list(self._sync)
            dev = list(self._device)
            wall = list(self._wall)
        if not sync:
            return {"n": 0}
        rnd = lambda v: None if v is None else round(v, 4)  # noqa: E731
        total_dev = sum(dev)
        return {
            "n": len(sync),
            "sync_p50_ms": rnd(percentile(sync, 50)),
            "sync_p99_ms": rnd(percentile(sync, 99)),
            "device_p50_ms": rnd(percentile(dev, 50)),
            # window sums, not a mean of ratios
            "sync_share": rnd(sum(sync) / total_dev) if total_dev else None,
            "wall_p50_ms": rnd(percentile(wall, 50)) if wall else None,
        }


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Profiler:
    """The on-demand capture and the sampled per-entry device time
    (singleton ``PROFILER``). Off (``sample_every == 0``) the scheduler
    pays one attribute read a step and an entry point one more
    (``active is None``). On, every Nth working step sets ``active`` to a
    list that each entry point run in the step appends its (name, start,
    end) CUDA events to; the N - 1 other steps pay one counter increment.
    On the CPU a sampled step records nothing and counts a failure: there
    is no device time to read.

    ``capture`` (the /admin/profile body) and a due step sample share one
    owner flag, as in the JAX package: the loser skips, never blocks."""

    def __init__(self):
        self.sample_every = 0       # 0 = attribution off
        self._n = 0                 # working-step counter
        self.sampled = 0            # sampled steps attributed
        self.sample_failures = 0
        self.captures = 0           # /admin/profile captures written
        self.device_time = DeviceTimeStats()
        self.sync = SyncStats()
        # the last sampled steps: the working step's number, its wall ms,
        # device ms by entry, and the device span from its first event to
        # its last
        self.recent_steps: deque = deque(maxlen=256)
        # the sampled step's entries while it runs (scheduler thread only)
        self.active: list | None = None
        self._lock = threading.Lock()
        self._busy = False  # guarded by self._lock

    # -- the /admin/profile body ----------------------------------------

    @staticmethod
    def prepare() -> None:
        """Start torch.profiler's CUDA tracer (kineto over CUPTI) on the
        calling thread with one empty session. It initializes at its first
        CUDA session and must do so on the thread that imported torch: a
        first session on an HTTP handler thread records no kernel ("External
        init callback must run in same thread as registerClient"). The
        server calls this on the thread that builds it."""
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                pass

    def capture(self, directory: str, ms: float) -> dict:
        """Write one torch.profiler trace (CPU and, on a card, CUDA
        activities) of the next `ms` milliseconds to
        `directory`/trace.json (created). Synchronous: the caller's thread
        sleeps out the window while the other threads keep launching, so
        a return means the trace is on disk. Raises RuntimeError("capture
        busy") while a capture or a sampled step owns the profiler."""
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._busy:
                raise RuntimeError("capture busy: a profiler capture or a "
                                   "sampled step is running in this "
                                   "process")
            self._busy = True
        try:
            os.makedirs(directory, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                time.sleep(max(float(ms), 0.0) / 1e3)
            path = os.path.join(directory, "trace.json")
            prof.export_chrome_trace(path)
            self.captures += 1
            if TRACER.enabled:
                TRACER.event("profile", 0, dir=directory, ms=float(ms))
            return {"dir": directory, "ms": float(ms), "trace": path}
        finally:
            with self._lock:
                self._busy = False

    # -- sampled step attribution ----------------------------------------

    def step_begin(self):
        """At the top of a working step: the step's start event when THIS
        step is sampled (``active`` armed), else None."""
        self._n += 1
        if self._n % self.sample_every:
            return None
        if not torch.cuda.is_available():
            self.sample_failures += 1
            return None
        with self._lock:
            if self._busy:
                return None  # an /admin/profile capture owns the profiler
            self._busy = True
        self.active = []
        return _event()

    def timed(self, name: str, fn, *args):
        """Run fn(*args); inside a sampled step, between two CUDA events
        recorded on the current stream under entry `name`."""
        rec = self.active
        if rec is None:
            return fn(*args)
        start = _event()
        try:
            return fn(*args)
        finally:
            rec.append((name, start, _event()))

    def step_end(self, start, wall_ms: float | None = None) -> None:
        """At the end of the sampled step: record the end event and hand
        the wait and the attribution to a daemon thread, so the scheduler
        thread goes back to launching at once."""
        entries, self.active = self.active, None
        end = _event()
        with self._lock:
            self._busy = False
        threading.Thread(target=self._ingest,
                         args=(self._n, start, end, entries, wall_ms),
                         name="dlprof-ingest", daemon=True).start()

    def _ingest(self, n: int, start, end, entries: list, wall_ms) -> None:
        try:
            end.synchronize()
            per: dict[str, float] = {}
            for name, s, e in entries:
                per[name] = per.get(name, 0.0) + s.elapsed_time(e)
            for name, ms in per.items():
                self.device_time.record(name, ms)
            device_ms = sum(per.values())
            self.sync.record(0.0, device_ms, wall_ms)
            self.recent_steps.append({"step": n, "wall_ms": wall_ms,
                               "device_ms": device_ms,
                               "span_ms": start.elapsed_time(end),
                               "by_entry": per})
            if TRACER.enabled:
                TRACER.event(
                    "sync", 0, sync_ms=0.0, device_ms=round(device_ms, 4),
                    wall_ms=(None if wall_ms is None else round(wall_ms, 4)),
                    share=0.0 if device_ms else None)
            self.sampled += 1
        except Exception:  # noqa: BLE001 — attribution is best effort
            self.sample_failures += 1

    def summary(self) -> dict:
        """The ``device_time`` /stats block (present when sampling on)."""
        return {"sample_every": self.sample_every,
                "sampled_steps": self.sampled,
                "sample_failures": self.sample_failures,
                "captures": self.captures,
                "by_entry": self.device_time.summary(),
                "sync": self.sync.summary()}

    def reset(self) -> None:
        self.sample_every = 0
        self._n = 0
        self.sampled = 0
        self.sample_failures = 0
        self.captures = 0
        self.device_time = DeviceTimeStats()
        self.sync = SyncStats()
        self.recent_steps = deque(maxlen=256)
        self.active = None


PROFILER = Profiler()
