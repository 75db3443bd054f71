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
  * auto-sizing (JAX :391-556): the autotune artifact's contract
    (``validate_autotune``, ``load_autotune``, from the stdlib-only
    tools/dlprof.py) and ``resolve_auto_shape``,
    which resolves ``--serve-batch auto`` and ``--prefix-blocks auto``
    from the ledger's headroom capped by the calibrated batch knee
    (``tools/autotune.py`` measures it on the card).
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
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque

import torch

from ..quants.torch_codec import QuantizedTensor
from ..tools.dlprof import (AUTOTUNE_KIND, AUTOTUNE_VERSION,  # noqa: F401
                           load_autotune, validate_autotune)
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
        self.by_key: dict[str, dict] = {}  # dlrace: guarded-by(self._lock)

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
    """{bytes_in_use, bytes_limit} of a CUDA device; None on the CPU.
    In use: the caching allocator's allocated bytes. Limit: what the
    allocator could hold, its reserved bytes plus the free bytes that
    cudaMemGetInfo reports (the card's total would count the CUDA context
    and memory that torch does not own as free)."""
    if device.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(device)
    free, _total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.memory_reserved(device)) + int(free)}


def ranks_on_card(mesh) -> int:
    """How many ranks of the mesh share this rank's card (parallel/mesh.py
    rank_device: rank r on cuda:(r % cards))."""
    from ..parallel.mesh import rank_device

    return sum(rank_device(mesh.device.type, r) == mesh.device
               for r in range(mesh.world))


def least_headroom(local: dict | None, mesh, share: int | None = None):
    """The device numbers of the mesh's rank with the least headroom,
    from each rank's own (`local`: device_memory_stats's, with the
    allocator's reserved bytes as `bytes_reserved`). A card that
    `share` ranks hold (default: ranks_on_card) lends each of them its
    share of the free bytes, not all of them: two ranks on one 80 GB card
    size against 40 GB each, not 80 GB twice. Every rank calls it (one
    gather over the mesh); None on the CPU."""
    from ..parallel.collectives import all_gather
    from ..parallel.mesh import WORLD

    if local is None or mesh is None or mesh.world == 1:
        return local
    share = share or ranks_on_card(mesh)
    reserved = int(local.get("bytes_reserved", 0))
    free = int(local["bytes_limit"]) - reserved
    mine = torch.tensor([int(local["bytes_in_use"]), reserved + free // share],
                        dtype=torch.int64, device=mesh.device)
    every = all_gather(mine, mesh, WORLD).tolist()
    in_use, limit = min(every, key=lambda r: r[1] - r[0])
    return {"bytes_in_use": in_use, "bytes_limit": limit}


def hbm_ledger(engine, prefix_cache=None, *, block_len: int | None = None,
               device_stats: dict | None | bool = True) -> dict:
    """Live bytes by category for one engine (the ``hbm`` /stats block):
    weights (every param but the vocab tables), vocab (tok_emb and wcls),
    KV slots (the whole (B, KVH, S, hs) cache), the prefix cache's K/V
    arena, the modelled logits workspace ((B, vocab) f32 logits and one
    (B, chunk, dim) activation). ``per_block_bytes`` is one more arena
    block (of the cache's block length; without a cache, of `block_len`,
    default 32 tokens). ``device_stats``: True reads
    ``device_memory_stats`` (None on the CPU), a dict stands in for it (a
    dict with only ``bytes_limit`` takes the accounted bytes as in use:
    what-if sizing), None skips it. With device numbers: the bytes in use
    and the limit, the unaccounted rest, and the headroom in KV slots and
    arena blocks."""
    spec = engine.spec
    params = engine.params
    vocab_b = _tensor_bytes([params[k] for k in ("tok_emb", "wcls")
                             if k in params])
    weights = _tensor_bytes({k: v for k, v in params.items()
                             if k not in ("tok_emb", "wcls")})
    kv = _tensor_bytes([engine.cache.k, engine.cache.v])
    arena, n_blocks, bl = 0, 0, block_len
    if prefix_cache is not None:
        arena = _tensor_bytes([prefix_cache.arena_k, prefix_cache.arena_v])
        n_blocks, bl = prefix_cache.num_blocks, prefix_cache.block_len
    cache_itemsize = torch.empty((), dtype=engine.cache_dtype).element_size()
    compute_itemsize = torch.empty((), dtype=engine.compute_dtype).element_size()
    logits_ws = (engine.batch * spec.vocab_size * 4
                 + engine.batch * engine.prefill_chunk * spec.dim
                 * compute_itemsize)
    per_slot = (kv // engine.batch if engine.batch else 0) or (
        2 * spec.n_layers * spec.n_kv_heads * engine.seq_len
        * spec.head_size * cache_itemsize)
    per_block = (arena // n_blocks if n_blocks else
                 2 * spec.n_layers * spec.n_kv_heads * int(bl or 32)
                 * spec.head_size * cache_itemsize)
    accounted = weights + vocab_b + kv + arena + logits_ws
    dev = (device_memory_stats(engine.device) if device_stats is True
           else (device_stats or None))
    if dev is not None and "bytes_in_use" not in dev:
        dev = {"bytes_in_use": accounted,
               "bytes_limit": int(dev.get("bytes_limit") or 0) or None}
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
    if dev is not None:
        out.update(device_bytes_in_use=dev["bytes_in_use"],
                   device_bytes_limit=dev["bytes_limit"],
                   unaccounted_bytes=max(dev["bytes_in_use"] - accounted, 0))
        if dev["bytes_limit"]:
            free = max(dev["bytes_limit"] - dev["bytes_in_use"], 0)
            out.update(headroom_bytes=free,
                       slots_addable=free // per_slot if per_slot else None,
                       prefix_blocks_addable=(free // per_block
                                              if per_block else None))
    return out


# -- auto-sizing ------------------------------------------------------------

# the knee when no calibration artifact is given: decode reads every
# weight once a step, so batching pays until the KV traffic competes with
# the weight read; 32 rows is the JAX package's conservative default.
# Calibrate the card's own with `python -m
# distributed_llama_tpu_torch.tools.autotune`
DEFAULT_KNEE_ROWS = 32
# the share of an ITL SLO a decode step may take when the curve raises the
# knee: a mixed iteration's wall is the decode step plus one (B, C) chunk,
# and the policy must hold its widest rung
ITL_BUDGET_FRAC = 0.2


def resolve_auto_shape(engine, *, serve_batch, prefix_blocks=0,
                       prefix_block_len: int = 32,
                       autotune: dict | None = None,
                       slo_itl_ms: float | None = None,
                       device_stats=True) -> dict:
    """Resolve ``--serve-batch auto`` and ``--prefix-blocks auto`` against
    a built template engine (JAX runtime/profiler.py:439):

      * serve_batch: the target capped by the KV slots the headroom can
        hold. The target is the knee (the artifact's, else
        ``DEFAULT_KNEE_ROWS``), raised to the largest measured batch whose
        decode-step p50 fits ``ITL_BUDGET_FRAC`` of ``slo_itl_ms`` when an
        ITL SLO and a curve are both given. Without device numbers (the
        CPU) the target stands alone.
      * prefix_blocks: the 2 x B x context target, capped at HALF the
        blocks the headroom could hold (the arena must not eat the
        headroom the slots were just granted). Both caps read the same
        headroom, so the slots and the arena together may exceed it:
        ``decision_bytes`` is what a decision allocates.

    Over ranks the headroom is the least of any rank's, each rank counting
    its share of a card that ranks share (least_headroom); the ledger's
    bytes are one rank's shard and its KV heads.

    The port has one engine per server, so the record's ``replicas`` is 1
    (the JAX package splits the caps across its replica tier). Returns
    the decision record: the chosen values, every input, and each value's
    basis ("autotune" | "default_heuristic" | "slo_curve" |
    "hbm_cap" | "static" | "context_heuristic"). Raises ValueError for an
    engine without weights or a cache to ledger."""
    if getattr(engine, "params", None) is None or not hasattr(engine,
                                                              "cache"):
        raise ValueError(
            "auto sizing needs a ledger-capable local engine (the "
            "process tier's workers own their engines — pass explicit "
            "sizes there; calibrate with tools/autotune.py and read the "
            "recommendation)")
    mesh = getattr(engine, "mesh", None)
    if device_stats is True and mesh is not None and mesh.world > 1:
        # every rank's numbers, the least headroom decides (an op)
        device_stats = engine.ranks_device_stats()
    ledger = hbm_ledger(engine, block_len=prefix_block_len,
                        device_stats=device_stats)
    knee = None
    knee_basis = "default_heuristic"
    if autotune is not None:
        k = (autotune.get("knee") or {}).get("knee_rows")
        if k:
            knee = int(k)
            knee_basis = "autotune"
    if knee is None:
        knee = DEFAULT_KNEE_ROWS
    target, target_basis = knee, knee_basis
    rows_under_slo = None
    if slo_itl_ms and autotune is not None:
        budget = ITL_BUDGET_FRAC * float(slo_itl_ms)
        afford = [int(p["rows"]) for p in autotune.get("decode_curve") or ()
                  if p.get("p50_ms") is not None and p["p50_ms"] <= budget]
        if afford:
            rows_under_slo = max(afford)
            if rows_under_slo > target:
                target, target_basis = rows_under_slo, "slo_curve"
    inputs = {
        "knee_rows": knee,
        "knee_basis": knee_basis,
        "slo_itl_ms": slo_itl_ms,
        "rows_under_itl_slo": rows_under_slo,
        "replicas": 1,
        "per_slot_bytes": ledger["per_slot_bytes"],
        "per_block_bytes": ledger["per_block_bytes"],
        "headroom_bytes": ledger["headroom_bytes"],
        "slots_addable": ledger["slots_addable"],
        "prefix_blocks_addable": ledger["prefix_blocks_addable"],
    }
    out = {"inputs": inputs}
    if serve_batch == "auto":
        cap = None
        if ledger["slots_addable"] is not None:
            cap = max(int(ledger["slots_addable"]), 1)
        b = min(target, cap) if cap is not None else target
        out["serve_batch"] = max(int(b), 1)
        out["serve_batch_basis"] = ("hbm_cap"
                                    if cap is not None and cap < target
                                    else target_basis)
    else:
        out["serve_batch"] = int(serve_batch)
        out["serve_batch_basis"] = "static"
    b = out["serve_batch"]
    if prefix_blocks == "auto":
        bl = max(int(prefix_block_len), 1)
        target = max(2 * b * engine.seq_len // bl, 1)
        cap = None
        if ledger["prefix_blocks_addable"] is not None:
            cap = max(int(ledger["prefix_blocks_addable"]) // 2, 1)
        out["prefix_blocks"] = min(target, cap) if cap is not None \
            else target
        out["prefix_blocks_basis"] = ("hbm_cap"
                                      if cap is not None and cap < target
                                      else "context_heuristic")
    else:
        out["prefix_blocks"] = (int(prefix_blocks)
                                if prefix_blocks else prefix_blocks)
        out["prefix_blocks_basis"] = "static"
    return out


def decision_bytes(decision: dict) -> int:
    """The KV slot and arena bytes a ``resolve_auto_shape`` decision
    allocates."""
    inp = decision["inputs"]
    return (int(decision["serve_batch"]) * inp["per_slot_bytes"]
            + int(decision["prefix_blocks"] or 0) * inp["per_block_bytes"])


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
        self._hist: dict[str, deque] = {}  # dlrace: guarded-by(self._lock)
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
        self._sync = deque(maxlen=self.window)  # dlrace: guarded-by(self._lock)
        self._device = deque(maxlen=self.window)  # dlrace: guarded-by(self._lock)
        self._wall = deque(maxlen=self.window)  # dlrace: guarded-by(self._lock)

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
        self._busy = False  # dlrace: guarded-by(self._lock)

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
        a return means the trace is on disk; the start and the stop hold
        the device gate exclusively (runtime/graphs.DEVICE_GATE), so no
        graph replay is in flight on another thread while CUPTI turns on
        or off: a stop beside a scheduler thread's cudaGraphLaunch hung a
        serving process on the H100 (ROADMAP S1). Raises
        RuntimeError("capture busy") while a capture or a sampled step
        owns the profiler."""
        from torch.profiler import ProfilerActivity, profile

        from .graphs import DEVICE_GATE  # graphs imports this module

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
            prof = profile(activities=acts)
            with DEVICE_GATE.exclusive():
                prof.start()
            try:
                time.sleep(max(float(ms), 0.0) / 1e3)
            finally:
                with DEVICE_GATE.exclusive():
                    prof.stop()
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
