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
  * ``PROFILER``: every ``sample_every``-th working scheduler step is
    timed on the card with CUDA events around the step (the device span
    from the step's first launch to its last, idle gaps included), under
    the entry ``scheduler_step``. Off (the default) it costs one
    attribute read a step.

Auto-sizing (``resolve_auto_shape`` and the autotune artifact) and the
on-demand trace capture are not ported.
"""

from __future__ import annotations

import re
import threading
from collections import deque

import torch

from ..quants.torch_codec import QuantizedTensor
from .stats import percentile

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
        if self.freeze:
            from .scheduler import RequestError

            raise RequestError(
                "compile_after_warmup",
                f"new graph key {ks!r} after warmup with the serving set "
                "frozen", retryable=False)

    def record(self, key, ms: float) -> None:
        ks = compile_key_str(key)
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


# -- sampled step device time -----------------------------------------------


class DeviceTimeStats:
    """Per-entry device-ms windows fed by the sampled steps."""

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


class Profiler:
    """Sampled per-step device time (singleton ``PROFILER``). Off
    (``sample_every == 0``) call sites pay one attribute read a step;
    on, every Nth working step is bracketed by two CUDA events on the
    current stream and its device ms recorded under ``scheduler_step``.
    On the CPU a sampled step records nothing and counts a failure: there
    is no device time to read."""

    ENTRY = "scheduler_step"

    def __init__(self):
        self.sample_every = 0       # 0 = off
        self._n = 0                 # working-step counter
        self.sampled = 0
        self.sample_failures = 0
        self.device_time = DeviceTimeStats()

    def step_begin(self):
        """At the top of a working step: the start event when THIS step
        is sampled, else None."""
        self._n += 1
        if self._n % self.sample_every:
            return None
        if not torch.cuda.is_available():
            self.sample_failures += 1
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start

    def step_end(self, start, wall_ms: float | None = None) -> None:
        """At the end of the sampled step: record the end event, wait for
        it, and keep the device ms between the two."""
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        self.device_time.record(self.ENTRY, start.elapsed_time(end))
        self.sampled += 1

    def summary(self) -> dict:
        """The ``device_time`` /stats block (present when sampling on)."""
        return {"sample_every": self.sample_every,
                "sampled_steps": self.sampled,
                "sample_failures": self.sample_failures,
                "by_entry": self.device_time.summary()}

    def reset(self) -> None:
        self.sample_every = 0
        self._n = 0
        self.sampled = 0
        self.sample_failures = 0
        self.device_time = DeviceTimeStats()


PROFILER = Profiler()
