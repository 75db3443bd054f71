"""CUDA graphs of the engine's steps — the port's counterpart of the JAX
engine's jitted steps (runtime/engine.py:669 _compiled_step, and the jitted
loops of decode_greedy_device and generate_device).

A step is a function over static device buffers: its inputs are read from
them at replay and its outputs written to them, so one capture serves every
call. `capture` runs the function once eagerly on a side stream (which
builds and loads every kernel library and runs the kernels' one-time
initialisers, none of which may happen under capture), then records one
more run into a graph with its own memory pool. Nothing falls back to
eager: a capture or replay that fails raises.

The kernel wrappers count their launches in Python, so a graph counts at
capture, where nothing launches. `capture` takes that count back and keeps
it as the graph's tally; every replay adds the tally, so the counters read
as if each replay had launched its kernels one by one, which it does.

A step carries its graph key's name (``profiler.compile_key_str``): inside
a sampled scheduler step (runtime/profiler.py) its replay is timed between
two CUDA events under that name.

Thread replicas (runtime/router.py) serve from several threads of one
process, and a stream capture is process-wide in effect: a kernel another
thread launches on the default stream while a capture is open, or a
memory allocation it makes, invalidates the capture or fails. So every
piece of device work a scheduler does runs under ``DEVICE_GATE.shared()``
(steps, warmups, borrows, block copies, every replay) and ``capture``
takes ``DEVICE_GATE.exclusive()``, as torch.profiler's start and stop do
(runtime/profiler.py): replicas step side by side, and a capture (a
rebuilt replica's, a scaled-up one's, or a key's first use) waits for the
steps and borrows in flight to end and holds the next ones off until it
is done; a borrow that lends the engine for a whole batch delays it, and
the sibling steps queued behind it, for that batch. The scheduler's stall
watchdog leaves the time a step waits at the gate out of its measure.
The exclusion also keeps the capture's launch tally its own: no sibling
counts into the window it takes back. The launches of a thread that set a
scope (``ops/launch_scope.py``) count into that scope as well, replays
included, so each replica's launches are its own.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, NamedTuple

import torch

from ..ops.cuda_attention import flash_attention
from ..ops.cuda_q40 import q40_expert_matmul, q40_gemv_mma, q40_matmul, q80_fused
from ..ops.cuda_q80 import q80_roundtrip
from ..ops import launch_scope
from .profiler import PROFILER

# the wrappers themselves, taken at import: a test that patches a module's
# attribute with a plain version leaves these counters in place (q80_fused
# and q40_gemv_mma count a share of K1's and K2's launches: the fused
# round trip, the small-batch GEMV)
LAUNCH_COUNTERS = (q40_matmul, q40_expert_matmul, q80_fused, flash_attention,
                   q80_roundtrip, q40_gemv_mma)
# their names in a launch scope (ops/launch_scope.py)
LAUNCH_NAMES = ("q40_matmul", "q40_expert_matmul", "q80_fused",
                "flash_attention", "q80_roundtrip", "q40_gemv_mma")


class DeviceGate:
    """A shared/exclusive gate over the process's device work, reentrant
    per thread. ``shared()`` may be held by many threads at once;
    ``exclusive()`` waits until no other thread holds the gate and keeps
    new shared holders out while it waits and while it is held (a capture
    is never starved by a stream of steps). A thread that holds it shared
    and asks for it exclusively (a graph captured at its first use inside
    a step) gives its shared hold up while it waits and gets it back
    after, so two such threads cannot deadlock each other. A holder that
    hands its device work to another thread and waits for it gives its
    hold up meanwhile (``released()``): the helper holds the gate itself,
    and a capture the helper needs does not wait on its waiting caller.
    Each thread's seconds spent waiting at the gate are kept
    (``waited_s``), so a stall watchdog can leave them out."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers: dict[int, int] = {}  # dlrace: guarded-by(self._cond)
        self._writer: int | None = None  # dlrace: guarded-by(self._cond)
        self._depth = 0  # dlrace: guarded-by(self._cond)
        self._waiting = 0  # dlrace: guarded-by(self._cond)
        self._waited: dict[int, float] = {}  # dlrace: guarded-by(self._cond)
        self._since: dict[int, float] = {}  # dlrace: guarded-by(self._cond)
        self.exclusive_waits = 0  # exclusive entries that had to wait

    def _wait_while(self, me: int,  # dlrace: holds(self._cond)
                    blocked: Callable[[], bool]) -> None:
        """Wait (self._cond held) until blocked() is false, timing it."""
        if not blocked():
            return
        t0 = self._since[me] = time.perf_counter()
        try:
            while blocked():
                self._cond.wait()
        finally:
            del self._since[me]
            self._waited[me] = (self._waited.get(me, 0.0)
                                + time.perf_counter() - t0)

    def waited_s(self, ident: int) -> float:
        """Seconds thread `ident` has waited at the gate, a wait in
        progress included."""
        with self._cond:
            t0 = self._since.get(ident)
            return self._waited.get(ident, 0.0) + (
                time.perf_counter() - t0 if t0 is not None else 0.0)

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if not (self._writer == me or me in self._readers):
                self._wait_while(me, lambda: self._writer is not None
                                 or self._waiting)
            self._readers[me] = self._readers.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._readers[me] -= 1
                if not self._readers[me]:
                    del self._readers[me]
                    self._cond.notify_all()

    @contextlib.contextmanager
    def released(self):
        """Give this thread's shared hold up while inside, and take it
        back (waiting like any shared entry) after."""
        me = threading.get_ident()
        with self._cond:
            held = self._readers.pop(me, 0)
            self._cond.notify_all()
        try:
            yield
        finally:
            if held:
                with self._cond:
                    self._wait_while(me, lambda: self._writer is not None
                                     or self._waiting)
                    self._readers[me] = held

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        held = 0
        with self._cond:
            if self._writer == me:
                self._depth += 1
            else:
                held = self._readers.pop(me, 0)
                self._waiting += 1
                self._cond.notify_all()
                if self._writer is not None or self._readers:
                    self.exclusive_waits += 1
                try:
                    self._wait_while(me, lambda: self._writer is not None
                                     or bool(self._readers))
                finally:
                    self._waiting -= 1
                self._writer, self._depth = me, 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._writer = None
                    if held:
                        self._readers[me] = held
                    self._cond.notify_all()


# the one gate of the process (see the module docstring)
DEVICE_GATE = DeviceGate()


class CapturedStep(NamedTuple):
    """One captured step: its graph, what the captured run returned (in
    the graph's pool, overwritten by every replay), the launches of one
    replay a counter, the capture's seconds and pool bytes, and the name
    its replays are timed under."""

    graph: torch.cuda.CUDAGraph
    out: object
    tally: tuple
    capture_s: float
    pool_bytes: int
    name: str = ""

    def replay(self) -> None:
        # shared: no profiler start or stop, and no capture, beside it
        with DEVICE_GATE.shared():
            PROFILER.timed(self.name, self.graph.replay)
        for counter, name, n in zip(LAUNCH_COUNTERS, LAUNCH_NAMES,
                                    self.tally):
            launch_scope.count(counter, name, n)


def capture(fn: Callable[[], object]) -> CapturedStep:
    """Warm fn up once eagerly on a side stream, then capture one run of it.
    The warm-up runs fn for real (its launches count, its writes land), so
    the caller sets the static buffers afterwards. Both run with the
    process's device work held off (DEVICE_GATE.exclusive())."""
    with DEVICE_GATE.exclusive():
        return _capture(fn)


def _capture(fn: Callable[[], object]) -> CapturedStep:  # dlrace: holds(DEVICE_GATE)
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = [c.launches for c in LAUNCH_COUNTERS]
    scoped = launch_scope.current()
    scoped_before = dict(scoped) if scoped is not None else None
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        tally = tuple(c.launches - b for c, b in zip(LAUNCH_COUNTERS, before))
        for c, b in zip(LAUNCH_COUNTERS, before):
            c.launches = b
        if scoped is not None:
            scoped.clear()
            scoped.update(scoped_before)
    torch.cuda.synchronize()
    return CapturedStep(graph, out, tally, time.perf_counter() - t0,
                        pool_bytes(graph))


def pool_bytes(graph: torch.cuda.CUDAGraph) -> int:
    """Bytes the caching allocator holds in the graph's private pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)
