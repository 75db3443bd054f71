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
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from ..ops.cuda_attention import flash_attention
from ..ops.cuda_q40 import q40_expert_matmul, q40_matmul, q80_fused
from ..ops.cuda_q80 import q80_roundtrip

# the wrappers themselves, taken at import: a test that patches a module's
# attribute with a plain version leaves these counters in place
LAUNCH_COUNTERS = (q40_matmul, q40_expert_matmul, q80_fused, flash_attention,
                   q80_roundtrip)


class CapturedStep(NamedTuple):
    """One captured step: its graph, what the captured run returned (in
    the graph's pool, overwritten by every replay), the launches of one
    replay a counter, and the capture's seconds and pool bytes."""

    graph: torch.cuda.CUDAGraph
    out: object
    tally: tuple
    capture_s: float
    pool_bytes: int

    def replay(self) -> None:
        self.graph.replay()
        for counter, n in zip(LAUNCH_COUNTERS, self.tally):
            counter.launches += n


def capture(fn: Callable[[], object]) -> CapturedStep:
    """Warm fn up once eagerly on a side stream, then capture one run of it.
    The warm-up runs fn for real (its launches count, its writes land), so
    the caller sets the static buffers afterwards."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = [c.launches for c in LAUNCH_COUNTERS]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        tally = tuple(c.launches - b for c, b in zip(LAUNCH_COUNTERS, before))
        for c, b in zip(LAUNCH_COUNTERS, before):
            c.launches = b
    torch.cuda.synchronize()
    return CapturedStep(graph, out, tally, time.perf_counter() - t0,
                        pool_bytes(graph))


def pool_bytes(graph: torch.cuda.CUDAGraph) -> int:
    """Bytes the caching allocator holds in the graph's private pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)
