"""Per-replica launch attribution: the kernel wrappers count their launches
(``count``) in process-wide counters (``q40_matmul.launches`` and the
like), which thread replicas serving from one process share. A thread
that sets a scope (a dict) while it steps one replica's engine gets that
replica's launches added to the dict too, under the counter's name, so
the replicas' dicts sum to the process-wide totals. Counting stays in
Python, next to the global counters: a replayed graph adds its tally to
both (runtime/graphs.py)."""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def count(counter, name: str, n: int = 1) -> None:
    """Add n launches to a wrapper's process-wide counter
    (``counter.launches``) and, under `name`, to this thread's scope if
    one is set."""
    counter.launches += n
    counts = getattr(_local, "counts", None)
    if counts is not None and n:
        counts[name] = counts.get(name, 0) + n


def current() -> dict | None:
    return getattr(_local, "counts", None)


@contextlib.contextmanager
def scope(counts: dict):
    """Attribute this thread's launches to `counts` while inside."""
    prev = getattr(_local, "counts", None)
    _local.counts = counts
    try:
        yield counts
    finally:
        _local.counts = prev
