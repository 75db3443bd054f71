"""Starting the ranks: one process per rank, joined by torch.distributed.

  run_ranks  the CLI's launcher (`dllama generate --tp 2` is one command,
             as in the JAX CLI): this process is rank 0, the others are
             spawned, every rank runs the same function, and rank 0 alone
             prints.
  run_node   one node of a multi-node cluster (`dllama ... --nnodes N`):
             this process is the node's first rank and holds its control
             link (parallel/multihost.py); it forms the control star,
             spawns the node's other local ranks, and every rank joins one
             process group at the coordinator's address. A spawned local
             rank exits when the process that started it is gone.
  RankPool   a standing group of worker ranks that run jobs sent by a
             parent which is not itself a rank: tests and chip_smoke.py
             start one group and send it many jobs (a job is a
             "module:function" name and its arguments; every rank calls
             it and its return value comes back). parallel/jobs.py holds
             the jobs. A pool is any grid's: each job builds the mesh of
             its axis sizes over the pool's ranks (parallel/mesh.py).

Processes are spawned, never forked: a child imports only this package,
so a parent that imports jax (a test) hands none of it down. The ranks
meet through a file store in a fresh temporary directory (no TCP port to
race for). Every rendezvous, collective and join is bounded: the process
group's timeout fails a collective that a dead rank never joins, and a
pool's result that does not arrive in time fails the job. A spawned rank
prints every thread's stack to stderr on SIGUSR1. A rank whose function
returned leaves the group only when every rank has (a barrier before
destroy_process_group): a rank that tore its gloo pairs down while another
still finished its own teardown aborted that one ("terminate called
without an active exception", exit -6).
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib
import io
import multiprocessing as mp
import os
import queue
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import init_ranks


def _rendezvous() -> tuple[str, str]:
    """A fresh rendezvous for one group of ranks: a file store in a new
    temporary directory (no port to race for), and that directory, which
    the caller removes when the ranks are done."""
    d = tempfile.mkdtemp(prefix="dllama-ranks-")
    return f"file://{os.path.join(d, 'store')}", d


def pack(obj) -> bytes:
    """Tensors, QuantizedTensors and plain objects as bytes for another
    rank (torch.save: bf16 and f16 survive, no shared-memory handles)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def unpack(blob: bytes):
    """The inverse of pack; only for bytes this program's ranks wrote."""
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=False)


def _resolve(name: str):
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def _run_and_leave(fn: str, args: tuple) -> None:
    """Run one rank's function, then leave the process group: after a
    barrier when it returned (every rank leaves together), at once when it
    raised (the others fail on their next collective)."""
    try:
        _resolve(fn)(*args)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cli_rank(rank: int, world: int, init: str, device_type: str,
              timeout_s: float, fn: str, args: tuple) -> None:
    """A spawned CLI rank: its output is dropped (rank 0 prints)."""
    sys.stdout = open(os.devnull, "w")
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    _share_cores(device_type, world)
    init_ranks(rank, world, init, device_type, timeout_s)
    _run_and_leave(fn, args)


def _join(procs: list, ranks: list[int], timeout_s: float) -> list:
    """Wait for spawned ranks (killing one still running after
    `timeout_s`); the (rank, exit code) of those that failed."""
    for p in procs:
        p.join(timeout_s)
        if p.is_alive():
            p.terminate()
            p.join(5)
    return [(r, p.exitcode) for r, p in zip(ranks, procs) if p.exitcode]


def _raise_failed(bad: list) -> None:
    if bad:
        raise RuntimeError(f"ranks failed (rank, exit code): {bad}")


def run_ranks(world: int, device_type: str, fn: str, args: tuple,
              timeout_s: float) -> None:
    """Run `fn(*args)` on `world` ranks: this process as rank 0, the others
    spawned. Raises if a spawned rank fails; a rank still running
    `timeout_s` after rank 0 returned is killed."""
    init, store_dir = _rendezvous()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_cli_rank, daemon=True,
                         args=(r, world, init, device_type, timeout_s, fn, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        init_ranks(0, world, init, device_type, timeout_s)
        _run_and_leave(fn, args)
    finally:
        bad = _join(procs, list(range(1, world)), timeout_s)
        shutil.rmtree(store_dir, ignore_errors=True)
    _raise_failed(bad)


def _follow_parent(parent: int) -> None:
    """Exit (code 1) once the process that spawned this one is gone: a
    node's link holder that exits on a lost peer takes its local ranks
    with it, wherever they wait."""
    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(0.2)
        os._exit(1)

    threading.Thread(target=watch, name="dllama-parent-watch",
                     daemon=True).start()


def _node_rank(rank: int, world: int, nnodes: int, coordinator: str,
               device_type: str, timeout_s: float, fn: str, args: tuple,
               parent: int) -> None:
    """A spawned local rank of a cluster node: its output is dropped."""
    from . import multihost as mh

    sys.stdout = open(os.devnull, "w")
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    _follow_parent(parent)
    _share_cores(device_type, world // nnodes)
    mh.join_data_plane(coordinator, rank, world, nnodes, device_type,
                       timeout_s)
    _run_and_leave(fn, args)


def run_node(nnodes: int, node_rank: int, world: int, coordinator: str,
             device_type: str, fn: str, args: tuple, timeout_s: float, *,
             connect_timeout: float, heartbeat_interval: float,
             worker_timeout: float) -> None:
    """Run `fn(*args)` on the world / nnodes ranks of node `node_rank` of a
    cluster: form the control star (multihost.init_multihost; a
    formation failure raises ClusterProtocolError before anything is
    spawned), spawn the node's other local ranks, join the process group
    with them as the node's first rank, and run. Raises if a spawned rank
    fails; one still running `timeout_s` after this one returned is
    killed."""
    from . import multihost as mh

    ctx = mp.get_context("spawn")
    ranks = mh.node_ranks(node_rank, world, nnodes)[1:]
    procs = [ctx.Process(target=_node_rank, daemon=True, args=(
        r, world, nnodes, coordinator, device_type, timeout_s, fn, args,
        os.getpid())) for r in ranks]

    def start() -> None:
        for p in procs:
            p.start()

    _share_cores(device_type, world // nnodes)
    try:
        mh.init_multihost(coordinator, nnodes, node_rank, world=world,
                          device_type=device_type, timeout_s=timeout_s,
                          connect_timeout=connect_timeout,
                          heartbeat_interval=heartbeat_interval,
                          worker_timeout=worker_timeout, before_join=start)
        _run_and_leave(fn, args)
    finally:
        bad = _join([p for p in procs if p.pid is not None],
                    [r for r, p in zip(ranks, procs) if p.pid is not None],
                    timeout_s)
    _raise_failed(bad)


def _share_cores(device_type: str, world: int) -> None:
    """CPU ranks share the host's cores: each spawned rank takes its share
    of torch's intra-op threads instead of all of them."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))


def _pool_worker(rank: int, world: int, init: str, device_type: str,
                 timeout_s: float, jobs, results) -> None:
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    _share_cores(device_type, world)
    init_ranks(rank, world, init, device_type, timeout_s)
    try:
        while (job := jobs.get()) is not None:
            name, args = job
            try:
                results.put((rank, True, _resolve(name)(*args)))
            except Exception:      # reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` spawned ranks of one process group, running jobs; close()
    (or the with-block's end) stops them."""

    def __init__(self, world: int, device_type: str,
                 timeout_s: float = 60.0):
        self.world, self.timeout_s = world, timeout_s
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        init, self._store_dir = _rendezvous()
        self._procs = [ctx.Process(
            target=_pool_worker, daemon=True,
            args=(r, world, init, device_type, timeout_s, self._jobs[r],
                  self._results)) for r in range(world)]
        for p in self._procs:
            p.start()
        self._broken = False

    def run(self, fn: str, *args, partial: bool = False):
        """Every rank's return value of `fn(*args)`, in rank order. A job
        that fails on any rank, or does not answer within the timeout,
        raises, and the pool takes no more jobs. With `partial` (a job in
        which ranks are meant to die) the ranks that gave no answer
        within the timeout read None, and the pool takes no more jobs."""
        if self._broken:
            raise RuntimeError("the rank pool failed an earlier job")
        for q in self._jobs:
            q.put((fn, args))
        out, errors, seen = [None] * self.world, [], 0
        end = time.monotonic() + self.timeout_s
        while seen < self.world:
            try:
                rank, ok, val = self._results.get(
                    timeout=0.2 if partial else self.timeout_s)
            except queue.Empty:
                # a partial job ends once every rank answered or is gone
                gone = [p for p in self._procs if not p.is_alive()]
                if partial and (time.monotonic() > end
                                or seen + len(gone) >= self.world):
                    self._broken = True
                    return out
                if partial:
                    continue
                self._broken = True
                raise TimeoutError(f"{fn}: no answer from every rank in "
                                   f"{self.timeout_s} s") from None
            seen += 1
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            self._broken = True
            raise RuntimeError(f"{fn} failed:\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self._jobs:
            with contextlib.suppress(Exception):
                q.put(None)
        for p in self._procs:
            p.join(5 if not self._broken else 1)
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(self._store_dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
