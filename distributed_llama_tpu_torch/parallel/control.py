"""The control channel of serving over ranks — the same-host counterpart of
the JAX package's root-to-worker replay (parallel/multihost.py:1077 RunMsg,
:1166 send_run, :1181 send_api), and the only place where the port's ranks
exchange control.

Under `chat` and `api` the inputs exist on rank 0 alone: stdin, HTTP
bodies, client disconnects, deadlines and every choice of the scheduler
and the samplers. So rank 0 runs every host layer, and the other ranks run
a follower loop (`Control.follow`) that executes the engine calls rank 0
mirrors to them, in the order rank 0 ran them:

  * One op stream. An engine method that issues a collective, or changes
    state a follower holds, is marked `@mirrored`. On rank 0 a call of it
    is one op: its name, its target (an engine or a draft, by id) and its
    host arguments (numpy arrays, numbers, strings). A device tensor that
    an earlier op returned travels as a reference (`Ref`), which each
    follower resolves to its own result of that op; a reference is dropped
    on every rank once rank 0's tensor is garbage. The engine's `pos`
    rides along with every op, so a host loop that moves it on rank 0
    (Engine.generate, the speculative loops, the server's prefix reuse)
    never desynchronises a follower.
  * Atomic send-then-run. Rank 0 broadcasts the op and runs it under one
    lock (an RLock: a mirrored method that calls another runs the inner
    one locally, as every follower does). Whatever thread calls the
    engine, the lock is the one order every rank sees: the supervisor's
    loop and rebuild, HTTP threads, the idle pinger.
  * An acknowledgement. After an op every rank contributes its status
    (ok, or raised). All ok: done. All raised the same way (a refused
    argument): rank 0 raises it and the ranks stay in step. Any other
    mix, a collective that failed or a peer that is gone: the run is lost
    (`RankLost`, naming the ranks), on rank 0 and on every follower.
  * Idle is not death. Every wait is bounded by the channel's timeout
    (the CLI's RANK_TIMEOUT_S), and an idle rank 0 sends a ping op every
    quarter of it, so followers wait through any idle stretch while a
    rank 0 that stops answering fails them in bounded time.
  * Death is bounded. A follower that dies makes rank 0's next op (a ping
    at the latest) fail at once: gloo sees the closed connection, and the
    process table names the rank. A rank 0 that dies fails the followers'
    wait the same way.
  * Shutdown. `close()` sends the shutdown op; `follow()` returns, and the
    CLI's run_ranks joins every rank.

Control rides a gloo group of its own over every rank, so it waits on the
host whatever carries the data collectives (NCCL when every rank has a
card of its own).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist

PING = "ping"
SHUTDOWN = "shutdown"


class RankLost(RuntimeError):
    """The ranks are no longer in step: a rank died, stopped answering,
    or failed an op the others ran. `ranks` names the ranks at fault
    (empty when they cannot be told apart)."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = list(ranks)


@dataclasses.dataclass(frozen=True)
class Ref:
    """A device tensor that op `seq` returned (element `idx` of a tuple)."""

    seq: int
    idx: int


@dataclasses.dataclass(frozen=True)
class ObjRef:
    """A mirrored object (an engine or a draft) that rank 0 let go of."""

    oid: int


class OwnCache:
    """The target object's own KV cache as an argument (a draft steps only
    the cache it owns)."""


def mirrored(fn):
    """Mark an engine or draft method as an op: on rank 0 of a mirrored
    engine it is broadcast, then run; anywhere else (one rank, a follower,
    or inside another op) it runs locally."""
    name = fn.__name__

    @functools.wraps(fn)
    def op(self, *args, **kw):
        ctl = self.control
        if ctl is None or ctl.inside():
            return fn(self, *args, **kw)
        return ctl.call(self, name, fn, args, kw)

    return op


def _alive(pid: int) -> bool:
    """Whether process `pid` still runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        return True


class Control:
    """One rank's end of the control channel over `mesh` (every rank
    builds one, at the same point: the constructor is collective).
    `timeout_s` bounds every wait of the channel; an idle rank 0 pings
    every quarter of it."""

    def __init__(self, mesh, timeout_s: float):
        self.rank, self.world = mesh.rank, mesh.world
        self.timeout_s = float(timeout_s)
        self.ping_s = self.timeout_s / 4
        self.group = dist.new_group(
            list(range(self.world)), backend="gloo",
            timeout=datetime.timedelta(seconds=self.timeout_s))
        pids: list = [None] * self.world
        dist.all_gather_object(pids, os.getpid(), group=self.group)
        self.pids = pids
        self._lock = threading.RLock()
        self._local = threading.local()
        self._objs: dict = {}          # followers: oid -> object
        self._next_oid = 0
        self._seq = 0
        self._keys: dict = {}          # rank 0: id(tensor) -> Ref
        self._results: dict = {}       # followers: Ref -> tensor
        self._drops: list = []         # rank 0: Refs and ObjRefs that died
        self._last = time.monotonic()
        self._on_lost: list = []
        self._pinger: threading.Thread | None = None
        self.lost: str | None = None
        self.closed = False
        # ops sent, their host seconds with the channel's own share (the
        # broadcast and the acknowledgement), and idle pings
        self.stats = dict(ops=0, op_s=0.0, control_s=0.0, pings=0)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def inside(self) -> bool:
        """Whether this thread runs an op already (inner calls are local)."""
        return getattr(self._local, "depth", 0) > 0

    def on_lost(self, fn) -> None:
        """Call fn(message) once when the run is lost (rank 0)."""
        self._on_lost.append(fn)

    # -- objects -------------------------------------------------------------

    def attach(self, obj) -> None:
        """Register the rank's engine built at start (object 0 on every
        rank). On rank 0 the engine becomes mirrored, and an idle pinger
        starts."""
        self._register_obj(obj)
        if self.is_root:
            obj.control = self
            self._pinger = threading.Thread(target=self._ping_loop,
                                            name="dllama-control-ping",
                                            daemon=True)
            self._pinger.start()

    def _register_obj(self, obj) -> None:
        """Number an engine or draft the same way on every rank; on rank 0
        it becomes mirrored, and its death drops it on the followers."""
        oid, self._next_oid = self._next_oid, self._next_oid + 1
        obj._ctl_id = oid
        if not self.is_root:
            self._objs[oid] = obj
            return
        weakref.finalize(obj, self._dropped, ObjRef(oid))
        if not isinstance(getattr(type(obj), "control", None), property):
            obj.control = self

    def _register(self, seq: int, out) -> None:
        """Record an op's result the same way on every rank: tensors as
        references, engines and drafts as objects."""
        items = out if isinstance(out, tuple) else (out,)
        for i, v in enumerate(items):
            if isinstance(v, torch.Tensor):
                ref = Ref(seq, i)
                if self.is_root:
                    self._keys[id(v)] = ref
                    weakref.finalize(v, self._forget, id(v), ref)
                else:
                    self._results[ref] = v
            elif getattr(v, "_mirrorable", False):
                self._register_obj(v)

    def _forget(self, key: int, ref: Ref) -> None:
        if self._keys.get(key) == ref:
            del self._keys[key]
        self._dropped(ref)

    def _dropped(self, ref) -> None:
        """Queue a dead result or object: the next op drops it on every
        follower."""
        self._drops.append(ref)

    def _encode(self, v):
        if isinstance(v, torch.Tensor):
            ref = self._keys.get(id(v))
            if ref is None:
                raise ValueError("a mirrored op got a device tensor that no "
                                 "earlier op returned: followers cannot "
                                 "resolve it")
            return ref
        if type(v).__name__ == "KVCache":
            return OwnCache()
        if isinstance(v, (list, tuple)):
            return type(v)(self._encode(x) for x in v)
        if isinstance(v, dict):
            return {k: self._encode(x) for k, x in v.items()}
        return v

    def _decode(self, v, obj):
        if isinstance(v, Ref):
            return self._results[v]
        if isinstance(v, OwnCache):
            return obj.cache
        if isinstance(v, (list, tuple)):
            return type(v)(self._decode(x, obj) for x in v)
        if isinstance(v, dict):
            return {k: self._decode(x, obj) for k, x in v.items()}
        return v

    # -- rank 0 --------------------------------------------------------------

    def call(self, obj, name: str, fn, args: tuple, kw: dict):
        """Send op `name` on `obj`, then run fn(obj, *args, **kw) here,
        then collect every rank's status. Raises RankLost when the ranks
        fell out of step."""
        if not self._lock.acquire(timeout=self.timeout_s):
            self._lose(f"op {name}: the op lock stayed held for "
                       f"{self.timeout_s:.0f} s by an op that never ended")
        try:
            self._check()
            if obj is not None and obj._ctl_id is None:
                raise ValueError(f"op {name} on an object that no op built: "
                                 "the other ranks do not hold it")
            t0 = time.perf_counter()
            seq, drops = self._seq + 1, self._drops
            msg = (seq, None if obj is None else obj._ctl_id, name,
                   self._encode(args), self._encode(kw),
                   getattr(obj, "pos", None), drops)
            self._seq, self._drops = seq, []
            try:
                dist.broadcast_object_list([msg], src=0, group=self.group)
            except RuntimeError as e:      # a peer is gone
                self._lose(f"op {name}: sending it failed: {self._who(e)}")
            except Exception:
                # unpicklable arguments: nothing was sent, the ranks are
                # in step and the caller gets the error
                self._seq, self._drops = seq - 1, drops + self._drops
                raise
            self._last = time.monotonic()
            t1 = time.perf_counter()
            self._local.depth = getattr(self._local, "depth", 0) + 1
            out, err = None, None
            try:
                if fn is not None:
                    out = fn(obj, *args, **kw)
            except Exception as e:  # noqa: BLE001 — judged by the ack
                err = e
            finally:
                self._local.depth -= 1
            t2 = time.perf_counter()
            self._ack(name, err)
            self.stats["ops"] += 1
            self.stats["op_s"] += time.perf_counter() - t0
            self.stats["control_s"] += (t1 - t0) + (time.perf_counter() - t2)
            if err is not None:
                raise err
            self._register(seq, out)
            return out
        finally:
            self._lock.release()

    def ping(self) -> None:
        """An op that runs nothing: keeps idle followers waiting, and
        finds a dead one."""
        self.stats["pings"] += 1
        self.call(None, PING, None, (), {})

    def close(self) -> None:
        """Send the shutdown op (rank 0): every follower's loop returns."""
        if self.closed:
            return
        if self.lost is None:
            try:
                self.call(None, SHUTDOWN, None, (), {})
            except RankLost:
                pass
        self.closed = True
        if self._pinger is not None:
            self._pinger.join(timeout=5.0)

    def _ping_loop(self) -> None:
        while not self.closed and self.lost is None:
            time.sleep(min(self.ping_s / 4, 1.0))
            if self.closed or self.lost is not None:
                return
            if time.monotonic() - self._last >= self.ping_s:
                try:
                    self.ping()
                except RankLost:
                    return
                except RuntimeError:      # closed meanwhile
                    return

    def _check(self) -> None:
        if self.lost is not None:
            raise RankLost(self.lost)
        if self.closed:
            raise RuntimeError("the control channel is closed")

    # -- every rank ----------------------------------------------------------

    def _ack(self, name: str, err) -> None:
        """Every rank's status after op `name`; RankLost unless all
        succeeded or all raised."""
        mine = torch.tensor([0 if err is None else 1], dtype=torch.int64)
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        try:
            dist.all_gather(got, mine, group=self.group)
        except RuntimeError as e:          # a peer is gone or silent
            self._lose(f"op {name}: {self._who(e)}")
        status = [int(t) for t in got]
        if not any(status):
            return
        why: list = [None] * self.world
        text = None if err is None else "".join(
            traceback.format_exception_only(type(err), err)).strip()
        try:
            dist.all_gather_object(why, text, group=self.group)
        except RuntimeError as e:
            self._lose(f"op {name}: {self._who(e)}")
        if all(status):
            return            # every rank refused it the same way: in step
        bad = [r for r, s in enumerate(status) if s]
        self._lose(f"op {name} failed on rank(s) {bad} and not on the "
                   "others, so the ranks are out of step: "
                   + "; ".join(f"rank {r}: {why[r]}" for r in bad), bad)

    def _who(self, e: Exception) -> str:
        dead = [r for r, pid in enumerate(self.pids)
                if r != self.rank and not _alive(pid)]
        if dead:
            return (f"rank(s) {dead} exited (process gone); the collective "
                    f"said: {e}")
        return (f"no answer from the other ranks within {self.timeout_s:.0f} "
                f"s, or a collective failed: {e}")

    def _lose(self, message: str, ranks=None) -> None:
        if ranks is None:
            ranks = [r for r, pid in enumerate(self.pids)
                     if r != self.rank and not _alive(pid)]
        first = self.lost is None
        if first:
            self.lost = f"rank {self.rank}: serving over ranks lost: {message}"
        if first and self.is_root:
            for fn in self._on_lost:
                fn(self.lost)
        raise RankLost(self.lost, ranks)

    # -- followers -----------------------------------------------------------

    def follow(self) -> None:
        """The follower loop: run every op rank 0 sends, in its order,
        until the shutdown op. Raises RankLost when rank 0 is gone, silent
        past the timeout, or the ranks fell out of step."""
        if self.is_root:
            raise RuntimeError("rank 0 sends ops; it does not follow")
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=0, group=self.group)
            except RuntimeError as e:
                self._lose(f"waiting for an op: {self._who(e)}")
            seq, oid, name, args, kw, pos, drops = box[0]
            for ref in drops:
                if isinstance(ref, ObjRef):
                    self._objs.pop(ref.oid, None)
                else:
                    self._results.pop(ref, None)
            if name in (PING, SHUTDOWN):
                self._ack(name, None)
                if name == SHUTDOWN:
                    self.closed = True
                    return
                continue
            obj = self._objs[oid]
            out, err = None, None
            try:
                if pos is not None:
                    obj.pos = pos
                out = getattr(obj, name)(*self._decode(args, obj),
                                         **self._decode(kw, obj))
            except Exception as e:  # noqa: BLE001 — judged by the ack
                err = e
            self._ack(name, err)
            if err is None:
                self._register(seq, out)
            if name == "release":
                self._release(obj)

    def _release(self, engine) -> None:
        """Forget a released engine and the drafts built over it."""
        for oid in [k for k, o in self._objs.items()
                    if o is engine or getattr(o, "engine", None) is engine]:
            del self._objs[oid]
