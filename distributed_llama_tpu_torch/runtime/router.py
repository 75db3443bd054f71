"""Replica failover: a fault-tolerant multi-replica serving tier — the
port of the JAX package's runtime/router.py (host code, copied).

One supervised engine (runtime/resilience.py) survives its own crashes,
but it is ONE replica: a crash, a stall or a tripped breaker takes the
service down for its recovery window. This module puts a host router in
front of N supervised replicas — threads of one process, each its own
``EngineSupervisor`` + ``Scheduler`` + radix prefix cache over SHARED
weights (``Engine.spawn``: N replicas cost N KV caches, arenas and graph
pools, never N weight copies), or worker processes
(runtime/replica_worker.py) — and makes replica failure invisible to
clients:

  * CACHE-AWARE ROUTING in the SGLang style: each request goes to the
    replica whose radix tree holds its longest prefix
    (``PrefixCache.match_len``, a read-only peek; a process replica's
    shadow index), falling back to least-loaded; ``session`` keys add
    stickiness.
  * BOUNDED AUTOMATIC RETRY: a request failed with a *retryable*
    structured frame BEFORE its first token streamed is resubmitted onto
    a different healthy replica, up to ``retry_budget`` times, with a
    fresh sampler rebuilt from the submit-time RNG snapshot, so greedy
    retries give the tokens the dead replica would have. A request that
    already streamed tokens is NEVER replayed: the client gets the frame
    re-raised with ``retryable=False``.
  * PER-REPLICA CIRCUIT BREAKERS with half-open probes, above the
    supervisor's own breaker.
  * ROLLING DRAIN: ``drain_replica``/``restart_replica`` (and
    ``rolling_restart``) take replicas out of rotation one at a time,
    finish their work, rebuild and re-admit, with zero failed requests.

``Router`` duck-types the ``EngineSupervisor`` surface the API server
uses (``submit``, ``engine``, ``exclusive()``, ``ready``/``state``,
``summary()``, ``drain()``, ``reset_breaker()``, ``close()``), and
``build_front_door`` is the one constructor of every serving tier.

Thread replicas share one card: their steps run side by side under the
process's device gate, and a replica's graph capture (a rebuild, a
scale-up) holds the others' device work off while it runs
(runtime/graphs.DEVICE_GATE); each replica's launches count to its own
scheduler (``Scheduler.launches``).

Chaos surface: each replica's scheduler carries ``fault_key="r{i}"``, so
the ``replica_raise``/``replica_stall`` sites (runtime/faults.py) kill or
wedge ONE replica mid-trace.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from .resilience import _COUNTER_KEYS, EngineSupervisor, EngineUnready
from .scheduler import QueueFull, RequestError, SchedulerClosed
from .stats import RouterStats, percentile
from .trace import TRACER

POLICIES = ("cache_aware", "least_loaded", "round_robin")

# session-affinity map bound: conversations are transient, and an
# unbounded dict on a long-lived router is a leak — the oldest stickiness
# entries fall off first (losing one only costs a cold placement)
_AFFINITY_CAP = 4096


class ReplicaHandle:
    """One supervised engine replica and its router-side health record —
    the reusable "engine owner" split out of apps/api_server.ApiState:
    it owns supervisor construction/rebuild for exactly one replica, so
    the HTTP layer never touches an engine directly again.

    The breaker fields (``fails``/``open_until``/``probing``) belong to
    the ROUTER's circuit (guarded by the router's lock), layered above
    the supervisor's own engine-level breaker: the supervisor answers
    "can this engine serve at all", the router circuit answers "should
    traffic go here right now"."""

    has_local_engine = True  # Router.exclusive may borrow our engine

    def __init__(self, rid: int, engine_factory, sup_kwargs: dict,
                 tier: str = "mixed"):
        self.id = rid
        # disaggregation role (runtime/kv_transfer.py): "prefill" keeps
        # this replica OUT of request placement — it only runs the
        # router's prefill passes and donates blocks; "decode"/"mixed"
        # serve requests (decode == mixed for a thread replica: the
        # role's value is that the ROUTER never places prefill-heavy
        # passes on it)
        self.tier = tier if tier in ("prefill", "decode", "mixed") \
            else "mixed"
        self._factory = engine_factory
        self._sup_kwargs = dict(sup_kwargs)
        self.sup = EngineSupervisor(engine_factory,
                                    fault_key=f"r{rid}", **self._sup_kwargs)
        self.draining = False   # router-level: out of rotation
        # fleet-controller scale-down mark (runtime/fleet.py): a replica
        # draining FOR REAP is a capacity decision, not a health event —
        # /readyz and Router.state exclude it instead of reporting
        # "draining"/unready for the whole tier
        self.reap = False
        # router circuit breaker (see class docstring)
        self.fails = 0
        self.open_until = 0.0   # 0 = closed; else half-open past it
        self.probing = False
        # counter carry across restart(): the replaced supervisor's
        # lifetime totals fold in here, so /stats aggregation never
        # resets or double-counts across a rolling restart (the same
        # contract SupervisorStats keeps across engine rebuilds)
        self._carry = {k: 0 for k in _COUNTER_KEYS}

    # -- health / placement signals ---------------------------------------

    @property
    def ready(self) -> bool:
        return self.sup.ready

    @property
    def state(self) -> str:
        return self.sup.state

    def load(self) -> int:
        """Live slots + queued requests — the least-loaded signal. Lock-
        free reads of the current generation's scheduler (deque len and
        slot scans are GIL-atomic enough for a placement heuristic)."""
        sched = self.sup._sched
        return (len(sched._queue)
                + sum(1 for s in sched.slots if s.req is not None))

    def match_len(self, tokens: list[int]) -> int:
        """Longest prefix this replica's radix tree caches (0 with the
        prefix cache off) — the cache-aware placement signal."""
        pc = self.sup.prefix_cache
        return pc.match_len(tokens) if pc is not None else 0

    # -- lifecycle (rolling restart) --------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop routing here (the router checks ``draining``) and wait
        for in-flight + queued work to finish. ROUTER-level only — the
        supervisor stays READY underneath, so ``undrain`` can re-admit
        without a rebuild (unlike EngineSupervisor.drain, whose DRAINING
        state is one-way). Lock-free busy check, same discipline as the
        supervisor's."""
        self.draining = True
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            sched = self.sup._sched
            if not sched._queue and all(s.req is None for s in sched.slots):
                return True
            time.sleep(0.02)
        return False

    def restart(self, timeout: float = 30.0) -> None:
        """Tear down and rebuild this replica's supervisor (fresh engine,
        cache, empty prefix tree — weights still shared) and re-enter
        rotation. Call after ``drain`` for a zero-failure rolling
        restart; calling it hot aborts in-flight work with structured
        shutdown frames (close()'s contract) first."""
        self.draining = True
        try:
            # close FIRST, swap after: `sup` always points at a live
            # object (the closed one answers ready=False/state=closed to
            # concurrent health reads during the window — never None)
            self.sup.close(timeout=timeout)
            # fold the dead supervisor's lifetime counters (close() is
            # final: no writer outlives it) so /stats totals carry
            old = self.sup.summary()
            for k in _COUNTER_KEYS:
                self._carry[k] += old.get(k) or 0
            self.sup = EngineSupervisor(self._factory,
                                        fault_key=f"r{self.id}",
                                        **self._sup_kwargs)
            self.fails = 0
            self.open_until = 0.0
            self.probing = False
        finally:
            self.draining = False

    def undrain(self) -> None:
        self.draining = False

    def note_routed(self, prompt: list[int]) -> None:
        """Placement hook: in-process replicas need nothing (match_len
        peeks the REAL radix tree); the remote handle overrides this to
        feed its shadow index."""

    def close(self, timeout: float = 30.0) -> None:
        self.draining = True
        if self.sup is not None:
            self.sup.close(timeout=timeout)

    def summary(self) -> dict:
        s = self.sup.summary()
        for k in _COUNTER_KEYS:
            s[k] = (s.get(k) or 0) + self._carry[k]
        s["replica"] = self.id
        s["tier"] = self.tier
        s["draining"] = self.draining
        s["reap"] = self.reap
        s["breaker_open"] = self.open_until > 0.0
        return s


class ShadowPrefixIndex:
    """Router-side shadow of a PROCESS replica's radix tree: cache-aware
    placement must survive the process boundary WITHOUT an RPC on the hot
    path (the SGLang router keeps placement cache-aware the same way —
    by shadowing what it routed, PAPERS.md), so the router records every
    prompt it places on a replica at the replica's own block granularity
    and walks this local index at pick time.

    It is an approximation by design: it tracks what was ROUTED, the
    worker's real tree tracks what was PUBLISHED and EVICTED — a stale
    entry costs one suboptimal placement (the worker's own lookup_pin is
    the ground truth at admission), never correctness. The monitor
    clears it whenever the worker's supervisor generation changes
    (``recoveries`` in the health payload — a rebuild empties the real
    tree) and on process respawn. Entries are whole-block token paths in
    an LRU-capped OrderedDict; eviction of a mid-path entry merely
    shortens a future match."""

    def __init__(self, block_len: int = 32, cap: int = 4096):
        self.block_len = int(block_len)
        self.cap = int(cap)
        self._paths: OrderedDict[tuple, None] = OrderedDict()  # dlrace: guarded-by(self._lock)
        self._lock = threading.Lock()

    def publish(self, tokens: list[int]) -> None:
        usable = max(len(tokens) - 1, 0) // self.block_len
        if usable <= 0:
            return
        with self._lock:
            for i in range(1, usable + 1):
                key = tuple(tokens[: i * self.block_len])
                self._paths[key] = None
                self._paths.move_to_end(key)
            while len(self._paths) > self.cap:
                self._paths.popitem(last=False)

    def match_len(self, tokens: list[int]) -> int:
        """Longest shadowed whole-block prefix, len-1-capped — the same
        rule as PrefixCache.match_len so thread and process replicas
        compare on one scale."""
        usable = max(len(tokens) - 1, 0) // self.block_len
        n = 0
        with self._lock:
            for i in range(1, usable + 1):
                if tuple(tokens[: i * self.block_len]) not in self._paths:
                    break
                n = i
        return n * self.block_len

    def truncate(self, tokens: list[int], keep_tokens: int) -> int:
        """Drop the shadowed paths of ``tokens`` BEYOND ``keep_tokens``
        — the shadow-staleness fix (runtime/kv_transfer.py): a donor's
        RMSG_BLOCK_QUERY answered with less than this shadow promised,
        which means the worker EVICTED part of the path the shadow still
        advertises. Left alone, the stale entries would keep attracting
        placements and fetches of dead blocks; the miss answer is the
        ground truth, so the entries past it go. Returns entries
        dropped."""
        usable = max(len(tokens) - 1, 0) // self.block_len
        dropped = 0
        missing = object()  # stored values are None — a None pop result
        # cannot distinguish hit from miss
        with self._lock:
            for i in range(max(keep_tokens, 0) // self.block_len + 1,
                           usable + 1):
                if self._paths.pop(tuple(tokens[: i * self.block_len]),
                                   missing) is not missing:
                    dropped += 1
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._paths.clear()


class _RemoteEngineInfo:
    """The slice of the Engine surface the HTTP handlers read off a
    PROCESS replica — a shape/context template (``seq_len``/``batch``),
    sourced from the worker's HELLO ack via the client cache. There is
    no local engine to step: anything beyond the template is refused."""

    def __init__(self, client):
        self._client = client

    def _field(self, name: str) -> int:
        v = getattr(self._client, name)
        if v is None:
            # no successful handshake yet (connect-mode worker not up):
            # the handlers map EngineUnready to a retryable 503
            raise EngineUnready("replica shape unknown (worker "
                                "unreachable)", 1.0)
        return v

    @property
    def seq_len(self) -> int:
        return self._field("seq_len")

    @property
    def batch(self) -> int:
        return self._field("batch")


class RemoteReplicaHandle:
    """One OUT-OF-PROCESS replica: a worker process (local-spawn mode —
    ``WorkerProc`` + respawn supervision) or a pre-started remote worker
    (connect mode, ``--replica-hosts``) behind the framed replica
    protocol (runtime/replica_worker.py). Duck-types ``ReplicaHandle``
    for the router AND the slice of the supervisor surface the router
    reaches through ``.sup`` (``sup is self``): submit, stats, drain,
    reset_breaker, _retry_after — so ``Router``'s placement, failover,
    circuit, and /stats code serve thread and process replicas through
    identical paths.

    Supervision (local-spawn mode): a monitor thread watches the process
    and a health probe (RMSG_PING — also the source of the cached
    ``load``/``busy``/counters, so the submit hot path never RPCs for
    health). A dead process is CLASSIFIED by exit code
    (``classify_exit`` — ``signal:SIGKILL`` vs ``config_error`` vs
    crash), its last-polled counters fold into a carry (totals never
    reset or double-count across a respawn), its shadow index clears,
    and it is respawned under exponential backoff — until
    ``spawn_breaker`` consecutive SHORT-LIVED spawns open the per-replica
    spawn breaker (state ``broken``; ``reset_breaker`` is the operator
    half-open, same as every other breaker in this stack). A SIGKILLed
    replica is routable again once the respawned worker's port handshake
    and warmup complete — the bound the chaos tests assert."""

    has_local_engine = False  # Router.exclusive must never pick us

    def __init__(self, rid: int, *, proc=None, address: tuple | None = None,
                 block_len: int = 32, shadow_cap: int = 4096,
                 io_timeout: float = 30.0, poll_interval: float = 0.25,
                 spawn_timeout: float = 180.0, respawn_timeout: float = 180.0,
                 spawn_backoff_base: float = 0.2,
                 spawn_backoff_max: float = 5.0, spawn_breaker: int = 3,
                 min_uptime: float = 5.0, tier: str = "mixed"):
        from .replica_worker import WorkerClient
        from .stats import ProcStats

        assert (proc is None) != (address is None), \
            "exactly one of proc (local spawn) or address (connect)"
        self.id = rid
        # disaggregation role: spawn mode stamps it from the shipped
        # worker config; connect mode starts at the default and adopts
        # whatever the worker's PONG advertises (pre-started workers own
        # their configs — _refresh_health below)
        self.tier = tier if tier in ("prefill", "decode", "mixed") \
            else "mixed"
        self.sup = self
        self.draining = False
        self.reap = False  # fleet scale-down mark (see ReplicaHandle)
        self.fails = 0
        self.open_until = 0.0
        self.probing = False
        self.shadow = ShadowPrefixIndex(block_len=block_len, cap=shadow_cap)
        self.proc_stats = ProcStats()
        self._proc = proc
        self._io = float(io_timeout)
        self._poll = float(poll_interval)
        self._respawn_timeout = float(respawn_timeout)
        self._backoff_base = float(spawn_backoff_base)
        self._backoff_max = float(spawn_backoff_max)
        self._spawn_breaker = int(spawn_breaker)
        self._min_uptime = float(min_uptime)
        self._lock = threading.RLock()
        self._closed = False
        self._broken = False  # dlrace: guarded-by(self._lock)
        self._spawn_fails = 0  # dlrace: guarded-by(self._lock)
        self._health = {"ready": False, "state": "starting", "load": 0,
                        "busy": False, "recoveries": 0}  # dlrace: guarded-by(self._lock)
        self._last_counters = {k: 0 for k in _COUNTER_KEYS}  # dlrace: guarded-by(self._lock)
        self._carry = {k: 0 for k in _COUNTER_KEYS}  # dlrace: guarded-by(self._lock)
        self._last_summary: dict | None = None  # dlrace: guarded-by(self._lock)
        # fold epoch: bumped by every death fold so a counter snapshot
        # RPC'd from the dying generation can never be re-installed into
        # the caches afterwards (it would be folded a second time on the
        # next death — double-counting /stats totals)
        self._fold_epoch = 0  # dlrace: guarded-by(self._lock)
        if proc is not None:
            proc.spawn()
            try:
                port = proc.wait_ready(timeout=spawn_timeout)
            except BaseException:
                # a worker that outlived its startup deadline (or a ctrl-C
                # during the wait) must not leak the process
                proc.stop(timeout=5.0)
                raise
            self.client = WorkerClient(proc.host, port,
                                       io_timeout=io_timeout)
        else:
            self.client = WorkerClient(address[0], address[1],
                                       io_timeout=io_timeout)
        self._spawned_at = time.perf_counter()  # dlrace: guarded-by(self._lock)
        self._refresh_health()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name=f"dllama-replica-proc-r{rid}",
            daemon=True)
        self._monitor_thread.start()

    # -- supervisor surface (sup is self) ----------------------------------

    @property
    def stats(self):
        """Client-side latency window (timings only — counters come from
        the worker's RSTATS, so the router's merge never double-counts)."""
        return self.client.stats

    @property
    def prefix_cache(self):
        return None  # match_len is overridden; the real tree is remote

    @property
    def engine(self):
        """Shape template only (see _RemoteEngineInfo) — the worker owns
        the real Engine on its side of the process boundary."""
        return _RemoteEngineInfo(self.client)

    def submit(self, prompt, max_tokens, sampler, eos_id=None,
               deadline=None, trace_id=None, fill=None, tenant=None,
               priority="normal"):
        if self._broken or self._closed:
            raise EngineUnready(self.state, self._retry_after())
        if not self._health.get("ready"):
            # cached health says no: refuse at the door without a TCP
            # round-trip (at most one poll interval stale — a recovered
            # worker is routable again within self._poll)
            raise EngineUnready(self.state, self._retry_after())
        return self.client.submit(prompt, max_tokens, sampler,
                                  eos_id=eos_id, deadline=deadline,
                                  trace_id=trace_id or 0, fill=fill,
                                  tenant=tenant, priority=priority)

    def exclusive(self):
        raise EngineUnready("remote replica: no borrowable local engine",
                            1.0)

    def _retry_after(self) -> float:
        return 30.0 if self._broken else 1.0

    def reset_breaker(self) -> None:
        """Operator half-open for BOTH process-level breakers: the spawn
        breaker here (the monitor resumes respawning) and the worker's
        own engine breaker over the wire (best-effort — the worker may be
        the very thing that is dead)."""
        with self._lock:
            self._spawn_fails = 0
            self._broken = False
            if self._health.get("state") == "broken":
                self._health = {**self._health, "state": "resetting"}
        self.client.reset_breaker()

    def profile(self, ms: float) -> dict | None:
        """RMSG_PROFILE relay: capture in the WORKER process (it owns its
        device work), into its per-worker capture dir. None when the
        worker is unreachable/busy."""
        if self._closed:
            return None
        return self.client.profile(ms)

    # -- handle surface ----------------------------------------------------

    @property
    def ready(self) -> bool:
        return (not self._closed and not self._broken
                and bool(self._health.get("ready")))

    @property
    def state(self) -> str:
        if self._closed:
            return "closed"
        if self._broken:
            return "broken"
        return str(self._health.get("state", "unknown"))

    def load(self) -> int:
        return int(self._health.get("load", 0))

    def match_len(self, tokens: list[int]) -> int:
        return self.shadow.match_len(tokens)

    def note_routed(self, prompt: list[int]) -> None:
        self.shadow.publish(prompt)

    def drain(self, timeout: float = 30.0) -> bool:
        """Router-level drain: stop routing here, then wait for the
        worker to report idle (the ``busy`` bit of its health payload).
        The worker's supervisor stays READY underneath — undrain
        re-admits without a rebuild, same as the thread handle."""
        self.draining = True
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            h = self.client.ping(timeout=2.0)
            if h is not None and not h.get("busy"):
                return True
            if h is None and self._proc is not None \
                    and self._proc.poll() is not None:
                return True  # dead = idle; the monitor owns the respawn
            time.sleep(0.05)
        return False

    def restart(self, timeout: float = 30.0) -> None:
        """Rolling-restart step: RMSG_REBUILD swaps the worker's
        supervisor in place (fresh engine + cache + empty radix tree,
        weights shared inside the process; counters carry worker-side)
        and blocks until the fresh one is warmed. A worker too dead to
        answer is stopped and left to the monitor's respawn path."""
        self.draining = True
        try:
            ok = self.client.rebuild(timeout=max(timeout,
                                                 self._respawn_timeout))
            self.shadow.clear()
            if not ok and self._proc is not None and not self._closed:
                self._proc.stop(timeout=5.0)  # monitor detects + respawns
            self._refresh_health()
        finally:
            self.draining = False

    def undrain(self) -> None:
        self.draining = False

    def close(self, timeout: float = 30.0) -> None:
        self._closed = True
        self.draining = True
        if self._proc is not None:
            self._proc.stop(timeout=min(timeout, 10.0))
        else:
            # connect mode: the worker belongs to its own operator —
            # just detach (a graceful shutdown of a shared remote worker
            # is an ADMIN decision, not a client disconnect side effect)
            pass
        self.client.close()
        # the monitor checks _closed every poll, but a death fold can hold
        # it in respawn backoff for a while — bound the wait rather than
        # let interpreter teardown race its health probes into a closed
        # client (join(None) could hang close() behind a full breaker run)
        monitor = self._monitor_thread
        if monitor.is_alive() and monitor is not threading.current_thread():
            monitor.join(timeout=min(timeout, 5.0) + self._poll)

    def summary(self) -> dict:
        with self._lock:
            epoch = self._fold_epoch
        live = None if self._closed else self.client.stats_summary()
        with self._lock:  # the death fold reads/resets these caches
            if live is not None and epoch != self._fold_epoch:
                # the worker died between the RPC and here: the fold
                # already absorbed these counts into _carry — installing
                # (or reporting) the stale snapshot would double-count
                live = None
            if live is not None:
                self._last_summary = live
                self._last_counters = {k: live.get(k) or 0
                                       for k in _COUNTER_KEYS}
            base = dict(live or self._last_summary or {})
            for k in _COUNTER_KEYS:
                base[k] = (base.get(k) or 0) + self._carry[k]
        base["state"] = self.state
        base["replica"] = self.id
        base["tier"] = self.tier
        base["draining"] = self.draining
        base["reap"] = self.reap
        base["breaker_open"] = self.open_until > 0.0
        proc = self.proc_stats.summary()
        proc["mode"] = "spawn" if self._proc is not None else "connect"
        proc["pid"] = self._proc.pid if self._proc is not None else None
        proc["addr"] = list(self.client.addr)
        base["proc"] = proc
        return base

    # -- supervision internals ---------------------------------------------

    def _refresh_health(self) -> None:
        with self._lock:
            epoch = self._fold_epoch
        payload = self.client.ping(timeout=3.0)
        with self._lock:
            if epoch != self._fold_epoch:
                # the worker died while the PING was in flight: the fold
                # owns the caches now — installing this stale payload
                # would double-count counters on the next fold and mark
                # a corpse ready
                return
            if payload is None:
                self._health = {**self._health, "ready": False,
                                "state": "unreachable"}
                return
            if payload.get("recoveries", 0) != self._health.get(
                    "recoveries", 0):
                # the worker's supervisor rebuilt (crash/stall recovery):
                # its radix tree is empty — stop claiming warm prefixes
                self.shadow.clear()
            self._last_counters = payload.get("counters",
                                              self._last_counters)
            if payload.get("tier") in ("prefill", "decode", "mixed"):
                # connect-mode workers own their configs: the PONG is
                # where the router learns (and tracks) their role
                self.tier = payload["tier"]
            self._health = payload

    def _monitor(self) -> None:
        while not self._closed:
            proc = self._proc
            rc = proc.poll() if proc is not None else None
            if proc is not None and rc is not None:
                self._supervise_death(rc)
                continue
            self._refresh_health()
            time.sleep(self._poll)

    def _supervise_death(self, rc: int) -> None:
        """Monitor-thread-only: classify and fold ONE real worker death,
        then drive respawn attempts to success (or the spawn breaker).
        The whole death — including every failed respawn attempt — is
        handled inside this one call, so a reaped straggler is never
        re-classified as a second 'exit', and failed attempts count once
        (as ``spawn_failures``, never as worker deaths). Blocking work
        (spawn, port-handshake wait, backoff sleeps) runs OUTSIDE
        ``self._lock`` — /stats and reset_breaker stay responsive for the
        full (possibly minutes-long) respawn."""
        from .replica_worker import classify_exit

        t_detect = time.perf_counter()
        cls = classify_exit(rc)
        if TRACER.enabled:
            # the classified exit ON the timeline: with the casualty
            # span's replica_lost error and the sibling retry's route
            # event this is the cross-process kill story in one place
            TRACER.event("worker_exit", 0, replica=self.id, cls=cls,
                         rc=rc)
        with self._lock:
            if self._closed:
                return
            # fold the dead process's last-polled counters: totals are a
            # <=1-poll-interval lower bound across a SIGKILL and can
            # never double-count (the respawned worker starts at zero;
            # the epoch bump keeps in-flight PING/STATS snapshots of the
            # dead generation out of the caches)
            self._fold_epoch += 1
            for k in _COUNTER_KEYS:
                self._carry[k] += self._last_counters.get(k, 0)
            self._last_counters = {k: 0 for k in _COUNTER_KEYS}
            self._last_summary = None
            self.shadow.clear()
            self._health = {"ready": False, "state": f"exited:{cls}",
                            "load": 0, "busy": False, "recoveries": 0}
            self.proc_stats.note_exit(cls)
            uptime = t_detect - self._spawned_at
            # streak = consecutive SHORT-LIVED spawns: a long-healthy
            # worker SIGKILLed by an operator/OOM respawns on the base
            # backoff; a crash-looping one escalates into the breaker
            self._spawn_fails = (self._spawn_fails + 1
                                 if uptime < self._min_uptime else 0)
            if self._spawn_fails >= self._spawn_breaker:
                self._broken = True
                self._health = {**self._health, "state": "broken"}
                if TRACER.enabled:
                    TRACER.event("circuit", 0, scope="spawn",
                                 replica=self.id, state="open",
                                 fails=self._spawn_fails)
        while not self._closed:
            while self._broken and not self._closed:
                time.sleep(self._poll)  # breaker open: reset_breaker
            if self._closed:
                return
            time.sleep(min(self._backoff_base * (2 ** self._spawn_fails),
                           self._backoff_max))
            with self._lock:
                if self._closed or self._proc.poll() is None:
                    return  # closed, or already respawned
            try:
                self._proc.spawn()
                port = self._proc.wait_ready(
                    timeout=self._respawn_timeout)
            except RuntimeError:
                # reap a startup-deadline straggler, stamp the ATTEMPT
                # (uptime must be measured from this failed spawn, not
                # the last healthy one — otherwise a crash loop reads as
                # "long uptime" and the breaker can never trip), and go
                # around again
                rc_f = self._proc.stop(timeout=5.0)
                with self._lock:
                    self._spawned_at = time.perf_counter()
                    self._spawn_fails += 1
                    self.proc_stats.note_spawn_failure(
                        None if rc_f is None else classify_exit(rc_f))
                    if self._spawn_fails >= self._spawn_breaker:
                        self._broken = True
                        self._health = {**self._health, "state": "broken"}
                        if TRACER.enabled:
                            TRACER.event("circuit", 0, scope="spawn",
                                         replica=self.id, state="open",
                                         fails=self._spawn_fails)
                continue
            with self._lock:
                if self._closed:
                    self._proc.stop(timeout=5.0)
                    return
                self.client.set_addr(self._proc.host, port)
                self._spawned_at = time.perf_counter()
                self.proc_stats.respawns += 1
                respawn_ms = (time.perf_counter() - t_detect) * 1e3
                self.proc_stats.respawn_ms.append(respawn_ms)
            if TRACER.enabled:
                TRACER.event("respawn", 0, replica=self.id,
                             ms=round(respawn_ms, 1), port=port)
            self._refresh_health()
            return


class RouterRequest:
    """One client request as the router sees it: a thin stream wrapper
    that owns the failover decision. ``tokens()`` streams the current
    replica's events; a retryable structured failure BEFORE the first
    token re-places the request (fresh sampler from the submit-time RNG
    snapshot — token streams are attempt-invariant); any failure AFTER
    tokens streamed re-raises the frame with ``retryable=False``.

    Duck-types the consumer surface of ``ServeRequest``: ``tokens()``,
    ``cancel()``, ``finished``, ``finish_reason``, ``stats``."""

    def __init__(self, router: "Router", prompt: list[int], max_tokens: int,
                 eos_id, deadline, sampler_spec: tuple, session,
                 trace_id: int = 0, tenant=None, priority="normal"):
        # one span id for the WHOLE request: every failover attempt's
        # scheduler/worker events carry it, so the casualty and its
        # sibling retry share a timeline (runtime/trace.py)
        self.trace_id = trace_id
        self._router = router
        self._prompt = prompt
        self._max_tokens = max_tokens
        self._eos_id = eos_id
        self._deadline = deadline      # absolute: shared across attempts
        self._sampler_spec = sampler_spec  # (vocab, temp, topp, rng_state)
        self._session = session
        # fairness tags: shared by every failover attempt (a retry rides
        # the same tenant's share + the same priority band)
        self._tenant = tenant
        self._priority = priority
        self._inner = None             # current ServeRequest
        self._handle: ReplicaHandle | None = None
        self._probe = False            # current attempt IS the half-open probe
        self._cancelled = False
        self.retries = 0
        self.emitted = 0
        self.finished = threading.Event()
        self.finish_reason: str | None = None

    @property
    def replica_id(self) -> int | None:
        h = self._handle
        return h.id if h is not None else None

    @property
    def stats(self):
        """The CURRENT attempt's RequestStats (a failover's final stats
        describe the attempt that actually served the client)."""
        return self._inner.stats

    def cancel(self) -> None:
        self._cancelled = True
        if self._inner is not None:
            self._inner.cancel()
        if self._probe and self.emitted == 0 and not self.finished.is_set():
            # cancelled before any token AND before (or instead of) the
            # stream being consumed: tokens()'s settlement may never run,
            # so release the armed probe here — idempotent if it does
            self._router._release_probe(self._handle)

    def _fresh_sampler(self):
        from ..sampler import Sampler

        vocab, temp, topp, rng_state = self._sampler_spec
        return Sampler(vocab, temperature=temp, topp=topp, seed=rng_state)

    def tokens(self, timeout: float = 600.0):
        """Yield token ids to the terminal event, failing over between
        replicas underneath (see class docstring). Raises RequestError
        with the structured frame when the request ultimately fails."""
        try:
            yield from self._tokens(timeout)
        finally:
            if not self.finished.is_set():
                # consumer abandoned the stream mid-flight (stop sequence,
                # chat end-marker, client disconnect -> GeneratorExit): no
                # terminal verdict will ever run _on_result, so settle the
                # circuit accounting HERE. Tokens streamed = the replica
                # served fine (success: resets fails, closes a probe);
                # nothing streamed = no verdict — just release a probe so
                # it can't leak probing=True and unroute the replica.
                if self.emitted > 0:
                    self._router._on_result(self._handle, ok=True,
                                            retried=self.retries > 0)
                elif self._probe:
                    self._router._release_probe(self._handle)
                self.finished.set()

    def _tokens(self, timeout: float):
        while True:
            try:
                for tok in self._inner.tokens(timeout=timeout):
                    self.emitted += 1
                    yield tok
                self.finish_reason = self._inner.finish_reason
                self._router._on_result(self._handle, ok=True,
                                        retried=self.retries > 0)
                self.finished.set()
                return
            except RequestError as e:
                failed = self._handle
                # breaker attribution: deadline/queue-budget expiries are
                # the CLIENT's budget or the tier's load, not the
                # replica's health — they must not open a healthy
                # replica's circuit under pressure
                if e.code not in ("deadline", "queue_timeout"):
                    self._router._on_result(failed, ok=False)
                elif self._probe:
                    # the probe expired on the client's budget: no health
                    # verdict either way — return the circuit to half-open
                    # instead of leaking probing=True (which would unroute
                    # the replica until a manual reset)
                    self._router._release_probe(failed)
                if self.emitted > 0:
                    # mid-stream kill: the client already holds a partial
                    # stream — surface the structured frame, explicitly
                    # NON-retryable at this layer (a transparent replay
                    # would re-emit tokens the client already rendered)
                    with self._router._lock:  # counter discipline: every
                        # RouterStats mutation rides the router lock
                        self._router.stats.midstream_failures += 1
                    self._terminal_error()
                    raise RequestError(
                        e.code, f"{e} [{self.emitted} tokens already "
                                "streamed; not replayed — resubmit to "
                                "regenerate]", retryable=False) from e
                if (not e.retryable or self._cancelled
                        or self.retries >= self._router.retry_budget):
                    self._terminal_error()
                    raise
                if TRACER.enabled:
                    TRACER.event("failover", self.trace_id,
                                 replica=failed.id if failed else None,
                                 code=e.code, attempt=self.retries + 1)
                try:
                    self._router._place(
                        self, exclude=(failed.id,) if failed else (),
                        sampler=self._fresh_sampler())
                except Exception:
                    # no healthy replica to retry on: deliver the ORIGINAL
                    # structured frame (still retryable — the client may
                    # come back after recovery)
                    self._terminal_error()
                    raise e from None
                self.retries += 1
                with self._router._lock:
                    self._router.stats.retries += 1

    def _terminal_error(self) -> None:
        self.finish_reason = "error"
        self.finished.set()


class Router:
    """N supervised replicas behind one submit/stream surface. See the
    module docstring for the policy and failure semantics; see
    ``build_front_door`` for how the API server constructs one."""

    def __init__(self, engine_factory, *, replicas: int = 2,
                 policy: str = "cache_aware", retry_budget: int = 1,
                 circuit_threshold: int = 3, circuit_cooldown: float = 5.0,
                 handle_factories=None, kv_transfer: bool = False,
                 fill_min_tokens: int = 32, tiers=None, **sup_kwargs):
        # circuit_* name the ROUTER-level breaker so the supervisor's own
        # breaker_threshold still rides **sup_kwargs without a collision
        assert policy in POLICIES, policy
        from .stats import KVTransferStats

        # cross-replica KV block transfer (runtime/kv_transfer.py): when
        # armed, placement also decides FILLS (the placed replica fetches
        # a warmer sibling's blocks instead of re-prefilling) and runs
        # the prefill/decode disaggregation (prefill-tier replicas take
        # the prompt pass, decode-tier replicas admit already-seeded).
        # fill_min_tokens (default: one block) is the minimum cache
        # advantage worth a transfer.
        self._kv_transfer = bool(kv_transfer)
        self._fill_min = max(int(fill_min_tokens), 1)
        self.kvx = KVTransferStats(enabled=self._kv_transfer,
                                   tier="router",
                                   block_len=int(fill_min_tokens))
        # thread replicas' supervisors arm the prefix cache's transfer
        # warmup off the ROUTER's flag (the router owns it — one home,
        # so build_front_door cannot pass it twice)
        sup_kwargs = dict(sup_kwargs, kv_transfer=self._kv_transfer)
        if handle_factories is not None:
            # PROCESS/REMOTE tier: the caller supplies zero-arg factories
            # building RemoteReplicaHandles (build_front_door's
            # --replica-procs/--replica-hosts paths); engine_factory is
            # unused — each worker process owns its own engine
            replicas = len(handle_factories)
        assert replicas >= 1, replicas
        self.policy = policy
        self.retry_budget = max(int(retry_budget), 0)
        self.circuit_threshold = int(circuit_threshold)
        self.circuit_cooldown = float(circuit_cooldown)
        self.stats = RouterStats(replicas=replicas, policy=policy)
        # the tier-level deadline default: resolved ONCE per request in
        # submit() so a failover retry continues the ORIGINAL end-to-end
        # budget — per-scheduler minting would grant each attempt a fresh
        # window (x(1+retry_budget) the documented bound)
        self._request_deadline = sup_kwargs.get("request_deadline")
        self._lock = threading.RLock()  # placement + breaker + affinity
        self._rr = 0  # dlrace: guarded-by(self._lock)
        self._affinity: OrderedDict[str, int] = OrderedDict()  # dlrace: guarded-by(self._lock)
        self._closed = False
        # fleet-controller surface (runtime/fleet.py): `scaling` is the
        # in-flight scale direction ("scaling_up"/"scaling_down"/None)
        # the /readyz state report surfaces; `_spawn_factory(rid, tier)`
        # is stashed by build_front_door so the controller can mint
        # replicas the same way the constructor did; `_recent_prompts`
        # is the warm-fill material a fresh replica replays (string/
        # bool stores are GIL-atomic; the ring rides the router lock)
        self.scaling: str | None = None
        self._spawn_factory = None
        self._recent_prompts: deque = deque(maxlen=32)  # dlrace: guarded-by(self._lock)
        # lifetime counters of reaped replicas: fold-on-reap so /stats
        # totals never reset when the controller scales down (the same
        # carry contract restart()/respawn keep within one handle)
        self._reap_carry = {k: 0 for k in _COUNTER_KEYS}  # dlrace: guarded-by(self._lock)
        # replicas build sequentially: each EngineSupervisor captures its
        # graphs before returning
        self.replicas: list[ReplicaHandle] = []
        try:
            if handle_factories is not None:
                for f in handle_factories:
                    self.replicas.append(f())
            else:
                for i in range(replicas):
                    self.replicas.append(
                        ReplicaHandle(i, engine_factory, sup_kwargs,
                                      tier=(tiers[i] if tiers
                                            else "mixed")))
        except BaseException:
            # replica K failed to build (e.g. the K+1-th KV cache/arena
            # OOMs): close the K already-running supervisors — their step
            # loop + watchdog threads and device memory must not outlive
            # the constructor that raised
            for h in self.replicas:
                try:
                    h.close(timeout=5.0)
                except Exception:  # noqa: BLE001 — best-effort unwind
                    pass
            raise

    # -- the supervisor surface the API server already speaks -------------

    @property
    def engine(self):
        """A shape/context template the handlers read (seq_len etc.);
        never step it directly without exclusive(). Prefers a replica
        with a LOCAL engine; an all-process tier serves the remote shape
        shim (_RemoteEngineInfo) instead."""
        for h in self.replicas:
            if getattr(h, "has_local_engine", True):
                return h.sup.engine
        return self.replicas[0].sup.engine

    @property
    def ready(self) -> bool:
        """/readyz contract: the SERVICE is ready while >= 1 replica can
        take traffic — single-replica failure must not unready the tier."""
        now = time.perf_counter()
        with self._lock:
            return any(self._routable(h, now) for h in self.replicas)

    @property
    def state(self) -> str:
        """Advisory tier state, CONSISTENT with ``ready``: "ready" iff
        some replica is actually routable (supervisor-ready, not drained,
        circuit allows) — a tier whose /readyz answers 503 must never
        report state="ready" back at the operator. A fleet-controller
        scale event in flight reports ``scaling_up``/``scaling_down``
        instead (the tier is still serving — capacity is changing, not
        health), and a replica marked ``reap`` is EXCLUDED from the
        unhealthy walk: draining-for-reap is the controller's decision,
        not a reason to call the tier draining."""
        now = time.perf_counter()
        scaling = self.scaling
        with self._lock:
            if any(self._routable(h, now) for h in self.replicas):
                return scaling or "ready"
            live = [h for h in self.replicas if not h.reap]
            if not live:
                return scaling or "draining"
            states = [h.state for h in live]
            for s in ("recovering", "draining"):
                if s in states:
                    return s
            if any(h.open_until > 0.0 for h in live):
                # router circuits hold traffic off supervisor-ready
                # replicas (the flapping case) — surface it, don't claim
                # the supervisors' "ready"
                return "degraded"
            if any(h.draining for h in live):
                # router-level drain leaves the supervisor READY
                return "draining"
            return states[0] if len(set(states)) == 1 else "degraded"

    def submit(self, prompt, max_tokens, sampler, eos_id=None,
               deadline=None, session=None, tenant=None,
               priority="normal") -> RouterRequest:
        """Place one request (PromptTooLong/QueueFull/EngineUnready
        surface here, exactly like the single-supervisor front door).
        ``sampler`` is consumed by the first attempt; its (temperature,
        topp, rng_state) snapshot — taken NOW, before any draw — rebuilds
        an identical sampler for each failover attempt."""
        if self._closed:
            raise SchedulerClosed("router is closed")
        if deadline is None and self._request_deadline:
            deadline = time.perf_counter() + self._request_deadline
        spec = (sampler.vocab_size, sampler.temperature, sampler.topp,
                sampler.rng_state)
        tid = TRACER.new_id() if TRACER.enabled else 0
        req = RouterRequest(self, [int(t) for t in prompt], max_tokens,
                            eos_id, deadline, spec, session, trace_id=tid,
                            tenant=tenant, priority=priority)
        with self._lock:
            # warm-fill material for fleet scale-ups (runtime/fleet.py):
            # a fresh replica replays the most recent prompts through
            # the KV fill path so its cache starts warm
            self._recent_prompts.append(req._prompt)
        if self._kv_transfer:
            # prefill/decode disaggregation: run the prompt through a
            # prefill-tier replica first (publishes its blocks), so the
            # decode placement below admits already-seeded via a fill
            # from that donor. No prefill worker routable -> the mixed
            # path below serves unchanged.
            self._prefill_pass(req)
        self._place(req, exclude=(), sampler=sampler)
        return req

    def exclusive(self):
        """Borrow ONE routable replica's engine (Scheduler.exclusive via
        its supervisor) — the legacy whole-batch endpoint's path. Lowest
        routable id wins so repeat borrows hit a warm engine. PROCESS
        replicas are never borrowable (their engine lives across the
        process boundary) — an all-process tier refuses with a
        structured 503 instead."""
        now = time.perf_counter()
        with self._lock:
            targets = [h for h in self.replicas
                       if self._routable(h, now)
                       and getattr(h, "has_local_engine", True)]
        if not targets:
            raise EngineUnready("no_replica", 1.0)
        return targets[0].sup.exclusive()

    def drain(self, timeout: float = 30.0) -> bool:
        """Whole-service drain (SIGTERM shutdown path): every replica's
        SUPERVISOR drains (one-way — admissions refused) within the
        shared deadline."""
        end = time.perf_counter() + timeout
        ok = True
        for h in self.replicas:
            h.draining = True
            ok &= h.sup.drain(timeout=max(end - time.perf_counter(), 0.1))
        return ok

    def reset_breaker(self, replica: int | None = None) -> None:
        """Operator half-open for the ENGINE breaker (supervisor BROKEN)
        plus a router-circuit reset — per replica or all."""
        targets = (self.replicas if replica is None
                   else [self.replicas[replica]])
        with self._lock:
            for h in targets:
                h.fails = 0
                h.open_until = 0.0
                h.probing = False
        for h in targets:
            h.sup.reset_breaker()

    def close(self, timeout: float = 30.0) -> None:
        self._closed = True
        for h in self.replicas:
            h.close(timeout=timeout)

    def summary(self) -> dict:
        """The /stats payload: aggregated counters (cross-replica AND
        cross-generation — each supervisor already folds its dead
        generations in), merged latency percentiles over the live
        generations' request windows, the per-replica summaries, and the
        router block."""
        reps = [h.summary() for h in self.replicas]
        with self._lock:
            reap_carry = dict(self._reap_carry)
        out = {k: sum(r.get(k) or 0 for r in reps) + reap_carry[k]
               for k in _COUNTER_KEYS}
        ttfts, itls = [], []
        for h in self.replicas:
            for r in list(h.sup.stats.requests):
                if r.ttft_ms is not None:
                    ttfts.append(r.ttft_ms)
                if r.itl_ms is not None:
                    itls.append(r.itl_ms)
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        out.update({
            "state": self.state,
            "scaling": self.scaling,
            "ttft_p50_ms": rnd(percentile(ttfts, 50)),
            "ttft_p99_ms": rnd(percentile(ttfts, 99)),
            "itl_p50_ms": rnd(percentile(itls, 50)),
            "itl_p99_ms": rnd(percentile(itls, 99)),
            "router": self.stats.summary(),
            "replicas": reps,
        })
        # the PARENT process's graph ledger (worker processes carry
        # their own in their per-replica summaries). No top-level hbm
        # block: thread replicas SHARE weight tensors — the per-replica
        # hbm blocks are each exact for their engine, and summing them
        # would count the one weight allocation many times.
        from .profiler import COMPILES
        from .stats import KVTransferStats

        out["compiles"] = COMPILES.summary()
        # the transfer-plane aggregate: the router's own record (thread-
        # tier fills, disaggregation decisions, shadow fixes) + every
        # worker's wire record — present even with transfer off
        # (enabled=False: a tier must not lose the family to a flag)
        out["kv_transfer"] = KVTransferStats.merge(
            [self.kvx.summary()]
            + [r.get("kv_transfer") for r in reps
               if isinstance(r.get("kv_transfer"), dict)])
        return out

    def _retry_after(self) -> float:
        """Client hint while NO replica is routable: the soonest any
        replica's own hint says to come back."""
        return min((h.sup._retry_after() for h in self.replicas),
                   default=1.0)

    def profile(self, ms: float) -> dict | None:
        """Relay POST /admin/profile into REMOTE replica workers — all
        captures run CONCURRENTLY so every worker traces the same ms
        window. Returns {"rK": {dir, ms} | None} per remote replica, or
        None when this router has no remote replicas (thread replicas
        share the parent's process — the HTTP handler captures locally
        instead)."""
        remote = [h for h in self.replicas if hasattr(h, "client")]
        if not remote:
            return None
        out: dict = {}

        def run(h):
            out[f"r{h.id}"] = h.profile(ms)

        threads = [threading.Thread(target=run, args=(h,), daemon=True)
                   for h in remote]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=float(ms) / 1e3 + 60.0)
        return out

    # -- rolling restart ---------------------------------------------------

    def drain_replica(self, replica: int, timeout: float = 30.0) -> bool:
        """Take ONE replica out of rotation and finish its in-flight work
        (new traffic keeps flowing to its siblings). Follow with
        restart_replica (rebuild + re-admit) or undrain_replica."""
        with self._lock:
            self.stats.drains += 1
        return self.replicas[replica].drain(timeout=timeout)

    def restart_replica(self, replica: int, timeout: float = 30.0) -> None:
        h = self.replicas[replica]
        with self._lock:
            self.stats.restarts += 1
        h.restart(timeout=timeout)
        with self._lock:
            # reset the router circuit AFTER the rebuild, under the lock:
            # a concurrent _on_result for a request that died with the old
            # generation must not interleave with restart's field clears
            # and leave the circuit half-cleared against the fresh engine
            h.fails = 0
            h.open_until = 0.0
            h.probing = False

    def undrain_replica(self, replica: int) -> None:
        self.replicas[replica].undrain()

    def rolling_restart(self, timeout: float = 30.0) -> bool:
        """The runbook recipe: drain + restart each
        replica IN TURN — at most one replica is ever out of rotation, so
        the service stays ready and no request is failed. Returns False
        if any drain timed out (its stragglers got shutdown frames)."""
        ok = True
        for h in self.replicas:
            ok &= self.drain_replica(h.id, timeout=timeout)
            self.restart_replica(h.id, timeout=timeout)
        return ok

    # -- fleet autoscaling surface (runtime/fleet.py) ----------------------

    def add_replica(self, handle) -> None:
        """Enter an already-built (and therefore already-warm: every
        handle constructor blocks on its warmup/handshake) replica into
        rotation. The fleet controller builds the handle OFF the router
        lock — possibly minutes of spawn + capture — and this entry is
        one guarded list append, so placement never waits on a spawn."""
        with self._lock:
            assert all(h.id != handle.id for h in self.replicas), handle.id
            self.replicas.append(handle)
            self.stats.replicas = len(self.replicas)

    def reap_replica(self, replica: int, timeout: float = 30.0) -> None:
        """Remove ONE drained replica from rotation and close it (the
        controller's scale-down tail: mark ``reap`` → drain → here).
        Close-before-remove: the handle's close() retires its monitor
        thread (so a respawn can never resurrect a reaped worker), and
        only then does the list forget it."""
        with self._lock:
            matches = [h for h in self.replicas if h.id == replica]
        if not matches:
            return
        h = matches[0]
        h.reap = True
        h.close(timeout=timeout)
        final = h.summary()  # close() is final: no writer outlives it
        with self._lock:
            for k in _COUNTER_KEYS:
                self._reap_carry[k] += final.get(k) or 0
            self.replicas = [x for x in self.replicas if x.id != replica]
            self.stats.replicas = len(self.replicas)
            # drop stale stickiness onto the dead id: those sessions
            # re-place fresh (losing affinity costs one cold placement)
            for k in [k for k, v in self._affinity.items() if v == replica]:
                del self._affinity[k]

    # -- placement ---------------------------------------------------------

    def _routable(self, h: ReplicaHandle, now: float) -> bool:
        """May REQUEST traffic go to h right now? Supervisor-ready AND
        not draining AND the router circuit allows it (closed, or
        half-open with no probe already in flight). Prefill-TIER
        replicas are never request-routable: they exist to run prefill
        passes and donate blocks (runtime/kv_transfer.py) — a tier of
        only prefill workers is therefore correctly unready. Caller
        holds the lock."""
        if getattr(h, "tier", "mixed") == "prefill":
            return False
        if h.reap:
            # marked for fleet scale-down: out of rotation from the mark
            # (its drain may not have started yet) — a reaped replica
            # must never take the request that blocks its own reap
            return False
        if h.draining or h.sup is None or not h.sup.ready:
            return False
        if h.open_until <= 0.0:
            return True
        if now < h.open_until:
            return False          # circuit open: cooling down
        return not h.probing      # half-open: one probe at a time

    def _pick(self, prompt, session,
              exclude) -> tuple[ReplicaHandle, str, bool]:
        """Choose a replica (plus the reason, for stats, and whether this
        pick IS the replica's half-open probe). Raises EngineUnready when
        nothing is routable."""
        if self.policy == "cache_aware":
            # the radix walks are O(prompt) and lock-free-safe (match_len
            # is a read-only peek; transiently stale is fine for routing)
            # — do them BEFORE taking the placement lock so long prompts
            # can't serialize every concurrent submit and /readyz probe
            match = {h.id: h.match_len(prompt) for h in self.replicas
                     if h.id not in exclude}
        now = time.perf_counter()
        with self._lock:
            cands = [h for h in self.replicas
                     if h.id not in exclude and self._routable(h, now)]
            if not cands:
                self.stats.no_replica_rejections += 1
                raise EngineUnready("no_replica", self._retry_after())
            if session is not None:
                rid = self._affinity.get(session)
                hit = next((h for h in cands if h.id == rid), None)
                if hit is not None:
                    self._affinity.move_to_end(session)
                    return (hit, "affinity", self._mark_probe(hit, now))
            if self.policy == "round_robin":
                h = cands[self._rr % len(cands)]
                self._rr += 1
                return (h, "fallback", self._mark_probe(h, now))
            if self.policy == "cache_aware":
                best = max(match.get(h.id, 0) for h in cands)
                if best > 0:
                    warm = [h for h in cands if match.get(h.id, 0) == best]
                    h = min(warm, key=lambda h: (h.load(), h.id))
                    return (h, "cache_hit", self._mark_probe(h, now))
            # least-loaded fallback (and the least_loaded policy itself)
            h = min(cands, key=lambda h: (h.load(), h.id))
            return (h, "fallback", self._mark_probe(h, now))

    # -- KV block transfer: fills + disaggregation (kv_transfer.py) --------

    def _pick_donor(self, target, prompt: list[int]):
        """The fill decision: the sibling whose cache (real radix tree
        for thread replicas, shadow index for process replicas) leads
        the TARGET's by at least one whole block's worth of tokens.
        Returns (donor_handle, donor_match_tokens) or None. Lock-free
        peeks, same discipline as cache-aware _pick — a transiently
        stale answer costs one useless fetch (which degrades to a
        re-prefill), never correctness."""
        have = target.match_len(prompt)
        best, best_n = None, have + self._fill_min - 1
        for h in self.replicas:
            if h.id == target.id or h.draining or h.sup is None:
                continue
            if not h.sup.ready:
                continue  # a dead/respawning donor cannot serve a fetch
            n = h.match_len(prompt)
            if n > best_n:
                best, best_n = h, n
        return (best, best_n) if best is not None else None

    def _prefill_pass(self, req: "RouterRequest") -> None:
        """Run req's prompt through a prefill-tier replica with
        max_tokens=0: the full prompt prefills there (big chunks, no
        decode rows to interfere with) and its whole blocks publish at
        prefill-finish — the donor the decode placement's fill then
        draws from. Every failure shape (no routable prefill worker,
        door refusal, worker death) falls back to the unified mixed
        path; the pass must never fail the request."""
        if len(req._prompt) <= self._fill_min:
            return  # nothing a whole-block handoff could carry
        now = time.perf_counter()
        with self._lock:
            cands = [h for h in self.replicas
                     if getattr(h, "tier", "mixed") == "prefill"
                     and not h.draining and h.sup is not None
                     and (h.open_until <= 0.0 or now >= h.open_until)]
        cands = [h for h in cands if h.sup.ready]
        if not cands:
            if any(getattr(h, "tier", "mixed") == "prefill"
                   for h in self.replicas):
                with self._lock:
                    self.kvx.prefill_pass_fallbacks += 1
            return
        h = min(cands, key=lambda h: (h.load(), h.id))
        t0 = time.perf_counter()
        try:
            inner = h.sup.submit(req._prompt, 0, req._fresh_sampler(),
                                 eos_id=req._eos_id,
                                 deadline=req._deadline,
                                 trace_id=req.trace_id)
            for _ in inner.tokens(timeout=60.0):
                pass  # max_tokens=0: prefill only, nothing streams
            h.note_routed(req._prompt)
            with self._lock:
                self.kvx.prefill_passes += 1
            if TRACER.enabled:
                TRACER.event("route", req.trace_id, replica=h.id,
                             reason="prefill_pass",
                             ms=round((time.perf_counter() - t0) * 1e3,
                                      3))
        except Exception:  # noqa: BLE001 — degrade to the mixed path
            with self._lock:
                self.kvx.prefill_pass_fallbacks += 1

    def _arrange_fill(self, h, req: "RouterRequest", sampler_unused=None):
        """Pre-submit fill work for a placement on h. Returns the
        ``fill`` tuple to ride a REMOTE submit frame (the worker fetches
        donor->self over the wire), or None. Thread-tier fills run right
        here (donor and target share this process)."""
        donor = self._pick_donor(h, req._prompt)
        if donor is None:
            return None
        dh, dn = donor
        remote_t = hasattr(h, "client")
        remote_d = hasattr(dh, "client")
        if remote_t and remote_d:
            addr = dh.client.addr
            return (addr[0], addr[1], dn, dh)
        if not remote_t and not remote_d:
            from .kv_transfer import local_fill

            local_fill(dh.sup, h.sup, req._prompt, stats=self.kvx,
                       trace_id=req.trace_id, donor_id=dh.id)
            # thread replicas peek the REAL tree — no shadow to go stale
        return None

    def _note_fill_verdict(self, donor_handle, req: "RouterRequest",
                           inner, expected: int) -> None:
        """The shadow-staleness fix: the worker's ACCEPT echoed what the
        donor's RMSG_BLOCK_QUERY actually answered. An answer SHORT of
        what the shadow promised means donor-side eviction — drop the
        stale entries so they stop attracting placements and fetches of
        dead blocks (-1 = no verdict: donor unreachable, maybe
        mid-respawn — its monitor clears the shadow on its own)."""
        ans = getattr(inner, "fill_answer", -1)
        if ans < 0 or ans >= expected:
            return
        shadow = getattr(donor_handle, "shadow", None)
        if shadow is not None and shadow.truncate(req._prompt, ans):
            with self._lock:
                self.kvx.shadow_truncates += 1

    def _mark_probe(self, h: ReplicaHandle, now: float) -> bool:
        """Arm the half-open probe if this pick crossed the cooldown.
        Returns True iff THIS pick is the probe (the caller must release
        it on a door refusal or a no-verdict expiry — see _release_probe)."""
        if h.open_until > 0.0 and now >= h.open_until:
            h.probing = True
            self.stats.breaker_probes += 1
            return True
        return False

    def _release_probe(self, h: ReplicaHandle | None) -> None:
        """A probe attempt ended with NO health verdict (refused at the
        door, or expired on the client's own deadline): re-open the
        half-open window instead of leaking probing=True, which would
        unroute the replica until a manual breaker reset."""
        if h is None:
            return
        with self._lock:
            h.probing = False

    def _place(self, req: RouterRequest, exclude: tuple, sampler) -> None:
        """Pick + submit, walking past replicas that refuse at the door
        (went unready/closed between pick and submit, or queue-full) —
        a door refusal is a placement miss, not a breaker-worthy request
        failure. Re-raises the last refusal when every replica refused."""
        tried = list(exclude)
        last_exc: Exception | None = None
        while True:
            try:
                h, reason, probe = self._pick(req._prompt, req._session,
                                              tried)
            except EngineUnready:
                if isinstance(last_exc, (QueueFull, EngineUnready)):
                    raise last_exc from None
                raise
            # cache FILL on miss (runtime/kv_transfer.py): when a warmer
            # sibling exists, thread tiers import its blocks right here;
            # process tiers ship the donor's coordinates on the submit
            # frame and the worker pulls donor->self directly
            fill = (self._arrange_fill(h, req) if self._kv_transfer
                    else None)
            try:
                if fill is not None:
                    d_host, d_port, d_expected, d_handle = fill
                    inner = h.sup.submit(req._prompt, req._max_tokens,
                                         sampler, eos_id=req._eos_id,
                                         deadline=req._deadline,
                                         trace_id=req.trace_id,
                                         fill=(d_host, d_port,
                                               d_expected, d_handle.id),
                                         tenant=req._tenant,
                                         priority=req._priority)
                    self._note_fill_verdict(d_handle, req, inner,
                                            d_expected)
                else:
                    inner = h.sup.submit(req._prompt, req._max_tokens,
                                         sampler, eos_id=req._eos_id,
                                         deadline=req._deadline,
                                         trace_id=req.trace_id,
                                         tenant=req._tenant,
                                         priority=req._priority)
            except (EngineUnready, QueueFull, SchedulerClosed) as e:
                if probe:
                    self._release_probe(h)
                tried.append(h.id)
                last_exc = e
                continue
            except BaseException:
                # anything else submit raises (PromptTooLong, bad-args
                # ValueError) is the CALLER's error, not the replica's —
                # propagate it, but never leak an armed probe with it
                if probe:
                    self._release_probe(h)
                raise
            # feed the placement signal for FUTURE picks: in-process
            # replicas no-op (match_len peeks their real radix tree); a
            # process replica records the routed prompt in its shadow
            # index (cache-aware placement without an RPC)
            h.note_routed(req._prompt)
            if TRACER.enabled:
                TRACER.event("route", req.trace_id, replica=h.id,
                             reason=reason, attempt=req.retries,
                             probe=probe)
            with self._lock:
                req._inner, req._handle = inner, h
                req._probe = probe
                self.stats.routed += 1
                if reason == "cache_hit":
                    self.stats.routed_cache_hit += 1
                elif reason == "affinity":
                    self.stats.routed_affinity += 1
                else:
                    self.stats.routed_fallback += 1
                if req._session is not None:
                    self._affinity[req._session] = h.id
                    self._affinity.move_to_end(req._session)
                    while len(self._affinity) > _AFFINITY_CAP:
                        self._affinity.popitem(last=False)
            if req._cancelled:
                inner.cancel()
            return

    def _on_result(self, h: ReplicaHandle | None, ok: bool,
                   retried: bool = False) -> None:
        """Terminal accounting for one attempt on replica h: drives the
        router circuit (consecutive request failures open it; any success
        — including the half-open probe — closes it)."""
        if h is None:
            return
        with self._lock:
            if ok:
                was_open = h.open_until > 0.0
                h.fails = 0
                h.open_until = 0.0
                h.probing = False
                if retried:
                    self.stats.failovers_ok += 1
                if was_open and TRACER.enabled:
                    TRACER.event("circuit", 0, scope="router",
                                 replica=h.id, state="closed")
                return
            h.fails += 1
            now = time.perf_counter()
            reopening = h.probing and h.open_until > 0.0
            h.probing = False
            if h.fails >= self.circuit_threshold or reopening:
                if h.open_until <= 0.0 or reopening:
                    self.stats.breaker_trips += 1
                    if TRACER.enabled:
                        TRACER.event("circuit", 0, scope="router",
                                     replica=h.id, state="open",
                                     fails=h.fails)
                h.open_until = now + self.circuit_cooldown


def build_front_door(engine, *, serve_batch: int, serve_chunk: int = 0,
                     queue_depth: int = 0, request_deadline: float = 0.0,
                     stall_timeout: float = 0.0, prefix_cache: bool = False,
                     prefix_blocks: int = 0, prefix_block_len: int = 32,
                     replicas: int = 1, retry_budget: int = 1,
                     route_policy: str = "cache_aware",
                     replica_procs: int = 0, replica_hosts=None,
                     worker_config: dict | None = None,
                     workdir: str | None = None,
                     worker_io_timeout: float = 30.0,
                     spawn_timeout: float = 300.0,
                     slo_ttft_ms: float | None = None,
                     slo_itl_ms: float | None = None,
                     draft: str | None = None, draft_len: int = 0,
                     draft_vocab: int | None = None,
                     kv_transfer: bool = False, tiers=None,
                     tenant_ledger=None):
    """The ONE constructor of the serving front door, shared by every
    deployment shape (apps/api_server.ApiState builds its door here):

      * replicas == 1 (default): an ``EngineSupervisor`` — the exact
        single-GPU supervisor.
      * replicas > 1: a ``Router`` over N THREAD replicas, each its own
        supervisor over ``engine``'s SHARED weight buffers.
      * replica_procs > 0: a ``Router`` over N locally-SPAWNED worker
        PROCESSES (runtime/replica_worker.py), each loading its own
        weights from ``worker_config`` — the real fault boundary: a
        SIGKILL/OOM/segfault costs one process, and the handle respawns
        it under supervision.
      * replica_hosts: a ``Router`` over pre-started workers at
        ``[(host, port), ...]`` — the cross-host tier (no spawn
        supervision; each host's operator owns its worker's lifetime).

    The HTTP handlers serve all four through the identical duck-typed
    surface.

    ``tenant_ledger`` (runtime/fleet.TenantLedger) arms weighted-fair
    admission: every LOCAL scheduler generation gets a fresh WFQueue
    over this one ledger (budgets survive rebuilds), and process
    workers arm their own worker-side WFQ from the budget spec shipped
    in ``worker_config`` (fairness must hold in the queue where waiting
    actually happens). Router shapes also stash ``_spawn_factory`` so
    the fleet controller (runtime/fleet.py) can mint replicas exactly
    the way this constructor did."""
    if replica_procs or replica_hosts:
        import os
        import tempfile

        from .replica_worker import WorkerProc

        factories = []
        if replica_procs:
            assert worker_config is not None, \
                "replica_procs needs a worker_config dict"
            workdir = workdir or tempfile.mkdtemp(prefix="dllama-replicas-")
            os.makedirs(workdir, exist_ok=True)

            def spawn_factory(i, tier):
                # the fleet controller mints replica i EXACTLY the way
                # the loop below does (fresh cfg, fault_key=r{i}, same
                # workdir/timeouts) — scale-ups and boot replicas are
                # indistinguishable to chaos keys and respawn folds
                cfg = dict(worker_config)
                cfg["fault_key"] = f"r{i}"
                cfg["kv_transfer"] = bool(kv_transfer)
                cfg["tier"] = tier
                proc = WorkerProc(i, cfg, workdir=workdir,
                                  io_timeout=worker_io_timeout)
                return RemoteReplicaHandle(
                    i, proc=proc, block_len=prefix_block_len,
                    io_timeout=worker_io_timeout,
                    spawn_timeout=spawn_timeout,
                    respawn_timeout=spawn_timeout, tier=tier)

            for i in range(int(replica_procs)):
                # replica identity at the key-filtered fault sites rides
                # into the worker so DLLAMA_FAULTS key=rK follows replica
                # K across respawns, same as the thread tier; the
                # per-replica disaggregation role + transfer arming
                # (runtime/kv_transfer.py) are stamped the same way
                tier = tiers[i] if tiers else "mixed"
                factories.append(lambda i=i, tier=tier:
                                 spawn_factory(i, tier))
        else:
            spawn_factory = None
            for i, (host, port) in enumerate(replica_hosts):
                def make(i=i, host=host, port=port):
                    return RemoteReplicaHandle(
                        i, address=(host, port),
                        block_len=prefix_block_len,
                        io_timeout=worker_io_timeout)
                factories.append(make)
        router = Router(None, policy=route_policy,
                        retry_budget=retry_budget,
                        handle_factories=factories,
                        kv_transfer=kv_transfer,
                        fill_min_tokens=prefix_block_len,
                        request_deadline=request_deadline or None)
        router._spawn_factory = spawn_factory
        return router

    def engine_factory():
        # a slot engine over the template's params (Engine.spawn: it
        # costs its KV cache and graph pools, never a weight copy), with
        # the template's mesh, dtypes and resolved vocab split
        return engine.spawn(serve_batch)

    n_blocks = 0
    if prefix_cache:
        n_blocks = prefix_blocks or max(
            2 * serve_batch * engine.seq_len // prefix_block_len, 1)
    fair_queue_factory = None
    if tenant_ledger is not None:
        from .fleet import WFQueue

        fair_queue_factory = lambda: WFQueue(tenant_ledger)  # noqa: E731
    sup_kwargs = dict(
        chunk=serve_chunk or None,
        max_queue=queue_depth or 4 * serve_batch,
        request_deadline=request_deadline or None,
        stall_timeout=stall_timeout or 10.0,
        prefix_blocks=n_blocks, prefix_block_len=prefix_block_len,
        slo_ttft_ms=slo_ttft_ms, slo_itl_ms=slo_itl_ms,
        draft=draft, draft_len=draft_len, draft_vocab=draft_vocab,
        fair_queue_factory=fair_queue_factory)
    if replicas <= 1:
        return EngineSupervisor(engine_factory, kv_transfer=kv_transfer,
                                **sup_kwargs)
    router = Router(engine_factory, replicas=replicas,
                    policy=route_policy, retry_budget=retry_budget,
                    kv_transfer=kv_transfer,
                    fill_min_tokens=prefix_block_len, tiers=tiers,
                    **sup_kwargs)
    # the fleet controller scales THREAD replicas too (tests drive the
    # loop without subprocesses): a scale-up builds a fresh supervised
    # replica over the same shared weight buffers
    router._spawn_factory = lambda rid, tier: ReplicaHandle(
        rid, engine_factory, dict(sup_kwargs, kv_transfer=kv_transfer),
        tier=tier)
    return router
