"""Engine supervision: watchdog, crash recovery, backoff, circuit breaker —
the port of the JAX package's runtime/resilience.py for one GPU.

``EngineSupervisor`` owns the serving step loop:

  * it runs the scheduler's step loop on its own thread and catches step
    exceptions;
  * a WATCHDOG thread reads the scheduler's in-step heartbeat
    (``Scheduler.step_age``: a wait at the device gate is left out) and
    declares a stall when one step exceeds
    ``stall_timeout`` (a hang raises nothing; the wedged thread cannot be
    interrupted, so its generation is abandoned);
  * RECOVERY fails the in-flight and queued requests with structured
    error frames, releases the failed engine's cache and graph pools
    (``Engine.release``), then builds a new engine and scheduler through
    ``engine_factory`` under exponential backoff, captures its graphs
    (``Scheduler.warmup``) and resumes; a CIRCUIT BREAKER keeps the
    supervisor unready after ``breaker_threshold`` consecutive failures
    (``reset_breaker()`` is the operator's half-open);
  * while not ready, ``submit()`` raises ``EngineUnready`` with a
    ``retry_after`` hint; the queue bound and the request deadlines live in
    the scheduler.

What a rebuild can recover is a failure on the host: an exception in the
step loop, a stalled step, a failed capture or allocation (the shapes
``runtime/faults.py`` injects). A sticky CUDA error (an illegal address,
a device-side assert) poisons the process's CUDA context; no engine built
in the same process will run, so the breaker opens after
``breaker_threshold`` failed rebuilds and the process must be restarted.

With ``prefix_blocks > 0`` every generation's scheduler gets a fresh
radix prefix cache (runtime/prefix_cache.py) over its own engine: its
arena holds K/V only that engine wrote, so a rebuild starts from an empty
tree, and the failed generation's arena goes back to the allocator with
its cache before the factory allocates. With ``draft`` ("self:D" or
"model:PATH", runtime/draft.py) every generation's scheduler builds its
draft over its own engine (a self-draft's params are that engine's
tensors); the failed engine's drafts, their caches and graphs, go back
with it (``Engine.release``).

Over ranks (parallel/control.py) the factory, the warmup, the release and
every step are ops that rank 0 mirrors to the other ranks, so a rebuild
runs on every rank in the same order. A failure that leaves the ranks in
step (a host exception on rank 0 before its op was sent, a stall that
ends) rebuilds as on one GPU. A rank that is lost (dead, silent past the
channel's timeout, or out of step after an op) cannot be rebuilt from
here: the supervisor goes to LOST, which is terminal and unready, and the
server reports it and exits.

Generations: each (engine, scheduler) pair is one generation. A failure
invalidates the generation first (a wedged step thread that wakes finds
``gen != self._gen`` and exits), then fails its requests, then rebuilds.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..parallel.control import RankLost
from .prefix_cache import PrefixCache
from .scheduler import Scheduler
from .stats import SupervisorStats
from .trace import TRACER

READY = "ready"
RECOVERING = "recovering"
BROKEN = "broken"          # circuit open: stays unready until reset
DRAINING = "draining"
CLOSED = "closed"
LOST = "lost"              # a rank of the mesh is gone: terminal

_COUNTER_KEYS = ("requests_submitted", "requests_finished",
                 "requests_failed", "requests_expired",
                 "requests_rejected", "tokens_out", "steps")


class EngineUnready(RuntimeError):
    """Admission refused: the engine is recovering, broken or draining.
    ``retry_after`` is the client hint (HTTP Retry-After)."""

    def __init__(self, state: str, retry_after: float):
        super().__init__(f"engine not ready (state: {state})")
        self.state = state
        self.retry_after = retry_after


class EngineSupervisor:
    """Supervised continuous-batching front door: the ``Scheduler``
    surface the API server uses (``submit``, ``engine``, ``stats``,
    ``exclusive()``, ``close()``) plus ``ready``/``state``, ``summary()``,
    ``drain()`` and ``reset_breaker()``."""

    def __init__(self, engine_factory, *, chunk: int | None = None,
                 max_queue: int = 0, queue_timeout: float | None = None,
                 request_deadline: float | None = None,
                 stall_timeout: float = 10.0, watchdog_poll: float = 0.02,
                 backoff_base: float = 0.1, backoff_max: float = 5.0,
                 breaker_threshold: int = 3,
                 prefix_blocks: int = 0, prefix_block_len: int = 32,
                 slo_ttft_ms: float | None = None,
                 slo_itl_ms: float | None = None,
                 draft: str | None = None, draft_len: int = 0,
                 draft_vocab: int | None = None,
                 kv_transfer: bool = False, fault_key: str | None = None,
                 fair_queue_factory=None):
        self._factory = engine_factory
        # this replica at the key-filtered fault sites: every generation's
        # scheduler carries it, so an armed kill follows the replica
        # across rebuilds
        self._fault_key = fault_key
        # the block-transfer plane (runtime/kv_transfer.py): every
        # generation's prefix cache is built with transfer on
        self._kv_transfer = bool(kv_transfer)
        # weighted-fair admission (runtime/fleet.py): a zero-argument
        # callable minting a fresh WFQueue a generation; the TenantLedger
        # behind it is the caller's, so budgets survive rebuilds
        self._fair_queue_factory = fair_queue_factory
        self._chunk = chunk
        # prefix_blocks > 0: a radix prefix cache of that many blocks of
        # prefix_block_len tokens, minted fresh with every generation
        self._prefix_blocks = int(prefix_blocks)
        self._prefix_block_len = int(prefix_block_len)
        # the SLOs of the admission policy: every generation's scheduler
        # gets a FRESH policy (the old EWMAs describe the dead engine's
        # steps; the new one learns again in a few steps)
        self._slo_ttft_ms = slo_ttft_ms
        self._slo_itl_ms = slo_itl_ms
        # the --draft spec string: built into a DraftModel per generation
        # inside _make_sched, over that generation's engine
        self._draft = draft
        self._draft_len = int(draft_len)
        self._draft_vocab = draft_vocab
        self.max_queue = int(max_queue)
        self._queue_timeout = queue_timeout
        self._request_deadline = request_deadline
        self.stall_timeout = float(stall_timeout)
        self._poll = watchdog_poll
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self.breaker_threshold = int(breaker_threshold)

        self.sup_stats = SupervisorStats()
        self._state_lock = threading.RLock()
        # dead generations' ServeStats stay live here (a straggler may
        # still count into one after the swap); generations past the cap
        # fold into the _carry totals
        self._dead_stats: list = []  # dlrace: guarded-by(self._state_lock)
        self._carry = {k: 0 for k in _COUNTER_KEYS}  # dlrace: guarded-by(self._state_lock)
        self._stop = False
        # why the ranks were lost (LOST), None while they are in step
        self.lost: str | None = None
        self._gen = 0  # dlrace: guarded-by(self._state_lock)
        self._state = READY  # dlrace: guarded-by(self._state_lock)
        self._sched = self._make_sched(engine_factory())  # dlrace: guarded-by(self._state_lock)
        # capture before the watchdog exists: a first step's capture must
        # never read as a stall, and /readyz means "will serve promptly"
        self._sched.warmup()
        self._loop_threads: dict[int, threading.Thread] = {}
        self._rebuild_thread: threading.Thread | None = None  # dlrace: guarded-by(self._state_lock)
        self._start_loop(self._sched, self._gen)
        self._watchdog_thread = threading.Thread(
            target=self._watchdog, name="dllama-watchdog", daemon=True)
        self._watchdog_thread.start()

    # -- the scheduler surface ---------------------------------------------

    @property
    def engine(self):
        return self._sched.engine

    @property
    def stats(self):
        """The CURRENT generation's ServeStats; cross-generation totals
        are in summary()."""
        return self._sched.stats

    @property
    def prefix_cache(self):
        """The CURRENT generation's radix prefix cache (None when off);
        like `stats`, it swaps wholesale on recovery."""
        return self._sched.prefix_cache

    @property
    def state(self) -> str:
        with self._state_lock:
            return self._state

    @property
    def ready(self) -> bool:
        """Engine healthy AND queue under its bound: the /readyz
        contract."""
        with self._state_lock:
            if self._state != READY:
                return False
            sched = self._sched
        return not self.max_queue or len(sched._queue) < self.max_queue

    def submit(self, prompt, max_tokens, sampler, eos_id=None,
               deadline=None, trace_id=None, tenant=None,
               priority="normal"):
        with self._state_lock:
            if self._state != READY:
                self.sup_stats.rejected_unready += 1
                raise EngineUnready(self._state, self._retry_after())
            sched = self._sched
        req = sched.submit(prompt, max_tokens, sampler, eos_id=eos_id,
                           deadline=deadline, trace_id=trace_id,
                           tenant=tenant, priority=priority)
        if sched._stop and not req.finished.is_set():
            # the generation died between the state check and the
            # enqueue: its abort may have drained the queue already
            sched._fail_req(req, {"code": "engine_error",
                                  "message": "engine failed during submit",
                                  "retryable": True})
        return req

    @contextlib.contextmanager
    def exclusive(self):
        """Borrow the current generation's engine (Scheduler.exclusive),
        refused while not ready. A crash inside the borrow is an engine
        failure like a step crash: recovery runs and the exception
        reaches the borrower."""
        with self._state_lock:
            if self._state != READY:
                raise EngineUnready(self._state, self._retry_after())
            sched, gen = self._sched, self._gen
        try:
            with sched.exclusive() as eng:
                yield eng
        except Exception as e:  # noqa: BLE001 — any failure in the borrow
            self._on_failure(gen, f"{type(e).__name__}: {e} "
                                  "(exclusive borrow)", kind="crash")
            raise

    def close(self, timeout: float = 30.0) -> None:
        end = time.perf_counter() + timeout
        with self._state_lock:
            self._stop = True
            self._state = CLOSED
            self._gen += 1  # invalidate every loop thread
            sched = self._sched
            rebuild = self._rebuild_thread
        sched.close(timeout=timeout)
        if rebuild is not None and rebuild.is_alive():
            # a close during a rebuild waits for the factory or warmup to
            # see _stop, so no thread is left launching at interpreter exit
            rebuild.join(timeout=max(end - time.perf_counter(), 1.0))
        if self._watchdog_thread.is_alive():
            self._watchdog_thread.join(timeout=max(self._poll * 10, 1.0))

    # -- the resilience surface --------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful drain: stop admitting (state DRAINING), keep stepping
        until the in-flight and queued work completes or `timeout` passes.
        Returns True when the scheduler went idle in time."""
        with self._state_lock:
            if self._state == READY:
                self._state = DRAINING
            elif self._state in (RECOVERING, BROKEN, LOST):
                return True  # nothing in flight: the failure aborted it
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            sched = self._sched
            # lock-free (has_work() takes the step mutex, which a wedged
            # step may hold forever)
            if not sched._queue and all(s.req is None for s in sched.slots):
                return True
            time.sleep(0.02)
        return False

    def reset_breaker(self) -> None:
        """Operator half-open: clear the failure streak and try one
        rebuild. No-op unless the breaker is open."""
        with self._state_lock:
            if self._state != BROKEN:
                return
            self.sup_stats.consecutive_failures = 0
            self._state = RECOVERING
            self._rebuild_thread = threading.Thread(
                target=self._rebuild, args=(time.perf_counter(),),
                daemon=True)
        if TRACER.enabled:
            TRACER.event("circuit", 0, scope="engine", state="half_open",
                         key=None)
        self._rebuild_thread.start()

    def summary(self) -> dict:
        """The /stats payload: the current generation's summary with the
        counter totals of every generation, the state, the resilience
        block and the device blocks (runtime/profiler.py)."""
        from .profiler import COMPILES, PROFILER, hbm_ledger

        with self._state_lock:
            sched = self._sched
            carry = dict(self._carry)
            dead = list(self._dead_stats)
            state = self._state
        out = sched.stats.summary()
        for k in _COUNTER_KEYS:
            out[k] = (out.get(k, 0) + carry[k]
                      + sum(getattr(d, k, 0) for d in dead))
        out["state"] = state
        out["resilience"] = self.sup_stats.summary()
        if self.lost is not None:
            out["resilience"]["lost"] = self.lost
        try:
            out["hbm"] = hbm_ledger(sched.engine, sched.prefix_cache)
        except AttributeError:  # a failed engine, released mid-scrape
            pass
        out["compiles"] = COMPILES.summary()
        if PROFILER.sample_every:
            out["device_time"] = PROFILER.summary()
        if TRACER.enabled:
            out["trace"] = TRACER.summary()
            out["step_timeline"] = TRACER.steps.summary_json()
        return out

    def _retry_after(self) -> float:
        # RECOVERING: one backoff step; BROKEN: nothing changes until an
        # operator steps in
        n = max(self.sup_stats.consecutive_failures, 1)
        if self._state in (BROKEN, LOST):
            return 30.0
        return min(self._backoff_base * (2 ** (n - 1)), self._backoff_max)

    # -- internals ---------------------------------------------------------

    def _make_sched(self, engine) -> Scheduler:
        pc = None
        if self._prefix_blocks > 0:
            pc = PrefixCache(engine, num_blocks=self._prefix_blocks,
                             block_len=self._prefix_block_len,
                             transfer=self._kv_transfer)
        draft_factory = None
        if self._draft:
            from .draft import build_draft

            spec_str = self._draft
            draft_factory = lambda eng: build_draft(eng, spec_str)  # noqa: E731
        return Scheduler(engine, chunk=self._chunk, max_queue=self.max_queue,
                         queue_timeout=self._queue_timeout,
                         request_deadline=self._request_deadline,
                         prefix_cache=pc, slo_ttft_ms=self._slo_ttft_ms,
                         slo_itl_ms=self._slo_itl_ms,
                         draft_factory=draft_factory,
                         draft_len=self._draft_len,
                         draft_vocab=self._draft_vocab,
                         fault_key=self._fault_key,
                         fair_queue=(self._fair_queue_factory()
                                     if self._fair_queue_factory else None))

    def _start_loop(self, sched: Scheduler, gen: int) -> None:
        for g in [g for g, t in self._loop_threads.items()
                  if not t.is_alive()]:
            del self._loop_threads[g]  # dead generations; wedged ones stay
        t = threading.Thread(target=self._loop, args=(sched, gen),
                             name=f"dllama-supervised-step-gen{gen}",
                             daemon=True)
        self._loop_threads[gen] = t
        t.start()

    def _loop(self, sched: Scheduler, gen: int) -> None:
        """Scheduler._run's body, with failures escalated to recovery."""
        while not self._stop and gen == self._gen and not sched._stop:
            sched._wake.clear()
            try:
                with sched._mutex:
                    did = sched._step_locked()
            except Exception as e:  # noqa: BLE001 — any step failure
                self._on_failure(gen, f"{type(e).__name__}: {e}",
                                 kind="crash")
                return
            if did and self.sup_stats.consecutive_failures:
                with self._state_lock:
                    if gen == self._gen:
                        # a real step succeeded after recovery
                        self.sup_stats.consecutive_failures = 0
            if not did and not self._stop and gen == self._gen:
                sched._wake.wait(timeout=0.05)

    def _watchdog(self) -> None:
        """Detect a step body running longer than stall_timeout."""
        while not self._stop:
            time.sleep(self._poll)
            with self._state_lock:
                if self._state != READY:
                    continue
                sched, gen = self._sched, self._gen
            age = sched.step_age()
            if age is not None and age > self.stall_timeout:
                self.sup_stats.watchdog_trips += 1
                self._on_failure(
                    gen, f"step stalled > {self.stall_timeout:.1f}s "
                         "(watchdog)", kind="stall")

    def _ranks_lost(self, engine) -> str | None:
        """Why the engine's ranks are lost, or None (one GPU, or in step)."""
        ctl = getattr(engine, "control", None)
        return None if ctl is None else ctl.lost

    def _go_lost(self, why: str) -> None:
        with self._state_lock:
            self.lost = why
            if self._state != CLOSED:
                self._state = LOST
        if TRACER.enabled:
            TRACER.event("circuit", 0, scope="engine", state="lost",
                         key=None)

    def trip_cluster(self, exc) -> None:
        """A cluster node is gone (parallel/multihost.ClusterPeerLost; JAX
        runtime/resilience.py:283): the engine's mesh spans a process that
        no rebuild brings back, so the supervisor goes to its terminal
        state, LOST, at once: every in-flight and queued request gets a
        structured ``cluster_peer_lost`` error frame (not retryable: the
        same server cannot serve a retry), and nothing is rebuilt.
        Idempotent; called from the link's detection thread while the
        step thread may be wedged in a collective (the abort takes no step
        mutex)."""
        with self._state_lock:
            if self._state in (CLOSED, LOST):
                return
            self._gen += 1          # wedged/stale threads exit on wake
            old = self._sched
            old._stop = True
            self.sup_stats.cluster_losses += 1
        self._go_lost(str(exc))
        old._abort_all(str(exc), code="cluster_peer_lost", retryable=False)

    def _on_failure(self, gen: int, msg: str, kind: str) -> None:
        """A loop crash or a watchdog stall: invalidate the generation,
        fail its requests, release its engine, rebuild in the background.
        Idempotent per generation. A lost rank is not rebuilt: LOST."""
        with self._state_lock:
            if gen != self._gen or self._state in (CLOSED, LOST):
                return
            t_detect = time.perf_counter()
            self._gen += 1          # wedged/stale threads exit on wake
            old = self._sched
            old._stop = True
            self._state = RECOVERING
            if kind == "crash":
                self.sup_stats.crashes += 1
            self.sup_stats.consecutive_failures += 1
        if TRACER.enabled:
            TRACER.event("engine_failure", 0, failure=kind, msg=msg[:200],
                         gen=gen, key=None)
        # outside the state lock (waiter wakeups) and without the step
        # mutex (a wedged step holds it)
        old._abort_all(f"engine failure: {msg}")
        lost = self._ranks_lost(old.engine)
        if lost is not None:
            self._go_lost(lost)
            return
        t = threading.Thread(target=self._rebuild,
                             args=(t_detect, old), daemon=True)
        with self._state_lock:
            self._rebuild_thread = t
        t.start()

    def _rebuild(self, t_detect: float, failed=None) -> None:
        """Release, backoff, factory, warmup, install, resume — on its own
        thread (the watchdog must keep watching, and freeing memory may
        wait for the card). Factory and warmup failures count toward the
        breaker."""
        try:
            self._rebuild_body(t_detect, failed)
        except RankLost as e:
            self._go_lost(str(e))

    def _rebuild_body(self, t_detect: float, failed) -> None:
        if failed is not None:
            # the failed generation's arena, cache and graph pools go back
            # before the factory allocates the next engine; on one stream,
            # the allocator orders any launch still queued on them first
            if failed.prefix_cache is not None:
                failed.prefix_cache.release()
            failed.draft_cache = None   # the draft's own, released below
            failed.engine.release()     # its drafts' caches and graphs too
        while not self._stop:
            with self._state_lock:
                n = self.sup_stats.consecutive_failures
                if n >= self.breaker_threshold:
                    self._state = BROKEN  # circuit open: stay unready
                    if TRACER.enabled:
                        TRACER.event("circuit", 0, scope="engine",
                                     state="open", fails=n, key=None)
                    return
            time.sleep(min(self._backoff_base * (2 ** max(n - 1, 0)),
                           self._backoff_max))
            if self._stop:
                return
            sched = None
            try:
                sched = self._make_sched(self._factory())
                # captured while unready: the watchdog watches READY
                # generations only
                sched.warmup()
            except Exception as e:  # noqa: BLE001 — one more consecutive failure
                if isinstance(e, RankLost):
                    raise
                if sched is not None:
                    if sched.prefix_cache is not None:
                        sched.prefix_cache.release()
                    sched.draft_cache = None
                    sched.engine.release()
                with self._state_lock:
                    self.sup_stats.consecutive_failures += 1
                continue
            with self._state_lock:
                if self._stop or self._state == CLOSED:
                    sched.close(timeout=1.0)
                    return
                self._gen += 1
                gen = self._gen
                self._dead_stats.append(self._sched.stats)
                if len(self._dead_stats) > 32:
                    old = self._dead_stats.pop(0)  # ancient: no writers
                    for k in _COUNTER_KEYS:
                        self._carry[k] += getattr(old, k, 0)
                self._sched = sched
                self._state = READY
                self.sup_stats.recoveries += 1
                recovery_ms = (time.perf_counter() - t_detect) * 1e3
                self.sup_stats.recovery_ms.append(recovery_ms)
            if TRACER.enabled:
                TRACER.event("recovery", 0, ms=round(recovery_ms, 3),
                             gen=gen, key=None)
            self._start_loop(sched, gen)
            return
