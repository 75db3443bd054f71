"""The fleet brain: load-adaptive autoscaling, SLO-aware overload
shedding and multi-tenant fairness — the port of the JAX package's
runtime/fleet.py (host code, copied; it reads the port's signals and
drives the port's actuators):

  * ``FleetController`` — a host-side control loop (one thread) that
    scales the replica set between ``--min-replicas``/``--max-replicas``
    from OBSERVED load: spawn on sustained queue growth or occupancy
    EWMA, drain and reap on sustained idle, the memory ledger's
    ``slots_addable`` (runtime/profiler.hbm_ledger) as the hard ceiling.
    Fresh replicas warm their caches through KV block fills from
    siblings (runtime/kv_transfer.py), and the prefill and decode tiers
    resize from their own saturation signals. Every decision is a trace
    event (``scale_up``/``scale_down``) and one log line.
  * ``ShedLadder`` — the door-level overload ladder, walked IN ORDER
    before any rejection: speculation off, ``max_tokens`` clamp,
    prefix-cache-only admission, then a structured 429 with a
    ``Retry-After`` from the live drain rate. Monotone degradation,
    rung-by-rung recovery with count-based hysteresis, so every
    transition is count-deterministic under test.
  * ``WFQueue``/``TenantLedger`` — priority classes and per-tenant token
    budgets (``--tenant-budgets``; the tenant from the request body or
    the ``X-Tenant`` header) with start-time weighted-fair queueing in
    place of the FIFO admission deque: over-budget tenants are served
    only when no in-budget tenant waits, and within a budget class the
    virtual-time tags bound any tenant's lead by one request's cost over
    its weighted share.

Everything here is host bookkeeping and thread scheduling: no kernel and
no graph is added, and a spawned replica captures its graphs before it
becomes routable (runtime/router.py).

Chaos surface (runtime/faults.py): ``spawn_stall`` (key ``rK``) slows the
controller's replica-K spawn; ``scale_flap`` replaces the measured
pressure with a synthetic oscillation for as many ticks as it is armed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from .faults import FAULTS
from .trace import TRACER

# priority classes, highest first: the WFQ serves a lower band only
# when every higher band is empty (strict priority ACROSS bands,
# weighted fairness WITHIN a band)
PRIORITIES = ("high", "normal", "low")
DEFAULT_TENANT = "anon"

# the shed/degrade ladder, walked top (healthy) to bottom (shed) one
# rung at a time (the names the /stats `fleet.ladder` block reports)
LADDER_RUNGS = ("healthy", "no_spec", "clamp", "prefix_only", "shed")


def parse_tenant_budgets(spec: str | None) -> dict:
    """Parse ``--tenant-budgets``: comma-separated
    ``name=weight[:tokens_per_sec]`` entries, e.g.
    ``"acme=3:5000,free=1:200"`` — weight is the WFQ share, the
    optional rate is the token-bucket refill (absent/0 = unlimited
    budget, fairness by weight only). Unknown tenants get weight 1,
    unlimited. Raises ValueError on malformed entries (the CLI refuses
    at parse time, never at serve time)."""
    out: dict[str, tuple[float, float]] = {}
    if not spec:
        return out
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"tenant budget {item!r}: expected "
                             "name=weight[:tokens_per_sec]")
        name, _, val = item.partition("=")
        w, _, rate = val.partition(":")
        try:
            weight = float(w)
            per_sec = float(rate) if rate else 0.0
        except ValueError:
            raise ValueError(f"tenant budget {item!r}: weight and rate "
                             "must be numbers") from None
        if weight <= 0 or per_sec < 0:
            raise ValueError(f"tenant budget {item!r}: weight must be "
                             "> 0 and rate >= 0")
        out[name.strip()] = (weight, per_sec)
    return out


class TenantLedger:
    """Per-tenant WFQ weights + token-bucket budgets, held OUTSIDE the
    scheduler so budgets survive supervisor rebuilds (each generation's
    fresh ``WFQueue`` shares this one ledger — the same externally-held
    discipline as the supervisor's counter carry).

    The bucket refills at ``tokens_per_sec`` up to ``burst_secs`` worth
    of credit; a request charges its COST (prompt + max_tokens — the
    service estimate the WFQ tags use) when it is admitted off the
    queue. ``in_budget`` going False never rejects by itself: it only
    demotes the tenant behind every in-budget sibling (work-conserving
    — overage is served from idle capacity, never from a victim's
    share). The injectable ``clock`` makes refill count-deterministic
    under test."""

    def __init__(self, budgets: dict | None = None, *,
                 burst_secs: float = 10.0, clock=time.monotonic):
        self._clock = clock
        self._burst = float(burst_secs)
        self.lock = threading.Lock()
        # name -> (weight, tokens_per_sec); absent tenants default (1, 0)
        self._spec: dict[str, tuple[float, float]] = dict(budgets or {})
        self._balance: dict[str, float] = {}  # dlrace: guarded-by(self.lock)
        self._last_refill = clock()  # dlrace: guarded-by(self.lock)
        # lifetime per-tenant accounting (the fleet /stats block)
        self._admitted: dict[str, int] = {}  # dlrace: guarded-by(self.lock)
        self._shed: dict[str, int] = {}  # dlrace: guarded-by(self.lock)
        self._charged: dict[str, int] = {}  # dlrace: guarded-by(self.lock)
        with self.lock:
            for name, (_, rate) in self._spec.items():
                if rate > 0:
                    self._balance[name] = rate * self._burst

    def weight(self, tenant: str) -> float:
        return self._spec.get(tenant, (1.0, 0.0))[0]

    def limited(self, tenant: str) -> bool:
        return self._spec.get(tenant, (1.0, 0.0))[1] > 0

    def _refill_locked(self, now: float) -> None:
        dt = max(now - self._last_refill, 0.0)
        self._last_refill = now
        for name, (_, rate) in self._spec.items():
            if rate > 0:
                cap = rate * self._burst
                self._balance[name] = min(
                    self._balance.get(name, cap) + rate * dt, cap)

    def in_budget(self, tenant: str) -> bool:
        """True when this tenant's bucket has credit (or it is not
        budget-limited at all)."""
        rate = self._spec.get(tenant, (1.0, 0.0))[1]
        if rate <= 0:
            return True
        with self.lock:
            self._refill_locked(self._clock())
            return self._balance.get(tenant, 0.0) > 0.0

    def charge(self, tenant: str, tokens: int) -> None:
        """Debit an admitted request's cost (the bucket may go negative
        — overage is repaid by refill before the tenant is in-budget
        again)."""
        with self.lock:
            self._refill_locked(self._clock())
            self._charged[tenant] = self._charged.get(tenant, 0) + int(tokens)
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            rate = self._spec.get(tenant, (1.0, 0.0))[1]
            if rate > 0:
                self._balance[tenant] = (
                    self._balance.get(tenant, rate * self._burst)
                    - float(tokens))

    def note_shed(self, tenant: str) -> None:
        with self.lock:
            self._shed[tenant] = self._shed.get(tenant, 0) + 1

    def summary(self) -> dict:
        """Per-tenant block of the fleet /stats payload: every tenant
        ever seen (configured or not), with weight, budget remaining
        (None = unlimited), admitted/shed/charged totals."""
        with self.lock:
            self._refill_locked(self._clock())
            names = (set(self._spec) | set(self._admitted)
                     | set(self._shed))
            out = {}
            for name in sorted(names):
                weight, rate = self._spec.get(name, (1.0, 0.0))
                out[name] = {
                    "weight": weight,
                    "tokens_per_sec": rate or None,
                    "budget_remaining": (round(self._balance.get(name, 0.0), 1)
                                         if rate > 0 else None),
                    "admitted": self._admitted.get(name, 0),
                    "shed": self._shed.get(name, 0),
                    "tokens_charged": self._charged.get(name, 0),
                }
            return out


class WFQueue:
    """Start-time weighted-fair admission queue, duck-typing the slice
    of ``collections.deque`` the scheduler uses (``append`` /
    ``popleft`` / ``len`` / truthiness) so it drops into
    ``Scheduler._queue`` unchanged.

    Within a priority band, requests carry virtual-time tags in the
    SFQ style: a request's start tag is max(band virtual time, its
    tenant's last finish tag), its finish tag start + cost/weight
    (cost = prompt + max_tokens — the service estimate). ``popleft``
    serves the smallest head finish tag among tenants, which bounds any
    tenant's lead over its weighted share by one request's cost — the
    two-tenant starvation bound the fleet tests pins. Bands are
    strict priority (high before normal before low); over-budget
    tenants (TenantLedger) are eligible only when NO in-budget tenant
    waits in any band, so a hog's overage rides idle capacity and never
    moves a victim.

    Locking: ``append``/``popleft`` take a tiny internal lock never
    held across a forward — the submit path stays as cheap as the
    deque it replaces (the measured constraint: mutex-taking submits
    once stalled a 2.8 s arrival trace to 8.5 s). ``__len__``/
    ``__bool__`` read one int lock-free, preserving the scheduler's
    and supervisor's lock-free busy checks."""

    def __init__(self, ledger: TenantLedger | None = None):
        self.ledger = ledger
        self._lock = threading.Lock()
        # band index -> tenant -> deque[(finish_tag, start_tag, req)]
        self._bands: dict[int, dict[str, deque]] = {
            i: {} for i in range(len(PRIORITIES))}  # dlrace: guarded-by(self._lock)
        self._vt = [0.0] * len(PRIORITIES)  # dlrace: guarded-by(self._lock)
        # (band, tenant) -> last finish tag handed out
        self._finish: dict[tuple, float] = {}  # dlrace: guarded-by(self._lock)
        self._n = 0  # dlrace: guarded-by(self._lock)

    def __len__(self) -> int:
        return self._n  # lock-free: int read is atomic under the GIL

    def __bool__(self) -> bool:
        return self._n > 0

    @staticmethod
    def _band_of(req) -> int:
        p = getattr(req, "priority", "normal")
        try:
            return PRIORITIES.index(p)
        except ValueError:
            return PRIORITIES.index("normal")

    @staticmethod
    def _cost_of(req) -> float:
        return float(len(getattr(req, "prompt", ()) or ())
                     + max(int(getattr(req, "max_tokens", 0) or 0), 1))

    def append(self, req) -> None:
        tenant = getattr(req, "tenant", None) or DEFAULT_TENANT
        band = self._band_of(req)
        weight = self.ledger.weight(tenant) if self.ledger else 1.0
        cost = self._cost_of(req)
        with self._lock:
            start = max(self._vt[band],
                        self._finish.get((band, tenant), 0.0))
            finish = start + cost / max(weight, 1e-9)
            self._finish[(band, tenant)] = finish
            self._bands[band].setdefault(tenant, deque()).append(
                (finish, start, req))
            self._n += 1

    def popleft(self):
        """The next request to admit (IndexError when empty — the
        deque contract ``Scheduler._abort_all`` relies on). Charges the
        winner's cost to its tenant's budget."""
        with self._lock:
            if self._n == 0:
                raise IndexError("pop from an empty WFQueue")
            pick = self._pick_locked(budgeted=True)
            if pick is None:
                # every waiting tenant is over budget: work-conserving
                # fallback — serve the overage by the same tags
                pick = self._pick_locked(budgeted=False)
            band, tenant, dq = pick
            finish, start, req = dq.popleft()
            if not dq:
                del self._bands[band][tenant]
            self._vt[band] = max(self._vt[band], start)
            self._n -= 1
        if self.ledger is not None:
            self.ledger.charge(tenant, int(self._cost_of(req)))
        return req

    def _pick_locked(self, budgeted: bool):  # dlrace: holds(self._lock)
        for band in range(len(PRIORITIES)):
            tenants = self._bands[band]
            best = None
            for tenant, dq in tenants.items():
                if not dq:
                    continue
                if budgeted and self.ledger is not None \
                        and not self.ledger.in_budget(tenant):
                    continue
                head = dq[0][0]
                if best is None or head < best[0]:
                    best = (head, tenant, dq)
            if best is not None:
                return (band, best[1], best[2])
        return None

    def snapshot_depths(self) -> dict:
        """{priority: queued} — the fleet /stats block's queue shape."""
        with self._lock:
            return {PRIORITIES[b]: sum(len(dq) for dq in t.values())
                    for b, t in self._bands.items()}


class ShedLadder:
    """The door-level overload ladder (rungs in ``LADDER_RUNGS``),
    walked monotonically one rung at a time with count-based hysteresis
    — ``up_after`` consecutive observations above ``hi`` escalate,
    ``down_after`` consecutive below ``lo`` recover, with ``cooldown``
    observations of dead time after every move so one noisy tick cannot
    thrash the ladder (the same discipline as AdmissionPolicy's chunk
    walk, which remains the rung BELOW this ladder: ``no_spec`` here
    composes with the policy's own spec actuator — either may turn
    drafting off, both must agree to turn it on).

    The pressure signal is the caller's (the FleetController feeds
    queue depth per slot of routable capacity); the drain rate feeds
    ``retry_after`` so a 429's Retry-After is derived from how fast the
    queue is ACTUALLY draining, not a constant."""

    def __init__(self, *, hi: float = 0.8, lo: float = 0.3,
                 up_after: int = 2, down_after: int = 4,
                 cooldown: int = 2, clamp_tokens: int = 64):
        self.hi = float(hi)
        self.lo = float(lo)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown = int(cooldown)
        self.clamp_tokens = int(clamp_tokens)
        self.rung = 0
        self.escalations = 0
        self.recoveries = 0
        self._above = 0
        self._below = 0
        self._since_move = self.cooldown  # first move is eligible
        self._drain_rate = 0.0   # requests/sec, EWMA
        self._queued = 0

    @property
    def name(self) -> str:
        return LADDER_RUNGS[self.rung]

    @property
    def spec_degraded(self) -> bool:
        return self.rung >= LADDER_RUNGS.index("no_spec")

    def observe(self, pressure: float, *, queued: int = 0,
                drained: float = 0.0) -> int:
        """One controller tick's observation: pressure in [0, inf),
        queued requests, and requests drained since the last tick
        (already per-second). Returns the rung AFTER the walk."""
        self._queued = int(queued)
        self._drain_rate = 0.5 * self._drain_rate + 0.5 * max(drained, 0.0)
        self._since_move += 1
        if pressure > self.hi:
            self._above += 1
            self._below = 0
        elif pressure < self.lo:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
        if self._since_move < self.cooldown:
            return self.rung
        if (self._above >= self.up_after
                and self.rung + 1 < len(LADDER_RUNGS)):
            self.rung += 1
            self.escalations += 1
            self._above = 0
            self._since_move = 0
            if TRACER.enabled:
                TRACER.event("degrade", 0, rung=self.rung,
                             name=self.name, pressure=round(pressure, 3))
        elif self._below >= self.down_after and self.rung > 0:
            self.rung -= 1
            self.recoveries += 1
            self._below = 0
            self._since_move = 0
            if TRACER.enabled:
                TRACER.event("degrade", 0, rung=self.rung,
                             name=self.name, pressure=round(pressure, 3),
                             recovered=True)
        return self.rung

    def retry_after(self) -> float:
        """A shed 429's Retry-After: queued work over the live drain
        rate, clamped to [0.5, 30] s — the time until the queue has
        actually made room, not a constant guess."""
        if self._drain_rate <= 1e-6:
            return 30.0
        return min(max(self._queued / self._drain_rate, 0.5), 30.0)

    def admit(self, *, max_tokens: int, prefix_hit: bool) -> tuple:
        """Walk the ladder for ONE arriving request. Returns
        ``(allowed, max_tokens, reason)`` — reason is None when nothing
        degraded, else the rung name that acted. The shed decision
        raises nothing itself: the door owns the structured 429."""
        if self.rung >= LADDER_RUNGS.index("shed"):
            return (False, max_tokens, "shed")
        if self.rung >= LADDER_RUNGS.index("prefix_only") and not prefix_hit:
            return (False, max_tokens, "prefix_only")
        if self.rung >= LADDER_RUNGS.index("clamp") \
                and (max_tokens <= 0 or max_tokens > self.clamp_tokens):
            return (True, self.clamp_tokens, "clamp")
        return (True, max_tokens, None)

    def summary(self) -> dict:
        return {
            "rung": self.rung,
            "name": self.name,
            "escalations": self.escalations,
            "recoveries": self.recoveries,
            "drain_rate": round(self._drain_rate, 3),
            "retry_after_s": round(self.retry_after(), 3),
        }


class ShedReject(Exception):
    """A request shed by the overload ladder — the door maps it to a
    structured 429 with the drain-rate-derived Retry-After."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(f"overload: {reason}")
        self.reason = reason
        self.retry_after = float(retry_after)


class FleetConfig:
    """Anti-flap knobs, all count-based (ticks of the controller's
    ``poll`` cadence) so every bar in the fleet tests is
    deterministic under a driven ``tick()``."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 1,
                 poll: float = 0.5, up_pressure: float = 0.75,
                 down_pressure: float = 0.15, up_after: int = 3,
                 down_after: int = 8, cooldown_ticks: int = 4,
                 spawn_backoff_ticks: int = 6, ewma_alpha: float = 0.4,
                 warm_prompts: int = 4):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.poll = float(poll)
        self.up_pressure = float(up_pressure)
        self.down_pressure = float(down_pressure)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown_ticks = int(cooldown_ticks)
        self.spawn_backoff_ticks = int(spawn_backoff_ticks)
        self.ewma_alpha = float(ewma_alpha)
        self.warm_prompts = int(warm_prompts)


class FleetController:
    """The measurement→decision loop over one serving front door
    (Router or EngineSupervisor — autoscaling needs a Router with a
    spawn factory; the ladder and fairness work on every tier).

    One controller thread ticks every ``config.poll`` seconds; each
    ``tick()`` is also a public, synchronous entry point so tests drive
    the loop count-deterministically with zero sleeps. A tick:

      1. observes per-tier load (queued + running per routable slot,
         EWMA-smoothed) and feeds the shed ladder;
      2. applies the ladder's ``no_spec`` rung to every local
         scheduler (process workers run their own AdmissionPolicy
         actuator worker-side — the parent's ladder governs the door);
      3. walks the scale decision per tier (prefill and decode/mixed
         resize independently): sustained pressure spawns (bounded by
         ``max_replicas`` and the HBM ledger's ``slots_addable``),
         sustained idle drains + reaps (never below ``min_replicas``).

    Chaos-proofing: the spawn runs on a worker thread (a SIGKILL of the
    half-built replica lands in that thread's failure fold, counted as
    ``spawn_failures`` + backoff ticks — never a confused respawn);
    the reap path marks the victim ``reap=True`` BEFORE draining so
    ``/readyz`` and ``Router.state`` report ``scaling_down`` instead of
    a health problem, and closes the handle (which retires its monitor)
    before removing it from rotation. A freshly spawned replica is
    warmed twice over: its supervisor/worker captures every graph
    before it reports ready (no capture after warmup), and the
    controller replays the router's recent prompts through the KV
    fill path so its CACHE starts warm too."""

    def __init__(self, door, *, config: FleetConfig | None = None,
                 ladder: ShedLadder | None = None,
                 ledger: TenantLedger | None = None,
                 stats=None, clock=time.monotonic):
        from .stats import FleetStats

        self.door = door
        self.config = config or FleetConfig()
        self.ladder = ladder
        self.ledger = ledger
        self.stats = stats or FleetStats(enabled=True)
        self._clock = clock
        self._lock = threading.Lock()
        self._closed = False
        # per-tier ("prefill" vs "serve" = decode+mixed) decision state
        self._load_ewma: dict[str, float] = {}  # dlrace: guarded-by(self._lock)
        self._above: dict[str, int] = {}  # dlrace: guarded-by(self._lock)
        self._idle: dict[str, int] = {}  # dlrace: guarded-by(self._lock)
        self._cooldown: dict[str, int] = {}  # dlrace: guarded-by(self._lock)
        self._backoff = 0  # dlrace: guarded-by(self._lock)
        # replica ids reserved by in-flight spawn threads (a spawn can
        # take minutes; the walk counts these toward max_replicas and
        # the next decision mints a DISTINCT id)
        self._pending: set[int] = set()  # dlrace: guarded-by(self._lock)
        self._scaling_threads: list[threading.Thread] = []
        self._flap_phase = False  # scale_flap fault toggle
        self._finished_last = 0
        self._last_tick = clock()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="dllama-fleet", daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=timeout)
        for t in list(self._scaling_threads):
            if t.is_alive():
                t.join(timeout=timeout)

    def _run(self) -> None:
        while not self._closed:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the brain must outlive a
                # transiently unreadable signal (a replica mid-respawn
                # answering half a summary); decisions resume next tick
                pass
            time.sleep(self.config.poll)

    # -- the door-side admission walk -------------------------------------

    def admit(self, *, tenant: str | None, n_prompt: int,
              max_tokens: int, prefix_hit: bool = False) -> int:
        """Run ONE arriving request through the shed ladder (called by
        the API door before submit). Returns the possibly-clamped
        max_tokens; raises ShedReject with the drain-rate Retry-After
        when the request must be turned away. Sheds are accounted per
        tenant and traced."""
        if self.ladder is None:
            return max_tokens
        allowed, mt, reason = self.ladder.admit(max_tokens=max_tokens,
                                                prefix_hit=prefix_hit)
        if allowed:
            if reason == "clamp":
                with self._lock:
                    self.stats.clamped += 1
            return mt
        name = tenant or DEFAULT_TENANT
        if self.ledger is not None:
            self.ledger.note_shed(name)
        with self._lock:
            self.stats.sheds += 1
            self.stats.sheds_by_reason[reason] = (
                self.stats.sheds_by_reason.get(reason, 0) + 1)
        retry = self.ladder.retry_after()
        if TRACER.enabled:
            TRACER.event("shed", 0, tenant=name, reason=reason,
                         retry_after=round(retry, 3),
                         n_prompt=int(n_prompt))
        raise ShedReject(reason, retry)

    # -- observation -------------------------------------------------------

    def _handles(self) -> list:
        return getattr(self.door, "replicas", None) or []

    def _serve_group(self, h) -> str:
        """Which saturation signal a replica feeds: the prefill tier
        resizes from its own load, decode and mixed replicas share the
        request-serving signal."""
        return "prefill" if getattr(h, "tier", "mixed") == "prefill" \
            else "serve"

    def _capacity(self) -> int:
        """KV slots per replica — the pressure denominator. The door's
        engine template knows its batch; a process tier that has not
        handshaken yet falls back to 1 (pressure reads high, which only
        delays scale-down — the safe direction)."""
        try:
            return max(int(self.door.engine.batch), 1)
        except Exception:  # noqa: BLE001 — EngineUnready pre-handshake
            return 1

    def _observe(self) -> dict:
        """{group: (pressure, n_routable)} over the live handles (or
        the single supervisor)."""
        handles = self._handles()
        cap = self._capacity()
        if not handles:
            sup = self.door
            try:
                sched = sup._sched
                load = (len(sched._queue)
                        + sum(1 for s in sched.slots if s.req is not None))
            except Exception:  # noqa: BLE001 — mid-rebuild
                load = 0
            return {"serve": (load / cap, 1)}
        out: dict[str, list] = {}
        for h in handles:
            if getattr(h, "reap", False):
                continue  # a draining-for-reap replica is not capacity
            g = self._serve_group(h)
            acc = out.setdefault(g, [0.0, 0])
            try:
                if h.sup is not None and h.sup.ready and not h.draining:
                    acc[0] += float(h.load())
                    acc[1] += 1
            except Exception:  # noqa: BLE001 — a dying replica's health
                continue
        return {g: ((load / (n * cap)) if n else 1.0, n)
                for g, (load, n) in out.items()}

    def _queued_total(self) -> int:
        handles = self._handles()
        if not handles:
            try:
                return len(self.door._sched._queue)
            except Exception:  # noqa: BLE001
                return 0
        total = 0
        for h in handles:
            try:
                total += max(int(h.load()) - self._capacity(), 0)
            except Exception:  # noqa: BLE001
                continue
        return total

    def _finished_total(self) -> int:
        try:
            return int(self.door.summary().get("requests_finished") or 0)
        except Exception:  # noqa: BLE001
            return self._finished_last

    def _hbm_headroom_ok(self) -> bool:
        """The hard ceiling: one more replica costs ``capacity`` KV
        slots — refuse the spawn when the HBM ledger says they do not
        fit. Unknown headroom (CPU backends report no limit) allows."""
        try:
            summary = self.door.summary()
            reps = summary.get("replicas") or [summary]
            for rep in reps:
                hbm = rep.get("hbm") if isinstance(rep, dict) else None
                if not isinstance(hbm, dict):
                    continue
                addable = hbm.get("slots_addable")
                if addable is not None:
                    return int(addable) >= self._capacity()
        except Exception:  # noqa: BLE001 — no signal = no ceiling
            return True
        return True

    # -- the decision loop -------------------------------------------------

    def tick(self) -> dict:
        """One observation + decision round (the thread's body; tests
        call it step by step). Returns the observation so chaos
        tests can assert on the exact signal a decision saw."""
        now = self._clock()
        dt = max(now - self._last_tick, 1e-6)
        self._last_tick = now
        obs = self._observe()
        # scale_flap (runtime/faults.py): replace the measured pressure
        # with a synthetic oscillation for exactly as many ticks as the
        # site is armed — the anti-flap bars count fires
        if FAULTS.triggered("scale_flap"):
            self._flap_phase = not self._flap_phase
            flap = 1.0 if self._flap_phase else 0.0
            obs = {g: (flap, n) for g, (n_p, n) in
                   zip(obs.keys(), obs.values())} or {"serve": (flap, 1)}
        finished = self._finished_total()
        drained = max(finished - self._finished_last, 0) / dt
        self._finished_last = finished
        queued = self._queued_total()
        serve_pressure = obs.get("serve", (0.0, 0))[0]
        if self.ladder is not None:
            rung = self.ladder.observe(serve_pressure, queued=queued,
                                       drained=drained)
            self._apply_degrade(rung)
        with self._lock:
            self.stats.ticks += 1
            self.stats.pressure = round(serve_pressure, 4)
            if self._backoff > 0:
                self._backoff -= 1
        if self._scalable():
            for group, (pressure, n) in obs.items():
                self._walk_scale(group, pressure, n)
        return {"obs": obs, "queued": queued, "drained": drained}

    def _apply_degrade(self, rung: int) -> None:
        """Rung >= no_spec turns per-slot drafting off on every LOCAL
        scheduler (thread replicas + the single supervisor; process
        workers keep their own worker-side AdmissionPolicy actuator —
        the parent's ladder acts at the door it owns). Re-applied every
        tick so a supervisor rebuild (fresh scheduler) re-learns the
        current rung within one poll."""
        degraded = self.ladder.spec_degraded if self.ladder else False
        with self._lock:
            self.stats.rung = self.ladder.rung if self.ladder else 0
        sups = ([h.sup for h in self._handles()
                 if getattr(h, "has_local_engine", True)
                 and h.sup is not None]
                or ([self.door] if not self._handles() else []))
        for sup in sups:
            try:
                sup._sched.spec_degraded = degraded
            except Exception:  # noqa: BLE001 — mid-rebuild: the fresh
                continue      # scheduler picks the rung up next tick

    def _scalable(self) -> bool:
        return (self.config.max_replicas > self.config.min_replicas
                or self.config.max_replicas > 1) \
            and getattr(self.door, "_spawn_factory", None) is not None

    def _tier_handles(self, group: str) -> list:
        return [h for h in self._handles()
                if self._serve_group(h) == group
                and not getattr(h, "reap", False)]

    def _walk_scale(self, group: str, pressure: float, n: int) -> None:
        cfg = self.config
        with self._lock:
            a = self.config.ewma_alpha
            prev = self._load_ewma.get(group, pressure)
            ewma = a * pressure + (1.0 - a) * prev
            self._load_ewma[group] = ewma
            cd = self._cooldown.get(group, 0)
            if cd > 0:
                self._cooldown[group] = cd - 1
                return
            if ewma > cfg.up_pressure:
                self._above[group] = self._above.get(group, 0) + 1
                self._idle[group] = 0
            elif ewma < cfg.down_pressure:
                self._idle[group] = self._idle.get(group, 0) + 1
                self._above[group] = 0
            else:
                self._above[group] = 0
                self._idle[group] = 0
            want_up = (self._above.get(group, 0) >= cfg.up_after
                       and self._backoff == 0)
            want_down = self._idle.get(group, 0) >= cfg.down_after
            pending = len(self._pending)
        # in-flight spawns count toward the ceiling: a spawn can take
        # minutes, and a second decision inside that window must not
        # double-mint the same replica id (or overshoot max_replicas)
        total = len([h for h in self._handles()
                     if not getattr(h, "reap", False)]) + pending
        if want_up:
            if total >= cfg.max_replicas:
                return
            if not self._hbm_headroom_ok():
                with self._lock:
                    self.stats.scale_blocked_hbm += 1
                return
            with self._lock:
                self._above[group] = 0
                self._cooldown[group] = cfg.cooldown_ticks
            self._scale_up(group, pressure)
        elif want_down:
            if total <= max(cfg.min_replicas, 1) or n <= 1:
                return
            with self._lock:
                self._idle[group] = 0
                self._cooldown[group] = cfg.cooldown_ticks
            self._scale_down(group, pressure)

    # -- scale-up ----------------------------------------------------------

    def _scale_up(self, group: str, pressure: float) -> None:
        router = self.door
        tier = "prefill" if group == "prefill" else "mixed"
        with self._lock:
            # reserve the id against concurrent/in-flight spawns: the
            # next decision sees it in _pending and mints rid + 1
            rid = max((h.id for h in self._handles()),
                      default=-1) + 1
            while rid in self._pending:
                rid += 1
            self._pending.add(rid)
            self.stats.target_replicas = (len(self._handles())
                                          + len(self._pending))
        router.scaling = "scaling_up"
        print(f"🧠 fleet: scale_up tier={tier} replica=r{rid} "
              f"pressure={pressure:.2f} "
              f"actual={len(self._handles())} "
              f"target={self.stats.target_replicas}", flush=True)
        t = threading.Thread(target=self._spawn_one, args=(rid, tier),
                             name=f"dllama-fleet-spawn-r{rid}",
                             daemon=True)
        self._scaling_threads.append(t)
        t.start()

    def _spawn_one(self, rid: int, tier: str) -> None:
        """Worker-thread body: build one replica handle (blocks on the
        spawn handshake + warmup — possibly minutes), enter it into
        rotation, warm its cache from siblings. A failure at ANY point
        folds into spawn_failures + backoff ticks — never a half-entered
        handle (the handle only joins ``router.replicas`` after its own
        constructor proved it routable-warm)."""
        router = self.door
        t0 = time.perf_counter()
        handle = None
        try:
            # slow-spawn chaos site: key-filtered so ONE scale-up can be
            # stalled deterministically while siblings spawn clean
            FAULTS.fire("spawn_stall", key=f"r{rid}")
            handle = router._spawn_factory(rid, tier)
            self._warm_from_siblings(handle)
            router.add_replica(handle)
            with self._lock:
                self.stats.scale_ups += 1
                self.stats.target_replicas = (len(self._handles())
                                              + len(self._pending) - 1)
            ms = (time.perf_counter() - t0) * 1e3
            if TRACER.enabled:
                TRACER.event("scale_up", 0, replica=rid, tier=tier,
                             ms=round(ms, 1))
            print(f"🧠 fleet: scale_up DONE replica=r{rid} tier={tier} "
                  f"ms={ms:.0f}", flush=True)
        except Exception as e:  # noqa: BLE001 — spawn died (or the entry
            # was refused): count + back off, and CLOSE a built handle —
            # a live worker process must never outlive a failed entry
            if handle is not None:
                try:
                    handle.close()
                except Exception:  # noqa: BLE001
                    pass
            with self._lock:
                self.stats.spawn_failures += 1
                self._backoff = self.config.spawn_backoff_ticks
            print(f"🧠 fleet: scale_up FAILED replica=r{rid} ({e}) — "
                  f"backing off {self.config.spawn_backoff_ticks} ticks",
                  flush=True)
        finally:
            with self._lock:
                self._pending.discard(rid)
            router.scaling = None

    def _warm_from_siblings(self, handle) -> None:
        """KV-fill cache warmup for a fresh replica: replay the router's
        recent prompts as max_tokens=0 prefills, each with a fill from
        the warmest sibling — the new cache seeds from donors instead
        of starting cold. Best-effort by design: every failure shape
        degrades to a cold start, never an error (the handle is already
        COMPILE-warm from its own constructor)."""
        router = self.door
        if not getattr(router, "_kv_transfer", False):
            return
        prompts = list(getattr(router, "_recent_prompts", ()) or ())
        if not prompts:
            return
        from ..sampler import Sampler

        filled = 0
        for prompt in prompts[-self.config.warm_prompts:]:
            try:
                donor = router._pick_donor(handle, prompt)
                if donor is None:
                    continue
                dh, dn = donor
                fill = None
                if hasattr(handle, "client") and hasattr(dh, "client"):
                    addr = dh.client.addr
                    fill = (addr[0], addr[1], dn, dh.id)
                elif not hasattr(handle, "client") \
                        and not hasattr(dh, "client"):
                    from .kv_transfer import local_fill

                    local_fill(dh.sup, handle.sup, prompt,
                               stats=getattr(router, "kvx", None))
                    handle.note_routed(prompt)
                    filled += 1
                    continue
                vocab = max(int(max(prompt)) + 1, 2)
                sampler = Sampler(vocab, temperature=0.0, topp=1.0, seed=1)
                inner = handle.sup.submit(prompt, 0, sampler, fill=fill)
                for _ in inner.tokens(timeout=30.0):
                    pass
                handle.note_routed(prompt)
                filled += 1
            except Exception:  # noqa: BLE001 — cold start, not an error
                continue
        with self._lock:
            self.stats.warm_fills += filled

    # -- scale-down --------------------------------------------------------

    def _scale_down(self, group: str, pressure: float) -> None:
        """Reap the highest-id idle replica of the group: mark it
        ``reap`` FIRST (readiness and state reporting exclude it from
        that moment — satellite: a draining-for-reap replica must not
        flip fleet readiness), drain it, close it (retiring its monitor
        so a respawn can never resurrect it — the close-before-remove
        ordering RemoteReplicaHandle.close guarantees), then drop it
        from rotation."""
        router = self.door
        victims = sorted(self._tier_handles(group), key=lambda h: -h.id)
        victim = None
        for h in victims:
            try:
                if not h.draining and h.load() == 0:
                    victim = h
                    break
            except Exception:  # noqa: BLE001
                continue
        if victim is None or len(self._tier_handles(group)) <= 1:
            return
        with self._lock:
            self.stats.target_replicas = len(self._handles()) - 1
        victim.reap = True
        router.scaling = "scaling_down"
        print(f"🧠 fleet: scale_down tier={group} replica=r{victim.id} "
              f"pressure={pressure:.2f} "
              f"target={self.stats.target_replicas}", flush=True)
        t = threading.Thread(target=self._reap_one, args=(victim,),
                             name=f"dllama-fleet-reap-r{victim.id}",
                             daemon=True)
        self._scaling_threads.append(t)
        t.start()

    def _reap_one(self, victim) -> None:
        router = self.door
        t0 = time.perf_counter()
        try:
            victim.drain(timeout=30.0)
            router.reap_replica(victim.id)
            with self._lock:
                self.stats.scale_downs += 1
            if TRACER.enabled:
                TRACER.event("scale_down", 0, replica=victim.id,
                             ms=round((time.perf_counter() - t0) * 1e3, 1))
            print(f"🧠 fleet: scale_down DONE replica=r{victim.id}",
                  flush=True)
        except Exception:  # noqa: BLE001 — victim died mid-drain: its
            # monitor (already told to close via reap_replica next tick)
            # or the next tick's walk owns the retry
            victim.reap = False
        finally:
            router.scaling = None

    # -- observability -----------------------------------------------------

    def summary(self) -> dict:
        out = self.stats.summary()
        handles = self._handles()
        out["actual_replicas"] = (len([h for h in handles
                                       if not getattr(h, "reap", False)])
                                  if handles else 1)
        if out.get("target_replicas", 0) == 0:
            out["target_replicas"] = out["actual_replicas"]
        out["min_replicas"] = self.config.min_replicas
        out["max_replicas"] = self.config.max_replicas
        out["autoscaling"] = self._scalable()
        if self.ladder is not None:
            out["ladder"] = self.ladder.summary()
        if self.ledger is not None:
            out["tenants"] = self.ledger.summary()
        return out
