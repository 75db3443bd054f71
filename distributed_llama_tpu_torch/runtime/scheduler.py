"""Continuous batching: a slot-based KV scheduler over the batch-B Engine —
the port of the JAX package's runtime/scheduler.py (its core: submit, the
scheduling iteration, warmup, the step thread, close, exclusive, the radix
prefix cache's admission seed and publish, and per-slot draft speculation).

Iteration-level scheduling in the Orca style (Yu et al., OSDI '22) with
slot-reuse KV management: the KV cache is ONE batch-B allocation whose rows
("slots") are leased to requests; requests join and leave the running
decode batch every step, through two engine calls:

  * ``Engine.slot_prefill_chunk`` — a (B, C) segment writing each
    prefilling row's chunk at its own offset (tail chunks pad to C), run
    eagerly;
  * ``Engine.slot_decode_step`` — a (B, 1) step at per-row positions, on
    the card one captured CUDA graph (captured in ``warmup``).

Rows not in a call are gated off by position == S: their writes go to the
cache's spare row and their logits are never read. A finished row's slot
goes to the next queued request at once (no zeroing: the new request
writes each position before any of its queries attends it).

Each iteration runs at most ONE prefill chunk and ONE decode step, so an
admitted prompt adds at most one chunk to the in-flight requests' token
gap. Each request samples with its own host Sampler (its xorshift stream
is the slot's RNG state), so greedy requests yield exactly the tokens of a
sequential ``Engine.generate`` where the arithmetic is the same (f32 on the
CPU: tests/test_torch_scheduler.py).

Cross-request KV reuse: with a ``runtime/prefix_cache.PrefixCache``
attached, ``_admit`` looks up the longest cached token prefix, seeds the
slot's cache row from arena blocks (``Engine.slot_seed_prefix``, eager
copies on the default stream between the graph's replays) and prefills
only the suffix; a slot publishes its PROMPT's K/V back into the tree when
the prompt finishes prefilling (prefill-written blocks only: decode-step
K/V is not guaranteed bitwise-equal to a cold prefill's). The matched path
stays pinned for the slot's lifetime, so eviction never frees a block an
in-flight slot came from, and ``_abort_all`` invalidates the whole tree
(the arena dies with the engine).

Per-slot draft speculation: with a ``draft_factory`` (runtime/draft.py) the
scheduler builds one DraftModel over its engine, whose cache holds the
draft K/V of every slot. A decode iteration with a greedy row that can
speculate runs ONE draft proposal (``DraftModel.propose``: draft_len greedy
draft steps for every speculating row) and ONE fixed-width verify forward
(``Engine.slot_verify_step``, (B, 1 + draft_len) tokens, one captured
graph): each speculating row emits its accepted draft prefix plus one token,
exactly the tokens of a plain greedy decode; sampled rows ride the same
forward and sample from its position-0 logits. A row's draft frontier
(``draft_pos``) trails what the target wrote after admission (the whole
prompt, prefix-cache seeded or not) and after plain rounds; one batched
draft catch-up chunk an iteration prefills it from the row's fed tokens.
``warmup`` runs the draft's prefill, proposal and the verify once with every
row gated, so speculative serving captures no graph after it.

Over tp ranks (parallel/control.py) the scheduler lives on rank 0: every
engine and draft call above is an op that the other ranks run after it,
in its order; the radix tree, the samplers and the requests stay here.
A vocab-sharded engine's rows sample from the argmax and candidate
summary (Engine.sample_view, each row at its own temperature), a row the
candidates cannot prove fetching its whole logits through one more op.

Flight recorder (runtime/trace.py): with ``TRACER`` on, ``submit`` mints
one trace id a request and each request's span records ``enqueue``,
``admit``, ``seed``, ``prefill`` (a chunk), ``first_token``, ``decode``
(every ``decode_every``-th token), ``spec`` and ``finish`` or ``error``;
every working iteration records a ``step`` (its composition and wall ms),
all on the host between launches. Off, each site costs one attribute
read. With ``PROFILER.sample_every`` set, every Nth working step times its
entry points on the card (runtime/profiler.py).

Thread model: ``submit()`` is thread-safe and never takes the step mutex;
the step loop runs on the ``start()`` thread, the supervisor's thread
(runtime/resilience.py) or synchronously through ``step()``. Every thread
issues its CUDA work on the default stream, so a capture, its replays and
the host copies between them are ordered on one stream. HTTP handler
threads touch host tokens only.

SLO-aware admission (either ``slo_ttft_ms`` or ``slo_itl_ms`` arms it):
``AdmissionPolicy`` walks a fixed ladder of chunk widths
(``chunk_ladder``: C, C/2, C/4, C/8) one rung at a time off the live step
wall, and turns speculation off while the ITL EWMA endangers the SLO.
``warmup()`` runs every rung, so an adaptive run captures no graph after
warmup.

Not ported: the weighted-fair queue and the KV-transfer methods (the
lock-free ``kv_match_len`` peek excepted); the constructor refuses them.
"""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from collections import deque
from typing import Iterator

import numpy as np

from .faults import FAULTS
from .profiler import PROFILER
from .sampling import FullLogitsView
from .speculative import count_accepted
from .stats import RequestStats, ServeStats, SpecStats
from .trace import TRACER

# constructor options of the JAX Scheduler that the port does not have yet,
# with the ROADMAP item that brings each
UNPORTED = {
    "fair_queue": "the weighted-fair queue (ROADMAP item 16)",
    "fault_key": "replica fault keys (ROADMAP item 16)",
}


class PromptTooLong(ValueError):
    """Prompt does not fit the engine's context window."""


class QueueFull(RuntimeError):
    """Admission refused: the request queue is at its bound. Overload
    surfaces as a fast structured rejection (HTTP 429 with Retry-After),
    never as unbounded queue latency."""

    def __init__(self, depth: int, bound: int, retry_after: float = 1.0):
        super().__init__(f"queue full ({depth} waiting, bound {bound})")
        self.retry_after = retry_after


class SchedulerClosed(RuntimeError):
    """Submission after close(): no step loop would serve it."""


class RequestError(RuntimeError):
    """Structured terminal failure of one request: a machine-readable
    ``code`` and whether a retry is expected to succeed (``retryable``).
    Raised out of ``ServeRequest.tokens()``."""

    def __init__(self, code: str, message: str, retryable: bool = True):
        super().__init__(message)
        self.code = code
        self.retryable = retryable

    def frame(self) -> dict:
        return {"code": self.code, "message": str(self),
                "retryable": self.retryable}


class ServeRequest:
    """One submitted generation request and its event stream: the
    scheduler pushes ``("token", id)`` events, then exactly one terminal
    event, ``("done", reason)`` (reason "stop", "length" or "cancelled")
    or ``("error", frame)``. ``tokens()`` iterates the stream; ``cancel()``
    retires the request at the next iteration."""

    def __init__(self, rid: int, prompt: list[int], max_tokens: int,
                 sampler, stop_ids: set[int],
                 deadline: float | None = None, trace_id: int = 0):
        self.id = rid
        # flight-recorder span id (runtime/trace.py), minted once a
        # request at the scheduler door; 0 = untraced
        self.trace_id = trace_id
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.sampler = sampler
        self.stop_ids = stop_ids
        # absolute time.perf_counter() bound: past it the request fails
        # with a structured "deadline" frame, queued or mid-decode
        self.deadline = deadline
        self.events: _queue.Queue = _queue.Queue()
        self.finished = threading.Event()
        self.finish_reason: str | None = None
        self.stats = RequestStats(n_prompt=len(prompt))
        self._cancelled = False
        self._terminal_lock = threading.Lock()
        self._terminal = False

    def _claim_terminal(self) -> bool:
        """Exactly-once guard for the terminal event: of concurrent
        failure paths, only the first claim delivers and counts."""
        with self._terminal_lock:
            if self._terminal:
                return False
            self._terminal = True
            return True

    def cancel(self) -> None:
        self._cancelled = True

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def tokens(self, timeout: float = 600.0) -> Iterator[int]:
        """Yield token ids until the terminal event; `timeout` bounds the
        wait for each event. Error frames raise ``RequestError``."""
        while True:
            kind, val = self.events.get(timeout=timeout)
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise RequestError(val.get("code", "error"),
                                   val.get("message", "scheduler error"),
                                   val.get("retryable", True))


# AdmissionPolicy's constants (the JAX package's defaults): the newest
# sample's EWMA weight, and the shares of the ITL SLO above which the
# policy shrinks (and turns speculation off) and under which it widens
# (and turns it back on)
EWMA_ALPHA = 0.25
SHRINK_FRAC = 0.85
WIDEN_FRAC = 0.5


def chunk_ladder(chunk: int, rungs: int = 4) -> list[int]:
    """The admission policy's fixed menu of chunk widths: descending
    halvings of the configured width, at most `rungs` entries, floor 1. A
    ladder (not a continuum) keeps the set of prefill shapes bounded and
    known up front: ``Scheduler.warmup()`` runs every rung, so an adaptive
    run captures nothing after warmup and ``--freeze-compiles`` holds
    while the width moves (JAX runtime/scheduler.py:187)."""
    ladder = [int(chunk)]
    while len(ladder) < rungs and ladder[-1] > 1:
        ladder.append(max(ladder[-1] // 2, 1))
    return ladder


class AdmissionPolicy:
    """SLO-aware admission (JAX runtime/scheduler.py:201): trade each
    iteration's chunked-prefill width against decode occupancy off the
    live step timeline, on the host only.

    An iteration with prefill and decode rows costs one (B, C) chunk
    forward plus one (B, 1) decode step, and every decoding row's token
    gap IS that iteration's wall: wide chunks finish prompts in few
    iterations (good TTFT) but stretch every running stream's gap (bad
    ITL). The policy walks ``chunk_ladder`` one rung at a time:

      * SHRINK one rung when decoding rows saw prefill interference and
        the ITL EWMA is above ``SHRINK_FRAC`` of ``slo_itl_ms``;
      * WIDEN one rung when decode rows are idle, when the ITL EWMA is
        under ``WIDEN_FRAC`` of the SLO, or when the TTFT EWMA endangers
        ``slo_ttft_ms`` while ITL has headroom.

    ``cooldown`` observed steps separate transitions. The "no
    speculation" actuator (``spec_allowed``) turns drafting off when the
    ITL EWMA passes ``SHRINK_FRAC`` of the SLO (a verify forward is wider
    than a decode step) and back on under ``WIDEN_FRAC``, independently
    of the width's cooldown. Exported as the ``admission`` /stats block
    and the ``dllama_admission_*`` /metrics family."""

    def __init__(self, chunk: int, *, slo_ttft_ms: float | None = None,
                 slo_itl_ms: float | None = None, cooldown: int = 2):
        if not (slo_ttft_ms or slo_itl_ms):
            raise ValueError("an SLO-less policy has no goal")
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_itl_ms = slo_itl_ms
        self.ladder = chunk_ladder(chunk)
        self._rung = 0              # index into ladder; 0 = widest
        self.cooldown = int(cooldown)
        self._since_change = self.cooldown  # first decision is eligible
        self.itl_ewma_ms: float | None = None
        self.ttft_ewma_ms: float | None = None
        self.shrinks = 0
        self.widens = 0
        self.spec_on = True
        self.spec_disables = 0
        self.spec_enables = 0

    @property
    def spec_allowed(self) -> bool:
        """Whether the scheduler may run speculative verify steps this
        iteration."""
        return self.spec_on

    @property
    def width(self) -> int:
        return self.ladder[self._rung]

    def _mix(self, prev: float | None, sample: float) -> float:
        return sample if prev is None else (
            EWMA_ALPHA * sample + (1.0 - EWMA_ALPHA) * prev)

    def observe_ttft(self, ttft_ms: float) -> None:
        self.ttft_ewma_ms = self._mix(self.ttft_ewma_ms, float(ttft_ms))

    def observe_step(self, wall_ms: float, decode_rows: int,
                     prefill_rows: int) -> None:
        """One working iteration's composition and wall ms, after its
        forwards ran. A step with decode rows is their token gap."""
        if decode_rows:
            self.itl_ewma_ms = self._mix(self.itl_ewma_ms, float(wall_ms))
        # the speculation actuator first: it does not wait out the
        # width's cooldown
        if self.slo_itl_ms and self.itl_ewma_ms is not None:
            if (self.spec_on
                    and self.itl_ewma_ms > SHRINK_FRAC * self.slo_itl_ms):
                self.spec_on = False
                self.spec_disables += 1
            elif (not self.spec_on
                  and self.itl_ewma_ms < WIDEN_FRAC * self.slo_itl_ms):
                self.spec_on = True
                self.spec_enables += 1
        self._since_change += 1
        if self._since_change < self.cooldown:
            return
        itl, slo_i = self.itl_ewma_ms, self.slo_itl_ms
        ttft, slo_t = self.ttft_ewma_ms, self.slo_ttft_ms
        if (slo_i and decode_rows and prefill_rows and itl is not None
                and itl > SHRINK_FRAC * slo_i):
            if self._rung + 1 < len(self.ladder):
                self._rung += 1
                self.shrinks += 1
                self._since_change = 0
            return
        comfortable = (slo_i is not None and itl is not None
                       and itl < WIDEN_FRAC * slo_i)
        ttft_pressure = (slo_t is not None and ttft is not None
                         and ttft > SHRINK_FRAC * slo_t
                         and (slo_i is None or itl is None
                              or itl < SHRINK_FRAC * slo_i))
        if ((decode_rows == 0 or comfortable or ttft_pressure)
                and self._rung > 0):
            self._rung -= 1
            self.widens += 1
            self._since_change = 0

    def summary(self) -> dict:
        rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
        return {
            "slo_ttft_ms": self.slo_ttft_ms,
            "slo_itl_ms": self.slo_itl_ms,
            "chunk_width": self.width,
            "chunk_ladder": list(self.ladder),
            "itl_ewma_ms": rnd(self.itl_ewma_ms),
            "ttft_ewma_ms": rnd(self.ttft_ewma_ms),
            "shrinks": self.shrinks,
            "widens": self.widens,
            "spec_allowed": self.spec_on,
            "spec_disables": self.spec_disables,
            "spec_enables": self.spec_enables,
        }


class _Slot:
    """One row of the batched KV cache: FREE when req is None, PREFILL
    while off < len(prompt), DECODE after. `pos` is the next cache write
    position, `last` the token to feed next step, `pins` the prefix-cache
    path the slot was seeded from (held until the slot releases). With a
    draft armed, `draft_pos` is the row's draft-cache frontier (positions
    below it hold the fed tokens' draft K/V) and `toks` the fed-token
    history the draft catch-up reads (prompt + emitted tokens)."""

    __slots__ = ("idx", "req", "pos", "off", "n_out", "last", "pins",
                 "draft_pos", "toks")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: ServeRequest | None = None
        self.pos = 0
        self.off = 0
        self.n_out = 0
        self.last = 0
        self.pins: tuple = ()
        self.draft_pos = 0
        self.toks: list[int] = []


class Scheduler:
    def __init__(self, engine, *, chunk: int | None = None,
                 max_queue: int = 0, queue_timeout: float | None = None,
                 request_deadline: float | None = None, prefix_cache=None,
                 slo_ttft_ms: float | None = None,
                 slo_itl_ms: float | None = None,
                 draft_factory=None, draft_len: int = 0,
                 draft_vocab: int | None = None, **unported):
        asked = {k: v for k, v in unported.items() if v}
        unknown = set(asked) - set(UNPORTED)
        if unknown:
            raise TypeError(f"Scheduler got unexpected options {sorted(unknown)}")
        if asked:
            raise ValueError("not ported yet: " + "; ".join(
                f"{k} ({UNPORTED[k]})" for k in sorted(asked)))
        self.engine = engine
        self.chunk = int(chunk or min(engine.prefill_chunk, engine.seq_len))
        if not 1 <= self.chunk <= engine.seq_len:
            raise ValueError(f"chunk {self.chunk} outside 1..{engine.seq_len}")
        # SLO-aware admission (either SLO arms it): the policy walks the
        # chunk-width ladder off the live step wall; `chunk` stays the
        # widest rung, and the only width without an SLO
        self.admission = (AdmissionPolicy(self.chunk,
                                          slo_ttft_ms=slo_ttft_ms,
                                          slo_itl_ms=slo_itl_ms)
                          if (slo_ttft_ms or slo_itl_ms) else None)
        self.slots = [_Slot(i) for i in range(engine.batch)]
        # radix prefix cache over THIS engine's arena (a supervisor rebuild
        # passes a fresh one); None = reuse off
        if prefix_cache is not None and prefix_cache.engine is not engine:
            raise ValueError("prefix cache arena belongs to a different engine")
        self.prefix_cache = prefix_cache
        # per-slot draft speculation: the factory builds a DraftModel over
        # THIS engine (a supervisor rebuild passes a fresh engine: the
        # draft's params are its tensors and die with it); its one
        # batched cache serves every slot, the frontiers live on the slots
        self.draft = draft_factory(engine) if draft_factory else None
        self.draft_len = int(draft_len) if self.draft is not None else 0
        if self.draft is not None and self.draft_len < 1:
            raise ValueError("a draft without a draft length proposes nothing")
        # the verify's device argmax runs over the TOKENIZER's vocab (the
        # host Sampler truncates there); requests whose sampler vocab
        # differs never speculate
        self.draft_vocab = int(draft_vocab or engine.spec.vocab_size)
        self.draft_cache = (self.draft.new_cache()
                            if self.draft is not None else None)
        # admission control: max_queue bounds the waiting line (0 = no
        # bound), queue_timeout how long a request may WAIT before it is
        # failed rather than started, request_deadline the default
        # end-to-end budget applied at submit
        self.max_queue = int(max_queue)
        self.queue_timeout = queue_timeout
        self.request_deadline = request_deadline
        # deque.append/popleft are atomic under the GIL, so submit() never
        # waits for the step mutex (an in-flight forward)
        self._queue: deque = deque()
        self._mutex = threading.RLock()  # step()/exclusive() mutual excl.
        self._wake = threading.Event()
        self.stats = ServeStats()
        if prefix_cache is not None:
            self.stats.prefix = prefix_cache.stats
        self.stats.admission = self.admission  # None without an SLO
        # always attached (mode "off" without a draft): a tier never loses
        # the spec family to a launch flag
        self._spec_stats = SpecStats(
            mode=(self.draft.label if self.draft is not None else "off"),
            draft_len=self.draft_len)
        self.stats.spec = self._spec_stats
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False
        # watchdog heartbeat: perf_counter when the current step body
        # entered, None between steps. Written by the stepping thread,
        # read lock-free by the supervisor's watchdog
        self._step_t0: float | None = None
        self._rid = 0  # guarded by self._rid_lock
        self._rid_lock = threading.Lock()

    # -- submission --------------------------------------------------------

    def submit(self, prompt: list[int], max_tokens: int, sampler,
               eos_id: int | set[int] | None = None,
               deadline: float | None = None,
               trace_id: int | None = None) -> ServeRequest:
        """Enqueue a request; it joins the running batch when a slot frees.
        `sampler` is the request's own (its RNG stream is the slot's
        sampling state). max_tokens <= 0 prefills and emits nothing.
        Raises PromptTooLong when the prompt cannot fit the context,
        QueueFull at the queue bound, SchedulerClosed after close().
        `deadline` is an absolute perf_counter bound (default: now +
        request_deadline when configured). `trace_id` defaults to a fresh
        id with tracing on (the scheduler door is the front door)."""
        if self._closed:
            raise SchedulerClosed("scheduler is closed")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.engine.seq_len:
            raise PromptTooLong(
                f"prompt is {len(prompt)} tokens; context is "
                f"{self.engine.seq_len}")
        if self.max_queue and len(self._queue) >= self.max_queue:
            with self._rid_lock:
                self.stats.requests_rejected += 1
            raise QueueFull(len(self._queue), self.max_queue)
        stop_ids = ({eos_id} if isinstance(eos_id, int)
                    else set(eos_id or ()))
        now = time.perf_counter()
        if deadline is None and self.request_deadline is not None:
            deadline = now + self.request_deadline
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        if trace_id is None:
            trace_id = TRACER.new_id() if TRACER.enabled else 0
        req = ServeRequest(rid, prompt, max_tokens, sampler, stop_ids,
                           deadline=deadline, trace_id=trace_id)
        req.stats.t_submit = now
        if TRACER.enabled:
            TRACER.event("enqueue", trace_id, rid=rid,
                         n_prompt=len(prompt), max_tokens=max_tokens,
                         key=None)
        with self._rid_lock:
            self.stats.requests_submitted += 1
        self.stats.requests.append(req.stats)
        self._queue.append(req)
        self._wake.set()
        if self._closed:
            # close() ran between the entry check and the append: its
            # abort may already have drained the queue — fail it here
            # (if the abort did see it, this claim loses)
            self._fail_req(req, {"code": "shutdown",
                                 "message": "scheduler shutdown",
                                 "retryable": False})
        return req

    # -- the scheduling iteration -----------------------------------------

    def step(self) -> bool:
        """One scheduling iteration: admit queued requests into free slots,
        run one prefill chunk for prefilling rows and one decode step for
        decoding rows. Returns False when there was no work."""
        with self._mutex:
            return self._step_locked()

    def has_work(self) -> bool:
        with self._mutex:
            return bool(self._queue) or any(s.req is not None
                                            for s in self.slots)

    def _step_locked(self) -> bool:
        prof = None
        if PROFILER.sample_every and (
                self._queue or any(s.req is not None for s in self.slots)):
            prof = PROFILER.step_begin()
        self._step_t0 = time.perf_counter()  # watchdog heartbeat: in-step
        try:
            return self._step_body()
        finally:
            wall_ms = (time.perf_counter() - self._step_t0) * 1e3
            self._step_t0 = None
            if prof is not None:
                PROFILER.step_end(prof, wall_ms)

    def _step_body(self) -> bool:
        if not self._queue and all(s.req is None for s in self.slots):
            # idle: no fault site fires (an armed fault lands on a
            # working step)
            return False
        # fault sites: no-ops unless armed, before any device launch
        FAULTS.fire("step_raise")
        FAULTS.fire("step_stall")
        FAULTS.fire("slow_step")
        now = time.perf_counter()
        # reap cancellations and expired deadlines first, so a dead
        # client's request never costs another forward
        for s in self.slots:
            if s.req is None:
                continue
            if s.req._cancelled:
                self._finish_slot(s, "cancelled")
            elif s.req.expired(now):
                req, s.req = s.req, None
                self._release_slot_cache(s, req)
                self._expire_req(req)
        self._admit()
        pre = [s for s in self.slots
               if s.req is not None and s.off < len(s.req.prompt)]
        dec = [s for s in self.slots
               if s.req is not None and s.off >= len(s.req.prompt)]
        if not pre and not dec:
            return False
        self.stats.steps += 1
        self.stats.occupancy.append(len(pre) + len(dec))
        self.stats.queue_depth.append(len(self._queue))
        # this iteration's chunk width: the policy's current rung, or the
        # one configured width without an SLO
        cw = (self.admission.width if self.admission is not None
              else self.chunk) if pre else 0
        if pre:
            self._prefill_chunk(pre, cw)
        # the policy's "no speculation" actuator gates every draft
        # launch: while the ITL EWMA endangers the SLO, decode rows take
        # plain (B, 1) steps
        spec_ok = self.draft is not None and (
            self.admission is None or self.admission.spec_allowed)
        if self.draft is not None and dec and not spec_ok:
            self._spec_stats.degraded_steps += 1
        if spec_ok:
            # one draft catch-up chunk an iteration: rows whose draft
            # frontier trails the target (fresh admissions, prefix-seeded
            # prompts, plain rounds) advance by up to one chunk
            self._draft_catchup_chunk()
        if dec:
            # rows that finished their prompt in this iteration's chunk
            # wait for the next one: one decode forward a row an iteration
            if spec_ok and any(self._spec_capable(s) for s in dec):
                self._decode_spec(dec)
            else:
                self._decode(dec)
        if TRACER.enabled:
            # the step timeline: composition and wall ms from the
            # watchdog heartbeat's t0
            TRACER.step(decode_rows=len(dec), prefill_rows=len(pre),
                        chunk=cw, queue_depth=len(self._queue),
                        wall_ms=(time.perf_counter() - self._step_t0) * 1e3,
                        key=None)
        if self.admission is not None:
            # the wall the timeline records is the policy's signal; it
            # sets the NEXT iteration's width
            self.admission.observe_step(
                (time.perf_counter() - self._step_t0) * 1e3,
                len(dec), len(pre))
        return True

    def _expire_req(self, req: ServeRequest, code: str = "deadline",
                    message: str = "request deadline exceeded") -> None:
        """Fail one request with a structured expiry frame."""
        if self._fail_req(req, {"code": code, "message": message,
                                "retryable": code != "deadline"}):
            self.stats.requests_expired += 1

    def _admit(self) -> None:
        now = time.perf_counter()
        free = [s for s in self.slots if s.req is None]
        while free and self._queue:
            req = self._queue.popleft()
            if req._cancelled:
                self._finish_req(req, "cancelled")
                continue
            if req.expired(now):
                self._expire_req(req)
                continue
            if (self.queue_timeout is not None
                    and now - req.stats.t_submit > self.queue_timeout):
                self._expire_req(req, code="queue_timeout",
                                 message="queue-time budget exceeded")
                continue
            s = free.pop(0)
            s.req = req
            s.off = s.pos = s.n_out = s.last = 0
            s.pins = ()
            # the draft state resets with the lease: the new request's
            # draft prefill overwrites the predecessor's draft K/V before
            # the draft attends it, as in the main cache
            s.draft_pos = 0
            s.toks = list(req.prompt)
            if TRACER.enabled:
                TRACER.event("admit", req.trace_id, slot=s.idx,
                             queue_ms=round(
                                 (now - req.stats.t_submit) * 1e3, 3),
                             key=None)
            if self.prefix_cache is not None:
                # seed the longest cached prefix (whole blocks, capped at
                # len - 1) and prefill only the suffix; the path stays
                # pinned until the slot releases. tokens_prefilled counts
                # per dispatched chunk, in _prefill_chunk
                n, ids, pins = self.prefix_cache.lookup_pin(req.prompt)
                if n > 0:
                    self.prefix_cache.seed_slot(s.idx, ids)
                    s.off = n
                    s.pins = pins
                if TRACER.enabled:
                    # a miss (hit=0) is timeline information too
                    TRACER.event("seed", req.trace_id, hit=n,
                                 n_prompt=len(req.prompt))

    def _sample_view(self, logits, rows: list[_Slot]):
        """Wrap one forward's logits for host sampling (JAX
        scheduler.py:744, Engine.sample_view): a vocab-sharded engine
        serves the rows from the argmax and candidate summary instead of
        a (B, vocab) fetch, at each sampling row's own temperature (a
        greedy row passes 1); a replicated engine (or a duck-typed test
        engine) gives the full-logits view."""
        eng = self.engine
        sv = getattr(eng, "sample_view", None)
        if sv is None:
            return FullLogitsView(eng.fetch_logits(logits))
        temps = np.ones((eng.batch,), np.float32)
        for s in rows:
            t = getattr(s.req.sampler, "temperature", 0.0)
            if t:
                temps[s.idx] = t
        return sv(logits, temps, self.draft_vocab)

    def _prefill_chunk(self, rows: list[_Slot], width: int) -> None:
        eng = self.engine
        b, c = eng.batch, width
        tok = np.zeros((b, c), np.int32)
        pos = np.full((b,), eng.seq_len, np.int32)  # gated rows: dropped
        lidx = np.zeros((b,), np.int32)
        finishing = []
        for s in rows:
            n = min(c, len(s.req.prompt) - s.off)
            tok[s.idx, :n] = s.req.prompt[s.off:s.off + n]
            if self.prefix_cache is not None:
                # real (not pad) tokens this forward prefills
                self.prefix_cache.stats.tokens_prefilled += n
            # tail padding (token 0) writes beyond the prompt; decode
            # overwrites them before any later query attends them
            pos[s.idx] = s.off
            lidx[s.idx] = n - 1
            if TRACER.enabled:
                TRACER.event("prefill", s.req.trace_id, off=s.off, n=n,
                             slot=s.idx)
            s.off += n
            if s.off == len(s.req.prompt):
                finishing.append(s)
        logits = eng.slot_prefill_chunk(tok, pos, lidx)
        if not finishing:
            return  # mid-prompt chunk: no logits to the host
        view = self._sample_view(logits, finishing)
        for s in finishing:
            s.pos = len(s.req.prompt)
            if self.prefix_cache is not None:
                # publish the prompt's blocks the moment they are all
                # written, not at slot finish, so requests sharing the
                # prefix hit while this one still decodes
                self.prefix_cache.publish(s.idx, s.req.prompt)
            if s.req.max_tokens <= 0:
                # the hard-cap contract of Engine.generate
                self._finish_slot(s, "length")
                continue
            self._emit(s, view.sample(s.req.sampler, s.idx))

    def _decode(self, rows: list[_Slot]) -> None:
        eng = self.engine
        tok = np.zeros((eng.batch, 1), np.int32)
        pos = np.full((eng.batch,), eng.seq_len, np.int32)
        for s in rows:
            tok[s.idx, 0] = s.last
            pos[s.idx] = s.pos
        view = self._sample_view(eng.slot_decode_step(tok, pos), rows)
        for s in rows:
            s.pos += 1
            self._emit(s, view.sample(s.req.sampler, s.idx))

    # -- per-slot draft speculation (runtime/draft.py) ---------------------

    def _speculates(self, req: ServeRequest) -> bool:
        """A greedy request at the verify's vocab: its tokens are the
        verify's device argmax."""
        smp = req.sampler
        return (getattr(smp, "temperature", None) == 0.0
                and getattr(smp, "vocab_size", 0) == self.draft_vocab)

    def _spec_capable(self, s: _Slot) -> bool:
        """Whether slot s rides a speculative verify this iteration: a
        speculating request, its draft caught up to the target, and at
        least 2 tokens of budget and of context left (a draft for one
        remaining token buys nothing)."""
        req = s.req
        return (self._speculates(req)
                and s.draft_pos >= s.pos
                and req.max_tokens - s.n_out >= 2
                and self.engine.seq_len - s.pos >= 2)

    def _draft_catchup_chunk(self) -> None:
        """One batched (B, C) draft prefill chunk for every slot whose
        draft frontier trails what the target wrote, from its fed-token
        history `s.toks` (the last emitted token is never fed, there or
        here). A prefix-cache seed fills the target's cache, not the
        draft's, so a seeded prompt is prefilled here from its tokens.
        Rows that never speculate get no draft K/V."""
        eng, c = self.engine, self.chunk
        rows = []
        for s in self.slots:
            if s.req is None or not self._speculates(s.req):
                continue
            avail = min(len(s.toks), max(s.off, s.pos))
            if s.draft_pos < avail:
                rows.append((s, avail))
        if not rows:
            return
        tok = np.zeros((eng.batch, c), np.int32)
        pos = np.full((eng.batch,), eng.seq_len, np.int32)
        for s, avail in rows:
            n = min(c, avail - s.draft_pos)
            tok[s.idx, :n] = s.toks[s.draft_pos:s.draft_pos + n]
            pos[s.idx] = s.draft_pos
            s.draft_pos += n
        self.draft_cache = self.draft.prefill_chunk(self.draft_cache, tok, pos)
        self._spec_stats.draft_forwards += 1

    def _decode_spec(self, rows: list[_Slot]) -> None:
        """The speculative decode iteration (JAX scheduler.py:880): ONE
        draft proposal of draft_len tokens for every speculating row, ONE
        fixed-width verify forward; each speculating row advances by its
        accepted prefix plus one token, the target's own argmax.
        Non-speculating rows (sampled, another vocab, draft catching up)
        ride the same forward with their segment padded by their own
        token and sample from the position-0 logits."""
        eng, k = self.engine, self.draft_len
        spec_rows = [s for s in rows if self._spec_capable(s)]
        dtok = np.zeros((eng.batch,), np.int32)
        dpos = np.full((eng.batch,), eng.seq_len, np.int32)  # gated rows
        for s in spec_rows:
            dtok[s.idx] = s.last
            dpos[s.idx] = s.pos
        drafts_np, self.draft_cache = self.draft.propose(
            self.draft_cache, dtok, dpos, k, n_vocab=self.draft_vocab)
        self._spec_stats.draft_forwards += 1
        tok = np.zeros((eng.batch, 1 + k), np.int32)
        pos = np.full((eng.batch,), eng.seq_len, np.int32)
        drafts: dict[int, list[int]] = {}
        for s in rows:
            # pad = the row's own token: its writes sit past the accepted
            # prefix and are overwritten before any query attends them
            tok[s.idx, :] = s.last
            pos[s.idx] = s.pos
        for s in spec_rows:
            # the proposal is always k long (one graph); the row's budget
            # and headroom cut it, the surplus becomes padding
            kk = min(k, eng.seq_len - s.pos - 1,
                     s.req.max_tokens - s.n_out - 1)
            d = [int(t) for t in drafts_np[s.idx][:kk]]
            drafts[s.idx] = d
            tok[s.idx, 1:1 + len(d)] = d
            s.draft_pos = s.pos + k  # the proposal wrote pos..pos+k-1
        greedy, logits0 = eng.slot_verify_step(tok, pos, self.draft_vocab)
        self._spec_stats.verify_forwards += 1
        nonspec = [s for s in rows if s.idx not in drafts]
        view0 = self._sample_view(logits0, nonspec) if nonspec else None
        for s in rows:
            d = drafts.get(s.idx)
            if d is None:
                s.pos += 1
                self._emit(s, view0.sample(s.req.sampler, s.idx))
                continue
            req = s.req
            m = count_accepted(d, greedy[s.idx])
            emitted = [int(g) for g in greedy[s.idx][: m + 1]]
            self._spec_stats.drafted += len(d)
            self._spec_stats.accepted += m
            self._spec_stats.emitted_spec += len(emitted)
            req.stats.spec_forwards += 1
            req.stats.spec_drafted += len(d)
            req.stats.spec_accepted += m
            pos0 = s.pos
            for t in emitted:
                s.pos += 1
                self._emit(s, t)
                if s.req is None:  # stop or budget retired the slot: the
                    break          # rest of the accepted tokens go
            if s.req is not None:
                # clamp the draft frontier to the verified stream:
                # positions past the first rejection hold rejected tokens'
                # draft K/V, which a plain round would never overwrite
                s.draft_pos = min(pos0 + k, s.pos)

    def _emit(self, s: _Slot, token: int) -> None:
        """Record one sampled token and retire the slot the moment the
        request is done: Engine.generate's continue condition, negated. A
        stop token is emitted, then stops the row; budget and context-edge
        rows finish as "length". The last emitted token is never fed
        back."""
        req = s.req
        token = int(token)
        s.n_out += 1
        s.last = token
        s.toks.append(token)  # the draft catch-up's fed-token history
        if req.stats.t_first is None:
            now = time.perf_counter()
            req.stats.t_first = now
            if self.admission is not None:
                self.admission.observe_ttft((now - req.stats.t_submit) * 1e3)
            if TRACER.enabled:
                TRACER.event("first_token", req.trace_id,
                             ttft_ms=round((now - req.stats.t_submit)
                                           * 1e3, 3))
        elif TRACER.enabled and s.n_out % TRACER.decode_every == 0:
            # progress at a bounded cadence: a per-token event would let
            # one long stream flush the ring
            TRACER.event("decode", req.trace_id, n_out=s.n_out)
        req.stats.n_out = s.n_out
        self.stats.tokens_out += 1
        req.events.put(("token", token))
        if token in req.stop_ids:
            self._finish_slot(s, "stop")
        elif s.n_out >= req.max_tokens or s.pos >= self.engine.seq_len:
            self._finish_slot(s, "length")

    def _release_slot_cache(self, s: _Slot, req: ServeRequest) -> None:
        """Prefix-cache bookkeeping for a slot leaving by any path: release
        the seed pins, and for a slot retiring MID-PREFILL (cancel,
        deadline) publish the prompt prefix it did write (s.off advances
        only after a chunk's forward ran, so [0, off) is real data).

        Only PREFILL-written blocks are ever published, never the decode
        extension: decode-step K/V is not guaranteed bitwise-equal to what
        a cold prefill of the same tokens writes (another kernel path may
        round differently), and seeding it would void the cache-on ==
        cache-off token parity. A next chat turn still hits the previous
        turn's prompt blocks and re-prefills only the reply and the new
        message."""
        if self.prefix_cache is None:
            return
        if 0 < s.off < len(req.prompt):
            self.prefix_cache.publish(s.idx, req.prompt[: s.off])
        self.prefix_cache.unpin(s.pins)
        s.pins = ()

    def _finish_slot(self, s: _Slot, reason: str) -> None:
        req, s.req = s.req, None  # the slot is free from here on
        self._release_slot_cache(s, req)
        self._finish_req(req, reason)

    def _finish_req(self, req: ServeRequest, reason: str) -> None:
        if not req._claim_terminal():
            return
        req.finish_reason = reason
        req.stats.t_done = time.perf_counter()
        self.stats.requests_finished += 1
        if TRACER.enabled:
            if req.stats.spec_forwards:
                # the request's accept record, one event a request
                TRACER.event("spec", req.trace_id,
                             forwards=req.stats.spec_forwards,
                             drafted=req.stats.spec_drafted,
                             accepted=req.stats.spec_accepted, key=None)
            TRACER.event("finish", req.trace_id, reason=reason,
                         n_out=req.stats.n_out)
        req.events.put(("done", reason))
        req.finished.set()

    def warmup(self) -> None:
        """Run one prefill chunk and one decode step with EVERY row gated
        off (pos == S: the writes land in the spare row, the logits are
        unread), so the cache is untouched. On the card this captures the
        slot decode graph, and builds and loads every kernel library the
        serving path launches. The supervisor runs it before it marks an
        engine ready, so a first step's capture never reads as a stall.
        With a draft, its prefill chunk, its proposal and the verify step
        run too, all rows gated, so speculative serving captures nothing
        after warmup. With an SLO, every rung of the width ladder runs its
        prefill chunk. With a prefix cache, one seed and one publish run
        too: the seed really writes row 0, so the scheduler must be
        idle."""
        eng = self.engine
        with self._mutex:
            gate = np.full((eng.batch,), eng.seq_len, np.int32)
            widths = (self.admission.ladder if self.admission is not None
                      else [self.chunk])
            for w in widths:
                eng.slot_prefill_chunk(np.zeros((eng.batch, w), np.int32),
                                       gate, np.zeros((eng.batch,), np.int32))
            eng.slot_decode_step(np.zeros((eng.batch, 1), np.int32), gate)
            if self.draft is not None:
                self.draft_cache = self.draft.prefill_chunk(
                    self.draft_cache,
                    np.zeros((eng.batch, self.chunk), np.int32), gate)
                _, self.draft_cache = self.draft.propose(
                    self.draft_cache, np.zeros((eng.batch,), np.int32),
                    gate, self.draft_len, n_vocab=self.draft_vocab)
                eng.slot_verify_step(
                    np.zeros((eng.batch, 1 + self.draft_len), np.int32),
                    gate, self.draft_vocab)
            if self.prefix_cache is not None:
                if any(s.req is not None for s in self.slots):
                    raise RuntimeError(
                        "prefix-cache warmup requires an idle scheduler")
                self.prefix_cache.warmup()
            mark = getattr(eng, "mark_compile_warm", None)
            if mark is not None:
                mark()

    # -- background thread -------------------------------------------------

    def start(self) -> None:
        with self._mutex:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="dllama-scheduler", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            # clear before the step: a submit after the clear is either
            # seen by this step or re-arms the wait below
            self._wake.clear()
            with self._mutex:
                try:
                    did = self._step_locked()
                except Exception as e:  # noqa: BLE001 — fail every request, keep serving
                    self._abort_all(f"{type(e).__name__}: {e}")
                    did = False
            if not did and not self._stop:
                self._wake.wait(timeout=0.05)

    def _fail_req(self, req: ServeRequest, frame: dict) -> bool:
        """Deliver one request's terminal error frame, exactly once.
        Returns whether THIS call won the claim."""
        if not req._claim_terminal():
            return False
        req.finish_reason = "error"
        req.stats.t_done = time.perf_counter()
        self.stats.requests_finished += 1
        self.stats.requests_failed += 1
        if TRACER.enabled:
            TRACER.event("error", req.trace_id,
                         code=frame.get("code", "error"),
                         retryable=bool(frame.get("retryable", True)),
                         n_out=req.stats.n_out, key=None)
        req.events.put(("error", dict(frame)))
        req.finished.set()
        return True

    def _abort_all(self, msg: str, code: str = "engine_error",
                   retryable: bool = True) -> None:
        """Fail every in-flight and queued request with one structured
        frame. Called WITHOUT the mutex by close() and the supervisor,
        when the step thread may be wedged inside a step holding it."""
        frame = {"code": code, "message": msg, "retryable": retryable}
        if self.prefix_cache is not None:
            # the engine generation behind the arena is being discarded:
            # the whole tree goes, so nothing seeds from a dead engine
            self.prefix_cache.invalidate()
        for s in self.slots:
            s.pins = ()  # the invalidate detached the pinned nodes
            if s.req is not None:
                req, s.req = s.req, None
                self._fail_req(req, frame)
        while self._queue:
            try:
                self._fail_req(self._queue.popleft(), frame)
            except IndexError:  # a racing abort drained it under us
                break

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop and fail whatever is still queued or in flight,
        so no waiter in ServeRequest.tokens() outlives the scheduler."""
        self._closed = True  # new submits raise SchedulerClosed
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        # no mutex: a stuck thread holds it forever
        self._abort_all("scheduler shutdown", code="shutdown",
                        retryable=False)

    def kv_match_len(self, tokens: list[int]) -> int:
        """Lock-free peek at this scheduler's cached prefix of `tokens`
        (0 with the cache off; PrefixCache.match_len)."""
        pc = self.prefix_cache
        return pc.match_len(tokens) if pc is not None else 0

    @contextlib.contextmanager
    def exclusive(self):
        """Lend the batched engine to a caller: blocks the step loop,
        drives every queued and in-flight request to completion on the
        caller's thread, then yields the engine with every slot free."""
        with self._mutex:
            while self._step_locked():
                pass
            yield self.engine
