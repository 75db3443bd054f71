"""Continuous batching: a slot-based KV scheduler over the batch-B Engine —
the port of the JAX package's runtime/scheduler.py (its core: submit, the
scheduling iteration, warmup, the step thread, close, exclusive).

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

Thread model: ``submit()`` is thread-safe and never takes the step mutex;
the step loop runs on the ``start()`` thread, the supervisor's thread
(runtime/resilience.py) or synchronously through ``step()``. Every thread
issues its CUDA work on the default stream, so a capture, its replays and
the host copies between them are ordered on one stream. HTTP handler
threads touch host tokens only.

Not ported: speculation (draft, verify steps), the prefix cache, the SLO
admission ladder, the weighted-fair queue and the KV-transfer methods; the
constructor refuses them.
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
from .stats import RequestStats, ServeStats

# constructor options of the JAX Scheduler that the port does not have yet,
# with the ROADMAP item that brings each
UNPORTED = {
    "prefix_cache": "the prefix cache (ROADMAP item 9)",
    "draft_factory": "draft speculation (ROADMAP item 12)",
    "draft_len": "draft speculation (ROADMAP item 12)",
    "slo_ttft_ms": "the SLO admission ladder (ROADMAP item 10c)",
    "slo_itl_ms": "the SLO admission ladder (ROADMAP item 10c)",
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
                 deadline: float | None = None):
        self.id = rid
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


class _Slot:
    """One row of the batched KV cache: FREE when req is None, PREFILL
    while off < len(prompt), DECODE after. `pos` is the next cache write
    position, `last` the token to feed next step."""

    __slots__ = ("idx", "req", "pos", "off", "n_out", "last")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: ServeRequest | None = None
        self.pos = 0
        self.off = 0
        self.n_out = 0
        self.last = 0


class Scheduler:
    def __init__(self, engine, *, chunk: int | None = None,
                 max_queue: int = 0, queue_timeout: float | None = None,
                 request_deadline: float | None = None, **unported):
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
        self.slots = [_Slot(i) for i in range(engine.batch)]
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
               deadline: float | None = None) -> ServeRequest:
        """Enqueue a request; it joins the running batch when a slot frees.
        `sampler` is the request's own (its RNG stream is the slot's
        sampling state). max_tokens <= 0 prefills and emits nothing.
        Raises PromptTooLong when the prompt cannot fit the context,
        QueueFull at the queue bound, SchedulerClosed after close().
        `deadline` is an absolute perf_counter bound (default: now +
        request_deadline when configured)."""
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
        req = ServeRequest(rid, prompt, max_tokens, sampler, stop_ids,
                           deadline=deadline)
        req.stats.t_submit = now
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
        if pre:
            self._prefill_chunk(pre)
        if dec:
            # rows that finished their prompt in this iteration's chunk
            # wait for the next one: one decode forward a row an iteration
            self._decode(dec)
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

    def _sample_view(self, logits) -> FullLogitsView:
        return FullLogitsView(self.engine.fetch_logits(logits))

    def _prefill_chunk(self, rows: list[_Slot]) -> None:
        eng = self.engine
        b, c = eng.batch, self.chunk
        tok = np.zeros((b, c), np.int32)
        pos = np.full((b,), eng.seq_len, np.int32)  # gated rows: dropped
        lidx = np.zeros((b,), np.int32)
        finishing = []
        for s in rows:
            n = min(c, len(s.req.prompt) - s.off)
            tok[s.idx, :n] = s.req.prompt[s.off:s.off + n]
            # tail padding (token 0) writes beyond the prompt; decode
            # overwrites them before any later query attends them
            pos[s.idx] = s.off
            lidx[s.idx] = n - 1
            s.off += n
            if s.off == len(s.req.prompt):
                finishing.append(s)
        logits = eng.slot_prefill_chunk(tok, pos, lidx)
        if not finishing:
            return  # mid-prompt chunk: no logits to the host
        view = self._sample_view(logits)
        for s in finishing:
            s.pos = len(s.req.prompt)
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
        view = self._sample_view(eng.slot_decode_step(tok, pos))
        for s in rows:
            s.pos += 1
            self._emit(s, view.sample(s.req.sampler, s.idx))

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
        if req.stats.t_first is None:
            req.stats.t_first = time.perf_counter()
        req.stats.n_out = s.n_out
        self.stats.tokens_out += 1
        req.events.put(("token", token))
        if token in req.stop_ids:
            self._finish_slot(s, "stop")
        elif s.n_out >= req.max_tokens or s.pos >= self.engine.seq_len:
            self._finish_slot(s, "length")

    def _finish_slot(self, s: _Slot, reason: str) -> None:
        req, s.req = s.req, None  # the slot is free from here on
        self._finish_req(req, reason)

    def _finish_req(self, req: ServeRequest, reason: str) -> None:
        if not req._claim_terminal():
            return
        req.finish_reason = reason
        req.stats.t_done = time.perf_counter()
        self.stats.requests_finished += 1
        req.events.put(("done", reason))
        req.finished.set()

    def warmup(self) -> None:
        """Run one prefill chunk and one decode step with EVERY row gated
        off (pos == S: the writes land in the spare row, the logits are
        unread), so the cache is untouched. On the card this captures the
        slot decode graph, and builds and loads every kernel library the
        serving path launches. The supervisor runs it before it marks an
        engine ready, so a first step's capture never reads as a stall."""
        eng = self.engine
        with self._mutex:
            gate = np.full((eng.batch,), eng.seq_len, np.int32)
            eng.slot_prefill_chunk(np.zeros((eng.batch, self.chunk), np.int32),
                                   gate, np.zeros((eng.batch,), np.int32))
            eng.slot_decode_step(np.zeros((eng.batch, 1), np.int32), gate)
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
        req.events.put(("error", dict(frame)))
        req.finished.set()
        return True

    def _abort_all(self, msg: str, code: str = "engine_error",
                   retryable: bool = True) -> None:
        """Fail every in-flight and queued request with one structured
        frame. Called WITHOUT the mutex by close() and the supervisor,
        when the step thread may be wedged inside a step holding it."""
        frame = {"code": code, "message": msg, "retryable": retryable}
        for s in self.slots:
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

    @contextlib.contextmanager
    def exclusive(self):
        """Lend the batched engine to a caller: blocks the step loop,
        drives every queued and in-flight request to completion on the
        caller's thread, then yields the engine with every slot free."""
        with self._mutex:
            while self._step_locked():
                pass
            yield self.engine
