"""OpenAI-compatible HTTP API server — the port of the JAX package's
apps/api_server.py for one GPU (ref: src/apps/dllama-api/dllama-api.cpp):

  * POST /v1/chat/completions and POST /v1/completions, streamed by SSE or
    not (ref: dllama-api.cpp:202-314);
  * GET /v1/models (ref: dllama-api.cpp:316-322), /, /health, /healthz
    (liveness), /readyz (readiness), /stats (serving counters) and
    /metrics (Prometheus text);
  * the Llama-3 header chat template (ref: dllama-api.cpp:173-181), the
    stop-sequence scan over the trailing pieces (ref: dllama-api.cpp:
    272-286), per-request temperature, seed, max_tokens and stop.

A threaded accept loop (ThreadingHTTPServer). With --serve-batch B the two
completion routes enqueue onto the continuous-batching scheduler under its
supervisor (runtime/scheduler.py, runtime/resilience.py): concurrent
requests share one batched decode step, on the card one replayed CUDA
graph, over B slots of a second engine that shares the first one's
weights. The supervisor is built, warmed up (the slot decode graph
captured) and started with the ApiState, on the thread that builds it and
before the server binds, so /readyz answers ready only once the engine can
serve and no request pays for the capture. Without --serve-batch, requests
serialize on the batch-1 engine behind state.engine_lock, reusing the
longest common token prefix of the previous request's cache. Handler
threads touch host tokens only; every CUDA call after the build runs on the
supervisor's step thread or, on the legacy path, under the engine lock.

With --prefix-cache (and --serve-batch B) every generation of the
supervisor carries a radix prefix cache (runtime/prefix_cache.py): an
arena of 2 x B x context tokens in blocks of 32 unless --prefix-blocks and
--prefix-block-len say otherwise, reported in /stats `prefix_cache` and
the /metrics `dllama_prefix_cache_*` families. On the legacy path,
--session FILE resumes the cached prefix and its token history at startup
(`load_server_session`) and saves them at shutdown
(`save_server_session`).

Speculative decoding (runtime/speculative.py, runtime/draft.py): with
--draft self:D|model:PATH and --serve-batch B, every slot drafts through
the scheduler's one fixed-width verify forward; on the legacy path
--lookup-decode K or --draft speculates every request, greedy ones through
the exact greedy streams (Engine.generate_lookup_stream,
generate_draft_stream), sampled ones through rejection resampling on a
numpy stream seeded from the shared sampler (Sampler.next_seed). The
legacy path folds each request's accept record into `spec_stats`, which
/stats and /metrics report as the `spec` block in every tier.

POST /v1/batch/completions (with --serve-batch B) decodes up to B prompts
as one batch on the scheduler's engine, borrowed through
``EngineSupervisor.exclusive()`` once every in-flight request has finished
(Engine.generate_batch_stream; greedy batches with --lookup-decode K
through Engine.generate_batch_lookup), in the JAX server's JSON and SSE
shapes.

Operator routes, loopback-only unless --admin-token TOKEN is given (then
``Authorization: Bearer TOKEN`` from elsewhere): GET /admin/trace
(the flight recorder's ring as JSONL, ``?n=``, ``?id=``, ``?kind=``,
``?since_ms=``; 404 with tracing off) and POST /admin/profile?ms=N (one
torch.profiler trace of the next N ms under --profile-dir). /stats carries
the ``trace`` and ``step_timeline`` blocks with --trace and
``device_time`` with --profile-sample; /metrics the tracer's families.
POST /admin/reset_breaker (body ``{"replica": i}`` optional; one GPU has
replica 0 only) is the operator's half-open of a BROKEN supervisor.

Admission and auto-sizing: --slo-ttft-ms/--slo-itl-ms arm every
generation's admission policy (runtime/scheduler.AdmissionPolicy, the
``admission`` block and ``dllama_admission_*``); --serve-batch auto and
--prefix-blocks auto resolve against the built engine's memory ledger
capped by the batch knee (--autotune FILE, runtime/profiler.
resolve_auto_shape), logged at startup and exported as the ``autosize``
block and ``dllama_autosize_*``; --freeze-compiles refuses a graph capture
after warmup.

Over --tp ranks (`dllama api --tp T`, parallel/control.py) this server is
rank 0: it alone binds the port and runs every host layer (HTTP, the
supervisor and scheduler, the tokenizer, the samplers), and every engine
call it makes is an op the other ranks run after it, in its order, so the
legacy path's early stops (a stop string, a disconnect, a deadline) reach
them at a step boundary. A lost rank makes /healthz and /readyz answer 503
with the reason, and the server stops and exits non-zero.

Not ported (each refused with a message naming its ROADMAP item): the
replica verbs, replicas and the router, and tenants.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..runtime.resilience import EngineUnready
from ..runtime.scheduler import PromptTooLong, QueueFull, RequestError

CHAT_EOS_MARKERS = ("<|eot_id|>", "<|end_of_text|>")
# a streaming batch lookup request sends an SSE comment this often while
# its collected run goes on (JAX apps/api_server.py:56)
KEEPALIVE_SECS = 1.0

_REPLICA_VERB = ("the replica verbs come with replicas and the fleet "
                 "(ROADMAP item 16)")
UNPORTED_ROUTES = {
    "/admin/drain_replica": _REPLICA_VERB,
    "/admin/restart_replica": _REPLICA_VERB,
    "/admin/undrain_replica": _REPLICA_VERB,
}


class BadRequest(ValueError):
    """A malformed client field (a non-numeric temperature or seed, a
    non-string prompt): HTTP 400, never a retryable 503."""


def _is_loopback(addr: str) -> bool:
    """The /admin/* guard's default: loopback only (IPv4 127.0.0.0/8,
    IPv6 ::1 and the IPv6-mapped IPv4 form)."""
    if addr.startswith("::ffff:"):
        addr = addr[len("::ffff:"):]
    return addr == "::1" or addr.startswith("127.")


def _admin_authorized(state: "ApiState", client_addr: str,
                      auth_header: str | None) -> bool:
    """May this caller use /admin/*? Loopback always may; from elsewhere
    only with ``Authorization: Bearer <--admin-token>``, compared in
    constant time (JAX apps/api_server.py:77)."""
    if _is_loopback(client_addr):
        return True
    if not state.admin_token or not auth_header:
        return False
    expected = "Bearer " + state.admin_token
    return hmac.compare_digest(auth_header.encode(), expected.encode())


def build_chat_prompt(messages: list[dict]) -> str:
    """Llama-3 header template (ref: dllama-api.cpp:173-181)."""
    out = []
    for m in messages:
        out.append(f"<|start_header_id|>{m.get('role', 'user')}<|end_header_id|>\n\n"
                   f"{m.get('content', '')}<|eot_id|>")
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


class ApiState:
    def __init__(self, engine, tokenizer, sampler, model_name: str = "dllama",
                 lookup_decode: int = 0, serve_batch: int = 0,
                 serve_chunk: int = 0, queue_depth: int = 0,
                 request_deadline: float = 0.0, stall_timeout: float = 0.0,
                 prefix_cache: bool = False, prefix_blocks: int = 0,
                 prefix_block_len: int = 32, draft: str | None = None,
                 draft_len: int = 0, admin_token: str | None = None,
                 profile_dir: str | None = None,
                 slo_ttft_ms: float | None = None,
                 slo_itl_ms: float | None = None,
                 autosize: dict | None = None):
        from ..runtime.stats import SpecStats

        self.engine = engine
        self.tokenizer = tokenizer
        self.sampler = sampler
        self.model_name = model_name
        # serve_batch > 0: the scheduler's slots (0 = the legacy path);
        # serve_chunk its prefill chunk (0 = the engine's); queue_depth
        # its queue bound (0 = 4 x serve_batch); request_deadline the
        # default end-to-end budget in seconds (0 = none); stall_timeout
        # the watchdog's bound in seconds (0 = 10)
        self.serve_batch = serve_batch
        self.serve_chunk = serve_chunk
        self.queue_depth = queue_depth
        self.request_deadline = request_deadline
        self.stall_timeout = stall_timeout
        # the radix prefix cache on the scheduler path: prefix_blocks 0
        # sizes the arena at 2 x B x context tokens (JAX
        # runtime/router.py:1680), enough for several system prompts and
        # recent conversations
        self.prefix_cache = prefix_cache
        self.prefix_blocks = prefix_blocks
        self.prefix_block_len = prefix_block_len
        # the SLOs of every generation's admission policy, and the startup
        # auto-sizing decision record (None without an 'auto')
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_itl_ms = slo_itl_ms
        self.autosize = autosize
        # the legacy path's prompt-lookup draft length (0 = off), and the
        # --draft spec string with its draft length: the scheduler path
        # builds its draft per generation, the legacy path one DraftModel
        # over this engine on first use (draft_model())
        self.lookup_decode = lookup_decode
        # the /admin/* bearer token (None: loopback only) and where
        # /admin/profile captures land (None: a fresh temp dir each)
        self.admin_token = admin_token
        self.profile_dir = profile_dir
        self.draft = draft
        self.draft_len = int(draft_len or 0)
        self._draft_model = None
        # the legacy path's aggregate accept record (the scheduler carries
        # its own on ServeStats.spec)
        self.spec_stats = SpecStats(
            mode=(draft or ("lookup" if lookup_decode else "off")),
            draft_len=self.draft_len or lookup_decode)
        # graceful drain (SIGTERM): POSTs 503, /readyz unready
        self.draining = False
        # why the ranks of a mirrored engine were lost (None: in step)
        self.lost: str | None = None
        # the legacy path's token history whose K/V is live in the cache
        self.cached_tokens: list[int] = []
        # serializes the legacy path's requests
        self.engine_lock = threading.RLock()
        self._build_info: dict | None = None
        if engine.device.type == "cuda":
            # /admin/profile captures on a handler thread: the profiler's
            # CUDA tracer must start on this one (Profiler.prepare)
            from ..runtime.profiler import PROFILER

            PROFILER.prepare()
        self._scheduler = (self._build_supervisor() if serve_batch > 0
                           else None)

    def build_info(self) -> dict:
        if self._build_info is None:
            from ..runtime.profiler import build_info

            self._build_info = build_info(self.engine)
        return self._build_info

    def draft_model(self):
        """The legacy path's DraftModel over this engine, built once on
        first use."""
        if self._draft_model is None and self.draft:
            from ..runtime.draft import build_draft

            with self.engine_lock:
                if self._draft_model is None:
                    self._draft_model = build_draft(self.engine, self.draft)
        return self._draft_model

    def _build_supervisor(self):
        """The supervisor over a batch-`serve_batch` engine, built, warmed
        up (the slot decode graph captured) and started. The engine
        factory shares this engine's params: a slot engine costs its KV
        cache, never a copy of the weights."""
        from ..runtime.resilience import EngineSupervisor

        eng = self.engine

        def engine_factory():
            # the template's mesh and its resolved vocab split carried
            # through every generation (JAX test_supervisor_tier_serves_
            # on_tp_mesh); on every rank, as one op
            return eng.spawn(self.serve_batch)

        n_blocks = 0
        if self.prefix_cache:
            n_blocks = self.prefix_blocks or max(
                2 * self.serve_batch * eng.seq_len // self.prefix_block_len, 1)
        return EngineSupervisor(
            engine_factory, chunk=self.serve_chunk or None,
            max_queue=self.queue_depth or 4 * self.serve_batch,
            request_deadline=self.request_deadline or None,
            stall_timeout=self.stall_timeout or 10.0,
            prefix_blocks=n_blocks, prefix_block_len=self.prefix_block_len,
            slo_ttft_ms=self.slo_ttft_ms, slo_itl_ms=self.slo_itl_ms,
            draft=self.draft, draft_len=self.draft_len,
            draft_vocab=self.tokenizer.vocab_size)


def load_server_session(state: ApiState, path: str) -> None:
    """Restore a previous server process's cached prefix and its token
    history (Engine.load_session, which refuses another model through the
    fingerprint): a request whose prompt extends the saved conversation
    prefills only its suffix, and answers as it would have without the
    restart."""
    tokens = state.engine.load_session(path)
    # the cache holds K/V for exactly engine.pos positions; a token past
    # them (a final unstepped token) must not count as cached
    state.cached_tokens = tokens[: state.engine.pos]


def save_server_session(state: ApiState, path: str) -> bool:
    """Persist the cached prefix and its token history (Engine.save_session)
    at shutdown. A shutdown mid-request leaves cached_tokens empty while
    engine.pos is large: the save is then SKIPPED (False) and a previous
    file stays. The cache is never saved beyond the tokens that describe
    it."""
    if not state.cached_tokens:
        return False
    eng = state.engine
    eng.pos = min(eng.pos, len(state.cached_tokens))
    eng.save_session(path, tokens=state.cached_tokens)
    return True


def _raw_prompt_body(body: dict) -> bool:
    """A /v1/completions-shaped body: a raw `prompt`, no chat template."""
    return "messages" not in body and "prompt" in body


def _prompt_and_stops(body: dict, chat: bool):
    if chat and not _raw_prompt_body(body):
        prompt = build_chat_prompt(body.get("messages", []))
        markers: tuple = CHAT_EOS_MARKERS
    else:
        prompt = body.get("prompt") or ""
        markers = ()
    stops = body.get("stop") or []
    if isinstance(stops, str):
        stops = [stops]
    return prompt, markers, stops


def _piece_scanner(tokenizer, first_prev: int, markers, stops):
    """Per-token text scan shared by both paths: returns scan(tok) -> the
    decoded piece to emit, or None when the request just stopped (eos, a
    chat marker or a stop sequence in the trailing window; the token is
    consumed, never emitted)."""
    scan_state = {"prev": first_prev, "tail": ""}
    tail_len = max([len(m) for m in markers]
                   + [len(s) for s in stops] + [1]) + 16
    eos = tokenizer.eos_id

    def scan(tok: int) -> str | None:
        if tok == eos:
            return None
        piece = tokenizer.decode_piece(scan_state["prev"], tok).decode(
            "utf-8", errors="replace")
        scan_state["prev"] = tok
        # bounded trailing window (ref: dllama-api.cpp:272-286)
        scan_state["tail"] = (scan_state["tail"] + piece)[-tail_len:]
        if (any(m in scan_state["tail"] for m in markers)
                or (stops and any(s in scan_state["tail"] for s in stops))):
            return None
        return piece

    return scan


def _completion_chunks(state: ApiState, body: dict):
    """The legacy path's generator of ("piece", text) events and one
    ("done", usage): the batch-1 engine, the shared sampler, and the
    longest common token prefix of the previous request kept in the cache
    (only the suffix is prefilled; positions past it are overwritten
    before any of this request's queries attends them). The body's shape
    picks the template, whichever route it came by (as in the JAX
    server)."""
    engine, tokenizer, sampler = state.engine, state.tokenizer, state.sampler
    prompt, markers, stops = _prompt_and_stops(body, chat=True)
    max_tokens = int(body.get("max_tokens", 0) or 0)

    tokens = tokenizer.encode(prompt)
    if len(tokens) >= engine.seq_len:
        raise PromptTooLong(
            f"prompt is {len(tokens)} tokens; context is {engine.seq_len}")
    lcp = 0
    while (lcp < len(state.cached_tokens) and lcp < len(tokens) - 1
           and state.cached_tokens[lcp] == tokens[lcp]):
        lcp += 1
    if lcp > 0:
        engine.pos = lcp
    else:
        engine.reset()
    suffix = tokens[lcp:]
    state.cached_tokens = []  # repopulated on success below

    # per-request temperature and seed must not leak into later requests:
    # both are restored in the finally below
    saved_temp = sampler.temperature
    saved_rng_state = None
    if body.get("temperature") is not None:
        sampler.set_temp(float(body["temperature"]))
    if body.get("seed") is not None:
        saved_rng_state = sampler.rng_state
        sampler.set_seed(int(body["seed"]))

    limit = engine.seq_len - len(tokens) - 1
    n_gen = min(max_tokens, limit) if max_tokens > 0 else limit
    scan = _piece_scanner(tokenizer, tokens[-1], markers, stops)
    emitted = 0
    finish = "length"
    history = list(tokens)  # every prompt position is written by prefill

    def plain_tokens():
        """The sampled loop as a token iterator: a token is stepped only
        if the consumer pulls again, so the last emitted token is never
        stepped (as in Engine.generate)."""
        logits = engine.prefill(suffix)
        for _ in range(n_gen):
            tok = sampler.sample(engine.fetch_logits(logits)[0])
            yield tok
            if engine.pos >= engine.seq_len:
                return
            logits = engine.step(np.asarray([[tok]], np.int32), engine.pos)
            history.append(tok)  # stepping tok wrote its K/V

    # the speculative streams do not append their tokens to `history`
    # (the consumer loop does), plain_tokens() appends as it steps:
    # `speculating` keeps exactly one owner, so a request that falls
    # through to the plain loop (a negative temperature) keeps the cached
    # prefix aligned with the real K/V positions
    speculating = state.draft is not None or state.lookup_decode > 0
    v = tokenizer.vocab_size
    try:
        if state.draft is not None and sampler.temperature == 0.0:
            token_iter = engine.generate_draft_stream(
                suffix, n_gen, history=tokens, draft=state.draft_model(),
                draft_len=state.draft_len or 7, vocab_size=v)
        elif state.draft is not None and sampler.temperature > 0.0:
            token_iter = engine.generate_draft_sampled_stream(
                suffix, n_gen, history=tokens, draft=state.draft_model(),
                temperature=sampler.temperature, topp=sampler.topp,
                seed=sampler.next_seed(), draft_len=state.draft_len or 7,
                vocab_size=v)
        elif state.lookup_decode > 0 and sampler.temperature == 0.0:
            token_iter = engine.generate_lookup_stream(
                suffix, n_gen, history=tokens,
                draft_len=state.lookup_decode, vocab_size=v)
        elif state.lookup_decode > 0 and sampler.temperature > 0.0:
            token_iter = engine.generate_lookup_sampled_stream(
                suffix, n_gen, history=tokens,
                temperature=sampler.temperature, topp=sampler.topp,
                seed=sampler.next_seed(), draft_len=state.lookup_decode,
                vocab_size=v)
        else:
            speculating = False
            token_iter = plain_tokens()
        for tok in token_iter:
            piece = scan(tok)
            if piece is None:
                finish = "stop"
                break
            emitted += 1
            if speculating:
                history.append(tok)  # its position is written by a verify
            yield ("piece", piece)
        state.cached_tokens = history[: engine.pos]
    finally:
        sampler.set_temp(saved_temp)
        if saved_rng_state is not None:
            sampler.rng_state = saved_rng_state
        if speculating and engine.last_spec:
            # fold the request's accept record into the legacy tier's
            ls, ss = engine.last_spec, state.spec_stats
            ss.verify_forwards += ls["forwards"]
            ss.drafted += ls["drafted"]
            ss.accepted += ls["accepted"]
            ss.emitted_spec += ls["emitted"]
    yield ("done", {"finish_reason": finish,
                    "prompt_tokens": len(tokens),
                    "completion_tokens": emitted})


def _sched_completion_chunks(state: ApiState, body: dict, chat: bool = True):
    """The scheduler path's generator: enqueue onto the shared
    continuous-batching scheduler and yield pieces as the request's slot
    produces tokens. The request samples with a Sampler of its own; an
    omitted seed derives from the shared sampler (Sampler.next_seed) under
    the engine lock, so runs are deterministic. A text-level stop, a client
    disconnect or the generator's close cancels the request and frees its
    slot. A structured failure (recovery, deadline, shutdown) ends the
    stream with finish_reason "error" and the frame in the done event."""
    from ..sampler import Sampler

    tokenizer = state.tokenizer
    sched = state._scheduler
    prompt, markers, stops = _prompt_and_stops(body, chat)
    max_tokens = int(body.get("max_tokens", 0) or 0)

    tokens = tokenizer.encode(prompt)
    temp = (state.sampler.temperature if body.get("temperature") is None
            else float(body["temperature"]))
    with state.engine_lock:
        seed = (int(body["seed"]) if body.get("seed") is not None
                else state.sampler.next_seed())
    sampler = Sampler(tokenizer.vocab_size, temperature=temp,
                      topp=state.sampler.topp, seed=seed)
    limit = sched.engine.seq_len - len(tokens) - 1
    n_gen = min(max_tokens, limit) if max_tokens > 0 else limit
    # PromptTooLong and QueueFull raise here, before any event: the
    # handler answers 400 or 429
    req = sched.submit(tokens, n_gen, sampler, eos_id=tokenizer.eos_id)

    scan = _piece_scanner(tokenizer, tokens[-1], markers, stops)
    emitted = 0
    finish = "length"
    err = None
    try:
        for tok in req.tokens():
            piece = scan(tok)
            if piece is None:
                finish = "stop"
                break
            emitted += 1
            yield ("piece", piece)
    except RequestError as e:
        finish = "error"
        err = e.frame()
    finally:
        req.cancel()  # a no-op after a natural finish
    done = {"finish_reason": finish,
            "prompt_tokens": len(tokens),
            "completion_tokens": emitted}
    if err is not None:
        done["error"] = err
    yield ("done", done)


def _batch_completion_chunks(state: ApiState, body: dict):
    """POST /v1/batch/completions generator (JAX apps/api_server.py:653):
    up to serve_batch prompts (``prompts``, raw, or ``messages_list``,
    chat-templated) decoded as ONE batch on the scheduler's engine.
    Yields ("piece", (row, piece)) events, ("keepalive", None) while a
    streamed lookup run collects, then one ("done", {...}) with per-row
    finish reasons and the usage. A request temperature and seed apply to
    the whole batch through the shared sampler (coins drawn in row order);
    the batch cache is reset before and after. The engine is borrowed
    through the supervisor's exclusive(), which first drives every
    in-flight request to completion."""
    sup = state._scheduler
    engine = sup.engine
    tokenizer, sampler = state.tokenizer, state.sampler
    # every field is parsed before the borrow: a malformed value fails
    # this request as a 400, never inside the exclusive lock
    try:
        if "prompts" in body:
            texts = body["prompts"]
            raw = True
        else:
            texts = [build_chat_prompt(m)
                     for m in body.get("messages_list", [])]
            raw = False
        b = len(texts)
        if not 1 <= b <= state.serve_batch:
            raise PromptTooLong(
                f"batch size {b} outside 1..{state.serve_batch} (server "
                f"started with --serve-batch {state.serve_batch})")
        max_tokens = int(body.get("max_tokens", 64))
        want_stream = bool(body.get("stream", False))
        stops = body.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        rows = [tokenizer.encode(t) for t in texts]
        limit = engine.seq_len - 1
        for i, r in enumerate(rows):
            if len(r) >= limit:
                raise PromptTooLong(
                    f"prompt {i}: {len(r)} tokens >= context {limit}")
        # the budget is the widest row's headroom: a long prompt that
        # reaches S retires only its own row
        headroom = max(limit - len(r) for r in rows)
        n_gen = min(max_tokens, headroom) if max_tokens > 0 else headroom
        n_prompt_toks = sum(len(r) for r in rows)
        req_temp = (float(body["temperature"])
                    if body.get("temperature") is not None else None)
        req_seed = (int(body["seed"])
                    if body.get("seed") is not None else None)
        markers = () if raw else CHAT_EOS_MARKERS
        tail_len = max([len(m) for m in markers]
                       + [len(s) for s in stops] + [1]) + 16
        prev = [r[-1] for r in rows]
    except PromptTooLong:
        raise
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        raise BadRequest(f"{type(e).__name__}: {e}") from e
    tails = [""] * b
    emitted = [0] * b
    finish = ["length"] * b
    # the engine's batch is fixed: a short batch pads with rows flagged
    # before the first step (they never sample or emit)
    rows = rows + [[rows[0][0]]] * (engine.batch - b)
    stop_flags = np.zeros(engine.batch, bool)
    stop_flags[b:] = True

    def scan_token(i: int, tok: int) -> str | None:
        """Row i's piece for tok, or None when the row just stopped (eos,
        a chat marker or a stop sequence)."""
        if tok == tokenizer.eos_id:
            finish[i] = "stop"
            return None
        piece = tokenizer.decode_piece(prev[i], tok).decode(
            "utf-8", errors="replace")
        prev[i] = tok
        tails[i] = (tails[i] + piece)[-tail_len:]
        if (any(m in tails[i] for m in markers)
                or (stops and any(s in tails[i] for s in stops))):
            finish[i] = "stop"
            return None
        emitted[i] += 1
        return piece

    def lookup_rows():
        return engine.generate_batch_lookup(
            rows, n_gen, eos_id=tokenizer.eos_id,
            draft_len=state.lookup_decode, vocab_size=tokenizer.vocab_size,
            stop_flags=stop_flags)

    # a real `with`: a crash inside the borrow reaches the supervisor's
    # recovery, and a generator torn down mid-stream still releases it
    with sup.exclusive():
        saved_temp = sampler.temperature
        saved_rng_state = None
        if req_temp is not None:
            sampler.set_temp(req_temp)
        if req_seed is not None:
            saved_rng_state = sampler.rng_state
            sampler.set_seed(req_seed)
        try:
            engine.reset()  # slots drained: the borrowed cache starts clean
            if state.lookup_decode > 0 and sampler.temperature == 0.0:
                # greedy batches speculate; collected, then scanned (a
                # text stop trims its row afterwards). A stream collects
                # on a helper thread and sends keepalives meanwhile
                if want_stream:
                    box: dict = {}

                    def collect():
                        try:
                            box["outs"] = lookup_rows()
                        except BaseException as e:  # noqa: BLE001 — re-raised below
                            box["err"] = e
                    t = threading.Thread(target=collect, daemon=True)
                    t.start()
                    try:
                        while True:
                            t.join(timeout=KEEPALIVE_SECS)
                            if not t.is_alive():
                                break
                            yield ("keepalive", None)
                    finally:
                        # a torn-down generator must not end the borrow
                        # while the thread still drives the engine
                        t.join()
                    if "err" in box:
                        raise box["err"]
                    outs = box["outs"]
                else:
                    outs = lookup_rows()
                for i in range(b):
                    for tok in outs[i]:
                        piece = scan_token(i, tok)
                        if piece is None:
                            break
                        yield ("piece", (i, piece))
            else:
                for step in engine.generate_batch_stream(
                        rows, n_gen, sampler, stop_flags=stop_flags):
                    for i, tok in enumerate(step):
                        if tok is None or stop_flags[i]:
                            continue
                        piece = scan_token(i, tok)
                        if piece is None:
                            stop_flags[i] = True
                            continue
                        yield ("piece", (i, piece))
        finally:
            sampler.set_temp(saved_temp)
            if saved_rng_state is not None:
                sampler.rng_state = saved_rng_state
            engine.reset()  # the batch cache holds nothing reusable
    yield ("done", {"finish_reasons": finish,
                    "prompt_tokens": n_prompt_toks,
                    "completion_tokens": sum(emitted)})


def _chunk_env(rid: str, created: int, model: str, index: int,
               delta: dict, finish_reason) -> dict:
    """One SSE chat.completion.chunk envelope."""
    return {"id": rid, "object": "chat.completion.chunk", "created": created,
            "model": model,
            "choices": [{"index": index, "delta": delta,
                         "finish_reason": finish_reason}]}


def _completion_env(rid: str, created: int, model: str, choices: list,
                    prompt_tokens: int, completion_tokens: int) -> dict:
    """The non-streamed chat.completion envelope and usage."""
    return {"id": rid, "object": "chat.completion", "created": created,
            "model": model, "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens}}


def _text_chunk_env(rid: str, created: int, model: str, text: str,
                    finish_reason) -> dict:
    """One SSE text_completion chunk (/v1/completions)."""
    return {"id": rid, "object": "text_completion", "created": created,
            "model": model,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": finish_reason}]}


def _text_completion_env(rid: str, created: int, model: str, text: str,
                         finish_reason, prompt_tokens: int,
                         completion_tokens: int) -> dict:
    """The non-streamed text_completion envelope (/v1/completions)."""
    return {"id": rid, "object": "text_completion", "created": created,
            "model": model,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": finish_reason}],
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens}}


def _unported_route(path: str) -> str | None:
    why = UNPORTED_ROUTES.get(path.split("?", 1)[0])
    return None if why is None else f"{path} is not ported: {why}"


def make_handler(state: ApiState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *fargs):  # quiet
            pass

        def _json(self, code: int, obj: dict,
                  retry_after: float | None = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if retry_after is not None:
                self.send_header("Retry-After",
                                 str(max(1, int(round(retry_after)))))
            self.end_headers()
            self.wfile.write(data)

        # SSE streaming (ref: dllama-api.cpp:125-145,183-200)
        def _sse_start(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def _sse(self, obj: dict) -> None:
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def _sse_done(self) -> None:
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": state.model_name, "object": "model",
                     "created": int(time.time()), "owned_by": "user"}]})
            elif self.path in ("/", "/health", "/healthz"):
                # liveness: 200 while recovering or draining (a restart
                # would cut the drain short); 503 once a rank is lost
                if state.lost is not None:
                    self._json(503, {"status": "lost", "error": state.lost,
                                     "build": state.build_info()})
                    return
                self._json(200, {"status": "draining" if state.draining
                                 else "ok",
                                 "build": state.build_info()})
            elif self.path == "/readyz":
                self._readyz()
            elif self.path == "/stats":
                self._stats()
            elif self.path == "/metrics":
                self._metrics()
            elif (self.path == "/admin/trace"
                  or self.path.startswith("/admin/trace?")):
                self._admin_trace()
            else:
                self._json(404, {"error": "not found"})

        def _stats(self) -> None:
            """GET /stats: the supervisor's summary (its trace,
            step_timeline and device_time blocks included when on); the
            legacy tier answers its accept record and the trace block."""
            from ..runtime.trace import TRACER

            if state._scheduler is not None:
                payload = state._scheduler.summary()
                if state.autosize:
                    # the startup decision: chosen shape and every input
                    payload["autosize"] = state.autosize
                self._json(200, payload)
                return
            payload = {"scheduler": "off",
                       "spec": state.spec_stats.summary()}
            if TRACER.enabled:
                payload["trace"] = TRACER.summary()
            self._json(200, payload)

        def _admin_denied(self) -> bool:
            """The admin guard: answers 403 and returns True unless the
            caller is on loopback or carries the --admin-token bearer."""
            if _admin_authorized(state, self.client_address[0],
                                 self.headers.get("Authorization")):
                return False
            self._json(403, {"error": "admin endpoints need loopback or a "
                                      "valid --admin-token bearer"})
            return True

        def _admin_trace(self) -> None:
            """GET /admin/trace[?n=200|?id=TID|?kind=K|?since_ms=MS] (JAX
            apps/api_server.py:1132): the flight-recorder ring as JSONL,
            first the clock anchor, then one event a line with its wall
            time. With filters, the whole ring is filtered, then the last
            n kept."""
            from urllib.parse import parse_qs, urlparse

            from ..runtime.trace import EVENT_KINDS, TRACER

            if self._admin_denied():
                return
            if not TRACER.enabled:
                self._json(404, {"error": "tracing off (start with "
                                          "--trace)"})
                return
            try:
                # keep_blank_values: "kind=" is refused, not dropped
                q = parse_qs(urlparse(self.path).query,
                             keep_blank_values=True)
                tid = int(q["id"][0]) if "id" in q else None
                n = int(q.get("n", ["200"])[0])
                if n < 0 or (tid is not None and tid < 0):
                    raise ValueError(n)
                kind = q["kind"][0] if "kind" in q else None
                if kind is not None and kind not in EVENT_KINDS:
                    raise ValueError(kind)
                since_ms = (float(q["since_ms"][0]) if "since_ms" in q
                            else None)
                if since_ms is not None and not since_ms >= 0:
                    raise ValueError(since_ms)   # NaN included
            except (ValueError, IndexError):
                self._json(400, {"error": "bad request"})
                return
            filtered = kind is not None or since_ms is not None
            events = (TRACER.by_id(tid) if tid is not None
                      else TRACER.recent(0 if filtered else n))
            if kind is not None:
                events = [e for e in events if e.get("kind") == kind]
            if since_ms is not None:
                cut = time.perf_counter() - since_ms / 1e3
                events = [e for e in events if e.get("ts", 0.0) >= cut]
            if tid is None and filtered and n:
                events = events[-n:]
            lines = [json.dumps({"anchor_wall": TRACER.anchor_wall,
                                 "anchor_mono": TRACER.anchor_mono,
                                 "events": len(events)})]
            lines += [json.dumps({**e, "ts_wall": TRACER.to_wall(e["ts"])})
                      for e in events]
            data = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _admin_reset_breaker(self) -> None:
            """POST /admin/reset_breaker {replica?: i} (JAX
            apps/api_server.py:1286): the operator's half-open of a
            BROKEN supervisor (``EngineSupervisor.reset_breaker``): one
            rebuild is tried. One GPU has replica 0 only."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                replica = body.get("replica")
                if replica is not None:
                    replica = int(replica)
            except (ValueError, TypeError, AttributeError):
                self._json(400, {"error": "bad request"})
                return
            sup = state._scheduler
            if sup is None:
                self._json(404, {"error": "no supervised scheduler "
                                          "(start with --serve-batch N)"})
                return
            if replica is not None and replica != 0:
                self._json(400, {"error": f"no replica {replica} "
                                          "(tier has 1)"})
                return
            sup.reset_breaker()
            self._json(200, {"status": "ok", "state": sup.state})

        def _admin_profile(self) -> None:
            """POST /admin/profile?ms=N (JAX apps/api_server.py:1372): one
            torch.profiler trace of the next N ms (0 < N <= 60000, the
            query or the body's ``ms``, default 100) under --profile-dir.
            Synchronous: a 200 means the trace is on disk; the threaded
            server and the scheduler keep running meanwhile. 409 while a
            capture or a sampled step owns the profiler."""
            import tempfile
            from urllib.parse import parse_qs, urlparse

            from ..runtime.profiler import PROFILER

            try:
                q = parse_qs(urlparse(self.path).query)
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                ms = (float(q["ms"][0]) if "ms" in q
                      else float(body.get("ms", 100.0)))
                if not 0.0 < ms <= 60_000.0:  # NaN included
                    raise ValueError(ms)
            except (ValueError, TypeError, AttributeError):
                self._json(400, {"error": "bad request: ms must be in "
                                          "(0, 60000]"})
                return
            base = state.profile_dir or tempfile.mkdtemp(prefix="dlprof-")
            target = os.path.join(base,
                                  f"profile-{int(time.time() * 1e3):x}")
            try:
                out = PROFILER.capture(target, ms)
            except RuntimeError as e:  # a capture is already running
                self._json(409, {"error": str(e)}, retry_after=ms / 1e3)
                return
            self._json(200, {"status": "ok", **out})

        def _metrics(self) -> None:
            """GET /metrics: Prometheus text from the /stats summary."""
            from ..runtime.profiler import COMPILES, hbm_ledger
            from ..runtime.trace import TRACER, render_prometheus

            if state._scheduler is None:
                payload, mode, st = None, "legacy", "off"
            else:
                payload, mode, st = (state._scheduler.summary(),
                                     "scheduler", None)
            payload = dict(payload or {})
            if state.autosize:
                payload["autosize"] = state.autosize
            if "compiles" not in payload:
                payload["compiles"] = COMPILES.summary()
            if "hbm" not in payload:
                payload["hbm"] = hbm_ledger(state.engine)
            if "spec" not in payload:
                payload["spec"] = state.spec_stats.summary()
            data = render_prometheus(payload, tracer=TRACER,
                                     model=state.model_name,
                                     mode=mode, state=st,
                                     build=state.build_info()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _readyz(self) -> None:
            """Ready = engine healthy AND queue under its bound AND not
            draining; 503 with Retry-After otherwise."""
            if state.lost is not None:
                self._json(503, {"status": "lost", "error": state.lost})
            elif state.draining:
                self._json(503, {"status": "draining"}, retry_after=1.0)
            elif state._scheduler is None:
                self._json(200, {"status": "ready", "scheduler": "off"})
            else:
                sup = state._scheduler
                if sup.ready:
                    self._json(200, {"status": "ready", "state": sup.state})
                else:
                    self._json(503, {"status": "unready", "state": sup.state},
                               retry_after=sup._retry_after())

        def do_POST(self):
            if self.path.startswith("/admin/"):
                if self._admin_denied():
                    return
                if (self.path == "/admin/profile"
                        or self.path.startswith("/admin/profile?")):
                    self._admin_profile()
                    return
                if self.path == "/admin/reset_breaker":
                    self._admin_reset_breaker()
                    return
                why = _unported_route(self.path)
                if why:
                    self._json(501, {"error": why})
                else:
                    self._json(404, {"error": "not found"})
                return
            routes = ("/v1/chat/completions", "/v1/completions",
                      "/v1/batch/completions")
            if self.path not in routes:
                self._json(404, {"error": "not found"})
                return
            if state.draining:
                self._json(503, {"error": "server draining"},
                           retry_after=2.0)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:  # json.JSONDecodeError is a ValueError
                self._json(400, {"error": "bad request"})
                return
            if self.path == "/v1/batch/completions":
                self._batch_post(body)
                return
            self._completion_post(body,
                                  chat=self.path == "/v1/chat/completions")

        def _batch_post(self, body: dict) -> None:
            """POST /v1/batch/completions (JAX apps/api_server.py:1428):
            the chat.completion shape with one choice a row (index = row);
            SSE chunks name their row in `index`."""
            if state.serve_batch <= 0:
                self._json(404, {"error": "batch endpoint off (start with "
                                          "--serve-batch N)"})
                return
            rid = f"batchcmpl-{int(time.time() * 1000):x}"
            created = int(time.time())
            stream = bool(body.get("stream", False))
            gen = _batch_completion_chunks(state, body)
            try:
                first = next(gen)
            except (PromptTooLong, BadRequest) as e:
                self._json(400, {"error": str(e)})
                return
            except EngineUnready as e:
                # the borrow is refused while recovering or draining
                self._json(503, {"error": str(e), "state": e.state},
                           retry_after=e.retry_after)
                return
            except Exception as e:  # noqa: BLE001 — the borrow's recovery
                # already ran (EngineSupervisor.exclusive): a retryable 503
                self._json(503, {"error": f"engine failure: "
                                          f"{type(e).__name__}: {e}"},
                           retry_after=1.0)
                return

            def events():
                yield first
                yield from gen

            if stream:
                self._sse_start()
                usage = None
                try:
                    for kind, payload in events():
                        if kind == "piece":
                            i, piece = payload
                            self._sse(_chunk_env(rid, created,
                                                 state.model_name, i,
                                                 {"content": piece}, None))
                        elif kind == "keepalive":
                            # an SSE comment: bytes on the wire while the
                            # collected lookup run goes on
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                        else:
                            usage = payload
                except Exception as e:  # noqa: BLE001 — after the 200: a
                    # structured error event and a terminated stream
                    self._sse({"error": f"engine failure: "
                                        f"{type(e).__name__}: {e}"})
                    self._sse_done()
                    return
                for i, fr in enumerate(usage["finish_reasons"]):
                    self._sse(_chunk_env(rid, created, state.model_name,
                                         i, {}, fr))
                self._sse_done()
                return

            texts: dict[int, str] = {}
            usage = None
            for kind, payload in events():
                if kind == "piece":
                    i, piece = payload
                    texts[i] = texts.get(i, "") + piece
                elif kind == "done":
                    usage = payload
            self._json(200, _completion_env(
                rid, created, state.model_name,
                [{"index": i,
                  "message": {"role": "assistant",
                              "content": texts.get(i, "")},
                  "finish_reason": fr}
                 for i, fr in enumerate(usage["finish_reasons"])],
                usage["prompt_tokens"], usage["completion_tokens"]))

        def _completion_post(self, body: dict, chat: bool) -> None:
            """/v1/chat/completions (chat=True) and /v1/completions."""
            rid = (f"{'chatcmpl' if chat else 'cmpl'}-"
                   f"{int(time.time() * 1000):x}")
            created = int(time.time())
            stream = bool(body.get("stream", False))
            use_sched = state.serve_batch > 0
            lock = (contextlib.nullcontext() if use_sched
                    else state.engine_lock)
            with lock:
                # pull the first event before committing a 200, so prompt
                # and admission errors still get a clean 4xx
                gen = (_sched_completion_chunks(state, body, chat=chat)
                       if use_sched else _completion_chunks(state, body))
                try:
                    first = next(gen)
                except PromptTooLong as e:
                    self._json(400, {"error": str(e)})
                    return
                except QueueFull as e:
                    self._json(429, {"error": str(e)},
                               retry_after=e.retry_after)
                    return
                except EngineUnready as e:
                    self._json(503, {"error": str(e), "state": e.state},
                               retry_after=e.retry_after)
                    return

                def events():
                    yield first
                    yield from gen

                if chat:
                    def piece_env(p):
                        return _chunk_env(rid, created, state.model_name, 0,
                                          {"content": p}, None)

                    def final_env(fr):
                        return _chunk_env(rid, created, state.model_name, 0,
                                          {}, fr)
                else:
                    def piece_env(p):
                        return _text_chunk_env(rid, created,
                                               state.model_name, p, None)

                    def final_env(fr):
                        return _text_chunk_env(rid, created,
                                               state.model_name, "", fr)

                if stream:
                    self._sse_start()
                    usage = None
                    for kind, payload in events():
                        if kind == "piece":
                            self._sse(piece_env(payload))
                        else:
                            usage = payload
                    if usage.get("error"):
                        # mid-stream failure: an explicit structured error
                        # event, then a terminated stream
                        self._sse({"error": usage["error"]})
                    self._sse(final_env(usage["finish_reason"]))
                    self._sse_done()
                    return

                text = ""
                usage = {"finish_reason": "length", "prompt_tokens": 0,
                         "completion_tokens": 0}
                for kind, payload in events():
                    if kind == "piece":
                        text += payload
                    else:
                        usage = payload
                if usage.get("error") and not text:
                    # failed before any output: a retryable status
                    self._json(503, {"error": usage["error"]},
                               retry_after=1.0)
                    return
                if chat:
                    self._json(200, _completion_env(
                        rid, created, state.model_name,
                        [{"index": 0,
                          "message": {"role": "assistant", "content": text},
                          "finish_reason": usage["finish_reason"]}],
                        usage["prompt_tokens"], usage["completion_tokens"]))
                else:
                    self._json(200, _text_completion_env(
                        rid, created, state.model_name, text,
                        usage["finish_reason"], usage["prompt_tokens"],
                        usage["completion_tokens"]))

    return Handler


def configure_observability(args) -> None:
    """The flight recorder and the step sampler from the CLI's flags, with
    the JAX server's refusals (apps/api_server.py:1901-1941): the
    recorder's knobs need --trace, and --profile-sample needs
    --serve-batch (it samples scheduler steps) and N >= 1."""
    if not args.trace and (args.trace_dir or args.trace_sample is not None
                           or args.trace_buffer is not None
                           or args.trace_decode_every is not None):
        sys.exit("error: --trace-dir/--trace-sample/--trace-buffer/"
                 "--trace-decode-every have no effect without --trace")
    if args.trace:
        from ..runtime.trace import TRACER

        if args.trace_sample is not None and not 0.0 <= args.trace_sample <= 1.0:
            sys.exit("error: --trace-sample must be in [0, 1]")
        TRACER.configure(
            capacity=args.trace_buffer or 8192,
            sample=1.0 if args.trace_sample is None else args.trace_sample,
            decode_every=args.trace_decode_every or 8,
            sink_dir=args.trace_dir)
    if (args.freeze_compiles or args.profile_sample is not None) \
            and not args.serve_batch:
        sys.exit("error: --freeze-compiles/--profile-sample require "
                 "--serve-batch N (the sentinel arms at scheduler "
                 "warmup; the sampler hooks scheduler steps)")
    if args.profile_sample is not None and args.profile_sample < 1:
        sys.exit("error: --profile-sample must be >= 1 (time every Nth "
                 "step; omit the flag to disable)")
    from ..runtime.profiler import COMPILES, PROFILER

    if args.freeze_compiles:
        # the sentinel refuses only on an engine that warmup marked warm,
        # so setting it before the supervisor's warmup is safe
        COMPILES.freeze = True
    if args.profile_sample is not None:
        PROFILER.sample_every = args.profile_sample


def build_server(args, mesh=None,
                 control=None) -> tuple[ThreadingHTTPServer, ApiState]:
    """The CLI's engine, its ApiState and a threaded server bound to
    --host/--port (port 0: any free port, in server.server_address). The
    prefix cache's block length is validated against the engine's context
    before the server binds; --serve-batch auto and --prefix-blocks auto
    resolve against the built engine; --session resumes a legacy-path
    session. Over ranks (`mesh`, `control`: rank 0 of `dllama api --tp`)
    the engine is rank 0's shard, mirrored to the other ranks."""
    from .dllama import (build_engine, check_admission_flags,
                         check_serve_flags)

    autotune_art = check_admission_flags(args)
    check_serve_flags(args)
    configure_observability(args)
    engine, tokenizer, sampler = build_engine(args, mesh)
    if control is not None:
        control.attach(engine)
    if args.draft:
        # the depth bound needs the model's spec: refused at startup, not
        # on the first request (parse_draft_spec vetted the format)
        from ..runtime.draft import parse_draft_spec

        kind, arg = parse_draft_spec(args.draft)
        if kind == "self" and not 1 <= int(arg) < engine.spec.n_layers:
            sys.exit(f"error: --draft self:{arg}: depth must be in "
                     f"1..{engine.spec.n_layers - 1} (the model has "
                     f"{engine.spec.n_layers} layers)")
        if kind == "model" and engine.mesh is not None:
            # JAX apps/api_server.py:1978-1986
            sys.exit("error: --draft model:PATH needs a mesh-less engine "
                     "(use --draft self:<depth>, which shares the target's "
                     "sharded buffers)")
    block_len = args.prefix_block_len or 32
    if args.prefix_cache and not 1 <= block_len <= engine.seq_len:
        sys.exit(f"error: --prefix-block-len {block_len} outside 1.."
                 f"{engine.seq_len} (the engine context)")
    serve_batch, prefix_blocks = args.serve_batch, args.prefix_blocks or 0
    autosize = None
    if serve_batch == "auto" or prefix_blocks == "auto":
        # resolve against the built engine's ledger, once, before any
        # scheduler exists (JAX apps/api_server.py:2004-2030)
        from ..runtime.profiler import decision_bytes, resolve_auto_shape

        try:
            autosize = resolve_auto_shape(
                engine, serve_batch=serve_batch, prefix_blocks=prefix_blocks,
                prefix_block_len=block_len, autotune=autotune_art,
                slo_itl_ms=args.slo_itl_ms)
        except ValueError as e:
            sys.exit(f"error: {e}")
        serve_batch = autosize["serve_batch"]
        prefix_blocks = autosize["prefix_blocks"]
        inp = autosize["inputs"]
        # both auto caps read the same headroom: a decision whose slots
        # and arena together exceed it would fail its first allocation
        need, room = decision_bytes(autosize), inp["headroom_bytes"]
        if room is not None and need > room:
            sys.exit(f"error: the auto-sized --serve-batch {serve_batch} "
                     f"and --prefix-blocks {prefix_blocks} need {need} "
                     f"bytes of KV slots and arena, over the device's "
                     f"{room} bytes of headroom: pass a smaller "
                     f"--serve-batch or --prefix-blocks")
        print(f"⚖️  auto-sized: --serve-batch {serve_batch} "
              f"({autosize['serve_batch_basis']})"
              + (f", --prefix-blocks {prefix_blocks} "
                 f"({autosize['prefix_blocks_basis']})"
                 if args.prefix_blocks == "auto" else "")
              + f" — knee={inp['knee_rows']} [{inp['knee_basis']}], "
                f"headroom_bytes={inp['headroom_bytes']}, "
                f"slots_addable={inp['slots_addable']}", flush=True)
    state = ApiState(engine, tokenizer, sampler,
                     lookup_decode=args.lookup_decode,
                     draft=args.draft,
                     draft_len=(args.draft_len or 7) if args.draft else 0,
                     serve_batch=serve_batch,
                     serve_chunk=args.serve_chunk,
                     queue_depth=args.queue_depth,
                     request_deadline=args.request_deadline,
                     stall_timeout=args.stall_timeout,
                     prefix_cache=bool(args.prefix_cache),
                     prefix_blocks=prefix_blocks,
                     prefix_block_len=block_len,
                     admin_token=args.admin_token,
                     profile_dir=args.profile_dir,
                     slo_ttft_ms=args.slo_ttft_ms,
                     slo_itl_ms=args.slo_itl_ms,
                     autosize=autosize)
    if args.session and os.path.exists(args.session):
        load_server_session(state, args.session)
        print(f"💾 resumed session from {args.session} "
              f"({engine.pos} cached positions)")
    return ThreadingHTTPServer((args.host, args.port), make_handler(state)), state


def finish(state: ApiState, drain_timeout: float,
           session: str | None = None) -> bool:
    """Stop admitting, let in-flight scheduler work finish for up to
    drain_timeout seconds, then close the supervisor (stragglers get
    structured shutdown frames); with `session`, save the legacy path's
    session. Returns whether the drain completed."""
    state.draining = True
    drained = True
    if state._scheduler is not None:
        drained = state._scheduler.drain(timeout=drain_timeout)
        state._scheduler.close()
    if session and state.lost is not None:
        print(f"💾 a rank is lost: the session is not saved (leaving "
              f"{session} untouched)")
    elif session:
        if save_server_session(state, session):
            print(f"💾 saved session to {session} "
                  f"({state.engine.pos} cached positions)")
        else:
            print("💾 no completed session to save "
                  f"(leaving {session} untouched)")
    return drained


def serve(args, mesh=None, control=None) -> None:
    """`dllama api`: serve until SIGTERM or Ctrl-C, then drain. Over ranks
    (rank 0 of `dllama api --tp`), a lost rank stops the server too, and
    the process exits non-zero with the reason."""
    server, state = build_server(args, mesh, control)

    def _begin_drain(*_):
        # SIGTERM: POSTs 503 and /readyz unready at once; serve_forever
        # returns and the finally below drains in-flight work
        state.draining = True
        threading.Thread(target=server.shutdown, daemon=True).start()

    def _lost(why: str) -> None:
        state.lost = why
        print(f"🔌 {why}", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    if control is not None:
        control.on_lost(_lost)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _begin_drain)
    host, port = server.server_address[:2]
    print(f"🔌 dllama-api listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if finish(state, args.drain_timeout, session=args.session):
            print("🔌 drained: all in-flight requests completed")
        else:
            print(f"🔌 drain deadline ({args.drain_timeout:.0f}s) elapsed; "
                  "failing stragglers")
    if state.lost is not None:
        sys.exit(f"error: {state.lost}")
