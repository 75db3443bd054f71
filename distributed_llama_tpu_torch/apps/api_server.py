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

Not ported (each refused with a message naming its ROADMAP item):
/v1/batch/completions, the /admin/* routes, replicas and the router, and
tenants.
"""

from __future__ import annotations

import contextlib
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

UNPORTED_ROUTES = {
    "/v1/batch/completions": "the batch endpoint needs generate_batch "
                             "(ROADMAP item 10b)",
    "/admin/": "the operator routes are not ported yet (ROADMAP item 10c)",
}


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
                 draft_len: int = 0):
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
        # the legacy path's prompt-lookup draft length (0 = off), and the
        # --draft spec string with its draft length: the scheduler path
        # builds its draft per generation, the legacy path one DraftModel
        # over this engine on first use (draft_model())
        self.lookup_decode = lookup_decode
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
        # the legacy path's token history whose K/V is live in the cache
        self.cached_tokens: list[int] = []
        # serializes the legacy path's requests
        self.engine_lock = threading.RLock()
        self._build_info: dict | None = None
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
        from ..runtime.engine import Engine
        from ..runtime.resilience import EngineSupervisor

        eng = self.engine

        def engine_factory():
            return Engine(eng.spec, eng.params, device=eng.device,
                          batch=self.serve_batch, max_seq_len=eng.seq_len,
                          compute_dtype=eng.compute_dtype,
                          cache_dtype=eng.cache_dtype,
                          prefill_chunk=eng.prefill_chunk,
                          activation_q80=eng.activation_q80,
                          cuda_graphs=eng.cuda_graphs)

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
    for prefix, why in UNPORTED_ROUTES.items():
        if path.startswith(prefix):
            return f"{path} is not ported: {why}"
    return None


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
                # would cut the drain short)
                self._json(200, {"status": "draining" if state.draining
                                 else "ok",
                                 "build": state.build_info()})
            elif self.path == "/readyz":
                self._readyz()
            elif self.path == "/stats":
                # the legacy tier's accept record answers too
                self._json(200, {"scheduler": "off",
                                 "spec": state.spec_stats.summary()}
                           if state._scheduler is None
                           else state._scheduler.summary())
            elif self.path == "/metrics":
                self._metrics()
            elif _unported_route(self.path):
                self._json(501, {"error": _unported_route(self.path)})
            else:
                self._json(404, {"error": "not found"})

        def _metrics(self) -> None:
            """GET /metrics: Prometheus text from the /stats summary."""
            from ..runtime.profiler import COMPILES, hbm_ledger
            from ..runtime.trace import render_prometheus

            if state._scheduler is None:
                payload, mode, st = None, "legacy", "off"
            else:
                payload, mode, st = (state._scheduler.summary(),
                                     "scheduler", None)
            payload = dict(payload or {})
            if "compiles" not in payload:
                payload["compiles"] = COMPILES.summary()
            if "hbm" not in payload:
                payload["hbm"] = hbm_ledger(state.engine)
            if "spec" not in payload:
                payload["spec"] = state.spec_stats.summary()
            data = render_prometheus(payload, model=state.model_name,
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
            if state.draining:
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
            why = _unported_route(self.path)
            if why:
                self._json(501, {"error": why})
                return
            if self.path not in ("/v1/chat/completions", "/v1/completions"):
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
            self._completion_post(body,
                                  chat=self.path == "/v1/chat/completions")

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


def build_server(args) -> tuple[ThreadingHTTPServer, ApiState]:
    """The CLI's engine, its ApiState and a threaded server bound to
    --host/--port (port 0: any free port, in server.server_address). The
    prefix cache's block length is validated against the engine's context
    before the server binds; --session resumes a legacy-path session."""
    from .dllama import build_engine

    engine, tokenizer, sampler = build_engine(args)
    if args.draft:
        # the depth bound needs the model's spec: refused at startup, not
        # on the first request (parse_draft_spec vetted the format)
        from ..runtime.draft import parse_draft_spec

        kind, arg = parse_draft_spec(args.draft)
        if kind == "self" and not 1 <= int(arg) < engine.spec.n_layers:
            sys.exit(f"error: --draft self:{arg}: depth must be in "
                     f"1..{engine.spec.n_layers - 1} (the model has "
                     f"{engine.spec.n_layers} layers)")
    block_len = args.prefix_block_len or 32
    if args.prefix_cache and not 1 <= block_len <= engine.seq_len:
        sys.exit(f"error: --prefix-block-len {block_len} outside 1.."
                 f"{engine.seq_len} (the engine context)")
    state = ApiState(engine, tokenizer, sampler,
                     lookup_decode=args.lookup_decode,
                     draft=args.draft,
                     draft_len=(args.draft_len or 7) if args.draft else 0,
                     serve_batch=args.serve_batch,
                     serve_chunk=args.serve_chunk,
                     queue_depth=args.queue_depth,
                     request_deadline=args.request_deadline,
                     stall_timeout=args.stall_timeout,
                     prefix_cache=bool(args.prefix_cache),
                     prefix_blocks=args.prefix_blocks or 0,
                     prefix_block_len=block_len)
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
    if session:
        if save_server_session(state, session):
            print(f"💾 saved session to {session} "
                  f"({state.engine.pos} cached positions)")
        else:
            print("💾 no completed session to save "
                  f"(leaving {session} untouched)")
    return drained


def serve(args) -> None:
    """`dllama api`: serve until SIGTERM or Ctrl-C, then drain."""
    server, state = build_server(args)

    def _begin_drain(*_):
        # SIGTERM: POSTs 503 and /readyz unready at once; serve_forever
        # returns and the finally below drains in-flight work
        state.draining = True
        threading.Thread(target=server.shutdown, daemon=True).start()

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
