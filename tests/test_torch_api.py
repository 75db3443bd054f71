"""The port's `dllama api` server held against the JAX package's on the
tiny fixture, on the CPU, all f32: the routes this slice ports (the cases
of tests/test_apps.py for /v1/models, /v1/chat/completions,
/v1/completions, SSE, /healthz, /readyz, /stats, /metrics, drain, the
structured mid-stream error frame, the 429 and the clean 400), with and
without --serve-batch. The same greedy request must give the JAX server's
text, streamed or not, on either path.
"""

import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import pytest

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.runtime.faults import FAULTS

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import numpy as np

    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(42), seq_len=192)


def _serve(state, make_handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _port_state(files, **kw):
    mpath, tpath = files
    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
         "--seed", "3", "--device", "cpu", *F32])
    engine, tokenizer, sampler = dllama.build_engine(args)
    return api_server.ApiState(engine, tokenizer, sampler, model_name="tiny", **kw)


def _jax_state(files, **kw):
    mpath, tpath = files
    args = jax_dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
         "--seed", "3", *F32])
    engine, tokenizer, sampler = jax_dllama.build_engine(args)
    return jax_api.ApiState(engine, tokenizer, sampler, model_name="tiny", **kw)


@pytest.fixture(scope="module")
def servers(files):
    """{(package, path): (address, state)}: the port's and the JAX
    package's server, each on the legacy path and with --serve-batch 2."""
    out, made = {}, []
    for pkg, mk_state, handler in (("port", _port_state, api_server.make_handler),
                                   ("jax", _jax_state, jax_api.make_handler)):
        for path, kw in (("legacy", {}), ("sched", dict(serve_batch=2, serve_chunk=16))):
            state = mk_state(files, **kw)
            server = _serve(state, handler)
            made.append((server, state))
            out[(pkg, path)] = (server.server_address, state)
    yield out
    for server, state in made:
        server.shutdown()
        if state._scheduler is not None:
            state._scheduler.close()


def _post(addr, path, body, timeout=240):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    return conn.getresponse()


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", path)
    return conn.getresponse()


def _sse_events(raw: str) -> list:
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events and events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _text(addr, route, body):
    """The completion's text, usage and finish reason, streamed or not."""
    resp = _post(addr, route, body)
    assert resp.status == 200
    if body.get("stream"):
        parsed = _sse_events(resp.read().decode())
        key = "delta" if route.endswith("chat/completions") else None
        pieces = [(p["choices"][0]["delta"].get("content", "") if key
                   else p["choices"][0]["text"]) for p in parsed]
        return "".join(pieces), None, parsed[-1]["choices"][0]["finish_reason"]
    out = json.loads(resp.read())
    choice = out["choices"][0]
    text = choice["message"]["content"] if "message" in choice else choice["text"]
    return text, out["usage"], choice["finish_reason"]


CHAT = {"messages": [{"role": "user", "content": "abba"}], "max_tokens": 6,
        "temperature": 0}
RAW = {"prompt": "ab", "max_tokens": 5, "temperature": 0}


@pytest.mark.parametrize("path", ["legacy", "sched"])
@pytest.mark.parametrize("route,body", [("/v1/chat/completions", CHAT),
                                        ("/v1/completions", RAW)])
@pytest.mark.parametrize("stream", [False, True])
def test_greedy_text_matches_jax_server(servers, path, route, body, stream):
    body = dict(body, stream=stream)
    got = _text(servers[("port", path)][0], route, body)
    want = _text(servers[("jax", path)][0], route, body)
    assert got == want
    assert got[2] in ("stop", "length")
    if not stream:
        usage = got[1]
        assert usage["completion_tokens"] <= body["max_tokens"]
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]


def test_stop_sequence_and_seed_match_jax_server(servers):
    """Per-request stop, temperature and seed on the scheduler path."""
    for body, finish in (({**RAW, "max_tokens": 12, "stop": ["S"]}, "stop"),
                         ({**CHAT, "temperature": 0.9, "seed": 7, "max_tokens": 8},
                          "length")):
        got = _text(servers[("port", "sched")][0], "/v1/chat/completions", body)
        assert got == _text(servers[("jax", "sched")][0], "/v1/chat/completions", body)
        assert got[2] == finish and got[1]["completion_tokens"] < body["max_tokens"] + 1


def test_models_route(servers):
    resp = _get(servers[("port", "legacy")][0], "/v1/models")
    assert resp.status == 200
    assert json.loads(resp.read())["data"][0]["id"] == "tiny"


def test_healthz_readyz_routes(servers):
    addr = servers[("port", "legacy")][0]
    for path, want in (("/healthz", "ok"), ("/readyz", "ready"), ("/", "ok")):
        resp = _get(addr, path)
        assert resp.status == 200, path
        body = json.loads(resp.read())
        assert body["status"] == want
    build = json.loads(_get(addr, "/healthz").read())["build"]
    assert build["device"] == "cpu" and build["torch"]


def test_readyz_scheduler_states_and_stats(files):
    """/readyz and /stats: the supervisor is built, warmed up and ready
    before the server binds (no request has built it), with its state and
    counters after a request."""
    state = _port_state(files, serve_batch=2, serve_chunk=16)
    sup = state._scheduler
    assert sup is not None and sup.ready and sup.engine._compile_warm
    server = _serve(state, api_server.make_handler)
    try:
        addr = server.server_address
        assert json.loads(_get(addr, "/readyz").read()) == {"status": "ready",
                                                            "state": "ready"}
        s = json.loads(_get(addr, "/stats").read())
        assert s["state"] == "ready" and s["requests_submitted"] == 0
        assert _post(addr, "/v1/completions", RAW).status == 200
        assert state._scheduler is sup
        resp = _get(addr, "/readyz")
        assert resp.status == 200 and json.loads(resp.read())["state"] == "ready"
        s = json.loads(_get(addr, "/stats").read())
        assert s["state"] == "ready" and s["resilience"]["recoveries"] == 0
        assert s["requests_finished"] >= 1 and s["tokens_out"] >= 1
        assert s["ttft_p50_ms"] is not None and s["ttft_p50_ms"] >= 0
        assert s["hbm"]["kv_slot_bytes"] > 0
        metrics = _get(addr, "/metrics").read().decode()
        assert 'dllama_up{model="tiny",mode="scheduler"} 1' in metrics
        assert "dllama_tokens_out_total" in metrics
        assert 'dllama_state{state="ready"} 1' in metrics
    finally:
        server.shutdown()
        state._scheduler.close()


def test_legacy_stats_and_metrics(servers):
    """The legacy tier answers /stats with the scheduler off, its
    speculative accept record (mode "off" here) and the transfer and fleet
    blocks (enabled=False), as the JAX server does."""
    addr = servers[("port", "legacy")][0]
    stats = json.loads(_get(addr, "/stats").read())
    jstats = json.loads(_get(servers[("jax", "legacy")][0], "/stats").read())
    assert set(stats) == {"scheduler", "spec", "kv_transfer", "fleet"}
    assert stats == {k: jstats[k] for k in stats}
    assert stats["scheduler"] == "off" and stats["spec"]["mode"] == "off"
    metrics = _get(addr, "/metrics").read().decode()
    assert 'mode="legacy"' in metrics and 'dllama_state{state="off"} 1' in metrics
    assert 'dllama_spec_mode{mode="off",draft_len="0"} 1' in metrics


def test_prompt_too_long_clean_400(servers):
    for path in ("sched", "legacy"):
        addr = servers[("port", path)][0]
        resp = _post(addr, "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "x" * 400}],
                      "max_tokens": 2, "temperature": 0})
        assert resp.status == 400
        assert "tokens" in json.loads(resp.read())["error"]
        assert _post(addr, "/v1/completions", {**RAW, "max_tokens": 2}).status == 200


def test_bad_json_and_unported_routes(servers):
    addr = servers[("port", "sched")][0]
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/v1/completions", "{not json", {"Content-Type": "application/json"})
    assert conn.getresponse().status == 400
    # the breaker reset on a healthy supervisor is a no-op that answers
    # the state; a replica verb on a single supervisor is the JAX
    # server's 400 (JAX apps/api_server.py:1351)
    for path, code in (("/admin/reset_breaker", 200),
                       ("/admin/drain_replica", 400)):
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("POST", path, "{}")
        resp = conn.getresponse()
        assert resp.status == code, path
        body = json.loads(resp.read())
        if code == 400:
            assert body == {"error": "replica operations need --replicas N > 1 "
                                     "and a replica index"}
        else:
            assert body == {"status": "ok", "state": "ready"}
    assert _get(addr, "/no/such/route").status == 404


def test_draining_rejects_posts_but_stays_alive(servers):
    addr, state = servers[("port", "sched")]
    state.draining = True
    try:
        resp = _post(addr, "/v1/completions", {"prompt": "ab", "max_tokens": 2})
        assert resp.status == 503 and resp.getheader("Retry-After") is not None
        resp = _get(addr, "/readyz")
        assert resp.status == 503 and json.loads(resp.read())["status"] == "draining"
        resp = _get(addr, "/healthz")
        assert resp.status == 200 and json.loads(resp.read())["status"] == "draining"
    finally:
        state.draining = False


def test_threaded_concurrent_streaming_clients(servers):
    """Two concurrent streaming clients through the shared scheduler: both
    complete with well-formed SSE and the JAX server's text."""
    addr = servers[("port", "sched")][0]
    jaddr = servers[("jax", "sched")][0]
    bodies = {"a": {"messages": [{"role": "user", "content": "ab"}], "max_tokens": 6,
                    "temperature": 0, "stream": True},
              "b": {"messages": [{"role": "user", "content": "abab baba abba x"}],
                    "max_tokens": 9, "temperature": 0, "stream": True}}
    results = {}

    def client(key):
        resp = _post(addr, "/v1/chat/completions", bodies[key])
        results[key] = (resp.status, resp.getheader("Content-Type"), resp.read().decode())

    threads = [threading.Thread(target=client, args=(k,)) for k in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    for key, body in bodies.items():
        status, ctype, raw = results[key]
        assert status == 200 and ctype.startswith("text/event-stream")
        parsed = _sse_events(raw)
        assert all(p["object"] == "chat.completion.chunk" for p in parsed)
        assert all(p["choices"][0]["index"] == 0 for p in parsed)
        finals = [p for p in parsed if p["choices"][0]["finish_reason"]]
        assert len(finals) == 1
        text = "".join(p["choices"][0]["delta"].get("content", "") for p in parsed)
        assert text == _text(jaddr, "/v1/chat/completions", body)[0]


def test_sched_greedy_matches_legacy_single(servers):
    """Continuous batching is a scheduling change, not a sampling one: the
    scheduler's greedy text equals the legacy path's."""
    assert (_text(servers[("port", "sched")][0], "/v1/chat/completions", CHAT)
            == _text(servers[("port", "legacy")][0], "/v1/chat/completions", CHAT))


def test_sse_midstream_error_frame(files):
    """A client streaming when the step loop crashes gets a structured
    error event and a terminated stream; the supervisor recovers."""
    state = _port_state(files, serve_batch=2, serve_chunk=16)
    server = _serve(state, api_server.make_handler)
    addr = server.server_address
    try:
        FAULTS.arm("slow_step", times=0, ms=25.0)
        resp = _post(addr, "/v1/completions", {"prompt": "abab", "max_tokens": 5000,
                                               "temperature": 0, "stream": True})
        assert resp.status == 200
        first = b""
        while not first.strip():
            first = resp.fp.readline()
        FAULTS.arm("step_raise")
        raw = first.decode() + resp.read().decode()
        parsed = _sse_events(raw)
        errs = [p for p in parsed if "error" in p]
        assert len(errs) == 1, raw[-500:]
        assert errs[0]["error"]["code"] == "engine_error"
        assert "injected step_raise" in errs[0]["error"]["message"]
        finals = [p for p in parsed if p.get("choices") and p["choices"][0]["finish_reason"]]
        assert finals and finals[-1]["choices"][0]["finish_reason"] == "error"
        sup = state._scheduler
        t0 = time.perf_counter()
        while not sup.ready and time.perf_counter() - t0 < 30.0:
            time.sleep(0.05)
        assert sup.ready, sup.state
        FAULTS.clear()
        assert _post(addr, "/v1/completions", {**RAW, "max_tokens": 2}).status == 200
        assert sup.sup_stats.recoveries == 1
    finally:
        FAULTS.clear()
        server.shutdown()
        state._scheduler.close()


def test_queue_overflow_429_retry_after(files):
    """One slot and one queue seat: the third concurrent request gets a
    fast 429 with Retry-After, and /readyz reports the full queue."""
    state = _port_state(files, serve_batch=1, serve_chunk=16, queue_depth=1)
    server = _serve(state, api_server.make_handler)
    addr = server.server_address
    results = {}

    def client(key, n):
        resp = _post(addr, "/v1/completions", {"prompt": "abab", "max_tokens": n,
                                               "temperature": 0, "stream": True})
        results[key] = (resp.status, resp.read().decode())

    try:
        FAULTS.arm("slow_step", times=0, ms=60.0)
        a = threading.Thread(target=client, args=("a", 30), daemon=True)
        a.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30.0:
            sup = state._scheduler
            if sup is not None and any(s.req is not None for s in sup._sched.slots):
                break
            time.sleep(0.02)
        b = threading.Thread(target=client, args=("b", 2), daemon=True)
        b.start()
        t0 = time.perf_counter()
        while len(state._scheduler._sched._queue) < 1:
            assert time.perf_counter() - t0 < 30.0, "B never queued"
            time.sleep(0.02)
        resp = _post(addr, "/v1/completions", {**RAW, "max_tokens": 2}, timeout=60)
        assert resp.status == 429
        assert int(resp.getheader("Retry-After")) >= 1
        assert "queue full" in json.loads(resp.read())["error"]
        assert _get(addr, "/readyz").status == 503
        FAULTS.clear()
        a.join(timeout=240)
        b.join(timeout=240)
        assert not a.is_alive() and not b.is_alive()
        assert results["a"][0] == 200 and results["b"][0] == 200
        assert state._scheduler.stats.requests_rejected == 1
    finally:
        FAULTS.clear()
        server.shutdown()
        state._scheduler.close()


def test_cli_api_mode_serves_and_drains(files):
    """`dllama api` through build_server and finish, as serve() runs them:
    bound to port 0, answers, and the drain closes the supervisor."""
    mpath, tpath = files
    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--host", "127.0.0.1",
         "--port", "0", "--serve-batch", "2", "--temperature", "0",
         "--device", "cpu", *F32])
    server, state = api_server.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        got = _text(server.server_address, "/v1/chat/completions", CHAT)
        assert got[2] in ("stop", "length")
        assert state.serve_batch == 2 and state._scheduler.engine.batch == 2
        assert state._scheduler.engine.params is state.engine.params
    finally:
        server.shutdown()
        server.server_close()
        assert api_server.finish(state, drain_timeout=10.0)
    assert state._scheduler.state == "closed"


# -- KV reuse: the prefix cache on the scheduler path, sessions on the legacy one --

SHARED = "You are a terse assistant. Answer in one word. "


def test_prefix_cache_stats_and_text_match_jax_server(files):
    """--prefix-cache with --serve-batch: two requests sharing a prefix of
    whole blocks give the JAX server's text, the second one hits, and
    /stats and /metrics carry the prefix cache's block and families with
    the JAX server's counters."""
    bodies = [{"prompt": SHARED + q, "max_tokens": 5, "temperature": 0}
              for q in ("ab", "cd?")]
    kw = dict(serve_batch=2, serve_chunk=16, prefix_cache=True, prefix_block_len=8)
    out = {}
    for pkg, mk_state, handler in (("port", _port_state, api_server.make_handler),
                                   ("jax", _jax_state, jax_api.make_handler)):
        state = mk_state(files, **kw)
        server = _serve(state, handler)
        try:
            texts = [_text(server.server_address, "/v1/completions", b) for b in bodies]
            stats = json.loads(_get(server.server_address, "/stats").read())
            metrics = _get(server.server_address, "/metrics").read().decode()
            out[pkg] = texts, stats["prefix_cache"], metrics
        finally:
            server.shutdown()
            state._scheduler.close()
    (texts, pc, metrics), (jtexts, jpc, _) = out["port"], out["jax"]
    assert texts == jtexts
    prefilled = pc.pop("tokens_prefilled")         # the JAX summary leaves it out
    assert pc == jpc
    assert prefilled > 0 and f"dllama_prefix_cache_tokens_prefilled_total {prefilled}" in metrics
    seq = 192
    assert pc["hits"] == 1 and pc["tokens_saved"] > 0 and pc["block_len"] == 8
    assert pc["num_blocks"] == 2 * 2 * seq // 8      # the 2 x B x context default
    assert f"dllama_prefix_cache_hits_total 1" in metrics
    assert 'dllama_hbm_bytes{category="prefix_arena"}' in metrics


def test_session_legacy_roundtrip_matches_jax(files, tmp_path):
    """--session on the legacy path: a server saves its cached prefix at
    shutdown, a new server resumes it, and a follow-up request that
    extends the first conversation answers as the JAX server does through
    the same restart and as the port does without one."""
    mpath, tpath = files
    first = {"prompt": "abba: cd", "max_tokens": 6, "temperature": 0}
    follow = {"prompt": "abba: cd ef? gh", "max_tokens": 6, "temperature": 0}

    def serve(pkg, session):
        argv = ["api", "--model", mpath, "--tokenizer", tpath, "--host", "127.0.0.1",
                "--port", "0", "--temperature", "0", "--seed", "3", *F32]
        if session:
            argv += ["--session", session]
        if pkg == "port":
            args = dllama.build_argparser().parse_args(argv + ["--device", "cpu"])
            server, state = api_server.build_server(args)
        else:
            args = jax_dllama.build_argparser().parse_args(argv)
            engine, tokenizer, sampler = jax_dllama.build_engine(args)
            state = jax_api.ApiState(engine, tokenizer, sampler, model_name="tiny")
            if session and __import__("os").path.exists(session):
                jax_api.load_server_session(state, session)
            server = ThreadingHTTPServer(("127.0.0.1", 0), jax_api.make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, state

    got = {}
    for pkg in ("port", "jax"):
        sess = str(tmp_path / f"{pkg}.npz")
        server, state = serve(pkg, sess)
        a = _text(server.server_address, "/v1/completions", first)
        server.shutdown()
        if pkg == "port":
            api_server.finish(state, drain_timeout=5.0, session=sess)
        else:
            assert jax_api.save_server_session(state, sess)
        server, state = serve(pkg, sess)
        assert state.cached_tokens and state.engine.pos == len(state.cached_tokens)
        b = _text(server.server_address, "/v1/completions", follow)
        server.shutdown()
        got[pkg] = (a, b)
    assert got["port"] == got["jax"]
    server, state = serve("port", None)
    try:
        assert _text(server.server_address, "/v1/completions", first) == got["port"][0]
        assert _text(server.server_address, "/v1/completions", follow) == got["port"][1]
    finally:
        server.shutdown()


def test_session_save_skipped_without_a_completed_request(files, tmp_path):
    """A shutdown with nothing cached leaves an earlier file untouched."""
    state = _port_state(files)
    path = tmp_path / "s.npz"
    path.write_bytes(b"earlier")
    assert not api_server.save_server_session(state, str(path))
    api_server.finish(state, drain_timeout=1.0, session=str(path))
    assert path.read_bytes() == b"earlier"


@pytest.mark.parametrize("argv,needle", [
    (["--prefix-cache"], "--prefix-cache requires --serve-batch N"),
    (["--prefix-blocks", "8"], "have no effect without --prefix-cache"),
    (["--prefix-block-len", "32"], "have no effect without --prefix-cache"),
    (["--serve-batch", "2", "--prefix-cache", "--prefix-blocks", "-1"],
     "--prefix-blocks must be >= 0"),
    (["--serve-batch", "2", "--prefix-blocks", "auto"], "have no effect without --prefix-cache"),
    (["--serve-batch", "2", "--session", "s.npz"], "does not compose with --session"),
    (["--serve-batch", "2", "--kv-transfer"],
     "--kv-transfer moves published prefix-cache blocks and requires --prefix-cache"),
], ids=["cache-needs-batch", "blocks-need-cache", "len-needs-cache", "negative-blocks",
        "auto-blocks", "session-with-batch", "kv-transfer"])
def test_prefix_and_session_refusals(argv, needle):
    """Each refusal in the JAX server's words (or naming its ROADMAP item),
    before any engine work."""
    with pytest.raises(SystemExit) as ei:
        dllama.main(["api", "--model", "x.m", "--tokenizer", "x.t", *argv])
    assert needle in str(ei.value)


@pytest.mark.parametrize("block_len", [-3, 193])
def test_prefix_block_len_checked_against_the_context(files, block_len):
    """The block length is validated against the engine's context before
    the server binds."""
    mpath, tpath = files
    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--port", "0", "--serve-batch", "2",
         "--prefix-cache", "--prefix-block-len", str(block_len), "--device", "cpu", *F32])
    with pytest.raises(SystemExit, match=r"outside 1\.\.192"):
        api_server.build_server(args)
