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
    addr = servers[("port", "legacy")][0]
    assert json.loads(_get(addr, "/stats").read()) == {"scheduler": "off"}
    metrics = _get(addr, "/metrics").read().decode()
    assert 'mode="legacy"' in metrics and 'dllama_state{state="off"} 1' in metrics


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
    for method, path in (("POST", "/v1/batch/completions"),
                         ("POST", "/admin/reset_breaker"), ("GET", "/admin/trace")):
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request(method, path, "{}")
        resp = conn.getresponse()
        assert resp.status == 501, path
        assert "ROADMAP item" in json.loads(resp.read())["error"]
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
