"""The port's operator surface held against the JAX package's, on the CPU:
the admin guard (apps/api_server.py _is_loopback, _admin_authorized),
GET /admin/trace (404 with tracing off; the n, id, kind and since_ms
filters; 400 on garbage), POST /admin/profile (a torch.profiler trace on
disk; 400, 403 and 409), the /stats trace blocks and the /metrics trace
families, the CLI's observability refusals in the JAX server's words, and
the profiler's per-entry attribution with CUDA events faked: every graph
replay and eager entry of a sampled scheduler step timed under its name,
the sync record at 0 collective ms, the sampled steps numbered.
"""

import http.client
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.runtime import trace as jax_trace
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.runtime import profiler, trace

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]
RAW = {"prompt": "abab", "max_tokens": 4, "temperature": 0}


@pytest.fixture(autouse=True)
def clean():
    for t in (trace.TRACER, jax_trace.TRACER):
        t.reset()
    profiler.PROFILER.reset()
    yield
    for t in (trace.TRACER, jax_trace.TRACER):
        t.reset()
    profiler.PROFILER.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(42), seq_len=96)


def _argv(files):
    mpath, tpath = files
    return ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
            "--seed", "3", *F32]


@pytest.fixture(scope="module")
def servers(files):
    """{package: (address, state)}: both servers with --serve-batch 2 and
    --admin-token s3cret."""
    out, made = {}, []
    port_args = dllama.build_argparser().parse_args(_argv(files) + ["--device", "cpu"])
    jax_args = jax_dllama.build_argparser().parse_args(_argv(files))
    for name, mod, args, build in (("port", api_server, port_args, dllama.build_engine),
                                   ("jax", jax_api, jax_args, jax_dllama.build_engine)):
        engine, tokenizer, sampler = build(args)
        state = mod.ApiState(engine, tokenizer, sampler, model_name="tiny", serve_batch=2,
                             serve_chunk=16, admin_token="s3cret")
        server = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        made.append((server, state))
        out[name] = (server.server_address, state)
    yield out
    for server, state in made:
        server.shutdown()
        if state._scheduler is not None:
            state._scheduler.close()


def _req(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


@pytest.mark.parametrize("addr", ["127.0.0.1", "127.8.9.1", "::1", "::ffff:127.0.0.1",
                                  "10.0.0.2", "::ffff:10.0.0.2", "192.168.1.1", "1::1"])
def test_loopback_guard_matches_jax(addr):
    assert api_server._is_loopback(addr) == jax_api._is_loopback(addr)


@pytest.mark.parametrize("token,header", [(None, None), (None, "Bearer x"),
                                          ("s3cret", None), ("s3cret", "Bearer s3cret"),
                                          ("s3cret", "Bearer s3cre"), ("s3cret", "s3cret")])
def test_admin_authorized_matches_jax(token, header):
    class State:
        admin_token = token
    for addr in ("127.0.0.1", "10.0.0.2"):
        assert api_server._admin_authorized(State, addr, header) == \
            jax_api._admin_authorized(State, addr, header)


TRACE_QUERIES = ["", "?n=2", "?n=0", "?id=1", "?id=2", "?kind=finish", "?kind=enqueue&n=1",
                 "?since_ms=600000", "?since_ms=0", "?kind=nope", "?kind=", "?n=-1",
                 "?since_ms=nan", "?id=x"]


def test_admin_trace_matches_jax(servers):
    """Off: 404. On, after the same two requests through each server: the
    same status and the same events (untimed fields) for every filter."""
    for name, (addr, _) in servers.items():
        assert _req(addr, "GET", "/admin/trace")[0] == 404, name
    got = {}
    for name, (addr, _), tr in (("port", servers["port"], trace.TRACER),
                                ("jax", servers["jax"], jax_trace.TRACER)):
        tr.configure(capacity=1024, decode_every=2)
        for body in (RAW, {**RAW, "prompt": "ba", "max_tokens": 3}):
            assert _req(addr, "POST", "/v1/completions", body)[0] == 200
        rows = []
        for q in TRACE_QUERIES:
            status, raw = _req(addr, "GET", "/admin/trace" + q)
            if status != 200:
                rows.append((q, status))
                continue
            lines = [json.loads(ln) for ln in raw.splitlines()]
            head, events = lines[0], lines[1:]
            assert head["events"] == len(events) and "anchor_wall" in head
            assert all("ts_wall" in e for e in events)
            rows.append((q, status, [(e["kind"], e["tid"]) for e in events
                                     if e["kind"] != "compile"]))
        got[name] = rows
        tr.reset()
    assert got["port"] == got["jax"]
    assert dict((r[0], r[1]) for r in got["port"])["?kind=nope"] == 400


def test_admin_guard_over_http(servers, monkeypatch):
    """From off loopback: 403 without the bearer, 200 with it, on
    /admin/trace and /admin/profile alike (both servers)."""
    for mod in (api_server, jax_api):
        monkeypatch.setattr(mod, "_is_loopback", lambda addr: False)
    trace.TRACER.configure(capacity=64)
    jax_trace.TRACER.configure(capacity=64)
    for name, (addr, _) in servers.items():
        assert _req(addr, "GET", "/admin/trace")[0] == 403, name
        assert _req(addr, "GET", "/admin/trace",
                    headers={"Authorization": "Bearer nope"})[0] == 403
        assert _req(addr, "GET", "/admin/trace",
                    headers={"Authorization": "Bearer s3cret"})[0] == 200
        assert _req(addr, "POST", "/admin/profile?ms=1")[0] == 403


def test_admin_profile_writes_a_trace(servers, tmp_path):
    """POST /admin/profile?ms=N: a torch.profiler Chrome trace under
    --profile-dir, the profile event, the captures count; 400 on a bad
    window (as the JAX server), 409 while the profiler is owned;
    /admin/reset_breaker answers as the JAX server's (200 on a healthy
    supervisor, 400 on a bad body); a replica verb on a single supervisor
    answers the JAX server's 400."""
    addr, state = servers["port"]
    jaddr, _ = servers["jax"]
    state.profile_dir = str(tmp_path)
    trace.TRACER.configure(capacity=64)
    status, raw = _req(addr, "POST", "/admin/profile?ms=30")
    assert status == 200
    out = json.loads(raw)
    assert out["status"] == "ok" and out["ms"] == 30.0
    assert out["dir"].startswith(str(tmp_path)) and os.path.isfile(out["trace"])
    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)
    assert profiler.PROFILER.captures == 1
    assert [e["kind"] for e in trace.TRACER.recent(0)] == ["profile"]
    for q in ("?ms=0", "?ms=-5", "?ms=nan", "?ms=60001", "?ms=x"):
        assert _req(addr, "POST", "/admin/profile" + q)[0] == \
            _req(jaddr, "POST", "/admin/profile" + q)[0] == 400, q
    profiler.PROFILER._busy = True
    try:
        assert _req(addr, "POST", "/admin/profile?ms=5")[0] == 409
    finally:
        profiler.PROFILER._busy = False
    for body, code in (({}, 200), ({"replica": "x"}, 400)):
        assert _req(addr, "POST", "/admin/reset_breaker", body)[0] == \
            _req(jaddr, "POST", "/admin/reset_breaker", body)[0] == code, body
    status, raw = _req(addr, "POST", "/admin/drain_replica", {})
    assert (status, raw) == _req(jaddr, "POST", "/admin/drain_replica", {})
    assert status == 400 and "replica operations need" in json.loads(raw)["error"]
    assert _req(addr, "POST", "/admin/nope", {})[0] == 404


def test_stats_and_metrics_carry_the_trace_blocks(servers):
    addr, state = servers["port"]
    stats = json.loads(_req(addr, "GET", "/stats")[1])
    assert "trace" not in stats and "step_timeline" not in stats
    assert "dllama_step_ms" not in _req(addr, "GET", "/metrics")[1]
    trace.TRACER.configure(capacity=256)
    assert _req(addr, "POST", "/v1/completions", RAW)[0] == 200
    stats = json.loads(_req(addr, "GET", "/stats")[1])
    assert stats["trace"]["enabled"] and stats["trace"]["next_id"] == 1
    assert stats["step_timeline"] and all(k.startswith("dec") for k in stats["step_timeline"])
    metrics = _req(addr, "GET", "/metrics")[1]
    for family in ("dllama_step_ms", "dllama_steps_by_composition_total",
                   "dllama_trace_events", "dllama_trace_next_id",
                   "dllama_trace_sink_dropped_total"):
        assert f"# TYPE {family} " in metrics, family


@pytest.mark.parametrize("flags", [["--trace-dir", "d"], ["--trace-sample", "0.5"],
                                   ["--trace-buffer", "64"], ["--trace-decode-every", "2"],
                                   ["--trace", "--trace-sample", "1.5"],
                                   ["--profile-sample", "2"],
                                   ["--serve-batch", "2", "--profile-sample", "0"]],
                         ids=["dir", "sample", "buffer", "decode-every", "sample-range",
                              "sample-needs-batch", "sample-zero"])
def test_observability_refusals_match_jax(files, flags):
    """Each refusal in the JAX server's words (the profile-sample ones
    name only the flag the port has), before any engine work."""
    argv = _argv(files) + flags
    with pytest.raises(SystemExit) as mine:
        api_server.configure_observability(dllama.build_argparser().parse_args(argv))
    with pytest.raises(SystemExit) as theirs:
        jax_api.serve(jax_dllama.build_argparser().parse_args(argv))
    if "--profile-sample" in flags:
        assert "--profile-sample" in str(mine.value) and "--profile-sample" in str(theirs.value)
    else:
        assert str(mine.value) == str(theirs.value)


def test_cli_api_configures_the_recorder_and_the_sampler(files, tmp_path):
    """`dllama api --trace ... --profile-sample 3 --admin-token t
    --profile-dir D` through build_server: the tracer configured as the
    JAX server configures its own, the sampler on, the state's token and
    directory set."""
    args = dllama.build_argparser().parse_args(
        _argv(files) + ["--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                        "--serve-batch", "2", "--trace", "--trace-buffer", "32",
                        "--trace-decode-every", "4", "--trace-sample", "0.5",
                        "--trace-dir", str(tmp_path / "tr"), "--profile-sample", "3",
                        "--admin-token", "t", "--profile-dir", str(tmp_path / "pr")])
    server, state = api_server.build_server(args)
    try:
        s = trace.TRACER.summary()
        assert (s["enabled"], s["capacity"], s["sample"], s["sink"]) == \
            (True, 32, 0.5, str(tmp_path / "tr"))
        assert trace.TRACER.decode_every == 4
        assert profiler.PROFILER.sample_every == 3
        assert state.admin_token == "t" and state.profile_dir == str(tmp_path / "pr")
    finally:
        server.server_close()
        api_server.finish(state, drain_timeout=5.0)


class _Event:
    """A CUDA event faked on a host clock that moves 1 ms a record."""

    clock = [0.0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        _Event.clock[0] += 1.0
        self.t = _Event.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_sampled_steps_attribute_every_entry(monkeypatch):
    """--profile-sample 1 with CUDA events faked and graph capture faked:
    each sampled step records its entries (the slot_decode replay, the
    eager slot_prefill chunk, the prefix seed and publish) under their
    names; device_time, the sync record (0 collective ms), the numbered
    step records and the sync events follow; a capture owning the
    profiler makes a due step skip, not block."""
    import types

    import torch

    from distributed_llama_tpu_torch.models.params import load_params, random_tensors
    from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
    from distributed_llama_tpu_torch.runtime import engine as engine_mod
    from distributed_llama_tpu_torch.runtime import graphs
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache
    from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
    from distributed_llama_tpu_torch.sampler import Sampler

    def fake_capture(fn):
        out = fn()
        return graphs.CapturedStep(types.SimpleNamespace(
            replay=lambda: out.copy_(fn()), reset=lambda: None),
            out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.001, 0)
    monkeypatch.setattr(engine_mod, "capture", fake_capture)
    monkeypatch.setattr(profiler, "_event", lambda: (e := _Event(), e.record(), e)[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05), mode="dense",
                         dtype=torch.float32, device="cpu")
    eng = Engine(spec, params, device="cpu", batch=2, compute_dtype=torch.float32,
                 cache_dtype=torch.float32)
    eng.cuda_graphs = True
    sched = Scheduler(eng, chunk=8, prefix_cache=PrefixCache(eng, num_blocks=8,
                                                             block_len=4))
    sched.warmup()
    trace.TRACER.configure(capacity=1024)
    prof = profiler.PROFILER
    prof.sample_every = 1
    shared = [7, 9, 23, 54, 11, 3, 88, 61]
    for tail in ([5], [6, 2]):
        req = sched.submit(shared + tail, 3, Sampler(128, 0.0, 0.9, 1))
        while not req.finished.is_set():
            sched.step()
    end = time.monotonic() + 30
    while prof.sampled + prof.sample_failures < prof._n and time.monotonic() < end:
        time.sleep(0.01)
    s = prof.summary()
    # request 1: two chunks and two decode steps; request 2: a seed, one
    # chunk for its suffix and two decode steps
    n_steps = len([e for e in trace.TRACER.recent(0) if e["kind"] == "step"])
    assert s["sample_failures"] == 0 and s["sampled_steps"] == prof._n == n_steps == 7
    assert set(s["by_entry"]) == {"slot_prefill:8", "slot_decode", "prefix_seed",
                                  "prefix_publish"}
    assert s["by_entry"]["slot_decode"]["n"] == 4 and s["by_entry"]["prefix_seed"]["n"] == 1
    assert s["sync"]["n"] == 7 and s["sync"]["sync_share"] == 0.0
    steps = sorted(prof.recent_steps, key=lambda r: r["step"])
    assert [r["step"] for r in steps] == list(range(1, 8))
    assert all(r["device_ms"] == sum(r["by_entry"].values()) == 1.0 * len(r["by_entry"])
               for r in steps)
    assert all(r["span_ms"] > r["device_ms"] and r["wall_ms"] > 0 for r in steps)
    syncs = [e for e in trace.TRACER.recent(0) if e["kind"] == "sync"]
    assert len(syncs) == 7 and all(e["sync_ms"] == 0.0 and e["share"] == 0.0 for e in syncs)
    prof._busy = True                       # an /admin/profile capture
    try:
        assert prof.step_begin() is None and prof.active is None
    finally:
        prof._busy = False
    sched.close()


def test_capture_starts_and_stops_with_no_graph_replay_in_flight(monkeypatch, tmp_path):
    """The device gate: torch.profiler's start and stop in a capture run
    with runtime/graphs.DEVICE_GATE held exclusively, and every graph
    replay holds it shared, so a replay on another thread waits out a
    start or a stop (the stall of ROADMAP S1); the window itself leaves
    the gate free."""
    import torch.profiler

    from distributed_llama_tpu_torch.runtime import graphs

    prof = profiler.PROFILER
    probes = []

    def free() -> bool:
        """Whether another thread can take the gate exclusively now (a
        probe that cannot waits on, and gets in once the gate is free)."""
        got = threading.Event()

        def probe():
            with graphs.DEVICE_GATE.exclusive():
                got.set()
        t = threading.Thread(target=probe, daemon=True)
        t.start()
        probes.append(t)
        return got.wait(0.2)

    seen = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            seen.append(("start", free()))

        def stop(self):
            seen.append(("stop", free()))

        def export_chrome_trace(self, path):
            seen.append(("window", free()))
            with open(path, "w") as f:
                json.dump({"traceEvents": []}, f)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    out = prof.capture(str(tmp_path / "p"), 1.0)
    assert os.path.isfile(out["trace"])
    assert seen == [("start", False), ("stop", False), ("window", True)]
    replays = []
    step = graphs.CapturedStep(
        type("G", (), {"replay": staticmethod(lambda: replays.append(free()))}),
        None, (0,) * len(graphs.LAUNCH_COUNTERS), 0.0, 0)
    step.replay()
    assert replays == [False] and free()
    for t in probes:
        t.join(5.0)
    assert not any(t.is_alive() for t in probes)
