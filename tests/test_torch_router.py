"""The port's replica tier (distributed_llama_tpu_torch/runtime/router.py)
against the JAX package's runtime/router.py: each scenario of the JAX
router tests runs through both routers, two thread replicas over the
same seeded tiny weights in f32, and the records are compared: every
request's greedy tokens (and the JAX batch-1 oracle's), its placement and
retries, the router's counters, the circuit's fields, readiness, and the
summary's keys and counts. Then `dllama api --replicas 2` with
--tenant-budgets beside the JAX server, the replica verbs and their
loopback guard; and the device gate and launch scopes that let thread
replicas share one card (runtime/graphs.py, ops/launch_scope.py)."""

import http.client
import json
import threading
import time
import types
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import ArchType as JaxArch
from distributed_llama_tpu.models import HiddenAct as JaxAct
from distributed_llama_tpu.models import ModelSpec as JaxSpec
from distributed_llama_tpu.models.params import load_params as jax_load
from distributed_llama_tpu.models.params import random_tensors as jax_random
from distributed_llama_tpu.runtime import router as jax_router
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.faults import FAULTS as JAX_FAULTS
from distributed_llama_tpu.runtime.resilience import EngineUnready as JaxUnready
from distributed_llama_tpu.runtime.scheduler import RequestError as JaxRequestError
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.ops import launch_scope
from distributed_llama_tpu_torch.runtime import graphs, router
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.resilience import EngineUnready
from distributed_llama_tpu_torch.runtime.scheduler import RequestError
from distributed_llama_tpu_torch.sampler import Sampler

SEQ, BL = 64, 4
FIELDS = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)


@pytest.fixture(scope="module")
def tiny():
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **FIELDS)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05), mode="dense",
                         dtype=torch.float32, device="cpu")
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **FIELDS)
    jparams = jax_load(jspec, jax_random(jspec, seed=3, scale=0.05), mode="dense",
                       dtype=jnp.float32)
    port = types.SimpleNamespace(
        name="port", Router=router.Router, FAULTS=FAULTS, Sampler=Sampler,
        RequestError=RequestError, EngineUnready=EngineUnready,
        factory=lambda: Engine(spec, params, device="cpu", batch=2,
                               compute_dtype=torch.float32, cache_dtype=torch.float32))
    jax = types.SimpleNamespace(
        name="jax", Router=jax_router.Router, FAULTS=JAX_FAULTS, Sampler=JaxSampler,
        RequestError=JaxRequestError, EngineUnready=JaxUnready,
        factory=lambda: JaxEngine(jspec, jparams, batch=2, compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32))
    oracles: dict = {}

    def oracle(prompt, n):
        key = (tuple(prompt), n)
        if key not in oracles:
            eng = JaxEngine(jspec, jparams, batch=1, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
            oracles[key] = eng.generate(prompt, n, _greedy(JaxSampler)).tokens
        return oracles[key]
    return types.SimpleNamespace(port=port, jax=jax, oracle=oracle)


@pytest.fixture(autouse=True)
def clean_faults():
    FAULTS.clear()
    JAX_FAULTS.clear()
    yield
    FAULTS.clear()
    JAX_FAULTS.clear()


def _greedy(cls):
    return cls(FIELDS["vocab_size"], temperature=0.0, topp=0.9, seed=1)


def _router(P, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("chunk", 8)
    kw.setdefault("stall_timeout", 60.0)
    kw.setdefault("backoff_base", 0.01)
    return P.Router(P.factory, **kw)


def _wait(pred, timeout=30.0):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _both(tiny, scenario):
    """Run scenario(P) on the port and on the JAX package; equal records."""
    mine, theirs = scenario(tiny.port), scenario(tiny.jax)
    assert mine == theirs
    return mine


def _run(P, r, n, prompt, **kw):
    """Submit, drain, and record (tokens, replica, retries)."""
    req = r.submit(prompt, n, _greedy(P.Sampler), **kw)
    return list(req.tokens(timeout=60.0)), req.replica_id, req.retries


def _counters(r):
    return r.stats.summary()


# -- placement ------------------------------------------------------------------


def test_placement_trace_matches_jax(tiny):
    """A trace of warm, cold and session requests through cache-aware
    placement: the same tokens (the oracle's), placements, cache hits and
    affinity wins, and the same match lengths on each replica."""
    p = [1, 9, 23, 54, 7, 11, 40, 3, 15]
    cold = [[2, 40, 77, 5], [3, 8, 13, 21, 34], [1, 9, 23, 99]]

    def scenario(P):
        r = _router(P, prefix_blocks=32, prefix_block_len=BL)
        try:
            rec = [_run(P, r, 3, p), _run(P, r, 3, p)]
            rec += [_run(P, r, 3, q) for q in cold]
            rec += [_run(P, r, 2, cold[0], session="conv-1"),
                    _run(P, r, 2, cold[0], session="conv-1")]
            return (rec, _counters(r), [h.match_len(p) for h in r.replicas],
                    [h.load() for h in r.replicas], r.ready, r.state)
        finally:
            r.close()
    rec = _both(tiny, scenario)
    assert rec[0][0][0] == tiny.oracle(p, 3) and rec[0][1][1] == 0
    assert rec[1]["routed_cache_hit"] >= 1 and rec[1]["routed_affinity"] == 1


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_policies_place_as_jax(tiny, policy):
    def scenario(P):
        r = _router(P, policy=policy)
        try:
            return [_run(P, r, 2, [5 + i, 7, 9]) for i in range(4)], _counters(r)
        finally:
            r.close()
    _both(tiny, scenario)


# -- failover -----------------------------------------------------------------------


@pytest.mark.parametrize("seeded", [False, True], ids=["cold", "seeded"])
def test_failover_pre_first_token_matches_jax(tiny, seeded):
    """replica_raise on r0 before the request's first token: the retry on
    r1 gives the oracle's tokens, cold or seeded from r1's cache; the
    same retries, counters and (seeded) cache hits on both packages."""
    p = [1, 9, 23, 54, 7, 11, 40, 3, 15]

    def scenario(P):
        r = _router(P, retry_budget=1, **(dict(prefix_blocks=32, prefix_block_len=BL)
                                           if seeded else {}))
        try:
            if seeded:
                for h in r.replicas:
                    list(h.sup.submit(p, 1, _greedy(P.Sampler)).tokens(timeout=60.0))
            P.FAULTS.arm("replica_raise", key="r0")
            rec = _run(P, r, 6, p)
            fired = P.FAULTS.fired("replica_raise")
            P.FAULTS.clear()
            assert _wait(lambda: r.replicas[0].ready)
            hits = (r.replicas[1].sup.prefix_cache.stats.hits if seeded else None)
            return rec, fired, _counters(r), hits
        finally:
            r.close()
    rec = _both(tiny, scenario)
    assert rec[0] == (tiny.oracle(p, 6), 1, 1) and rec[1] == 1


def test_midstream_kill_is_structured_and_not_replayed(tiny):
    def scenario(P):
        r = _router(P, retry_budget=3)
        try:
            P.FAULTS.arm("slow_step", times=0, ms=25.0)
            req = r.submit([1, 9, 23], 40, _greedy(P.Sampler))
            it = req.tokens(timeout=60.0)
            got = [next(it)]
            P.FAULTS.arm("replica_raise", key=f"r{req.replica_id}")
            with pytest.raises(P.RequestError) as ei:
                for t in it:
                    got.append(t)
            P.FAULTS.clear()
            e = ei.value
            return (e.code, e.retryable, "already streamed" in str(e), req.finish_reason,
                    _counters(r)["midstream_failures"], _counters(r)["retries"])
        finally:
            P.FAULTS.clear()
            r.close()
    assert _both(tiny, scenario) == ("engine_error", False, True, "error", 1, 0)


def test_kill_mid_trace_zero_unstreamed_failures(tiny):
    """r0 killed on its 3rd working step under a paced trace of 8
    requests: every request completes with the oracle's tokens or, only
    after streaming, fails non-retryable; readiness holds throughout."""
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 128, 5)] for _ in range(8)]

    def scenario(P):
        r = _router(P, retry_budget=1, circuit_threshold=100)
        results, gaps = {}, []
        stop = threading.Event()

        def sample():
            while not stop.is_set():
                if not r.ready:
                    gaps.append(1)
                time.sleep(0.005)

        def client(i):
            req = r.submit(prompts[i], 6, _greedy(P.Sampler))
            got = []
            try:
                for t in req.tokens(timeout=120.0):
                    got.append(t)
                results[i] = ("ok", got)
            except P.RequestError as e:
                results[i] = ("error", len(got), e.retryable)
        try:
            P.FAULTS.arm("slow_step", times=0, ms=20.0)
            P.FAULTS.arm("replica_raise", key="r0", after=2)
            th = [threading.Thread(target=sample, daemon=True)]
            th[0].start()
            clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for c in clients:
                c.start()
                time.sleep(0.03)
            for c in clients:
                c.join(timeout=120.0)
        finally:
            stop.set()
            P.FAULTS.clear()
        crashes = r.replicas[0].sup.sup_stats.crashes
        r.close()
        return results, gaps, crashes
    for P in (tiny.port, tiny.jax):
        results, gaps, crashes = scenario(P)
        assert len(results) == 8 and not gaps and crashes >= 1, P.name
        for i, res in results.items():
            if res[0] == "ok":
                assert res[1] == tiny.oracle(prompts[i], 6), (P.name, i)
            else:
                assert res[1] >= 1 and res[2] is False, (P.name, i, res)


def test_rolling_drain_zero_failures(tiny):
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 128, 5)] for _ in range(6)]

    def scenario(P):
        r = _router(P)
        results = {}

        def client(i):
            try:
                results[i] = list(r.submit(prompts[i], 4, _greedy(P.Sampler)).tokens(
                    timeout=120.0))
            except Exception as e:  # noqa: BLE001
                results[i] = repr(e)
        try:
            P.FAULTS.arm("slow_step", times=0, ms=15.0)
            clients = []
            for i in range(6):
                clients.append(threading.Thread(target=client, args=(i,)))
                clients[-1].start()
                time.sleep(0.04)
                if i == 2:
                    roller = threading.Thread(target=lambda: r.rolling_restart(timeout=60.0))
                    roller.start()
            for c in clients:
                c.join(timeout=120.0)
            roller.join(timeout=120.0)
        finally:
            P.FAULTS.clear()
        out = (results, _counters(r)["drains"], _counters(r)["restarts"], r.ready)
        r.close()
        return out
    results, drains, restarts, ready = _both(tiny, scenario)
    assert (drains, restarts, ready) == (2, 2, True)
    assert all(results[i] == tiny.oracle(prompts[i], 4) for i in range(6))


# -- the circuit -----------------------------------------------------------------------


# the circuit's cooldown: far longer than a replica's rebuild under any
# load; the test ends it by moving `open_until` to now, so the half-open
# probe comes exactly when the test asks for it
COOL = 300.0


def _end_cooldown(h):
    h.open_until = time.perf_counter()


def test_circuit_open_and_half_open_probe_match_jax(tiny):
    p = [1, 9, 23, 54]

    def scenario(P):
        r = _router(P, retry_budget=1, circuit_threshold=2, circuit_cooldown=COOL,
                    breaker_threshold=1000)
        h0 = r.replicas[0]
        rec = []
        try:
            P.FAULTS.arm("replica_raise", key="r0", times=0)
            for _ in range(2):
                assert _wait(lambda: h0.ready)
                rec.append(_run(P, r, 3, p))
            rec.append((_counters(r)["breaker_trips"], h0.open_until > 0.0, h0.fails))
            assert _wait(lambda: h0.ready)
            rec.append(_run(P, r, 3, p))      # circuit open: r1, no retry
            P.FAULTS.clear()
            _end_cooldown(h0)
            rec.append(_run(P, r, 3, p))      # the half-open probe on r0
            rec.append((_counters(r)["breaker_probes"], h0.open_until, h0.fails,
                        h0.probing))
            # door refusal of a probe, a caller error on a probe, an
            # abandoned stream, a cancel before consuming: each settles
            r._on_result(h0, ok=False)
            r._on_result(h0, ok=False)
            _end_cooldown(h0)
            with pytest.raises(Exception):
                r.submit(list(range(1, SEQ + 2)), 2, _greedy(P.Sampler))
            rec.append((h0.probing, h0.open_until > 0.0))
            req = r.submit([3, 11], 4, _greedy(P.Sampler))
            rec.append((req.replica_id, h0.probing))
            gen = req.tokens(timeout=60.0)
            next(gen)
            gen.close()
            req.cancel()
            rec.append((h0.probing, h0.open_until, h0.fails, req.finished.is_set()))
            return rec
        finally:
            P.FAULTS.clear()
            r.close()
    rec = _both(tiny, scenario)
    assert rec[3][1:] == (1, 0)           # routed to r1, no retry
    assert rec[4] == (tiny.oracle(p, 3), 0, 0)


def test_no_routable_replica_and_summary_match_jax(tiny):
    def scenario(P):
        r = _router(P)
        try:
            for h in r.replicas:
                assert h.drain(timeout=30.0)
            with pytest.raises(P.EngineUnready) as ei:
                r.submit([1, 9], 2, _greedy(P.Sampler))
            rec = [ei.value.retry_after > 0, _counters(r)["no_replica_rejections"], r.ready,
                   r.state]
            r.undrain_replica(0)
            rec.append(_run(P, r, 2, [1, 9]))
            rec.append(_run(P, r, 2, [1, 9, 23]))
            assert r.drain_replica(0, timeout=30.0)
            r.restart_replica(0, timeout=60.0)
            rec.append(_run(P, r, 2, [1, 9, 23]))
            s = r.summary()
            rec.append({k: s[k] for k in ("requests_finished", "tokens_out", "state",
                                          "requests_submitted", "router")})
            rec.append(sorted(s))
            rec.append([sorted(x) for x in s["replicas"]])
            rec.append({k: s["kv_transfer"][k] for k in ("enabled", "tier", "fills_ok")})
            return rec
        finally:
            r.close()
    rec = _both(tiny, scenario)
    assert rec[-4]["requests_finished"] == 3 and rec[-4]["tokens_out"] == 6


# -- the device gate and launch scopes (thread replicas on one card) ------------


def test_device_gate_holds_captures_off_shared_work():
    """exclusive() waits for every other shared holder and holds new ones
    off; a thread holding it shared may take it exclusively (a graph
    captured at its first use inside a step) without deadlocking a
    sibling doing the same."""
    gate = graphs.DeviceGate()
    order = []
    inside = threading.Event()
    release = threading.Event()

    def stepper(tag):
        with gate.shared():
            order.append(("in", tag))
            inside.set()
            release.wait(5.0)
            order.append(("out", tag))

    idents = []

    def capturer():
        idents.append(threading.get_ident())
        inside.wait(5.0)
        with gate.exclusive():
            order.append(("capture",))

    a = threading.Thread(target=stepper, args=("a",))
    c = threading.Thread(target=capturer)
    a.start()
    c.start()
    time.sleep(0.1)
    late = threading.Thread(target=stepper, args=("late",))
    late.start()            # arrives while the capture waits: held off
    time.sleep(0.1)
    assert order == [("in", "a")]
    release.set()
    for t in (a, c, late):
        t.join(5.0)
    assert order[:3] == [("in", "a"), ("out", "a"), ("capture",)]
    assert gate.exclusive_waits == 1
    assert gate.waited_s(idents[0]) >= 0.1      # its wait is timed
    # two shared holders each upgrading: both captures run, one at a time
    done = []
    barrier = threading.Barrier(2)

    def upgrade(tag):
        with gate.shared():
            barrier.wait(5.0)
            with gate.exclusive():
                done.append(tag)
    ts = [threading.Thread(target=upgrade, args=(t,)) for t in "xy"]
    for t in ts:
        t.start()
    for t in ts:
        t.join(5.0)
    assert sorted(done) == ["x", "y"] and not any(t.is_alive() for t in ts)
    # a holder that hands its device work to a helper thread and waits
    # for it (a streamed lookup batch in a borrow) gives its hold up
    # meanwhile: the helper's capture, beside a sibling's step, does not
    # wait on the waiting holder
    got = []
    sibling_in = threading.Event()

    def sibling():
        with gate.shared():
            sibling_in.set()
            time.sleep(0.1)

    def helper():
        with gate.shared():
            with gate.exclusive():
                got.append("capture")

    def holder():
        with gate.shared():
            sibling_in.wait(5.0)
            with gate.released():
                h = threading.Thread(target=helper)
                h.start()
                h.join(5.0)
            got.append("back")
    ts = [threading.Thread(target=f) for f in (sibling, holder)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(5.0)
    assert got == ["capture", "back"] and not any(t.is_alive() for t in ts)
    assert not gate._readers and gate._writer is None


def test_a_step_held_at_the_gate_is_not_a_stall(tiny):
    """A borrow of one replica holds the device gate shared while a capture
    waits for it, so the other replica's step waits at the gate behind the
    capture for longer than stall_timeout. Its watchdog leaves that wait
    out: no stall, no recovery, and the request completes once the borrow
    ends."""
    P = tiny.port
    r = _router(P, stall_timeout=0.3)
    prompt = [1, 5, 9, 13, 17]
    try:
        assert _wait(lambda: all(h.ready for h in r.replicas))
        def capture():
            with graphs.DEVICE_GATE.exclusive():
                pass
        cap = threading.Thread(target=capture)
        with r.exclusive():                 # replica 0 lent for a batch
            cap.start()
            assert _wait(lambda: graphs.DEVICE_GATE._waiting, 5.0)
            req = r.replicas[1].sup.submit(prompt, 4, _greedy(P.Sampler))
            sched = r.replicas[1].sup._sched
            assert _wait(lambda: sched._step_t0 is not None, 5.0)
            time.sleep(0.8)                 # > stall_timeout at the gate
            assert req.stats.t_first is None and sched.step_age() < 0.3
        cap.join(5.0)
        assert list(req.tokens(timeout=60.0)) == tiny.oracle(prompt, 4)
        assert [h.sup.sup_stats.watchdog_trips for h in r.replicas] == [0, 0]
        assert all(h.ready for h in r.replicas)
    finally:
        r.close()


def test_launch_scopes_attribute_replays_and_undo_captures(monkeypatch):
    """A replay adds its tally to the process counters and to the
    replaying thread's scope; a capture takes back what its run counted,
    in the scope too; another thread's scope sees none of it."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40

    import contextlib

    class FakeGraph:
        def replay(self):
            pass

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda g: 0)

    def step():
        launch_scope.count(cuda_q40.q40_matmul, "q40_matmul", 2)
        launch_scope.count(cuda_attention.flash_attention, "flash_attention")

    mine, other = {}, {}
    k1, k3 = cuda_q40.q40_matmul.launches, cuda_attention.flash_attention.launches
    with launch_scope.scope(mine):
        cap = graphs.capture(step)        # warm-up counts, capture does not
        assert mine == {"q40_matmul": 2, "flash_attention": 1}
        cap.replay()
        cap.replay()
    with launch_scope.scope(other):
        pass
    assert mine == {"q40_matmul": 6, "flash_attention": 3} and other == {}
    assert cuda_q40.q40_matmul.launches - k1 == 6
    assert cuda_attention.flash_attention.launches - k3 == 3


def test_thread_replicas_share_weights_and_count_launches_apart(tiny):
    """build_front_door's thread replicas run Engine.spawn over the
    template's tensors (no weight copy), and each scheduler's launch
    scope is its own (on the CPU the plain versions count nothing, so
    the scopes stay empty and apart)."""
    tmpl = tiny.port.factory()
    door = router.build_front_door(tmpl, serve_batch=2, serve_chunk=8, replicas=2)
    try:
        ptrs = {h.sup.engine.params["layers"][1]["w2"].data_ptr() for h in door.replicas}
        assert ptrs == {tmpl.params["layers"][1]["w2"].data_ptr()}
        scopes = [h.sup._sched.launches for h in door.replicas]
        assert scopes[0] is not scopes[1]
        assert _run(tiny.port, door, 3, [4, 5, 6])[0] == tiny.oracle([4, 5, 6], 3)
    finally:
        door.close()


# -- dllama api --replicas 2 ------------------------------------------------------------


@pytest.fixture(scope="module")
def api_pair(tmp_path_factory):
    """The port's and the JAX package's `dllama api --serve-batch 2
    --replicas 2 --prefix-cache --tenant-budgets`, on the tiny fixture."""
    d = tmp_path_factory.mktemp("fleet_api")
    mpath, tpath = write_fixture(d, seed=2)
    flags = ["--serve-batch", "2", "--replicas", "2", "--prefix-cache",
             "--tenant-budgets", "gold=4:2000,free=1", "--port", "0",
             "--buffer-float-type", "f32", "--compute-dtype", "f32"]
    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--device", "cpu", "--cache-dtype",
         "f32", *flags])
    server, state = api_server.build_server(args)
    jargs = jax_dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, *flags])
    jengine, jtok, jsmp = jax_dllama.build_engine(jargs)
    jstate = jax_api.ApiState(jengine, jtok, jsmp, serve_batch=2, replicas=2,
                              prefix_cache=True, tenant_budgets="gold=4:2000,free=1",
                              route_policy="cache_aware")
    jstate.scheduler()      # the JAX door builds lazily; the port's at startup
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), jax_api.make_handler(jstate))
    for s in (server, jserver):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield (server.server_address[:2], state), (jserver.server_address[:2], jstate)
    for s, st in ((server, state), (jserver, jstate)):
        s.shutdown()
        s.server_close()
        if st._fleet is not None:
            st._fleet.close()
        if st._scheduler is not None:
            st._scheduler.close()


def _req(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp.status, resp.read().decode(), dict(resp.getheaders())


def test_api_replicas_answer_as_jax(api_pair):
    """Completions through the port's replica tier, the tenant from the
    body and from X-Tenant, equal the JAX server's text; /readyz names
    each replica; /stats carries the router, kv_transfer and fleet blocks
    with the tenants' accounting; /metrics the router, replica and fleet
    families."""
    (addr, state), (jaddr, _) = api_pair
    bodies = [({"prompt": "ab", "max_tokens": 6, "temperature": 0, "tenant": "gold"}, {}),
              ({"prompt": "abab baba", "max_tokens": 5, "temperature": 0}, {"X-Tenant": "free"}),
              ({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                "temperature": 0, "user": "u1"}, {})]
    for body, hdr in bodies:
        path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
        mine = _req(addr, "POST", path, body, hdr)
        theirs = _req(jaddr, "POST", path, body, hdr)
        assert mine[0] == theirs[0] == 200
        a, b = json.loads(mine[1]), json.loads(theirs[1])
        assert a["choices"] == b["choices"] and a["usage"] == b["usage"]
    ready = json.loads(_req(addr, "GET", "/readyz")[1])
    jready = json.loads(_req(jaddr, "GET", "/readyz")[1])
    assert ready == jready == {"status": "ready", "state": "ready",
                               "replicas": {"r0": "ready", "r1": "ready"}}
    stats = json.loads(_req(addr, "GET", "/stats")[1])
    jstats = json.loads(_req(jaddr, "GET", "/stats")[1])
    assert {"router", "replicas", "kv_transfer", "fleet"} <= set(stats)
    assert set(stats["fleet"]) == set(jstats["fleet"])
    assert stats["fleet"]["tenants"] == jstats["fleet"]["tenants"]
    assert stats["router"]["routed"] == jstats["router"]["routed"] == 3
    metrics = _req(addr, "GET", "/metrics")[1]
    for fam in ('dllama_up{model="dllama",mode="router"} 1', "dllama_router_routed_total 3",
                'dllama_replica_up{replica="1"} 1', "dllama_fleet_info",
                'dllama_fleet_tenant_admitted_total{tenant="gold"} 1',
                "dllama_kv_transfer_info"):
        assert fam in metrics, fam


def test_api_replica_verbs_and_guard(api_pair, monkeypatch):
    """drain, undrain and restart one replica answer as the JAX server's
    verbs; bad replica indices are the same 400; off loopback without the
    token the verbs are refused (403)."""
    (addr, state), (jaddr, _) = api_pair
    for path, body in (("/admin/drain_replica", {"replica": 1, "timeout": 30}),
                       ("/admin/undrain_replica", {"replica": 1}),
                       ("/admin/restart_replica", {"replica": 0, "timeout": 60}),
                       ("/admin/drain_replica", {"replica": 7}),
                       ("/admin/drain_replica", {}),
                       ("/admin/reset_breaker", {"replica": 1}),
                       ("/admin/nope", {})):
        mine, theirs = _req(addr, "POST", path, body), _req(jaddr, "POST", path, body)
        assert (mine[0], json.loads(mine[1])) == (theirs[0], json.loads(theirs[1])), path
    assert state._scheduler.stats.restarts == 1
    monkeypatch.setattr(api_server, "_is_loopback", lambda a: False)
    assert _req(addr, "POST", "/admin/drain_replica", {"replica": 0})[0] == 403
