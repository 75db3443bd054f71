"""The port's serving resilience (runtime/faults.py, runtime/resilience.py)
on the CPU: the cases of tests/test_resilience.py that need no prefix cache,
draft or cluster, against the port's scheduler and supervisor. With an
injected step crash mid-decode, in-flight requests get structured error
frames, the supervisor releases the failed engine, rebuilds, turns ready
again, and the next request gives the tokens of the port's sequential
Engine.generate (held against the JAX engine in tests/test_torch_engine.py
and test_torch_scheduler.py). The watchdog finds a stall within its bound;
queue overflow and deadlines get fast structured rejections. All f32.
"""

import threading
import time

import pytest
import torch

from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS, FaultError, FaultRegistry
from distributed_llama_tpu_torch.runtime.resilience import (
    BROKEN, READY, RECOVERING, EngineSupervisor, EngineUnready)
from distributed_llama_tpu_torch.runtime.scheduler import (
    QueueFull, RequestError, Scheduler, SchedulerClosed)
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64


@pytest.fixture(scope="module")
def tiny():
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                     n_heads=4, n_kv_heads=2, vocab_size=128, seq_len=SEQ,
                     hidden_act=HiddenAct.SILU)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    return spec, params


@pytest.fixture(autouse=True)
def clean_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


def _engine(tiny, batch):
    spec, params = tiny
    return Engine(spec, params, device="cpu", batch=batch,
                  compute_dtype=torch.float32, cache_dtype=torch.float32)


def _factory(tiny, batch=2, made=None):
    def make():
        eng = _engine(tiny, batch)
        if made is not None:
            made.append(eng)
        return eng
    return make


def _greedy(spec):
    return Sampler(spec.vocab_size, temperature=0.0, topp=0.9, seed=1)


def _oracle(tiny, prompt, max_tokens):
    return _engine(tiny, 1).generate(prompt, max_tokens, _greedy(tiny[0])).tokens


def _wait(pred, timeout=30.0, poll=0.01):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return True
        time.sleep(poll)
    return False


# -- the fault registry --------------------------------------------------


def test_fault_registry_count_deterministic():
    r = FaultRegistry()
    r.arm("step_raise", after=2, times=2)
    r.fire("step_raise")
    r.fire("step_raise")
    with pytest.raises(FaultError):
        r.fire("step_raise")
    with pytest.raises(FaultError):
        r.fire("step_raise")
    r.fire("step_raise")  # times=2 spent
    assert r.fired("step_raise") == 2
    r.clear()
    r.fire("step_raise")


def test_fault_registry_env_parsing():
    r = FaultRegistry()
    r.load_env({"DLLAMA_FAULTS": "step_raise:after=1;times=3, slow_step:ms=5;times=0"})
    assert r.armed("step_raise") and r.armed("slow_step")
    r.fire("step_raise")
    with pytest.raises(FaultError):
        r.fire("step_raise")
    t0 = time.perf_counter()
    r.fire("slow_step")
    assert time.perf_counter() - t0 >= 0.004
    with pytest.raises(ValueError):
        FaultRegistry().load_env({"DLLAMA_FAULTS": "step_raise:bogus=1"})
    with pytest.raises(ValueError):
        FaultRegistry().load_env({"DLLAMA_FAULTS": "no_such_site"})


def test_fault_stall_releasable():
    r = FaultRegistry()
    r.arm("step_stall", ms=60_000)
    done = threading.Event()

    def stallee():
        r.fire("step_stall")
        done.set()

    t = threading.Thread(target=stallee, daemon=True)
    t.start()
    assert not done.wait(0.1)
    r.release()
    assert done.wait(5.0)


# -- the scheduler: close(), deadlines, queue bound -----------------------


def test_scheduler_close_fails_queued_waiters(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8)
    FAULTS.arm("slow_step", times=0, ms=30.0)
    sched.start()
    reqs = [sched.submit([1, 9, 23], 200, _greedy(spec)) for _ in range(3)]
    results: dict = {}

    def waiter(i, req):
        try:
            results[i] = ("ok", list(req.tokens(timeout=30.0)))
        except RequestError as e:
            results[i] = ("error", e.code)

    threads = [threading.Thread(target=waiter, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    _wait(lambda: any(s.req is not None for s in sched.slots), 30.0)
    t0 = time.perf_counter()
    sched.close()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), "a waiter outlived close()"
    assert time.perf_counter() - t0 < 10.0
    assert len(results) == 3
    for i, req in enumerate(reqs):
        assert req.finished.is_set()
        assert results[i][0] == "error" and req.finish_reason == "error"
    with pytest.raises(SchedulerClosed):
        sched.submit([1], 1, _greedy(spec))


def test_scheduler_queue_bound_rejects_fast(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8, max_queue=2)
    sched.submit([1, 2], 4, _greedy(spec))
    sched.submit([1, 3], 4, _greedy(spec))
    with pytest.raises(QueueFull) as ei:
        sched.submit([1, 4], 4, _greedy(spec))
    assert ei.value.retry_after > 0
    assert sched.stats.requests_rejected == 1
    sched.close()


def test_scheduler_request_deadline_structured_frame(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8)
    FAULTS.arm("slow_step", times=0, ms=30.0)
    sched.start()
    req = sched.submit([1, 9, 23], 10_000, _greedy(spec),
                       deadline=time.perf_counter() + 0.3)
    got = []
    with pytest.raises(RequestError) as ei:
        for t in req.tokens(timeout=30.0):
            got.append(t)
    assert ei.value.code == "deadline" and not ei.value.retryable
    assert req.finish_reason == "error"
    assert sched.stats.requests_expired == 1
    assert len(got) < 60
    sched.close()


def test_scheduler_queue_timeout_expires_queued(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8, queue_timeout=0.25)
    r0 = sched.submit([1, 9], 2, _greedy(spec))
    sched.step()
    r1 = sched.submit([1, 8], 2, _greedy(spec))
    time.sleep(0.3)
    for _ in range(100):
        if r0.finished.is_set() and r1.finished.is_set():
            break
        sched.step()
    assert r0.finish_reason == "length"
    with pytest.raises(RequestError) as ei:
        list(r1.tokens(timeout=5.0))
    assert ei.value.code == "queue_timeout"
    sched.close()


# -- the supervisor: recovery, watchdog, breaker ---------------------------


def test_step_crash_recovers_and_stays_token_identical(tiny):
    """A crash mid-decode: structured frames, the failed engine released,
    a rebuild, ready again, and the next request oracle-identical."""
    spec = tiny[0]
    made = []
    sup = EngineSupervisor(_factory(tiny, made=made), chunk=8, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=5)
    try:
        p = [1, 9, 23, 54]
        FAULTS.arm("slow_step", times=0, ms=25.0)
        req = sup.submit(p, 40, _greedy(spec))
        it = req.tokens(timeout=30.0)
        got = [next(it)]
        FAULTS.arm("step_raise")
        with pytest.raises(RequestError) as ei:
            for t in it:
                got.append(t)
        assert ei.value.code == "engine_error"
        assert "injected step_raise" in str(ei.value)
        assert req.finish_reason == "error"
        assert _wait(lambda: sup.ready, 30.0), sup.state
        assert sup.sup_stats.crashes == 1
        assert sup.sup_stats.recoveries == 1
        # the failed engine gave its cache back before the next was built
        assert len(made) == 2 and made[0].cache is None
        assert sup.engine is made[1] and made[1].cache is not None
        FAULTS.clear()
        req2 = sup.submit(p, 6, _greedy(spec))
        assert list(req2.tokens(timeout=60.0)) == _oracle(tiny, p, 6)
        s = sup.summary()
        assert s["state"] == READY
        assert s["requests_failed"] >= 1
        assert s["resilience"]["recoveries"] == 1
        assert s["hbm"]["kv_slot_bytes"] > 0
    finally:
        sup.close()


def test_watchdog_detects_stall_within_bound(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=0.5,
                           backoff_base=0.01, breaker_threshold=5)
    try:
        FAULTS.arm("slow_step", times=0, ms=25.0)
        req = sup.submit([1, 9, 23], 40, _greedy(spec))
        FAULTS.arm("step_stall", ms=60_000)
        t0 = time.perf_counter()
        with pytest.raises(RequestError) as ei:
            list(req.tokens(timeout=30.0))
        detected = time.perf_counter() - t0
        assert detected < 10.0, f"stall took {detected:.1f}s to surface"
        assert "stalled" in str(ei.value)
        assert sup.sup_stats.watchdog_trips == 1
        assert _wait(lambda: sup.ready, 30.0), sup.state
        FAULTS.clear()
        req2 = sup.submit([2, 40, 77], 4, _greedy(spec))
        assert list(req2.tokens(timeout=60.0)) == _oracle(tiny, [2, 40, 77], 4)
    finally:
        FAULTS.clear()
        sup.close()


def test_supervisor_unready_rejects_submit(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0,
                           backoff_base=0.5, breaker_threshold=5)
    try:
        FAULTS.arm("slow_step", times=0, ms=25.0)
        req = sup.submit([1, 9], 40, _greedy(spec))
        FAULTS.arm("step_raise")
        with pytest.raises(RequestError):
            list(req.tokens(timeout=30.0))
        assert _wait(lambda: sup.state == RECOVERING, 10.0)
        with pytest.raises(EngineUnready) as ei:
            sup.submit([1, 9], 4, _greedy(spec))
        assert ei.value.retry_after > 0
        assert sup.sup_stats.rejected_unready == 1
        assert _wait(lambda: sup.ready, 30.0)
    finally:
        sup.close()


def test_circuit_breaker_opens_and_resets(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=2)
    try:
        FAULTS.arm("step_raise", times=0)
        for _ in range(6):
            if sup.state == BROKEN:
                break
            assert _wait(lambda: sup.state in (READY, BROKEN), 30.0)
            try:
                req = sup.submit([1, 9], 8, _greedy(spec))
                with pytest.raises(RequestError):
                    list(req.tokens(timeout=30.0))
            except EngineUnready:
                time.sleep(0.05)
        assert sup.state == BROKEN, sup.state
        assert not sup.ready
        with pytest.raises(EngineUnready) as ei:
            sup.submit([1, 9], 4, _greedy(spec))
        assert ei.value.retry_after >= 30.0
        trips = sup.sup_stats.consecutive_failures
        assert trips >= 2
        time.sleep(0.2)
        assert sup.sup_stats.consecutive_failures == trips
        FAULTS.clear()
        sup.reset_breaker()
        assert _wait(lambda: sup.ready, 30.0), sup.state
        req2 = sup.submit([2, 40, 77], 4, _greedy(spec))
        assert list(req2.tokens(timeout=60.0)) == _oracle(tiny, [2, 40, 77], 4)
    finally:
        FAULTS.clear()
        sup.close()


def test_supervisor_drain_finishes_inflight_then_refuses(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0)
    try:
        req = sup.submit([1, 9, 23], 5, _greedy(spec))
        assert sup.drain(timeout=60.0)
        assert list(req.tokens(timeout=5.0)) == _oracle(tiny, [1, 9, 23], 5)
        with pytest.raises(EngineUnready):
            sup.submit([1, 9], 2, _greedy(spec))
        assert not sup.ready
    finally:
        sup.close()


def test_supervisor_exclusive_borrows_current_engine(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0)
    try:
        r = sup.submit([1, 9, 23], 3, _greedy(spec))
        with sup.exclusive() as eng:
            assert eng is sup.engine
            assert r.finished.is_set()
        assert list(r.tokens(timeout=5.0)) == _oracle(tiny, [1, 9, 23], 3)
    finally:
        sup.close()


def test_prefill_raise_site_recovers(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=4, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=5)
    try:
        FAULTS.arm("prefill_raise")
        req = sup.submit([1, 9, 23, 54, 7], 4, _greedy(spec))
        with pytest.raises(RequestError) as ei:
            list(req.tokens(timeout=30.0))
        assert "injected prefill_raise" in str(ei.value)
        assert _wait(lambda: sup.ready, 30.0)
        req2 = sup.submit([1, 9, 23, 54, 7], 4, _greedy(spec))
        assert list(req2.tokens(timeout=60.0)) == _oracle(tiny, [1, 9, 23, 54, 7], 4)
    finally:
        sup.close()


def test_slow_step_still_serves_under_deadline_pressure(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0)
    try:
        FAULTS.arm("slow_step", times=0, ms=30.0)
        tight = sup.submit([1, 9], 10_000, _greedy(spec),
                           deadline=time.perf_counter() + 0.25)
        with pytest.raises(RequestError) as ei:
            list(tight.tokens(timeout=30.0))
        assert ei.value.code == "deadline"
        FAULTS.clear()
        ok = sup.submit([2, 40, 77], 4, _greedy(spec))
        assert list(ok.tokens(timeout=60.0)) == _oracle(tiny, [2, 40, 77], 4)
        assert sup.ready
        assert sup.sup_stats.recoveries == 0
    finally:
        FAULTS.clear()
        sup.close()


def test_terminal_delivery_exactly_once(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8)
    req = sched.submit([1, 2], 2, _greedy(spec))
    frame = {"code": "engine_error", "message": "x", "retryable": True}
    assert sched._fail_req(req, frame) is True
    assert sched._fail_req(req, frame) is False
    assert sched.stats.requests_failed == 1
    assert sched.stats.requests_finished == 1
    with pytest.raises(RequestError):
        list(req.tokens(timeout=5.0))
    assert req.events.empty()
    sched.close()


def test_exclusive_borrow_crash_triggers_recovery(tiny):
    spec = tiny[0]
    sup = EngineSupervisor(_factory(tiny), chunk=8, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=5)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            with sup.exclusive():
                raise RuntimeError("boom")
        assert _wait(lambda: sup.ready, 30.0), sup.state
        assert sup.sup_stats.crashes == 1
        assert sup.sup_stats.recoveries == 1
        req = sup.submit([1, 9, 23], 4, _greedy(spec))
        assert list(req.tokens(timeout=60.0)) == _oracle(tiny, [1, 9, 23], 4)
    finally:
        sup.close()


def test_trip_cluster_goes_lost_with_structured_frames(tiny):
    """A lost cluster node (JAX runtime/resilience.py:283 trip_cluster): the
    in-flight request fails at once with a structured, non-retryable
    cluster_peer_lost frame, the supervisor goes to its terminal state
    (LOST: unready, nothing rebuilt), and a second trip changes nothing."""
    from distributed_llama_tpu_torch.parallel.multihost import ClusterPeerLost
    from distributed_llama_tpu_torch.runtime.resilience import LOST

    spec = tiny[0]
    made = []
    sup = EngineSupervisor(_factory(tiny, made=made), chunk=8,
                           stall_timeout=60.0, backoff_base=0.01)
    try:
        FAULTS.arm("slow_step", times=0, ms=25.0)
        req = sup.submit([1, 9], 40, _greedy(spec))
        exc = ClusterPeerLost(1, 0.3, "serve", "eof")
        sup.trip_cluster(exc)
        with pytest.raises(RequestError) as ei:
            list(req.tokens(timeout=30.0))
        frame = ei.value.frame()
        assert frame["code"] == "cluster_peer_lost"
        assert frame["retryable"] is False
        assert str(exc) in frame["message"]
        assert sup.state == LOST and not sup.ready
        assert sup.sup_stats.cluster_losses == 1
        sup.trip_cluster(exc)
        time.sleep(0.2)
        assert sup.sup_stats.cluster_losses == 1 and len(made) == 1
        with pytest.raises(EngineUnready):
            sup.submit([1, 9], 4, _greedy(spec))
    finally:
        FAULTS.clear()
        sup.close()
