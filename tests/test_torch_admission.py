"""The port's SLO admission ladder held against the JAX package's
(runtime/scheduler.py chunk_ladder and AdmissionPolicy), on the CPU, f32.

The ladder must equal the JAX one for every chunk and rung count; the
policy's summary must equal the JAX policy's after every call of a random
sequence of observations (hypothesis); an adaptive scheduler and a static
one must both give the JAX adaptive scheduler's greedy tokens; warmup must
run every rung, so that with CUDA's graph API faked an adaptive run
captures nothing after warmup, frozen or not; the "no speculation"
actuator must degrade a drafting scheduler as the JAX one does, with the
same spec block; and a supervisor's rebuilt generation must start a fresh
policy (JAX tests/test_autotune.py, tests/test_draft.py:526).
"""

import time
import types

import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import draft as jax_draft
from distributed_llama_tpu.runtime import scheduler as jax_sched
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.faults import FAULTS as JAX_FAULTS
from distributed_llama_tpu.runtime.resilience import EngineSupervisor as JaxSupervisor
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import engine as engine_mod
from distributed_llama_tpu_torch.runtime import graphs, scheduler
from distributed_llama_tpu_torch.runtime.draft import DraftModel
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.profiler import COMPILES
from distributed_llama_tpu_torch.runtime.resilience import EngineSupervisor
from distributed_llama_tpu_torch.runtime.scheduler import (AdmissionPolicy, Scheduler,
                                                           chunk_ladder)
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64
# JAX tests/test_autotune.py:294's trace: three prompts over two slots
PROMPTS = [[1, 9, 23, 54, 7, 88, 101, 5, 61, 17, 3] * 3, [2, 40, 77, 12, 9],
           list(range(1, 40))]
BUDGETS = [10, 8, 6]


def _pair(seed, n_layers, n_heads, n_kv_heads):
    kw = dict(dim=64, hidden_dim=128, n_layers=n_layers, n_heads=n_heads,
              n_kv_heads=n_kv_heads, vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=seed, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jspec, jax_params.random_tensors(
        jspec, seed=seed, scale=0.05), mode="dense", dtype=jnp.float32)
    return spec, params, jspec, jp


@pytest.fixture(scope="module")
def tiny():
    """tests/test_autotune.py's model: 2 layers, dense f32, seed 3."""
    return _pair(3, 2, 4, 2)


@pytest.fixture(scope="module")
def tiny4():
    """tests/test_draft.py's model: 4 layers, dense f32, seed 41."""
    return _pair(41, 4, 8, 4)


def _engine(tiny, batch):
    spec, params, _, _ = tiny
    return Engine(spec, params, device="cpu", batch=batch,
                  compute_dtype=torch.float32, cache_dtype=torch.float32)


def _jengine(tiny, batch):
    _, _, jspec, jp = tiny
    return JaxEngine(jspec, jp, batch=batch, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32)


def _greedy():
    return Sampler(128, 0.0, 0.9, 1)


def _jgreedy():
    return JaxSampler(128, 0.0, 0.9, 1, backend="python")


def _run(sched, reqs, limit=800):
    for _ in range(limit):
        if all(r.finished.is_set() for r in reqs):
            return
        sched.step()
    raise AssertionError("scheduler did not drain within the step limit")


def _serve(sched, greedy, prompts=PROMPTS, budgets=BUDGETS):
    sched.warmup()
    reqs = [sched.submit(p, k, greedy()) for p, k in zip(prompts, budgets)]
    _run(sched, reqs)
    outs = [list(r.tokens(timeout=5.0)) for r in reqs]
    summary = sched.stats.summary()
    sched.close()
    return outs, summary


# -- the ladder and the policy ------------------------------------------------


@pytest.mark.parametrize("rungs", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 8, 16, 32, 100, 256])
def test_chunk_ladder_matches_jax(chunk, rungs):
    assert chunk_ladder(chunk, rungs) == jax_sched.chunk_ladder(chunk, rungs)


def test_chunk_ladder_shape():
    """JAX tests/test_autotune.py:225's cases."""
    assert chunk_ladder(32) == [32, 16, 8, 4]
    assert chunk_ladder(8) == [8, 4, 2, 1]
    assert chunk_ladder(2) == [2, 1]
    assert chunk_ladder(1) == [1]
    assert chunk_ladder(256) == [256, 128, 64, 32]


_OPS = st.lists(st.one_of(
    st.tuples(st.just("step"), st.floats(0.0, 400.0), st.integers(0, 4),
              st.integers(0, 4)),
    st.tuples(st.just("ttft"), st.floats(0.0, 4000.0))), max_size=60)


@settings(max_examples=60, deadline=None)
@given(slo_ttft=st.one_of(st.none(), st.floats(1.0, 2000.0)),
       slo_itl=st.one_of(st.none(), st.floats(1.0, 200.0)),
       chunk=st.sampled_from([1, 2, 16, 32, 256]),
       cooldown=st.integers(0, 3), ops=_OPS)
def test_admission_policy_summaries_match_jax(slo_ttft, slo_itl, chunk, cooldown, ops):
    if slo_ttft is None and slo_itl is None:
        slo_itl = 50.0
    kw = dict(slo_ttft_ms=slo_ttft, slo_itl_ms=slo_itl, cooldown=cooldown)
    mine, theirs = AdmissionPolicy(chunk, **kw), jax_sched.AdmissionPolicy(chunk, **kw)
    assert mine.summary() == theirs.summary()
    for op in ops:
        for p in (mine, theirs):
            if op[0] == "step":
                p.observe_step(op[1], decode_rows=op[2], prefill_rows=op[3])
            else:
                p.observe_ttft(op[1])
        assert mine.summary() == theirs.summary(), op
        assert (mine.width, mine.spec_allowed) == (theirs.width, theirs.spec_allowed)


def test_admission_policy_unit():
    """JAX tests/test_autotune.py:232's walk on both packages' policies:
    shrink on ITL pressure with mixed work, the cooldown, the ladder's
    floor, recovery, a pure-prefill widen and the TTFT/ITL conflict."""
    for mod in (scheduler, jax_sched):
        p = mod.AdmissionPolicy(32, slo_itl_ms=10.0, cooldown=2)
        assert p.width == 32
        p.observe_step(20.0, decode_rows=2, prefill_rows=1)
        assert p.width == 16 and p.shrinks == 1
        p.observe_step(20.0, decode_rows=2, prefill_rows=1)
        assert p.width == 16
        p.observe_step(20.0, decode_rows=2, prefill_rows=1)
        assert p.width == 8 and p.shrinks == 2
        for _ in range(10):
            p.observe_step(50.0, decode_rows=2, prefill_rows=1)
        assert p.width == chunk_ladder(32)[-1]
        for _ in range(40):
            p.observe_step(1.0, decode_rows=2, prefill_rows=0)
        assert p.width == 32 and p.widens >= 3
        p2 = mod.AdmissionPolicy(32, slo_itl_ms=10.0, cooldown=1)
        p2._rung = 2
        p2.observe_step(30.0, decode_rows=0, prefill_rows=3)
        assert p2.width == 16 and p2.widens == 1
        p3 = mod.AdmissionPolicy(32, slo_ttft_ms=100.0, slo_itl_ms=10.0, cooldown=1)
        p3._rung = 1
        p3.observe_ttft(95.0)
        p3.observe_step(6.0, decode_rows=2, prefill_rows=1)
        assert p3.width == 32 and p3.widens == 1
        p3._rung = 1
        p3.itl_ewma_ms = 9.0
        p3.observe_step(9.0, decode_rows=2, prefill_rows=0)
        assert p3.width == 16


def test_a_policy_needs_an_slo():
    with pytest.raises(ValueError, match="no goal"):
        AdmissionPolicy(32)


# -- the scheduler ----------------------------------------------------------


def test_adaptive_and_static_give_the_jax_adaptive_tokens(tiny):
    """An impossibly tight ITL SLO shrinks the width every few steps; the
    port's adaptive run, its static run and the JAX adaptive run give the
    same greedy tokens (chunk boundaries never change tokens)."""
    want, jsum = _serve(jax_sched.Scheduler(_jengine(tiny, 2), chunk=16, slo_itl_ms=0.0001),
                        _jgreedy)
    static, ssum = _serve(Scheduler(_engine(tiny, 2), chunk=16), _greedy)
    adaptive, asum = _serve(Scheduler(_engine(tiny, 2), chunk=16, slo_itl_ms=0.0001),
                            _greedy)
    assert jsum["admission"]["shrinks"] >= 1 and asum["admission"]["shrinks"] >= 1
    assert "admission" not in ssum
    assert adaptive == static == want
    # the same walk: the widths a step took depend on the step count only
    for k in ("chunk_width", "chunk_ladder", "shrinks", "widens", "slo_itl_ms"):
        assert asum["admission"][k] == jsum["admission"][k], k


def test_adaptive_chunk_converges_under_slow_steps(tiny):
    """JAX tests/test_autotune.py:266: the slow_step fault holds every
    mixed step over the ITL SLO while prompts keep prefilling; the width
    walks down to the ladder's floor, then widens back as decode idles."""
    sched = Scheduler(_engine(tiny, 2), chunk=16, slo_itl_ms=30.0)
    sched.warmup()
    floor = sched.admission.ladder[-1]
    FAULTS.arm("slow_step", times=0, ms=40.0)
    try:
        reqs = [sched.submit([1, 9, 23, 54], 24, _greedy())]
        reqs += [sched.submit(list(range(1, 49)), 2, _greedy()) for _ in range(3)]
        min_width = sched.admission.width
        for _ in range(800):
            if all(r.finished.is_set() for r in reqs):
                break
            sched.step()
            min_width = min(min_width, sched.admission.width)
        assert all(r.finished.is_set() for r in reqs)
    finally:
        FAULTS.clear()
        sched.close()
    adm = sched.stats.summary()["admission"]
    assert min_width == floor, (min_width, adm)
    assert adm["shrinks"] >= len(sched.admission.ladder) - 1
    assert adm["widens"] >= 1, adm
    assert adm["itl_ewma_ms"] > 30.0


def _fake_capture(fn):
    """CUDA graph capture faked on the CPU: a replay reruns fn eagerly and
    copies its outputs into the captured ones."""
    out = fn()

    def replay():
        out.copy_(fn())
    return graphs.CapturedStep(types.SimpleNamespace(replay=replay, reset=lambda: None),
                               out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.001, 0)


def test_warmup_runs_the_ladder_and_an_adaptive_run_captures_nothing(tiny, monkeypatch):
    """Warmup runs every rung's prefill chunk, all rows gated, and captures
    the slot decode graph; an adaptive run whose width moves then captures
    nothing, with the ledger frozen (JAX tests/test_autotune.py:333)."""
    monkeypatch.setattr(engine_mod, "capture", _fake_capture)
    COMPILES.reset()
    eng = _engine(tiny, 2)
    eng.cuda_graphs = True  # as a CUDA engine has it
    widths = []
    prefill = eng.slot_prefill_chunk

    def recording(tok, pos, lidx):
        widths.append(tok.shape[1])
        return prefill(tok, pos, lidx)
    monkeypatch.setattr(eng, "slot_prefill_chunk", recording)
    sched = Scheduler(eng, chunk=16, slo_itl_ms=0.0001)
    try:
        sched.warmup()
        assert widths == [16, 8, 4, 2] == sched.admission.ladder
        assert list(eng.graphs) == ["slot_decode"]
        COMPILES.freeze = True
        reqs = [sched.submit(list(range(1, 34)), 6, _greedy()),
                sched.submit([2, 40, 77], 8, _greedy())]
        _run(sched, reqs)
        for r in reqs:
            assert r.finish_reason == "length"  # no frozen refusal
        assert sched.admission.shrinks >= 1
        assert set(widths[4:]) > {16}  # the run used narrower rungs
        assert COMPILES.summary()["after_warmup"] == 0
        assert list(eng.graphs) == ["slot_decode"]
    finally:
        sched.close()
        COMPILES.reset()


# -- the "no speculation" actuator ---------------------------------------------


def test_spec_actuator_degrades_as_jax(tiny4):
    """JAX tests/test_draft.py:526: the policy turns drafting off under
    ITL pressure and back on when it clears; a hot drafting scheduler then
    serves plain decode steps at parity, counts them in degraded_steps,
    and gives the JAX scheduler's spec block."""
    for mod in (scheduler, jax_sched):
        pol = mod.AdmissionPolicy(16, slo_itl_ms=50.0)
        assert pol.spec_allowed
        for _ in range(4):
            pol.observe_step(200.0, decode_rows=2, prefill_rows=0)
        assert not pol.spec_allowed and pol.spec_disables == 1
        for _ in range(10):
            pol.observe_step(5.0, decode_rows=2, prefill_rows=0)
        assert pol.spec_allowed and pol.spec_enables == 1
        assert pol.summary()["spec_allowed"] is True

    prompt = [1, 9, 23, 54]
    want = _engine(tiny4, 1).generate(prompt, 6, _greedy()).tokens
    mine = Scheduler(_engine(tiny4, 1), chunk=8, slo_itl_ms=0.001,
                     draft_factory=lambda e: DraftModel.self_draft(e, 2),
                     draft_len=4, draft_vocab=128)
    theirs = jax_sched.Scheduler(
        _jengine(tiny4, 1), chunk=8, slo_itl_ms=0.001,
        draft_factory=lambda e: jax_draft.DraftModel.self_draft(e, 2),
        draft_len=4, draft_vocab=128)
    FAULTS.arm("slow_step", times=0, ms=5.0)
    JAX_FAULTS.arm("slow_step", times=0, ms=5.0)
    try:
        got = []
        for sched, greedy in ((mine, _greedy), (theirs, _jgreedy)):
            r = sched.submit(prompt, 6, greedy())
            _run(sched, [r])
            got.append((list(r.tokens(timeout=5)), sched.stats.summary()))
    finally:
        FAULTS.clear()
        JAX_FAULTS.clear()
        mine.close()
        theirs.close()
    (toks, summ), (jtoks, jsumm) = got
    assert toks == jtoks == want
    assert summ["spec"]["degraded_steps"] > 0
    assert summ["spec"]["verify_forwards"] <= 1  # at most the first
    assert summ["spec"] == jsumm["spec"]
    assert summ["admission"]["spec_disables"] == jsumm["admission"]["spec_disables"] >= 1


# -- the supervisor -----------------------------------------------------------


def _wait(pred, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while not pred() and time.perf_counter() < deadline:
        time.sleep(0.01)
    return pred()


def test_a_rebuilt_generation_starts_a_fresh_policy(tiny):
    """JAX runtime/resilience.py:114: the supervisor gives every
    generation's scheduler a FRESH policy with its SLOs; after a crash the
    new policy's summary is a new JAX policy's, whatever the dead one
    had learnt."""
    sup = EngineSupervisor(lambda: _engine(tiny, 2), chunk=16, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=5,
                           slo_ttft_ms=400.0, slo_itl_ms=0.0001)
    jsup = JaxSupervisor(lambda: _jengine(tiny, 2), chunk=16, stall_timeout=60.0,
                         backoff_base=0.01, breaker_threshold=5,
                         slo_ttft_ms=400.0, slo_itl_ms=0.0001)
    try:
        for s, greedy in ((sup, _greedy), (jsup, _jgreedy)):
            # a short prompt decodes while the long one prefills: mixed
            # steps over the SLO shrink the width
            reqs = [s.submit(p, 6, greedy()) for p in (PROMPTS[1], PROMPTS[0])]
            assert all(list(r.tokens(timeout=60.0)) for r in reqs)
        old = sup._sched.admission
        assert old.shrinks >= 1 and old.itl_ewma_ms is not None
        assert old.summary()["slo_ttft_ms"] == 400.0
        FAULTS.arm("step_raise")
        req = sup.submit([1, 2, 3], 4, _greedy())
        with pytest.raises(scheduler.RequestError):
            list(req.tokens(timeout=30.0))
        assert _wait(lambda: sup.ready and sup._sched.admission is not old), sup.state
        fresh = sup._sched.admission
        want = jax_sched.AdmissionPolicy(16, slo_ttft_ms=400.0, slo_itl_ms=0.0001)
        assert fresh.summary() == want.summary()
        assert sup.summary()["admission"] == want.summary()
        assert sup.summary()["resilience"]["recoveries"] == 1
    finally:
        FAULTS.clear()
        sup.close()
        jsup.close()
