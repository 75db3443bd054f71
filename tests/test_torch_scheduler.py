"""The port's continuous-batching scheduler and slot steps held against the
JAX package's (runtime/scheduler.py, Engine.slot_prefill_chunk and
Engine.slot_decode_step), on the CPU, all f32.

The six cases of tests/test_scheduler.py run through the port's Scheduler:
its greedy tokens must equal the port's sequential Engine.generate AND the
JAX Scheduler's on the same weights, exactly (staggered joins, slot reuse,
early stop, the zero budget, the thread and cancel, exclusive()). The slot
steps, with a gated row and a join mid-decode, must give the JAX engine's
logits and caches at 1e-5 for LLAMA and MIXTRAL (the latter through the
dense all-expert branch a batch takes), and a gated row's cache must stay
bit-untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.scheduler import Scheduler as JaxScheduler
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.scheduler import PromptTooLong, Scheduler
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_scheduler.py's model: dense f32 weights, seed 3."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jspec, jax_params.random_tensors(
        jspec, seed=3, scale=0.05), mode="dense", dtype=jnp.float32)
    return spec, params, jspec, jp


def _engine(tiny, batch):
    spec, params, _, _ = tiny
    return Engine(spec, params, device="cpu", batch=batch,
                  compute_dtype=torch.float32, cache_dtype=torch.float32)


def _greedy(vocab):
    return Sampler(vocab, temperature=0.0, topp=0.9, seed=1)


def _oracle(tiny, prompt, max_tokens, eos_id=None):
    """The port's sequential single-row reference."""
    return _engine(tiny, 1).generate(prompt, max_tokens, _greedy(tiny[0].vocab_size),
                                     eos_id=eos_id).tokens


def _run(sched, reqs, limit=500):
    for _ in range(limit):
        if all(r.finished.is_set() for r in reqs):
            return
        sched.step()
    raise AssertionError("scheduler did not drain within the step limit")


def _drain(req):
    return list(req.tokens(timeout=5.0))


def _jax_scheduled(tiny, batch, chunk, plan, eos_id=None):
    """The JAX Scheduler's tokens for `plan`: [(prompt, max_tokens, steps
    before the next submit)], driven the same way as the port's."""
    _, _, jspec, jp = tiny
    eng = JaxEngine(jspec, jp, batch=batch, compute_dtype=jnp.float32,
                    cache_dtype=jnp.float32)
    sched = JaxScheduler(eng, chunk=chunk)
    reqs = []
    for prompt, n, steps in plan:
        reqs.append(sched.submit(prompt, n, JaxSampler(
            jspec.vocab_size, 0.0, 0.9, 1, backend="python"),
            eos_id=eos_id if prompt is plan[0][0] else None))
        for _ in range(steps):
            sched.step()
    _run(sched, reqs)
    return [list(r.tokens(timeout=5.0)) for r in reqs]


P0 = [1, 9, 23, 54, 7, 88, 101, 5, 61, 17, 3]   # 3 padded chunks
P1 = [2, 40, 77, 12, 9]
P2 = [5, 66, 31, 90, 14, 8, 55]


def test_parity_staggered_joins_and_slot_reuse(tiny):
    """Three requests through 2 slots: r1 joins mid-decode of r0, r2 waits
    for r1's early finish. Every output equals the port's sequential
    generate and the JAX scheduler's."""
    spec = tiny[0]
    eng = _engine(tiny, 2)
    sched = Scheduler(eng, chunk=4)
    r0 = sched.submit(P0, 10, _greedy(spec.vocab_size))
    for _ in range(5):
        sched.step()
    assert not r0.finished.is_set()
    r1 = sched.submit(P1, 4, _greedy(spec.vocab_size))
    r2 = sched.submit(P2, 6, _greedy(spec.vocab_size))
    _run(sched, [r0, r1, r2])

    got = [_drain(r0), _drain(r1), _drain(r2)]
    assert got == [_oracle(tiny, P0, 10), _oracle(tiny, P1, 4), _oracle(tiny, P2, 6)]
    assert got == _jax_scheduled(tiny, 2, 4, [(P0, 10, 5), (P1, 4, 0), (P2, 6, 0)])
    assert r0.finish_reason == r1.finish_reason == r2.finish_reason == "length"
    assert max(sched.stats.occupancy) <= 2
    assert max(sched.stats.queue_depth) >= 1
    s = sched.stats.summary()
    assert s["requests_finished"] == 3
    assert s["tokens_out"] == 20
    assert s["ttft_p50_ms"] is not None and s["ttft_p50_ms"] >= 0


def test_parity_eos_early_finish(tiny):
    """A stop token ends a request early (the token included) and frees the
    one slot to a queued request."""
    spec = tiny[0]
    p0, p1 = [1, 9, 23, 54, 7], [2, 40, 77, 12, 9, 31]
    base = _oracle(tiny, p0, 8)
    eos = base[2]
    want0 = _oracle(tiny, p0, 8, eos_id=eos)
    assert want0 == base[:3] and want0[-1] == eos

    sched = Scheduler(_engine(tiny, 1), chunk=8)
    r0 = sched.submit(p0, 8, _greedy(spec.vocab_size), eos_id=eos)
    r1 = sched.submit(p1, 5, _greedy(spec.vocab_size))
    _run(sched, [r0, r1])
    got = [_drain(r0), _drain(r1)]
    assert got == [want0, _oracle(tiny, p1, 5)]
    assert got == _jax_scheduled(tiny, 1, 8, [(p0, 8, 0), (p1, 5, 0)], eos_id=eos)
    assert r0.finish_reason == "stop"
    assert max(sched.stats.occupancy) == 1


def test_prompt_too_long_and_empty_rejected(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 2))
    with pytest.raises(PromptTooLong):
        sched.submit(list(range(1, SEQ + 1)), 4, _greedy(spec.vocab_size))
    with pytest.raises(ValueError):
        sched.submit([], 4, _greedy(spec.vocab_size))
    assert not sched.has_work()


def test_budget_zero_prefills_and_emits_nothing(tiny):
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 2), chunk=4)
    r = sched.submit([1, 9, 23], 0, _greedy(spec.vocab_size))
    _run(sched, [r])
    assert _drain(r) == []
    assert r.finish_reason == "length"
    assert _jax_scheduled(tiny, 2, 4, [([1, 9, 23], 0, 0)]) == [[]]


def test_threaded_loop_and_cancellation(tiny):
    """The background thread drains submissions; cancel() retires a request
    mid-stream and frees its slot to the next one."""
    spec = tiny[0]
    sched = Scheduler(_engine(tiny, 1), chunk=8)
    sched.start()
    try:
        r0 = sched.submit([1, 9, 23, 54], 30, _greedy(spec.vocab_size))
        it = r0.tokens(timeout=60.0)
        got = [next(it), next(it)]
        r0.cancel()
        rest = list(it)
        assert got + rest == _oracle(tiny, [1, 9, 23, 54], 30)[: len(got) + len(rest)]
        assert r0.finished.wait(60.0)
        assert r0.finish_reason == "cancelled"
        r1 = sched.submit([2, 40, 77], 4, _greedy(spec.vocab_size))
        assert r1.finished.wait(60.0)
        assert _drain(r1) == _oracle(tiny, [2, 40, 77], 4)
    finally:
        sched.close()


def test_exclusive_drains_then_lends_engine(tiny):
    spec = tiny[0]
    eng = _engine(tiny, 2)
    sched = Scheduler(eng, chunk=8)
    r = sched.submit([1, 9, 23], 3, _greedy(spec.vocab_size))
    with sched.exclusive() as borrowed:
        assert borrowed is eng
        assert r.finished.is_set()
        borrowed.reset()
    assert _drain(r) == _oracle(tiny, [1, 9, 23], 3)


def test_scheduler_refuses_unported_options(tiny):
    """Every option of the JAX Scheduler is ported now: fault_key names the
    scheduler at the replica fault sites and fair_queue takes the FIFO
    deque's place; an unknown option is still refused."""
    from distributed_llama_tpu_torch.runtime.fleet import WFQueue

    eng = _engine(tiny, 2)
    q = WFQueue()
    sched = Scheduler(eng, fault_key="r3", fair_queue=q)
    assert sched.fault_key == "r3" and sched._queue is q
    r = sched.submit([1, 9, 23], 3, _greedy(tiny[0].vocab_size),
                     tenant="acme", priority="high")
    assert (r.tenant, r.priority) == ("acme", "high") and len(q) == 1
    while sched.step():
        pass
    assert len(q) == 0 and _drain(r) == _oracle(tiny, [1, 9, 23], 3)
    # the SLOs are ported: either one arms the admission policy
    assert Scheduler(eng, slo_ttft_ms=500.0).admission is not None
    assert Scheduler(eng).admission is None
    with pytest.raises(TypeError):
        Scheduler(eng, no_such_option=1)


# -- the slot steps against the JAX engine's ----------------------------------


@pytest.fixture(scope="module", params=["LLAMA", "MIXTRAL"])
def slot_engines(request, tmp_path_factory):
    moe = dict(arch=JaxArch.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, _ = write_fixture(tmp_path_factory.mktemp("fx"), seed=29,
                             **(moe if request.param == "MIXTRAL" else {}))
    spec, tensors = read_model(mpath)
    jp = jax_params.load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    jeng = JaxEngine(spec, jp, batch=3, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32, pallas_interpret=True)
    eng = Engine(spec, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), spec, "cpu"),
                 device="cpu", batch=3, compute_dtype=torch.float32,
                 cache_dtype=torch.float32)
    return spec, jeng, eng


def _rows(cache, r):
    return [t[r].clone() for t in (*cache.k, *cache.v)]


def test_slot_steps_match_jax_engine(slot_engines):
    """Row 0 prefills two chunks and decodes; row 1 joins mid-decode; row 2
    is gated in every call (pos == S). Live rows' logits and every cache
    match the JAX engine at 1e-5; a gated row's cache is bit-untouched,
    and so is a row mid-decode while another row's chunk prefills."""
    spec, jeng, eng = slot_engines
    s, c = spec.seq_len, 4
    rng = np.random.default_rng(5)
    p0 = rng.integers(3, spec.vocab_size, 7).tolist()
    p1 = rng.integers(3, spec.vocab_size, 3).tolist()
    idle = _rows(eng.cache, 2)

    def chunk(row_tokens):
        """A (3, C) chunk: {row: (tokens, pos)}, other rows gated."""
        tok = np.zeros((3, c), np.int32)
        pos = np.full((3,), s, np.int32)
        lidx = np.zeros((3,), np.int32)
        for r, (t, p) in row_tokens.items():
            tok[r, :len(t)] = t
            pos[r] = p
            lidx[r] = len(t) - 1
        return tok, pos, lidx

    def check(calls, live):
        want = np.asarray(calls(jeng))
        got = calls(eng).numpy()
        np.testing.assert_allclose(got[live], want[live], **TOL)
        for mine, theirs in zip((*eng.cache.k, *eng.cache.v),
                                (*jeng.cache.k, *jeng.cache.v)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)
        return got

    for i in range(0, len(p0), c):
        args = chunk({0: (p0[i:i + c], i)})
        check(lambda e: e.slot_prefill_chunk(*args), [0])
    tok = np.zeros((3, 1), np.int32)
    pos = np.full((3,), s, np.int32)
    tok[0, 0], pos[0] = 11, len(p0)
    check(lambda e: e.slot_decode_step(tok, pos), [0])
    mid = _rows(eng.cache, 0)
    args = chunk({1: (p1, 0)})        # row 1 joins; row 0 sits mid-decode
    check(lambda e: e.slot_prefill_chunk(*args), [1])
    assert all(torch.equal(a, b) for a, b in zip(mid, _rows(eng.cache, 0)))
    tok[1, 0], pos[0], pos[1] = 12, len(p0) + 1, len(p1)
    check(lambda e: e.slot_decode_step(tok, pos), [0, 1])
    assert all(torch.equal(a, b) for a, b in zip(idle, _rows(eng.cache, 2)))
    assert eng.pos == 0 and not eng.graphs   # no self.pos; nothing captured


def test_slot_steps_refuse_wrong_shapes(slot_engines):
    _, _, eng = slot_engines
    with pytest.raises(ValueError, match="slots"):
        eng.slot_decode_step(np.zeros((2, 1), np.int32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="one token"):
        eng.slot_decode_step(np.zeros((3, 2), np.int32), np.zeros(3, np.int32))
