"""The port's real-draft speculation held against the JAX package's
(runtime/draft.py, Engine.generate_draft*, Engine.slot_verify_step and the
scheduler's per-slot drafting; tests/test_draft.py case by case), on the
CPU, all f32.

Greedy self-draft and model-draft streams must give the JAX engine's
tokens and accept record and the port's plain generate()'s tokens; the
sampled draft, drawing the same PCG64 uniforms in the JAX order, the JAX
engine's tokens at the same seed. The scheduler with a draft armed must
give the JAX scheduler's tokens and `spec` block, through joins, slot reuse
after cancel and deadline, mixed greedy and sampled rows and a prefix-cache
seed, keep each row's draft frontier at or below the verified stream, and
capture no graph after its warmup (CUDA graph capture faked on the CPU).
The CLI's --draft refusals are the JAX CLI's words; the legacy API path,
chat and the CLI with --draft self:1 print what the JAX ones print.
"""

import builtins
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import draft as jdraft
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.scheduler import Scheduler as JaxScheduler
from distributed_llama_tpu.runtime.trace import render_prometheus as jax_render
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import draft as draft_mod
from distributed_llama_tpu_torch.runtime import engine as engine_mod
from distributed_llama_tpu_torch.runtime import graphs
from distributed_llama_tpu_torch.runtime.draft import (DraftModel, build_draft,
                                                       parse_draft_spec)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.runtime.profiler import COMPILES
from distributed_llama_tpu_torch.runtime.scheduler import RequestError, Scheduler
from distributed_llama_tpu_torch.runtime.trace import render_prometheus
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 96
PROMPT = [1, 5, 9, 1, 5]


@pytest.fixture(scope="module")
def tiny():
    """tests/test_draft.py's model: 4 layers, dense f32, seed 41."""
    kw = dict(dim=64, hidden_dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jsp = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=41, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jsp, jax_params.random_tensors(
        jsp, seed=41, scale=0.05), mode="dense", dtype=jnp.float32)
    return spec, params, jsp, jp


def _engine(tiny, batch=1):
    spec, params, _, _ = tiny
    return Engine(spec, params, device="cpu", batch=batch,
                  compute_dtype=torch.float32, cache_dtype=torch.float32)


def _jengine(tiny, batch=1):
    _, _, jsp, jp = tiny
    return JaxEngine(jsp, jp, batch=batch, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32)


@pytest.fixture(scope="module")
def one(tiny):
    """Batch-1 engines of both packages, reset by each test."""
    return _engine(tiny), _jengine(tiny)


def _greedy(v=128):
    return Sampler(v, 0.0, 0.9, 1)


def _oracle(tiny, prompt, max_tokens, eos_id=None):
    return _engine(tiny).generate(prompt, max_tokens, _greedy(),
                                  eos_id=eos_id).tokens


def _run(sched, reqs, limit=500):
    for _ in range(limit):
        if all(r.finished.is_set() for r in reqs):
            return
        sched.step()
    raise AssertionError("scheduler did not drain within the step limit")


# -- the draft spec and the CLI's refusals -------------------------------------


@pytest.mark.parametrize("s", ["self:2", "model:/x/y.m", "self", "self:",
                               "self:0", "self:-1", "self:two", "model:",
                               "lookup:3", ""])
def test_parse_draft_spec_equals_jax(s):
    try:
        want = jdraft.parse_draft_spec(s)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            parse_draft_spec(s)
        assert str(ei.value) == str(e)
    else:
        assert parse_draft_spec(s) == want


def test_self_draft_depth_bounds_and_shared_tensors(one):
    eng, _ = one
    with pytest.raises(ValueError, match="depth"):
        DraftModel.self_draft(eng, 0)
    with pytest.raises(ValueError, match="depth"):
        DraftModel.self_draft(eng, eng.spec.n_layers)
    d = DraftModel.self_draft(eng, 2)
    assert d.spec.n_layers == 2 and d.label == "self2"
    # zero extra weights: the same layer dicts, the same tensors
    assert all(a is b for a, b in zip(d.params["layers"], eng.params["layers"][:2]))
    for name in ("tok_emb", "rms_final", "wcls"):
        assert d.params[name].data_ptr() == eng.params[name].data_ptr()
    # one cache of the target's shape, allocated once and zeroed in place
    ptrs = [t.data_ptr() for t in (*d.cache.k, *d.cache.v)]
    d.cache.k[0].fill_(1.0)
    c = d.new_cache()
    assert c is d.cache and [t.data_ptr() for t in (*c.k, *c.v)] == ptrs
    assert len(c.k) == 2 and c.k[0].shape == (1, 4, SEQ, 8)
    assert not c.k[0].any()
    with pytest.raises(ValueError, match="own cache"):
        d.propose(types.SimpleNamespace(), np.zeros(1, np.int32),
                  np.zeros(1, np.int32), 2, n_vocab=128)


CLI_CASES = [
    (["--draft-len", "5"], "--draft-len has no effect"),
    (["--draft", "self:2", "--draft-len", "0"], "--draft-len must"),
    (["--draft", "self:2", "--lookup-decode", "5"], "--lookup-decode"),
    (["--draft", "bananas"], "--draft"),
    (["--draft", "self:0"], "--draft"),
    (["--draft", "model:/definitely/not/here.m"], "no such file"),
    (["--draft", "self:2", "--dp", "2"], "--dp"),
    (["--draft", "self:2", "--pp", "2"], "--pp"),
    (["--draft", "self:2", "--device-sampling"], "--device-sampling"),
]


@pytest.mark.parametrize("extra,needle", CLI_CASES)
def test_cli_draft_dead_flag_validation(extra, needle):
    """Every bad --draft combination dies before any model load, with the
    JAX CLI's message."""
    base = ["generate", "--model", "x.m", "--tokenizer", "x.t"]
    with pytest.raises(SystemExit) as ei:
        dllama.main(base + extra)
    with pytest.raises(SystemExit) as ej:
        jax_dllama.main(base + extra)
    assert needle in str(ei.value.code)
    assert str(ei.value.code) == str(ej.value.code)


def test_cli_draft_refusals_in_api_and_chat(tmp_path):
    with pytest.raises(SystemExit) as ei:
        dllama.main(["api", "--model", "x.m", "--tokenizer", "x.t",
                     "--serve-batch", "2", "--replica-hosts", "h1:9001",
                     "--draft", "self:2"])
    assert "--replica-hosts" in str(ei.value.code)
    mpath, tpath = write_fixture(tmp_path, n_layers=2)
    for main in (dllama.main, jax_dllama.main):
        with pytest.raises(SystemExit) as ei:
            main(["api", "--model", mpath, "--tokenizer", tpath, "--draft",
                  "self:2", "--port", "0"]
                 + (["--device", "cpu"] if main is dllama.main else []))
        assert "depth must be in 1..1" in str(ei.value.code)


# -- greedy streams against the JAX engine and plain generate ------------------


@pytest.mark.parametrize("depth,draft_len", [(1, 4), (2, 7), (3, 1), (2, 3)])
def test_self_draft_matches_jax_and_plain_greedy(tiny, one, depth, draft_len):
    """Accepted and rejected drafts never change a token (a tiny random
    model's prefix disagrees often, so rejections run); the accept record
    is the JAX engine's."""
    eng, jeng = one
    want = _oracle(tiny, PROMPT, 24)
    eng.reset()
    jeng.reset()
    got = eng.generate_draft(PROMPT, 24, draft=DraftModel.self_draft(eng, depth),
                             draft_len=draft_len)
    jgot = jeng.generate_draft(PROMPT, 24, draft_len=draft_len,
                               draft=jdraft.DraftModel.self_draft(jeng, depth))
    assert got.tokens == want == jgot.tokens
    assert eng.last_accept_stats == jeng.last_accept_stats
    assert eng.last_spec == jeng.last_spec
    fwd, n = eng.last_accept_stats
    assert n == len(want) and fwd <= n + 1 and eng.last_spec["emitted"] == n


def test_self_draft_eos_budget_and_context_edge(tiny, one):
    eng, jeng = one
    probe = _oracle(tiny, PROMPT, 16)
    eos = probe[5]
    want = _oracle(tiny, PROMPT, 16, eos_id=eos)
    for e, mk in ((eng, DraftModel), (jeng, jdraft.DraftModel)):
        e.reset()
        out = e.generate_draft(PROMPT, 16, eos_id=eos,
                               draft=mk.self_draft(e, 2), draft_len=5)
        assert out.tokens == want
        assert e.pos == len(PROMPT) + len(want) - 1
        e.reset()
        assert e.generate_draft(PROMPT, 0, draft=mk.self_draft(e, 2)).tokens == []
        assert e.pos == len(PROMPT)
    edge = (PROMPT * 20)[: SEQ - 5]
    want = _oracle(tiny, edge, 40)
    eng.reset()
    jeng.reset()
    got = eng.generate_draft(edge, 40, draft=DraftModel.self_draft(eng, 2))
    assert got.tokens == want == jeng.generate_draft(
        edge, 40, draft=jdraft.DraftModel.self_draft(jeng, 2)).tokens
    assert eng.pos == jeng.pos == SEQ and eng.last_spec == jeng.last_spec


def test_model_draft_file_matches_jax_and_plain_greedy(tiny, one, tmp_path):
    """A separate draft .m (another width and depth, the same vocab) rides
    the same machinery: its quality only moves the accept rate. A draft of
    another vocab is refused before its weights load."""
    eng, jeng = one
    mpath, _ = write_fixture(tmp_path, rng=np.random.default_rng(9),
                             vocab_size=128, dim=32, n_layers=1, n_heads=4,
                             n_kv_heads=2, seq_len=SEQ)
    want = _oracle(tiny, PROMPT, 16)
    eng.reset()
    jeng.reset()
    d = build_draft(eng, f"model:{mpath}")
    assert d.label == "model" and d.spec.dim == 32 and len(d.cache.k) == 1
    got = eng.generate_draft(PROMPT, 16, draft=d, draft_len=4)
    jgot = jeng.generate_draft(PROMPT, 16, draft_len=4,
                               draft=jdraft.build_draft(jeng, f"model:{mpath}"))
    assert got.tokens == want == jgot.tokens
    assert eng.last_spec == jeng.last_spec
    (tmp_path / "bad").mkdir()
    bad, _ = write_fixture(tmp_path / "bad", rng=np.random.default_rng(9),
                           vocab_size=64, dim=32, n_layers=1, n_heads=4, n_kv_heads=2)
    with pytest.raises(ValueError, match="vocab"):
        build_draft(eng, f"model:{bad}")


# -- the sampled draft ----------------------------------------------------------


def test_accept_or_resample_q_marginal_is_exact():
    from distributed_llama_tpu_torch.runtime.speculative import (
        accept_or_resample_q, draw)

    rng = np.random.default_rng(11)
    p = np.asarray([0.5, 0.3, 0.15, 0.05])
    for q in (np.asarray([0.4, 0.35, 0.15, 0.1]), np.asarray([0.05, 0.15, 0.3, 0.5]),
              np.asarray([0.0, 0.6, 0.4, 0.0]), np.asarray([1.0, 0.0, 0.0, 0.0])):
        counts = np.zeros(4)
        n = 40_000
        for _ in range(n):
            d = draw(q, rng.random())
            _, t = accept_or_resample_q(p, q, d, rng.random(), rng.random())
            counts[t] += 1
        np.testing.assert_allclose(counts / n, p, atol=0.012, err_msg=str(q))
    assert accept_or_resample_q(p, p, 2, 0.999, 0.5) == (True, 2)


@pytest.mark.parametrize("seed,draft_len", [(7, 7), (5003, 2), (11, 4)])
def test_draft_sampled_matches_jax(one, seed, draft_len):
    """The same logits (f32, to ~1e-6) and the same uniforms in the same
    order: the JAX engine's tokens and accept record."""
    eng, jeng = one
    eng.reset()
    jeng.reset()
    kw = dict(temperature=0.8, topp=0.9, seed=seed, draft_len=draft_len)
    got = eng.generate_draft_sampled(PROMPT, 12, draft=DraftModel.self_draft(eng, 2), **kw)
    want = jeng.generate_draft_sampled(
        PROMPT, 12, draft=jdraft.DraftModel.self_draft(jeng, 2), **kw)
    assert got.tokens == want.tokens and len(got.tokens) == 12
    assert eng.last_spec == jeng.last_spec


def test_draft_sampled_deterministic_and_contracts(one):
    eng, _ = one
    runs = []
    for _ in range(2):
        eng.reset()
        runs.append(eng.generate_draft_sampled(
            PROMPT, 12, draft=DraftModel.self_draft(eng, 2), temperature=0.8,
            topp=0.9, seed=7).tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 12
    eos = runs[0][4]
    eng.reset()
    out = eng.generate_draft_sampled(PROMPT, 12, draft=DraftModel.self_draft(eng, 2),
                                     temperature=0.8, topp=0.9, seed=7,
                                     eos_id=eos).tokens
    assert out == runs[0][: runs[0].index(eos) + 1]
    assert eng.pos == len(PROMPT) + len(out) - 1


# -- the scheduler's per-slot drafts --------------------------------------------


def _spec_sched(tiny, batch=2, depth=2, draft_len=4, **kw):
    return Scheduler(_engine(tiny, batch), chunk=8,
                     draft_factory=lambda e: DraftModel.self_draft(e, depth),
                     draft_len=draft_len, draft_vocab=128, **kw)


def _jax_spec_sched(tiny, batch=2, depth=2, draft_len=4):
    return JaxScheduler(_jengine(tiny, batch), chunk=8,
                        draft_factory=lambda e: jdraft.DraftModel.self_draft(e, depth),
                        draft_len=draft_len, draft_vocab=128)


def _jgreedy():
    return JaxSampler(128, temperature=0.0, topp=0.9, seed=1, backend="python")


def test_scheduler_matches_jax_through_join_and_slot_reuse(tiny):
    """Three requests on two slots, one joining mid-decode and one waiting
    for a slot: the port's tokens equal the sequential oracle and the JAX
    scheduler's, and so does the `spec` block."""
    p0 = [1, 9, 23, 54, 7, 88, 101, 5, 61, 17, 3]
    p1 = [2, 40, 77, 12, 9]
    p2 = [5, 66, 31, 90, 14, 8, 55]
    outs = []
    for sched, smp in ((_spec_sched(tiny), _greedy), (_jax_spec_sched(tiny), _jgreedy)):
        r0 = sched.submit(p0, 24, smp())
        for _ in range(3):
            sched.step()
        assert not r0.finished.is_set()
        r1 = sched.submit(p1, 4, smp())
        r2 = sched.submit(p2, 6, smp())
        _run(sched, [r0, r1, r2])
        outs.append(([list(r.tokens(timeout=5)) for r in (r0, r1, r2)],
                     sched.stats.summary()["spec"], r0.stats.spec_forwards))
        sched.close()
    (got, blk, fwd0), (want, jblk, jfwd0) = outs
    assert got == want == [_oracle(tiny, p0, 24), _oracle(tiny, p1, 4),
                           _oracle(tiny, p2, 6)]
    assert blk == jblk and blk["mode"] == "self2" and blk["verify_forwards"] >= 1
    assert fwd0 == jfwd0 >= 1


def test_scheduler_mixed_greedy_and_sampled_rows(tiny):
    """A sampled row rides the verify forward's position-0 logits while its
    greedy neighbour speculates: the greedy row is the oracle's, the
    sampled row the JAX scheduler's."""
    pg, ps = [1, 9, 23, 54], [2, 40, 77]
    outs = []
    for sched, mk in ((_spec_sched(tiny), Sampler),
                      (_jax_spec_sched(tiny),
                       lambda *a, **k: JaxSampler(*a, backend="python", **k))):
        rg = sched.submit(pg, 8, mk(128, 0.0, 0.9, seed=1))
        rs = sched.submit(ps, 8, mk(128, 0.8, 0.9, seed=5))
        _run(sched, [rg, rs])
        outs.append((list(rg.tokens(timeout=5)), list(rs.tokens(timeout=5))))
        sched.close()
    assert outs[0] == outs[1]
    assert outs[0][0] == _oracle(tiny, pg, 8) and len(outs[0][1]) == 8


def test_draft_kv_resets_on_slot_reuse_cancel_and_deadline(tiny):
    sched = _spec_sched(tiny, batch=1)
    r0 = sched.submit([1, 9, 23, 54], 30, _greedy())
    for _ in range(6):
        sched.step()
    assert not r0.finished.is_set()
    s0 = sched.slots[0]
    assert s0.draft_pos > 0
    r0.cancel()
    sched.step()
    assert r0.finish_reason == "cancelled"
    r1 = sched.submit([2, 40, 77], 4, _greedy())
    sched.step()
    assert s0.draft_pos <= 3
    _run(sched, [r1])
    assert list(r1.tokens(timeout=5)) == _oracle(tiny, [2, 40, 77], 4)
    FAULTS.arm("slow_step", times=0, ms=25.0)
    try:
        r2 = sched.submit([5, 66, 31], 10_000, _greedy(),
                          deadline=time.perf_counter() + 0.2)
        with pytest.raises(RequestError) as ei:
            for _ in range(200):
                sched.step()
                if r2.finished.is_set():
                    list(r2.tokens(timeout=5))
                    break
        assert ei.value.code == "deadline"
    finally:
        FAULTS.clear()
    r3 = sched.submit([7, 3, 91, 4], 5, _greedy())
    _run(sched, [r3])
    assert list(r3.tokens(timeout=5)) == _oracle(tiny, [7, 3, 91, 4], 5)
    sched.close()


def test_draft_frontier_clamped_to_verified_stream(tiny):
    sched = _spec_sched(tiny, batch=1)
    r = sched.submit([1, 9, 23, 54], 20, _greedy())
    saw_rejection = False
    for _ in range(200):
        if r.finished.is_set():
            break
        sched.step()
        s = sched.slots[0]
        if s.req is not None:
            assert s.draft_pos <= s.pos, (s.draft_pos, s.pos)
        blk = sched.stats.spec
        saw_rejection |= blk.drafted > blk.accepted
    assert r.finished.is_set() and saw_rejection
    assert list(r.tokens(timeout=5)) == _oracle(tiny, [1, 9, 23, 54], 20)
    sched.close()


def test_prefix_cache_seed_is_prefilled_into_the_draft(tiny):
    """A prefix-cache hit seeds the target's cache, not the draft's: the
    draft catch-up prefills the seeded prompt from the row's tokens, and
    the speculating row's tokens stay the oracle's."""
    eng = _engine(tiny, 2)
    pc = PrefixCache(eng, num_blocks=16, block_len=4)
    sched = Scheduler(eng, chunk=8, prefix_cache=pc,
                      draft_factory=lambda e: DraftModel.self_draft(e, 2),
                      draft_len=4, draft_vocab=128)
    shared = [3, 14, 15, 92, 65, 35, 89, 79, 32, 38, 46, 26]
    for tail in ([5], [7, 9]):
        r = sched.submit(shared + tail, 10, _greedy())
        _run(sched, [r])
        assert list(r.tokens(timeout=5)) == _oracle(tiny, shared + tail, 10)
    assert pc.stats.hits == 1 and pc.stats.tokens_saved == 12
    assert sched.stats.spec.accepted > 0
    sched.close()


def _fake_capture(fn):
    """CUDA graph capture faked on the CPU: a replay reruns fn eagerly and
    copies its outputs into the captured ones, as a real replay rewrites
    its pool."""
    out = fn()

    def leaves(o):
        return [o] if isinstance(o, torch.Tensor) else list(o or ())

    def replay():
        for a, b in zip(leaves(out), leaves(fn())):
            a.copy_(b)
    return graphs.CapturedStep(types.SimpleNamespace(replay=replay, reset=lambda: None),
                               out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.001, 0)


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(engine_mod, "capture", _fake_capture)
    monkeypatch.setattr(draft_mod, "capture", _fake_capture)
    COMPILES.reset()
    yield
    COMPILES.reset()


def test_spec_serving_captures_nothing_after_warmup(tiny, fake_graphs):
    """Warmup captures the draft's proposal and the verify (graph keys
    recorded in COMPILES); a whole speculative serve then captures nothing
    more, even with the ledger frozen, and its tokens are the oracle's."""
    eng = _engine(tiny, 2)
    eng.cuda_graphs = True           # as a CUDA engine has it
    sched = Scheduler(eng, chunk=8,
                      draft_factory=lambda e: DraftModel.self_draft(e, 2),
                      draft_len=4, draft_vocab=128)
    sched.warmup()
    assert set(eng.graphs) == {"slot_decode", ("slot_verify", 5, 128)}
    assert set(sched.draft.graphs) == {("sdraft_scan", "self2", 4, 128)}
    keys = set(COMPILES.summary()["by_key"])
    assert {"slot_decode", "slot_verify:5:128", "sdraft_scan:self2:4:128"} <= keys
    COMPILES.freeze = True
    prompts = ([1, 9, 23, 54, 7], [2, 40], [5, 66, 31])
    reqs = [sched.submit(p, 8, _greedy()) for p in prompts]
    _run(sched, reqs)
    for r, p in zip(reqs, prompts):
        assert list(r.tokens(timeout=5)) == _oracle(tiny, p, 8)
    assert COMPILES.summary()["after_warmup"] == 0
    assert sched.stats.spec.verify_forwards >= 1
    sched.close()


def test_supervisor_rebuild_with_draft_armed(tiny):
    """A crash with drafting armed: the dying generation's requests get
    structured frames, its draft is released with its engine, and the
    rebuilt generation drafts over its own engine at oracle parity."""
    from distributed_llama_tpu_torch.runtime.resilience import EngineSupervisor

    spec, params, _, _ = tiny
    sup = EngineSupervisor(lambda: _engine(tiny, 2), chunk=8, stall_timeout=60.0,
                           backoff_base=0.01, breaker_threshold=5,
                           draft="self:2", draft_len=4, draft_vocab=128)
    try:
        p = [1, 9, 23, 54]
        FAULTS.arm("slow_step", times=0, ms=25.0)
        req = sup.submit(p, 40, _greedy())
        it = req.tokens(timeout=30.0)
        next(it)
        draft0 = sup._sched.draft
        FAULTS.arm("step_raise")
        with pytest.raises(RequestError) as ei:
            for _ in it:
                pass
        assert ei.value.code == "engine_error"
        deadline = time.perf_counter() + 30.0
        while not sup.ready and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert sup.ready, sup.state
        FAULTS.clear()
        assert sup._sched.draft is not draft0 and draft0.cache is None
        assert sup._sched.draft.engine is sup._sched.engine
        req2 = sup.submit(p, 6, _greedy())
        assert list(req2.tokens(timeout=60.0)) == _oracle(tiny, p, 6)
        assert sup._sched.stats.spec.verify_forwards >= 1
    finally:
        FAULTS.clear()
        sup.close()


# -- observability ---------------------------------------------------------------


def _spec_lines(text):
    return sorted(l for l in text.splitlines() if "spec" in l)


def test_spec_stats_block_and_metrics_family_equal_jax(tiny):
    outs = []
    for sched, smp in ((_spec_sched(tiny), _greedy), (_jax_spec_sched(tiny), _jgreedy)):
        r = sched.submit([1, 9, 23, 54], 6, smp())
        _run(sched, [r])
        list(r.tokens(timeout=5))
        outs.append(sched.stats.summary()["spec"])
        sched.close()
    blk, jblk = outs
    assert blk == jblk and blk["mode"] == "self2" and blk["draft_len"] == 4
    assert blk["drafted"] > 0 and 0.0 <= blk["accept_rate"] <= 1.0
    assert _spec_lines(render_prometheus({"spec": blk})) == \
        _spec_lines(jax_render({"spec": jblk}))
    off = Scheduler(_engine(tiny, 2), chunk=8).stats.summary()["spec"]
    joff = JaxScheduler(_jengine(tiny, 2), chunk=8).stats.summary()["spec"]
    assert off == joff and off["mode"] == "off" and off["verify_forwards"] == 0
    assert "dllama_spec_mode" in render_prometheus({"spec": off})


# -- the legacy API path, chat and the CLI against the JAX ones -----------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(19), seq_len=192)


CPU_F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


def test_api_draft_decode_matches_jax(files):
    mpath, tpath = files
    argv = ["api", "--model", mpath, "--tokenizer", tpath, "--steps", "8",
            "--temperature", "0", "--seed", "3"] + CPU_F32

    def states(draft):
        je, jt, js = jax_dllama.build_engine(jax_dllama.build_argparser().parse_args(argv))
        pe, pt, ps = dllama.build_engine(dllama.build_argparser().parse_args(
            argv + ["--device", "cpu"]))
        kw = dict(draft=draft, draft_len=4 if draft else 0)
        return api_server.ApiState(pe, pt, ps, **kw), jax_api.ApiState(je, jt, js, **kw)

    body = {"messages": [{"role": "user", "content": "abab"}],
            "max_tokens": 8, "temperature": 0}
    plain, _ = states(None)
    st, jst = states("self:1")
    got = list(api_server._completion_chunks(st, body))
    assert got == list(jax_api._completion_chunks(jst, body))
    assert got == list(api_server._completion_chunks(plain, body))
    fwd, n = st.engine.last_accept_stats
    assert n >= fwd
    body_s = {"messages": [{"role": "user", "content": "abab"}],
              "max_tokens": 6, "temperature": 0.8, "seed": 11}
    before = st.sampler.rng_state
    assert list(api_server._completion_chunks(st, body_s)) == \
        list(jax_api._completion_chunks(jst, body_s))
    assert st.sampler.rng_state == before
    blk = st.spec_stats.summary()
    assert blk == jst.spec_stats.summary() and blk["mode"] == "self:1"
    assert "dllama_spec_mode" in render_prometheus({"spec": blk})


def test_api_scheduler_path_drafts_per_slot(files):
    """`dllama api --serve-batch 2 --draft self:1`: the supervisor's
    scheduler drafts, and its text is the legacy path's."""
    mpath, tpath = files
    argv = ["api", "--model", mpath, "--tokenizer", tpath, "--temperature",
            "0", "--seed", "3", "--device", "cpu"] + CPU_F32
    pe, pt, ps = dllama.build_engine(dllama.build_argparser().parse_args(argv))
    body = {"messages": [{"role": "user", "content": "abab"}],
            "max_tokens": 8, "temperature": 0}
    want = list(api_server._completion_chunks(api_server.ApiState(pe, pt, ps), body))
    st = api_server.ApiState(pe, pt, ps, serve_batch=2, draft="self:1", draft_len=3)
    try:
        got = list(api_server._sched_completion_chunks(st, body))
        summ = st._scheduler.summary()
    finally:
        st._scheduler.close()
    assert got == want
    assert summ["spec"]["mode"] == "self1" and summ["spec"]["verify_forwards"] >= 1


def _chat(main, argv, lines, monkeypatch, capsys):
    it = iter(lines)

    def fake_input(*a):
        try:
            return next(it)
        except StopIteration:
            raise EOFError
    monkeypatch.setattr(builtins, "input", fake_input)
    main(argv)
    return capsys.readouterr().out.splitlines()


def _replies(lines):
    """The assistant's reply lines of a chat transcript."""
    return [lines[i + 1] for i, l in enumerate(lines[:-1]) if l == "🤖 Assistant"]


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_chat_draft_matches_jax(files, monkeypatch, capsys, temperature, tmp_path):
    """Two chat turns with --draft self:1 print the JAX chat's transcript
    (the draft catching up on the whole conversation each turn); with
    --session the second process resumes and the draft prefills the
    loaded history."""
    mpath, tpath = files
    argv = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "6",
            "--seed", "7", "--temperature", temperature, "--draft", "self:1"] + CPU_F32
    lines = ["", "abab", "abab"]
    want = _chat(jax_dllama.main, argv, lines, monkeypatch, capsys)
    got = _chat(dllama.main, argv + ["--device", "cpu"], lines, monkeypatch, capsys)
    assert got[-4:] == want[-4:] and _replies(got) == _replies(want)
    if temperature == "0":
        plain = [a for a in argv if a not in ("--draft", "self:1")]
        assert _replies(got) == _replies(_chat(
            dllama.main, plain + ["--device", "cpu"], lines, monkeypatch, capsys))
        sess = ["--session", str(tmp_path / "s.npz")]
        first = _chat(dllama.main, argv + ["--device", "cpu"] + sess, ["", "abab"],
                      monkeypatch, capsys)
        second = _chat(dllama.main, argv + ["--device", "cpu"] + sess, ["abab"],
                       monkeypatch, capsys)
        assert _replies(first) + _replies(second) == _replies(got)
        assert len(_replies(got)) == 2


def test_cli_draft_matches_jax(files, capsys):
    mpath, tpath = files
    base = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt",
            "abab", "--steps", "8", "--seed", "7"] + CPU_F32
    dllama.main(base + ["--temperature", "0", "--device", "cpu"])
    plain = capsys.readouterr().out.splitlines()[-1]
    dllama.main(base + ["--temperature", "0", "--draft", "self:1", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    jax_dllama.main(base + ["--temperature", "0", "--draft", "self:1"])
    assert got == plain == capsys.readouterr().out.splitlines()[-1]
    inf = ["inference"] + base[1:] + ["--temperature", "0.8", "--draft", "self:1",
                                      "--draft-len", "3"]
    dllama.main(inf + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    jax_dllama.main(inf)
    want = capsys.readouterr().out.splitlines()
    assert got[-3:-1] == want[-3:-1] and "draft self:1" in got[-2]
