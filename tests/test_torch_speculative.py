"""The port's prompt-lookup speculation held against the JAX package's
(runtime/speculative.py, Engine.generate_lookup*, tests/test_speculative.py
case by case), on the CPU, all f32.

The numpy helpers (find_draft, target_dist, draw, accept_or_resample,
accept_or_resample_q, count_accepted) must return the JAX package's values
bit for bit, on seeded and hypothesis inputs. Greedy lookup must give the
JAX engine's tokens, forwards and accept record, and the port's plain
generate()'s tokens (draft lengths 1, 3 and 7, eos, budget 0, the context
edge, a padded vocab). Sampled lookup draws the same numpy PCG64 uniforms
in the same order as the JAX engine, so at the same seed it gives the same
tokens. The legacy API path, chat and the CLI with --lookup-decode print
what the JAX ones print.
"""

import builtins

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import speculative as jspec
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import speculative as pspec
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

PROMPT = [1, 5, 9, 1, 5]   # a repeated bigram seeds the n-gram table


def _pair(seed: int, scale: float = 0.05, seq_len: int = 96, n_layers: int = 2):
    """The port and JAX engines over the same dense f32 weights."""
    kw = dict(dim=64, hidden_dim=96, n_layers=n_layers, n_heads=8,
              n_kv_heads=4, vocab_size=128, seq_len=seq_len)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jsp = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=seed, scale=scale),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jsp, jax_params.random_tensors(
        jsp, seed=seed, scale=scale), mode="dense", dtype=jnp.float32)
    eng = Engine(spec, params, device="cpu", compute_dtype=torch.float32,
                 cache_dtype=torch.float32)
    jeng = JaxEngine(jsp, jp, compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    return spec, eng, jeng


@pytest.fixture(scope="module")
def pair():
    return _pair(41)


def _greedy(v):
    return Sampler(v, 0.0, 0.9, 1)


def _fresh(*engines):
    for e in engines:
        e.reset()
    return engines


# -- the numpy helpers against the JAX package's -------------------------------


def test_find_draft_cases():
    """tests/test_speculative.py's find_draft cases on the port's copy."""
    h = np.asarray([5, 6, 7, 9, 5, 6, 7], np.int32)
    assert pspec.find_draft(h, 4) == [9, 5, 6, 7]
    assert pspec.find_draft(h, 1) == [9]
    assert pspec.find_draft(np.asarray([1, 2, 3, 4], np.int32), 4) == []
    assert pspec.find_draft(np.asarray([4, 8, 2, 4], np.int32), 2) == [8, 2]
    h2 = np.asarray([3, 1, 7, 3, 1, 8, 3, 1], np.int32)
    assert pspec.find_draft(h2, 1, max_ngram=2) == [8]
    h3 = np.asarray([1, 2, 9, 8, 7, 1, 2, 1, 2], np.int32)
    assert pspec.find_draft(h3, 3, max_ngram=2) == [9, 8, 7]
    assert pspec.find_draft(h3, 2, max_ngram=2) == [1, 2]


def _helpers_agree(rng: np.random.Generator) -> None:
    n = int(rng.integers(1, 48))
    h = rng.integers(0, int(rng.integers(2, 8)), n).astype(np.int32)
    for k in (1, 3, 7):
        for mx in (1, 2, 3):
            assert pspec.find_draft(h, k, max_ngram=mx) == \
                jspec.find_draft(h, k, max_ngram=mx)
    v = int(rng.integers(2, 96))
    logits = (rng.standard_normal(v + 3) * rng.uniform(0.1, 6.0)).astype(np.float32)
    temp, topp = float(rng.uniform(0.05, 2.0)), float(rng.choice([0.0, 0.5, 0.9, 0.99, 1.0]))
    p = pspec.target_dist(logits, temp, topp, v)
    np.testing.assert_array_equal(p, jspec.target_dist(logits, temp, topp, v))
    q = pspec.target_dist(logits[::-1].copy(), temp, topp, v)
    u = rng.random(3)
    d = int(rng.integers(0, v))
    assert pspec.draw(p, u[0]) == jspec.draw(p, u[0])
    assert pspec.accept_or_resample(p, d, u[1], u[2]) == \
        jspec.accept_or_resample(p, d, u[1], u[2])
    assert pspec.accept_or_resample_q(p, q, d, u[1], u[2]) == \
        jspec.accept_or_resample_q(p, q, d, u[1], u[2])
    draft = [int(x) for x in rng.integers(0, 4, int(rng.integers(0, 8)))]
    greedy = rng.integers(0, 4, len(draft) + 1)
    assert pspec.count_accepted(draft, greedy) == jspec.count_accepted(draft, greedy)


def test_helpers_equal_jax_on_seeded_inputs():
    for seed in range(300):
        _helpers_agree(np.random.default_rng(seed))


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_helpers_equal_jax_on_hypothesis_inputs(seed):
    _helpers_agree(np.random.default_rng(seed))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=0, max_size=40),
       st.integers(1, 8), st.integers(1, 4))
def test_find_draft_equals_jax_on_hypothesis_histories(hist, k, mx):
    h = np.asarray(hist, np.int32)
    assert pspec.find_draft(h, k, max_ngram=mx) == jspec.find_draft(h, k, max_ngram=mx)


def test_accept_or_resample_marginal_is_exact():
    """Marginalizing the port's accept/resample step over its two uniforms
    reproduces p, for every draft token (JAX test_speculative.py:320)."""
    rng = np.random.default_rng(11)
    p = np.asarray([0.5, 0.3, 0.15, 0.05])
    for d in range(4):
        counts = np.zeros(4)
        n = 40_000
        for _ in range(n):
            _, t = pspec.accept_or_resample(p, d, rng.random(), rng.random())
            counts[t] += 1
        np.testing.assert_allclose(counts / n, p, atol=0.012, err_msg=f"draft={d}")
    assert pspec.accept_or_resample(np.asarray([0.0, 1.0]), 1, 0.999, 0.5) == (True, 1)


def test_target_dist_matches_host_sampler():
    """target_dist is the distribution the port's Sampler draws from."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal(64).astype(np.float32) * 2.0
    p = pspec.target_dist(logits, 0.8, 0.9, 64)
    assert abs(p.sum() - 1.0) < 1e-9
    smp = Sampler(64, 0.8, 0.9, seed=123)
    counts = np.zeros(64)
    n = 50_000
    for _ in range(n):
        counts[smp.sample(logits)] += 1
    np.testing.assert_allclose(counts / n, p, atol=0.01)
    assert set(np.nonzero(counts)[0]) <= set(np.nonzero(p)[0])


# -- greedy lookup against the JAX engine and plain generate -------------------


@pytest.mark.parametrize("draft_len", [1, 3, 7])
def test_lookup_matches_jax_and_plain_greedy(pair, draft_len):
    spec, eng, jeng = pair
    eng, jeng = _fresh(eng, jeng)
    want = eng.generate(PROMPT, 24, _greedy(spec.vocab_size)).tokens
    eng.reset()
    got = eng.generate_lookup(PROMPT, 24, draft_len=draft_len)
    jgot = jeng.generate_lookup(PROMPT, 24, draft_len=draft_len)
    assert got.tokens == want == jgot.tokens
    assert eng.last_accept_stats == jeng.last_accept_stats
    assert eng.last_spec == jeng.last_spec
    fwd, n = eng.last_accept_stats
    assert n == len(want) and fwd <= n + 1
    assert eng.pos == jeng.pos == len(PROMPT) + len(want) - 1
    # the run's stats: the prefill plus one record a verify forward, its
    # device ms (verify + logits copy) and host ms (mining, accepting)
    assert len(got.stats.steps) == fwd
    assert all(s.device_ms >= 0 and s.host_ms >= 0 for s in got.stats.steps)


def test_lookup_eos_budget_zero_and_context_edge(pair):
    spec, eng, jeng = pair
    eng, jeng = _fresh(eng, jeng)
    probe = eng.generate_lookup(PROMPT, 16).tokens
    eos = probe[5]
    for e in _fresh(eng, jeng):
        out = e.generate_lookup(PROMPT, 16, eos_id=eos).tokens
        assert out == probe[: probe.index(eos) + 1]
        assert e.pos == len(PROMPT) + len(out) - 1
    # continuing from the rewound position equals an unbroken greedy run
    cont = eng.generate([out[-1]], 4, _greedy(spec.vocab_size)).tokens
    eng.reset()
    full = eng.generate(PROMPT + out, 4, _greedy(spec.vocab_size)).tokens
    assert cont == full

    for e in _fresh(eng, jeng):
        assert e.generate_lookup([1, 5, 9], 0).tokens == []
        assert e.pos == 3 and e.last_accept_stats == (1, 0)
        assert e.last_spec == {"forwards": 1, "drafted": 0, "accepted": 0,
                               "emitted": 0}

    # the context edge: drafts shrink to the headroom, the run stops at S
    edge = (PROMPT * 20)[: spec.seq_len - 6]
    eng, jeng = _fresh(eng, jeng)
    want = eng.generate(edge, 40, _greedy(spec.vocab_size)).tokens
    eng.reset()
    got = eng.generate_lookup(edge, 40, draft_len=7).tokens
    assert got == want == jeng.generate_lookup(edge, 40, draft_len=7).tokens
    assert eng.pos == jeng.pos == spec.seq_len
    assert eng.last_spec == jeng.last_spec


def test_lookup_respects_tokenizer_vocab_truncation(pair):
    spec, eng, jeng = pair
    eng, jeng = _fresh(eng, jeng)
    want = eng.generate(PROMPT, 12, Sampler(96, 0.0, 0.9, 1)).tokens
    eng.reset()
    got = eng.generate_lookup(PROMPT, 12, draft_len=4, vocab_size=96).tokens
    assert got == want == jeng.generate_lookup(PROMPT, 12, draft_len=4,
                                               vocab_size=96).tokens
    assert all(t < 96 for t in got)


def test_lookup_accepts_on_repetitive_continuation():
    """A model whose greedy continuation loops confirms several tokens a
    forward, and the JAX engine confirms the same."""
    spec, eng, jeng = _pair(43, seq_len=160)
    probe = eng.generate([2, 7], 96, _greedy(spec.vocab_size)).tokens
    tail = probe[-24:]
    assert len(set(tail)) <= len(tail) - 4, "the greedy stream must loop"
    eng.reset()
    out = eng.generate_lookup([2, 7], 96, draft_len=7)
    assert out.tokens == probe == jeng.generate_lookup([2, 7], 96, draft_len=7).tokens
    fwd, n = eng.last_accept_stats
    assert (fwd, n) == jeng.last_accept_stats and n / fwd > 1.5


# -- sampled lookup against the JAX engine at the same seed --------------------


@pytest.mark.parametrize("seed,draft_len", [(9, 3), (5000, 7), (123, 1)])
def test_lookup_sampled_matches_jax(pair, seed, draft_len):
    """Same logits (f32, to ~1e-6), same uniforms in the same order: the
    same tokens and the same accept record. History primed with the
    greedy continuation, so drafts are proposed and accepted."""
    spec, eng, jeng = pair
    eng, jeng = _fresh(eng, jeng)
    probe = eng.generate(PROMPT, 24, _greedy(spec.vocab_size)).tokens
    kw = dict(temperature=0.8, topp=0.9, seed=seed, draft_len=draft_len,
              history=PROMPT + probe)
    eng.reset()
    got = eng.generate_lookup_sampled(PROMPT, 16, **kw).tokens
    want = jeng.generate_lookup_sampled(PROMPT, 16, **kw).tokens
    assert got == want and len(got) == 16
    assert eng.last_spec == jeng.last_spec
    assert eng.last_spec["drafted"] > 0


def test_lookup_sampled_eos_and_budget(pair):
    spec, eng, jeng = pair
    eng, jeng = _fresh(eng, jeng)
    probe = eng.generate_lookup_sampled(PROMPT, 16, temperature=0.8,
                                        topp=0.9, seed=9).tokens
    assert len(probe) == 16
    eos = probe[5]
    for e in _fresh(eng, jeng):
        out = e.generate_lookup_sampled(PROMPT, 16, temperature=0.8, topp=0.9,
                                        seed=9, eos_id=eos).tokens
        assert out == probe[: probe.index(eos) + 1]
        assert e.pos == len(PROMPT) + len(out) - 1
    with pytest.raises(ValueError, match="greedy"):
        next(eng.generate_lookup_sampled_stream(PROMPT, 4, temperature=0.0,
                                                topp=0.9, seed=1))


# -- the legacy API path, chat and the CLI against the JAX ones ----------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(19), seq_len=192)


CPU_F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


def _states(files, **kw):
    mpath, tpath = files
    argv = ["api", "--model", mpath, "--tokenizer", tpath, "--steps", "8",
            "--temperature", "0", "--seed", "3"] + CPU_F32
    je, jt, js = jax_dllama.build_engine(jax_dllama.build_argparser().parse_args(argv))
    pe, pt, ps = dllama.build_engine(dllama.build_argparser().parse_args(
        argv + ["--device", "cpu"]))
    return (api_server.ApiState(pe, pt, ps, **kw),
            jax_api.ApiState(je, jt, js, **kw))


def test_api_lookup_decode_matches_jax(files):
    """Greedy requests speculate with the plain path's text; sampled ones
    take the rejection stream seeded from the request's seed and give the
    JAX server's text; the legacy tier's `spec` block equals JAX's."""
    st, jst = _states(files, lookup_decode=5)
    plain, _ = _states(files)
    body = {"messages": [{"role": "user", "content": "abab"}],
            "max_tokens": 8, "temperature": 0}
    got = list(api_server._completion_chunks(st, body))
    assert got == list(jax_api._completion_chunks(jst, body))
    assert got == list(api_server._completion_chunks(plain, body))
    fwd, n = st.engine.last_accept_stats
    assert n >= fwd and (fwd, n) == jst.engine.last_accept_stats
    body_s = {"messages": [{"role": "user", "content": "abab"}],
              "max_tokens": 6, "temperature": 0.8, "seed": 11}
    before = st.sampler.rng_state
    assert list(api_server._completion_chunks(st, body_s)) == \
        list(jax_api._completion_chunks(jst, body_s))
    assert st.sampler.rng_state == before
    assert st.spec_stats.summary() == jst.spec_stats.summary()
    assert st.spec_stats.summary()["mode"] == "lookup"
    assert st.cached_tokens == jst.cached_tokens


def _chat(main, argv, lines, monkeypatch, capsys):
    it = iter(lines)

    def fake_input(*a):
        try:
            return next(it)
        except StopIteration:
            raise EOFError
    monkeypatch.setattr(builtins, "input", fake_input)
    main(argv)
    return capsys.readouterr().out.splitlines()[-4:]


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_chat_lookup_decode_matches_jax(files, monkeypatch, capsys, temperature):
    """Two chat turns mining the whole conversation print the JAX chat's
    transcript, and at temperature 0 the plain chat's."""
    mpath, tpath = files
    argv = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "6",
            "--seed", "7", "--temperature", temperature] + CPU_F32
    lines = ["", "abab", "abab"]
    want = _chat(jax_dllama.main, argv + ["--lookup-decode", "5"], lines,
                 monkeypatch, capsys)
    got = _chat(dllama.main, argv + ["--lookup-decode", "5", "--device", "cpu"],
                lines, monkeypatch, capsys)
    assert got == want
    if temperature == "0":
        assert got == _chat(dllama.main, argv + ["--device", "cpu"], lines,
                            monkeypatch, capsys)


def test_cli_lookup_decode_matches_jax(files, capsys):
    mpath, tpath = files
    base = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt",
            "abab", "--steps", "8", "--seed", "7"] + CPU_F32
    dllama.main(base + ["--temperature", "0", "--device", "cpu"])
    plain = capsys.readouterr().out.splitlines()[-1]
    dllama.main(base + ["--temperature", "0", "--lookup-decode", "5",
                        "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    jax_dllama.main(base + ["--temperature", "0", "--lookup-decode", "5"])
    assert got == plain == capsys.readouterr().out.splitlines()[-1]
    # temperature > 0: the sampled mode, its tokens and forwards the JAX
    # CLI's (the wall-time line differs)
    inf = ["inference"] + base[1:] + ["--temperature", "0.8", "--lookup-decode", "5"]
    dllama.main(inf + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    jax_dllama.main(inf)
    want = capsys.readouterr().out.splitlines()
    assert got[-3:-1] == want[-3:-1]
    assert "tokens/forward" in got[-2]
