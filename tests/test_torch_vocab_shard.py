"""The vocab split of the port (ops/sharded_vocab.py, runtime/sampling.py,
Engine(shard_vocab=)) held against the JAX package on the CPU, over gloo
ranks (parallel/launch.RankPool) and, for the host sampler, in-process:

  * the embedding gathered from each rank's vocab rows is bit-identical
    to the replicated gather;
  * the sharded argmax follows the pinned tie-break (the lowest id among
    equal maxima, within and across ranks), as np.argmax and the JAX
    sharded_sample_prep pick;
  * the per-rank summary (top-k candidates and guards) equals the JAX
    one: the same ids, the probabilities within f32 rounding;
  * sample_candidates equals the JAX function on the same candidates and
    coins, the fallback (None) included, and leaves the sampler's stream
    where the JAX one leaves it;
  * a vocab-sharded tp = 2 engine samples generate_batch at temperature
    0.8 as the JAX vocab-sharded engine does, through the candidates
    (exact) and through the one-row fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llama_tpu.ops.sharded_vocab import \
    sharded_sample_prep as jax_prep
from distributed_llama_tpu.parallel import make_mesh as jax_make_mesh
from distributed_llama_tpu.runtime import sampling as jax_sampling
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.runtime import sampling
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import ENGINE, F32, JOBS, Case


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


def _inputs(seed, b=3, v=96, dim=16, peak=1.0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((v, dim)).astype(np.float32)
    tokens = rng.integers(0, v, size=(b, 5)).astype(np.int32)
    logits = (rng.standard_normal((b, v)) * peak).astype(np.float32)
    return emb, tokens, logits


def _vocab_job(pool, tp, emb, tokens, logits, temps, n_vocab, k):
    return pool.run(f"{JOBS}:vocab", tp, emb, tokens, logits, temps,
                    n_vocab, k)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_embedding_is_bit_identical(tp, pool2, pool4):
    emb, tokens, logits = _inputs(tp)
    got = _vocab_job(pool2 if tp == 2 else pool4, tp, emb, tokens, logits,
                     np.ones(3, np.float32), 96, 4)
    for r in got:
        np.testing.assert_array_equal(r["emb"], emb[tokens])


def test_sharded_argmax_follows_the_pinned_tie_break(pool4):
    """Row 0: the maximum at ids 10 and 30 (ranks 0 and 1) -> 10; row 1:
    at 50 and 51 (one rank) -> 50; row 2: the maximum past n_vocab is
    masked, the next at 40 and 70 -> 40."""
    emb, tokens, logits = _inputs(7)
    logits[0, [10, 30]] = 9.0
    logits[1, [50, 51]] = 9.0
    logits[2, 90] = 50.0
    logits[2, [40, 70]] = 9.0
    n_vocab = 88
    temps = np.ones(3, np.float32)
    got = _vocab_job(pool4, 4, emb, tokens, logits, temps, n_vocab, 4)
    want = jax_prep(jnp.asarray(logits), jnp.asarray(temps),
                    jax_make_mesh(tp=4), ("tp",), n_vocab, 4)[0]
    assert list(got[0]["prep"][0]) == [10, 50, 40] == list(np.asarray(want))
    assert list(got[0]["prep"][0]) == list(np.argmax(logits[:, :n_vocab], -1))


@pytest.mark.parametrize("tp", [2, 4])
def test_sample_prep_matches_jax(tp, pool2, pool4):
    emb, tokens, logits = _inputs(20 + tp, peak=3.0)
    temps = np.asarray([0.8, 1.0, 0.5], np.float32)
    got = _vocab_job(pool2 if tp == 2 else pool4, tp, emb, tokens, logits,
                     temps, 90, 5)
    want = [np.asarray(a) for a in jax_prep(
        jnp.asarray(logits), jnp.asarray(temps), jax_make_mesh(tp=tp),
        ("tp",), 90, 5)]
    for r in got:
        amax, cand_p, cand_id, guard = r["prep"]
        np.testing.assert_array_equal(amax, want[0])
        np.testing.assert_array_equal(cand_id, want[2])
        np.testing.assert_allclose(cand_p, want[1], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(guard, want[3], rtol=1e-6, atol=1e-9)


def _summary(rng, v, shards, k, peak):
    """A per-shard top-k summary of one softmax row, as the device
    computes it (candidates desc per shard, the k-th as the guard)."""
    x = rng.standard_normal(v) * peak
    p = np.exp(x - x.max())
    p = (p / p.sum()).astype(np.float32)
    vl = v // shards
    cp, ci, gd = [], [], []
    for s in range(shards):
        loc = p[s * vl:(s + 1) * vl]
        order = np.lexsort((np.arange(vl), -loc))[:k]
        cp.append(loc[order])
        ci.append(s * vl + order)
        gd.append(loc[order[-1]])
    return (np.concatenate(cp), np.concatenate(ci).astype(np.int32),
            np.asarray(gd, np.float32), int(np.argmax(p)))


@pytest.mark.parametrize("case", range(24))
def test_sample_candidates_matches_jax(case):
    """The same candidates and coins give the same token (or the same
    fallback) and the same stream position in both packages. Peaked rows
    (exact through the candidates) and flat ones (the fallback) alike."""
    rng = np.random.default_rng(case)
    peak = (8.0, 3.0, 0.5)[case % 3]
    topp = (0.9, 0.5, 0.99, 0.0)[case % 4]
    cand_p, cand_id, guard, amax = _summary(rng, 128, 4, 4, peak)
    seed = 1000 + case
    mine, theirs = Sampler(128, 0.8, topp, seed), JaxSampler(
        128, 0.8, topp, seed, backend="python")
    got = sampling.sample_candidates(mine, cand_p, cand_id, guard, amax)
    want = jax_sampling.sample_candidates(theirs, cand_p, cand_id, guard, amax)
    assert got == want
    assert mine.rng_state == theirs.rng_state


def test_the_candidate_cases_reach_both_outcomes():
    """The cases above hold both branches: an exact draw and a fallback."""
    outcomes = set()
    for case in range(24):
        rng = np.random.default_rng(case)
        cand_p, cand_id, guard, amax = _summary(
            rng, 128, 4, 4, (8.0, 3.0, 0.5)[case % 3])
        s = Sampler(128, 0.8, (0.9, 0.5, 0.99, 0.0)[case % 4], 1000 + case)
        outcomes.add(sampling.sample_candidates(s, cand_p, cand_id, guard,
                                                amax) is None)
    assert outcomes == {True, False}


@pytest.mark.parametrize("scale", [1.0, 500.0], ids=["flat", "peaked"])
def test_sharded_batch_sampling_matches_jax(scale, pool2):
    """generate_batch at temperature 0.8 on a vocab-sharded tp = 2 engine:
    the JAX vocab-sharded engine's stream, the one-device port's stream;
    flat logits fall back to one replicated row, peaked ones sample from
    the candidates."""
    case = Case("LLAMA", "dense", seed=31, wcls_scale=scale)
    prompts = [[1, 5, 9], [2, 7], [3, 3, 3, 3], [8]]
    v = case.spec.vocab_size
    jeng = case.jax_engine(tp=2, batch=4, shard_vocab=True)
    want = jeng.generate_batch(prompts, 6, JaxSampler(v, 0.8, 0.9, 5,
                                                      backend="python"))
    one = Engine(case.pspec, case.params(), device="cpu", batch=4, **F32)
    assert one.generate_batch(prompts, 6, Sampler(v, 0.8, 0.9, 5)) == want
    got = pool2.run(ENGINE, 2, 1, case.blob, dict(F32, batch=4,
                                                  shard_vocab=True),
                    [("generate_batch", (prompts, 6, Sampler(v, 0.8, 0.9, 5)),
                      {})])
    assert got[0]["shard_vocab"]
    assert got[0]["results"][0] == got[1]["results"][0] == want
    stats = got[0]["vocab_sample_stats"]
    assert stats["sharded" if scale > 1 else "fallback"] > 0, stats
