"""The port's device sampler (distributed_llama_tpu_torch/ops/device_sampler.py)
held against the JAX package's ops/device_sampler.py, case for case with
tests/test_device_sampler.py: the xorshift* stream bit for bit, and the
tokens and RNG states of sample_token over many seeds, on the CPU. The JAX
sampler is jitted per (temperature, topp), as the JAX engine runs it.

Tokens must be identical: both samplers sum the CDF in f32, in their own
order, so a token could differ only where the coin falls within f32
rounding of a CDF boundary; the seeds here meet no such case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import device_sampler as jds
from distributed_llama_tpu_torch.ops import device_sampler as ds
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.utils.rng import xorshift_f32, xorshift_u32


def _state(st) -> list[int]:
    return [int(x) for x in np.asarray(st)]


def test_xorshift_bit_parity_10000_draws():
    """10,000 steps from a 64-bit seed: every u32 sample and every state
    equal to the JAX stream's (one lax.scan) and the host's."""
    seed = 987654321012345

    def body(st, _):
        st, s = jds.xorshift_step(st)
        return st, (st, s)
    _, (jstates, jsamples) = jax.lax.scan(body, jds.state_from_seed(seed), None,
                                          length=10_000)
    jstates, jsamples = np.asarray(jstates), np.asarray(jsamples)
    st, host = ds.state_from_seed(seed), seed
    for i in range(10_000):
        st, s = ds.xorshift_step(st)
        host, want = xorshift_u32(host)
        assert int(s) == want == int(jsamples[i]), i
        assert _state(st) == [host >> 32, host & 0xFFFFFFFF] == _state(jstates[i]), i


@pytest.mark.parametrize("seed", [0, 7, (1 << 64) - 1])
def test_coin_f32_parity(seed):
    st, jst, host = ds.state_from_seed(seed), jds.state_from_seed(seed), seed
    for i in range(200):
        st, c = ds.coin_f32(st)
        jst, jc = jds.coin_f32(jst)
        host, want = xorshift_f32(host)
        assert c.dtype == torch.float32
        assert float(c) == float(jc) == want, i
        assert _state(st) == _state(jst), i


def test_state_from_seed_matches_jax():
    for seed in (0, 1, 2 ** 32, 2 ** 63 + 12345, -1):
        assert _state(ds.state_from_seed(seed)) == _state(jds.state_from_seed(seed))


def test_sample_token_greedy_is_argmax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        logits = rng.standard_normal(512).astype(np.float32)
        st = ds.state_from_seed(1)
        tok, st2 = ds.sample_token(torch.from_numpy(logits), st, 0.0, 0.9)
        jtok, _ = jds.sample_token(jnp.asarray(logits), jds.state_from_seed(1), 0.0, 0.9)
        assert int(tok) == int(np.argmax(logits)) == int(jtok)
        assert st2 is st      # greedy draws no coin


@pytest.mark.parametrize("topp", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_sample_token_matches_jax_over_seeds(temperature, topp):
    """8 seeds x 25 draws each, the RNG state evolving: multinomial (topp
    0 and 1) and nucleus modes, tokens and states equal to JAX's and to
    the host Sampler's states."""
    vocab = 300
    jfn = jax.jit(lambda lg, s: jds.sample_token(lg, s, temperature, topp))
    rng = np.random.default_rng(int(temperature * 10) + int(topp * 100))
    for seed in range(8):
        st, jst = ds.state_from_seed(seed * 7919), jds.state_from_seed(seed * 7919)
        host = Sampler(vocab, temperature, topp, seed * 7919)
        for i in range(25):
            logits = (rng.standard_normal(vocab) * 2.0).astype(np.float32)
            tok, st = ds.sample_token(torch.from_numpy(logits), st, temperature, topp)
            jtok, jst = jfn(jnp.asarray(logits), jst)
            host.sample(logits)
            assert int(tok) == int(jtok), (seed, i)
            assert 0 <= int(tok) < vocab
            assert _state(st) == _state(jst) == [host.rng_state >> 32,
                                                 host.rng_state & 0xFFFFFFFF], (seed, i)


@pytest.mark.parametrize("shape", ["peaked", "uniform", "mixed"])
def test_large_vocab_matches_jax_topk_window(shape):
    """At vocab 4096 the JAX sampler takes its top-512 window when the
    nucleus lies inside it ("peaked") and its full sort when it does not
    ("uniform"); the port always sorts in full. Tokens and states equal."""
    vocab = 4096
    rng = np.random.default_rng({"peaked": 1, "uniform": 2, "mixed": 3}[shape])
    jfn = jax.jit(lambda lg, s: jds.sample_token(lg, s, 1.0, 0.9))
    st, jst = ds.state_from_seed(77), jds.state_from_seed(77)
    for i in range(30):
        scale = 4.0 if shape == "peaked" or (shape == "mixed" and i % 2 == 0) else 0.01
        logits = (rng.standard_normal(vocab) * scale).astype(np.float32)
        tok, st = ds.sample_token(torch.from_numpy(logits), st, 1.0, 0.9)
        jtok, jst = jfn(jnp.asarray(logits), jst)
        assert int(tok) == int(jtok), (shape, i)
        assert _state(st) == _state(jst)


def test_nucleus_cut_inside_fewer_candidates_than_the_window():
    """About 100 tokens above the cutoff and the rest far below (the JAX
    window's n_cand < k case): equal to JAX and to the host Sampler."""
    vocab = 4096
    rng = np.random.default_rng(5)
    logits = np.full(vocab, -12.0, np.float32)
    hot = rng.choice(vocab, size=100, replace=False)
    logits[hot] = rng.standard_normal(100).astype(np.float32)
    jfn = jax.jit(lambda lg, s: jds.sample_token(lg, s, 0.8, 0.95))
    host = Sampler(vocab, 0.8, 0.95, 5)
    st, jst = ds.state_from_seed(5), jds.state_from_seed(5)
    for i in range(20):
        tok, st = ds.sample_token(torch.from_numpy(logits), st, 0.8, 0.95)
        jtok, jst = jfn(jnp.asarray(logits), jst)
        assert int(tok) == int(jtok) == host.sample(logits.copy()), i


def test_empty_nucleus_edge():
    """topp < 1/n over near-uniform probs leaves no cutoff candidate: the
    (first) argmax, as JAX and the host Sampler take."""
    n = 8
    logits = np.full(n, 1.0, np.float32)
    logits[5] = 1.0 + 1e-4
    tok, _ = ds.sample_token(torch.from_numpy(logits), ds.state_from_seed(9), 1.0, 0.05)
    jtok, _ = jds.sample_token(jnp.asarray(logits), jds.state_from_seed(9), 1.0, 0.05)
    assert int(tok) == int(jtok) == Sampler(n, 1.0, 0.05, 9).sample(logits.copy()) == 5


def test_sample_token_stays_a_device_tensor():
    """The token is a 0-dim int64 tensor and the state a (2,) int64 one:
    nothing is read back to Python, so a captured graph can hold it."""
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    for temperature, topp in ((0.0, 0.9), (0.8, 0.0), (0.8, 0.9)):
        tok, st = ds.sample_token(logits, ds.state_from_seed(3), temperature, topp)
        assert isinstance(tok, torch.Tensor) and tok.shape == () and tok.dtype == torch.int64
        assert st.shape == (2,) and st.dtype == torch.int64
