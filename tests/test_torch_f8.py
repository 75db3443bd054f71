"""The port's fp8 (e4m3) KV cache held against the JAX package's, on the
CPU (the cases of tests/test_f8_cache.py): writes saturate instead of
making NaN, the flash kernel's plain version reads an e4m3 cache as the
Pallas kernel does in interpret mode, the e4m3 bit helpers agree on all
256 codes, and an f8-cache engine tracks the JAX one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.models.params import \
    random_tensors as jax_random_tensors
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.ops.pallas_attention import (_f8_bits_to,
                                                        flash_attention)
from distributed_llama_tpu.ops.pallas_attention import \
    saturate_f8_nan_codes as jax_saturate
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.params import (load_params,
                                                       random_tensors)
from distributed_llama_tpu_torch.models.spec import ModelSpec
from distributed_llama_tpu_torch.models.transformer import _to_cache_dtype
from distributed_llama_tpu_torch.ops import cuda_attention
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.testing import write_fixture

F8 = torch.float8_e4m3fn
PROMPT = [1, 7, 3, 9, 4, 2]
# tests/test_f8_cache.py: e4m3 carries ~2 significant digits, so logits
# read back from an f8 cache agree with another cache to 0.15 on O(1)
# values, and flash attention over e4m3 k/v to 2e-2
LOGITS_ATOL = 0.15
ATTN_ATOL = 2e-2


def _spec_pair():
    """The spec of tests/test_f8_cache.py (make_spec LLAMA, dim 128, 8/4
    heads, hidden 256) in both packages."""
    kw = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
              vocab_size=128, seq_len=16, rope_theta=10000.0)
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct

    return jspec, ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU,
                            **kw)


@pytest.fixture(scope="module")
def f8_engines():
    jspec, spec = _spec_pair()
    jparams = jax_load_params(jspec, jax_random_tensors(jspec, 5, 0.05),
                              mode="q40", dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)

    def port(cache_dtype):
        return Engine(spec, params_from_jax(np_params, spec, "cpu"),
                      device="cpu", compute_dtype=torch.float32,
                      cache_dtype=cache_dtype)

    jax_f8 = JaxEngine(jspec, jparams, compute_dtype=jnp.float32,
                       cache_dtype=jnp.float8_e4m3fn, use_pallas=False)
    return spec, jax_f8, port(F8), port(torch.float32)


def test_cache_write_clamps_before_the_cast():
    x = torch.tensor([1000.0, -1e6, 3.0, 447.9, -0.01])
    got = _to_cache_dtype(x, F8)
    assert got.dtype == F8
    np.testing.assert_array_equal(got.float().numpy()[:3], [448.0, -448.0, 3.0])
    assert torch.equal(_to_cache_dtype(x, torch.float32), x)


def test_f8_write_saturates_outliers():
    """K outliers beyond e4m3's +-448 saturate, so the cache holds no NaN
    (tests/test_f8_cache.py:72-91, with wk scaled 10x further so that
    outliers are certain: K's spread is then ~1e3)."""
    _, spec = _spec_pair()
    host = random_tensors(spec, seed=5, scale=0.05)
    wk = host["layers.0.wk"]
    host["layers.0.wk"] = dataclasses.replace(wk, data=wk.to_f32() * 40000.0)
    params = load_params(spec, host, mode="dense", dtype=torch.float32,
                         device="cpu")
    eng = Engine(spec, params, device="cpu", compute_dtype=torch.float32,
                 cache_dtype=F8)
    logits = eng.fetch_logits(eng.step(np.asarray([PROMPT], np.int32), 0))
    assert np.isfinite(logits).all()
    k0 = eng.cache.k[0].float()
    assert not torch.isnan(k0).any()
    assert k0.abs().max().item() == 448.0


@pytest.mark.parametrize("t,qdt", [(1, "f32"), (4, "f32"), (1, "bf16")])
def test_f8_flash_plain_matches_pallas_interpret(t, qdt):
    """The plain flash attention over an e4m3 cache against the Pallas
    kernel in interpret mode (tests/test_f8_cache.py:94-111): both read
    the same uint8 bits; q stays in its own dtype, and so does the output."""
    rng = np.random.default_rng(3 + t)
    b, h, kvh, s, hs = 1, 8, 4, 256, 128
    q = rng.standard_normal((b, t, h, hs)).astype(np.float32)
    k8 = jnp.asarray(rng.standard_normal((b, kvh, s, hs)), jnp.float8_e4m3fn)
    v8 = jnp.asarray(rng.standard_normal((b, kvh, s, hs)), jnp.float8_e4m3fn)
    pos = (100 + np.arange(t, dtype=np.int32))[None, :]
    jdt, tdt = ((jnp.float32, torch.float32) if qdt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = flash_attention(jnp.asarray(q, jdt), k8, v8, jnp.asarray(pos),
                           interpret=True)
    assert want.dtype == jdt

    def bits(a):
        return torch.from_numpy(np.array(a).view(np.uint8)).view(F8)

    got = cuda_attention.flash_attention(
        torch.from_numpy(q).to(tdt), bits(k8), bits(v8), torch.from_numpy(pos))
    assert got.dtype == tdt and tuple(got.shape) == (b, t, h, hs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATTN_ATOL)


def test_f8_bit_helpers_match_jax_on_all_codes():
    """f8_bits_to and saturate_f8_nan_codes against the JAX package's over
    all 256 e4m3 codes, NaN codes included (the JAX decode reads 0x7F as
    480); off the NaN codes the decode equals torch's own cast."""
    codes = np.arange(256, dtype=np.uint8)
    tcodes = torch.from_numpy(codes)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(_f8_bits_to(jnp.asarray(codes), jdt), np.float32)
        got = cuda_attention.f8_bits_to(tcodes, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    finite = (codes & 0x7F) != 0x7F
    np.testing.assert_array_equal(
        cuda_attention.f8_bits_to(tcodes).numpy()[finite],
        tcodes.view(F8).float().numpy()[finite])

    jf8 = jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn)
    want = np.asarray(jax.lax.bitcast_convert_type(jax_saturate(jf8),
                                                   jnp.uint8))
    got = cuda_attention.saturate_f8_nan_codes(tcodes.view(F8))
    assert got.dtype == F8
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    assert not torch.isnan(got.float()).any()
    x = torch.tensor([1.0, float("nan")])
    assert cuda_attention.saturate_f8_nan_codes(x) is x


def test_f8_engine_tracks_the_jax_f8_engine(f8_engines):
    """A tiny f8-cache engine against the JAX f8 engine and against its own
    f32-cache twin (tests/test_f8_cache.py:39-52)."""
    spec, jax_f8, f8, f32 = f8_engines
    for e in (f8, f32):
        e.reset()
    jax_f8.reset()
    assert f8.cache.k[0].dtype == F8
    assert f8.cache.k[0].nbytes * 4 == f32.cache.k[0].nbytes
    tok = np.asarray([PROMPT], np.int32)
    lj = np.asarray(jax_f8.step(tok, 0))
    lf = f8.fetch_logits(f8.step(tok, 0))
    lr = f32.fetch_logits(f32.step(tok, 0))
    assert np.isfinite(lf).all()
    np.testing.assert_allclose(lf, lj, rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(lf, lr, rtol=0, atol=LOGITS_ATOL)
    nxt = np.asarray([[5]], np.int32)
    l2j = np.asarray(jax_f8.step(nxt, len(PROMPT)))
    l2 = f8.fetch_logits(f8.step(nxt, len(PROMPT)))
    assert np.isfinite(l2).all()
    np.testing.assert_allclose(l2, l2j, rtol=0, atol=LOGITS_ATOL)


def test_f8_engine_generates_the_jax_f8_tokens(f8_engines):
    spec, jax_f8, f8, _ = f8_engines
    jax_f8.reset()
    f8.reset()
    want = jax_f8.generate(PROMPT, 6, JaxSampler(
        spec.vocab_size, 0.0, 0.9, 1, backend="python")).tokens
    got = f8.generate(PROMPT, 6, Sampler(spec.vocab_size, 0.0, 0.9, 1)).tokens
    assert len(got) == 6 and got == want


def test_cli_runs_with_an_f8_cache(tmp_path, capsys):
    mpath, tpath = write_fixture(tmp_path, seed=2)
    dllama.main(["inference", "--model", mpath, "--tokenizer", tpath,
                 "--prompt", "ab", "--steps", "4", "--seed", "7",
                 "--temperature", "0", "--device", "cpu",
                 "--cache-dtype", "f8"])
    assert "Generated tokens:    4" in capsys.readouterr().out
