"""The port's copies of the host code held against the JAX package's
originals: file formats, the streamed loader, tokenizer and sampler."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.model_file import read_model as jax_read_model
from distributed_llama_tpu.io.tokenizer_file import \
    read_tokenizer_file as jax_read_tok
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.models.params import \
    random_tensors as jax_random_tensors
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture as jax_write_fixture
from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_tpu_torch.io.model_file import read_model
from distributed_llama_tpu_torch.io.tokenizer_file import read_tokenizer_file
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.loader import load_params_streamed
from distributed_llama_tpu_torch.models.params import (fuse_layer_weights,
                                                       load_params,
                                                       random_tensors)
from distributed_llama_tpu_torch.quants.types import FloatType
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.testing import tiny_spec, write_fixture
from distributed_llama_tpu_torch.tokenizer import Tokenizer


def _same_params(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if k == "layers":
            for la, lb in zip(a[k], b[k]):
                _same_params(la, lb)
        elif hasattr(a[k], "packed"):
            assert torch.equal(a[k].packed, b[k].packed), k
            assert torch.equal(a[k].scales, b[k].scales), k
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_fixture_files_are_byte_identical(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jm, jt = jax_write_fixture(tmp_path / "jax", seed=13)
    pm, pt = write_fixture(tmp_path / "port", seed=13)
    for a, b in ((jm, pm), (jt, pt)):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("wt", [FloatType.Q40, FloatType.F32])
def test_fixture_read_identically(tmp_path, wt):
    mpath, tpath = write_fixture(tmp_path, seed=3, weights_float_type=wt)
    jspec, jt = jax_read_model(mpath)
    spec, t = read_model(mpath)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
    assert jt.keys() == t.keys()
    for name in t:
        for field in ("data", "scales", "packed"):
            x, y = getattr(jt[name], field), getattr(t[name], field)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    jtok, tok = jax_read_tok(tpath), read_tokenizer_file(tpath)
    assert (jtok.vocab, jtok.scores, jtok.bos_id, jtok.eos_id) == \
        (tok.vocab, tok.scores, tok.bos_id, tok.eos_id)


def test_streamed_loader_equals_converted_jax_params(tmp_path):
    """The port's own loader (host fusion, packed bytes straight to the
    device) gives exactly what params_from_jax makes of the JAX loader's
    params, fused."""
    mpath, _ = write_fixture(tmp_path, seed=8)
    spec, tensors = jax_read_model(mpath)
    jparams = jax_load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    want = fuse_layer_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), spec, "cpu"))
    got, stats = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32)
    _same_params(got, want)
    assert 0 < stats.peak_host_bytes < stats.total_bytes


def test_load_params_matches_converted_jax_params():
    spec = tiny_spec()
    host = random_tensors(spec, seed=4)
    jhost = jax_random_tensors(spec, seed=4)
    jparams = jax_load_params(spec, jhost, mode="q40", dtype=jnp.float32)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec,
                           "cpu")
    _same_params(load_params(spec, host, mode="q40"), want)


def test_params_from_jax_reads_bf16_leaves():
    spec = tiny_spec()
    jparams = jax_load_params(spec, jax_random_tensors(spec, seed=1),
                              mode="q40", dtype=jnp.bfloat16)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec)
    assert p["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["tok_emb"].float().numpy(),
        np.asarray(jparams["tok_emb"].astype(jnp.float32)))


@pytest.mark.parametrize("text", ["hello world", "ab", "", "héllo ✓ 日本"])
def test_tokenizer_parity(tmp_path, text):
    _, tpath = write_fixture(tmp_path, seed=1)
    jt = JaxTokenizer.from_file(tpath)
    jt._native = None  # the pure-Python oracle the port copies
    t = Tokenizer.from_file(tpath)
    ids = t.encode(text)
    assert ids == jt.encode(text)
    assert t.decode(ids) == jt.decode(ids)
    assert t.stop_token_ids() == jt.stop_token_ids()


@pytest.mark.parametrize("temperature,topp", [
    (0.0, 0.9), (0.8, 0.9), (1.0, 1.0), (0.5, 0.3)])
def test_sampler_stream_parity(temperature, topp):
    rng = np.random.default_rng(int(temperature * 10 + topp * 100))
    js = JaxSampler(288, temperature, topp, 42, backend="python")
    s = Sampler(288, temperature, topp, 42)
    for _ in range(40):
        logits = rng.standard_normal(288).astype(np.float32) * 3
        assert s.sample(logits) == js.sample(logits)
    assert s.rng_state == js.rng_state
