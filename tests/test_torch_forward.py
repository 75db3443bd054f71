"""The port's Llama forward held against the JAX package's forward, on the
same weights: the tiny fixture's `.m` read by the JAX package, its params
tree handed to the port through params_from_jax. The JAX side runs its
Pallas kernels in interpret mode (use_pallas=True, pallas_interpret=True),
the port its kernels' plain versions on the CPU. All f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params
from distributed_llama_tpu.models.transformer import KVCache as JaxKVCache
from distributed_llama_tpu.models.transformer import forward as jax_forward
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.params import fuse_layer_weights
from distributed_llama_tpu_torch.models.transformer import KVCache, forward
from distributed_llama_tpu_torch.testing import tiny_spec

# f32 on both sides, O(1) logits through 2 layers: the only differences are
# summation order and the Pallas kernel's -8 fold
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def fixture_params(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx")
    mpath, _ = write_fixture(d, seed=31)
    spec, tensors = read_model(mpath)
    jparams = load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return spec, jparams, np_params


def _jax_run(spec, jparams, tokens, pos0, cache):
    return jax_forward(jparams, spec, jnp.asarray(tokens, jnp.int32),
                       jnp.int32(pos0), cache, compute_dtype=jnp.float32,
                       use_pallas=True, pallas_interpret=True)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_then_decode_matches_jax(fixture_params, fused):
    spec, jparams, np_params = fixture_params
    params = params_from_jax(np_params, spec, "cpu")
    if fused:
        fuse_layer_weights(params)
    prompt = np.asarray([[1, 40, 7, 99, 150, 3, 17, 42, 8]], np.int32)
    jcache = JaxKVCache.create(spec, 1, dtype=jnp.float32)
    cache = KVCache.create(spec, 1, dtype=torch.float32)

    want, jcache = _jax_run(spec, jparams, prompt, 0, jcache)
    got = forward(params, spec, torch.from_numpy(prompt), 0, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    pos = prompt.shape[1]
    for tok in (5, 77, 200, 12):
        want, jcache = _jax_run(spec, jparams, [[tok]], pos, jcache)
        got = forward(params, spec, torch.tensor([[tok]]), pos, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        pos += 1
    np.testing.assert_allclose(cache.k[1].numpy(), np.asarray(jcache.k[1]),
                               **LOGIT_TOL)


def test_logits_for_all_and_logit_index(fixture_params):
    spec, jparams, np_params = fixture_params
    params = params_from_jax(np_params, spec, "cpu")
    toks = np.asarray([[3, 9, 27, 81]], np.int32)
    want, _ = jax_forward(jparams, spec, jnp.asarray(toks), jnp.int32(0),
                          JaxKVCache.create(spec, 1, dtype=jnp.float32),
                          logits_for_all=True)
    got = forward(params, spec, torch.from_numpy(toks), 0,
                  KVCache.create(spec, 1), logits_for_all=True)
    assert tuple(got.shape) == (1, 4, spec.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    mid = forward(params, spec, torch.from_numpy(toks), 0,
                  KVCache.create(spec, 1), logit_index=1)
    np.testing.assert_allclose(mid.numpy(), np.asarray(want)[:, 1],
                               **LOGIT_TOL)


def test_per_row_pos0_matches_separate_rows(fixture_params):
    """A batch whose rows start at different positions computes each row as
    if it ran alone."""
    spec, _, np_params = fixture_params
    params = params_from_jax(np_params, spec, "cpu")
    prefix = torch.tensor([[4, 8, 15, 16, 23]])
    alone = []
    for p0 in (2, 5):
        cache = KVCache.create(spec, 1)
        forward(params, spec, prefix[:, :p0], 0, cache)
        alone.append(forward(params, spec, torch.tensor([[42, 7]]), p0, cache))
    cache = KVCache.create(spec, 2)
    for b, p0 in enumerate((2, 5)):
        row = KVCache([k[b:b + 1] for k in cache.k], [v[b:b + 1] for v in cache.v])
        forward(params, spec, prefix[:, :p0], 0, row)
    both = forward(params, spec, torch.tensor([[42, 7], [42, 7]]), [2, 5],
                   cache)
    np.testing.assert_allclose(both.numpy(), torch.cat(alone).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_moe_archs_not_ported_yet():
    from distributed_llama_tpu_torch.models.spec import ArchType

    spec = tiny_spec(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    with pytest.raises(NotImplementedError, match="slice 2"):
        forward({}, spec, torch.zeros((1, 1), dtype=torch.long), 0, None)


@pytest.mark.parametrize("arch", ["LLAMA", "GROK1"])
def test_rope_matches_jax(arch):
    """rope_llama (interleaved pairs) and rope_falcon (half rotation)."""
    from distributed_llama_tpu.models.spec import ArchType as JaxArch
    from distributed_llama_tpu.ops.rope import apply_rope as jax_apply_rope
    from distributed_llama_tpu_torch.models.spec import ArchType
    from distributed_llama_tpu_torch.ops.rope import apply_rope, rope_angles

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = (np.arange(5)[None, :] + np.asarray([[0], [90]])).astype(np.int32)
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                          JaxArch[arch])
    pt = torch.from_numpy(pos)
    got = apply_rope(torch.from_numpy(x), rope_angles(pt, 16, 10000.0),
                     ArchType[arch])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("act", ["SILU", "GELU"])
def test_norm_and_activations_match_jax(act):
    from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
    from distributed_llama_tpu.ops.activations import \
        apply_hidden_act as jax_act
    from distributed_llama_tpu.ops.norms import rmsnorm as jax_rmsnorm
    from distributed_llama_tpu_torch.models.spec import HiddenAct
    from distributed_llama_tpu_torch.ops.activations import apply_hidden_act
    from distributed_llama_tpu_torch.ops.norms import rmsnorm

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        apply_hidden_act(torch.from_numpy(x), HiddenAct[act]).numpy(),
        np.asarray(jax_act(jnp.asarray(x), JaxAct[act])), atol=1e-6,
        rtol=1e-6)
