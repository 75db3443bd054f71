"""The port's forward with positions on the device — a (B,) int32 pos0
tensor — held against the JAX forward's per_row_pos branch with the same
vector (distributed_llama_tpu/models/transformer.py:486, the drop-mode
_scatter_cache_write at :97), at B = 3 for Llama and Mixtral, all f32. The
JAX side runs its Pallas kernels in interpret mode, the port its kernels'
plain versions on the CPU.

The rows: one mid-cache, one gated at pos0 == S (every write dropped, its
logits ignored as the JAX slot steps ignore them), and one whose segment
runs past S (T = 4 at S - 2, T = 1 at S - 1), which keeps only its
in-range writes. The caches start from the same random contents on both
sides, so a write that lands where it should not shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params
from distributed_llama_tpu.models.spec import ArchType
from distributed_llama_tpu.models.transformer import KVCache as JaxKVCache
from distributed_llama_tpu.models.transformer import forward as jax_forward
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.transformer import KVCache, cache_write, forward

# f32 on both sides, 1e-5 relative on the logits of every position inside
# the cache; the caches' K/V likewise
TOL = dict(rtol=1e-5, atol=1e-6)
B = 3


@pytest.fixture(scope="module", params=["LLAMA", "MIXTRAL"])
def model(request, tmp_path_factory):
    moe = dict(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, _ = write_fixture(tmp_path_factory.mktemp("fx"), seed=53,
                             **(moe if request.param == "MIXTRAL" else {}))
    spec, tensors = read_model(mpath)
    jparams = load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec, "cpu")
    return spec, jparams, params


def _caches(spec, seed):
    """The same random (B, KVH, S, hs) contents in a JAX and a port cache."""
    rng = np.random.default_rng(seed)
    shape = (B, spec.n_kv_heads, spec.seq_len, spec.head_size)
    k = [rng.standard_normal(shape).astype(np.float32) for _ in range(spec.n_layers)]
    v = [rng.standard_normal(shape).astype(np.float32) for _ in range(spec.n_layers)]
    jcache = JaxKVCache(tuple(jnp.asarray(a) for a in k), tuple(jnp.asarray(a) for a in v))
    cache = KVCache.create(spec, B, dtype=torch.float32, device="cpu")
    for dst, src in zip((*cache.k, *cache.v), (*k, *v)):
        dst.copy_(torch.from_numpy(src))
    return jcache, cache, k, v


@pytest.mark.parametrize("t", [1, 4])
def test_device_pos0_matches_jax_per_row_forward(model, t):
    spec, jparams, params = model
    s = spec.seq_len
    pos0 = np.asarray([37, s, s - 2 if t == 4 else s - 1], np.int32)
    toks = np.random.default_rng(t).integers(1, spec.vocab_size, (B, t)).astype(np.int32)
    jcache, cache, k0, v0 = _caches(spec, seed=t)

    want, jcache = jax_forward(jparams, spec, jnp.asarray(toks), jnp.asarray(pos0), jcache,
                               compute_dtype=jnp.float32, use_pallas=True,
                               pallas_interpret=True, logits_for_all=True)
    got = forward(params, spec, torch.from_numpy(toks), torch.from_numpy(pos0), cache,
                  compute_dtype=torch.float32, logits_for_all=True)
    want = np.asarray(want)
    inside = pos0[:, None] + np.arange(t)[None, :] < s
    np.testing.assert_allclose(got.numpy()[inside], want[inside], **TOL)

    for l in range(spec.n_layers):
        for mine, theirs, before in ((cache.k[l], jcache.k[l], k0[l]),
                                     (cache.v[l], jcache.v[l], v0[l])):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)
            # the gated row: bit-untouched
            assert np.array_equal(mine[1].numpy(), before[1])
            # the row past S: its in-range writes kept, nothing else moved
            kept = s - pos0[2]
            assert not np.array_equal(mine[2, :, s - kept:].numpy(), before[2, :, s - kept:])
            assert np.array_equal(mine[2, :, :s - kept].numpy(), before[2, :, :s - kept])
            # the mid-cache row: exactly its t slots written
            changed = (mine[0].numpy() != before[0]).any(axis=(0, 2))
            assert changed.nonzero()[0].tolist() == list(range(37, 37 + t))


def test_device_pos0_equals_host_pos0(model):
    """The same segment at the same positions, given as host ints and as a
    device tensor: the same logits and caches, bit for bit."""
    spec, _, params = model
    toks = torch.tensor([[5, 9, 2], [7, 7, 1], [3, 4, 11]])
    _, host_cache, _, _ = _caches(spec, seed=11)
    _, dev_cache, _, _ = _caches(spec, seed=11)
    pos = [4, 20, 0]
    a = forward(params, spec, toks, pos, host_cache, logits_for_all=True)
    b = forward(params, spec, toks, torch.tensor(pos, dtype=torch.int32), dev_cache,
                logits_for_all=True)
    assert torch.equal(a, b)
    for x, y in zip((*host_cache.k, *host_cache.v), (*dev_cache.k, *dev_cache.v)):
        assert torch.equal(x, y)


def test_logit_index_on_the_device(model):
    spec, _, params = model
    toks = torch.tensor([[5, 9, 2, 8]] * B)
    every = forward(params, spec, toks, 0, KVCache.create(spec, B, device="cpu"),
                    logits_for_all=True)
    idx = torch.tensor([0, 3, 1])
    got = forward(params, spec, toks, torch.zeros(B, dtype=torch.int32),
                  KVCache.create(spec, B, device="cpu"), logit_index=idx)
    assert torch.equal(got, every[torch.arange(B), idx])


def test_cache_write_rows_drop_outside_the_cache():
    """Row index of each (b, kvh, t) vector; positions outside [0, S) go to
    the one spare row past the cache, so no dropped write can land on a
    kept one."""
    q_pos = torch.tensor([[3, 4], [7, 8], [-1, 0]], dtype=torch.int32)
    w = cache_write(q_pos, n_kv_heads=2, seq_len=8, spare=True)
    spare = 3 * 2 * 8
    assert w.rows.tolist() == [3, 4, 11, 12,
                               16 + 7, spare, 24 + 7, spare,
                               spare, 32, spare, 40]


def test_a_write_past_the_cache_needs_the_spare_row(model):
    """A batch-row view of a larger cache has no spare row of its own: a
    segment that may drop a write refuses it rather than overwrite the
    next row; one that stays inside writes as before."""
    spec, _, params = model
    cache = KVCache.create(spec, 2, device="cpu")
    row0 = KVCache([k[0:1] for k in cache.k], [v[0:1] for v in cache.v])
    tok = torch.tensor([[5]])
    forward(params, spec, tok, 3, row0)                    # host pos inside: fine
    with pytest.raises(ValueError, match="spare row"):
        forward(params, spec, tok, torch.tensor([3], dtype=torch.int32), row0)
    with pytest.raises(ValueError, match="spare row"):
        forward(params, spec, tok, spec.seq_len, row0)
    assert all(not k[1].any() for k in cache.k)            # row 1 untouched
    last = KVCache([k[1:2] for k in cache.k], [v[1:2] for v in cache.v])
    forward(params, spec, tok, torch.tensor([spec.seq_len], dtype=torch.int32), last)
    assert all(not k[1].any() for k in cache.k)            # the drop touched nothing


def test_fp8_cache_written_at_device_positions(model):
    """An e4m3 cache takes the same index write (its bits moved as bytes):
    equal to the same write at host positions."""
    spec, _, params = model
    toks = torch.tensor([[5, 9]])
    a = KVCache.create(spec, 1, dtype=torch.float8_e4m3fn, device="cpu")
    b = KVCache.create(spec, 1, dtype=torch.float8_e4m3fn, device="cpu")
    forward(params, spec, toks, 6, a)
    forward(params, spec, toks, torch.tensor([6], dtype=torch.int32), b)
    for x, y in zip((*a.k, *a.v), (*b.k, *b.v)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        assert x.view(torch.uint8)[0, :, 6:8].any()
