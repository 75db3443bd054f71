"""Port kernel K3 (distributed_llama_tpu_torch/ops/cuda_attention.py) held
against the JAX package's Pallas flash_attention in interpret mode, on the
grids of tests/test_pallas_attention.py, with inputs made by numpy from a
seed. On the CPU the port's wrapper runs its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.pallas_attention import \
    flash_attention as jax_flash_attention
from distributed_llama_tpu_torch.ops import cuda_attention
from distributed_llama_tpu_torch.ops.attention import decode_attention

# both sides f32 on the CPU: the online softmax over 512-blocks and the
# dense softmax differ only in rounding, ~1e-6 on O(1) outputs
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, b, t, h, kvh, s, pos0, hs=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hs)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    pos0 = np.broadcast_to(np.asarray(pos0, np.int32).reshape(-1, 1), (b, 1))
    q_pos = (pos0 + np.arange(t, dtype=np.int32)[None, :]).astype(np.int32)
    return q, k, v, q_pos


def _both(q, k, v, q_pos):
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        interpret=True))
    got = cuda_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos))
    return got, want


@pytest.mark.parametrize("b,h,kvh,s,t,pos0", [
    # decode (T = 1)
    (1, 8, 8, 256, 1, 255),
    (1, 8, 2, 256, 1, 255),
    (1, 8, 8, 256, 1, 0),
    (2, 8, 4, 512, 1, 100),
    (1, 4, 4, 384, 1, 300),
    # prefill chunks
    (1, 8, 8, 256, 16, 0),
    (1, 8, 2, 256, 16, 100),
    (2, 8, 4, 512, 32, 37),
    (1, 4, 4, 384, 8, 300),
])
def test_flash_attention_matches_pallas(b, h, kvh, s, t, pos0):
    q, k, v, q_pos = _inputs(pos0 + s + h + t, b, t, h, kvh, s, pos0)
    got, want = _both(q, k, v, q_pos)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, h, 128)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_flash_attention_per_row_pos0(t):
    """A different pos0 per row: each row reads its own limit."""
    q, k, v, q_pos = _inputs(9 + t, 3, t, 4, 2, 256, [3, 100, 250])
    got, want = _both(q, k, v, q_pos)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_output_takes_cache_dtype():
    """q is lifted to (or narrowed to) the cache dtype, as in the JAX
    kernel: a bf16 cache gives a bf16 output."""
    q, k, v, q_pos = _inputs(2, 1, 1, 4, 4, 64, 63)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    out = cuda_attention.flash_attention(torch.from_numpy(q), kb, vb,
                                         torch.from_numpy(q_pos))
    assert out.dtype == torch.bfloat16


def test_flash_supported_bounds():
    assert cuda_attention.flash_supported(1, 32, 8)
    assert cuda_attention.flash_supported(256, 32, 32)
    assert cuda_attention.flash_supported(256, 32, 8)
    assert not cuda_attention.flash_supported(512, 32, 8)


def test_dense_attention_matches_jax_dense():
    """The dense path the engine takes for T*G > 1024 rows."""
    from distributed_llama_tpu.ops.attention import \
        decode_attention as jax_decode_attention

    q, k, v, q_pos = _inputs(4, 1, 6, 4, 2, 32, 10, hs=16)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos)))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(q_pos))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
