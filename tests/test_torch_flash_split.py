"""What surrounds kernel K3's split-S design (distributed_llama_tpu_torch/
ops/cuda_attention.py), on the CPU: the wrapper's split plan is a function
of the shapes alone and its splits cover every fill, and the split-and-merge
math in plain PyTorch (`split_partials`, `merge_partials`, with the
kernel's split rule) equals the JAX package's Pallas flash_attention in
interpret mode on the grids of tests/test_torch_attention.py, plus splits
wholly past pos0, pos0 = 0 and a different pos0 per row, and over an e4m3
cache under bf16 q. Inputs are made by numpy from a seed.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.pallas_attention import \
    flash_attention as jax_flash_attention
from distributed_llama_tpu_torch.ops import cuda_attention as ca

# both sides f32 on the CPU: the online softmax over 512-blocks and the
# split-and-merge differ only in rounding, ~1e-6 on O(1) outputs
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, b, t, h, kvh, s, pos0, hs=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hs)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    pos0 = np.broadcast_to(np.asarray(pos0, np.int32).reshape(-1, 1), (b, 1))
    q_pos = (pos0 + np.arange(t, dtype=np.int32)[None, :]).astype(np.int32)
    return q, k, v, q_pos


def _pallas(q, k, v, q_pos):
    return np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        interpret=True))


def _split(q, k, v, q_pos, n_split):
    return ca.flash_attention_split_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), n_split).numpy()


def _n_splits(b, h, kvh, s, t):
    """The plan's n_split for this launch, then 1, 2, 3 and S / TILE."""
    _, planned = ca.split_plan(b, kvh, s, t, h // kvh)
    return sorted({planned, 1, 2, 3, math.ceil(s / ca.TILE)})


def test_split_plan_takes_no_position():
    """The plan's arguments are the shapes (and the path): nothing that a
    decode step changes, so a launch's grid can sit in a CUDA graph."""
    assert list(inspect.signature(ca.split_plan).parameters) == \
        ["b", "kvh", "s", "t", "g", "exact"]


@pytest.mark.parametrize("b,kvh,s,t,g,exact", [
    (1, 32, 2048, 1, 1, False),      # Llama-2-7B decode
    (1, 8, 2048, 1, 4, False),       # Mixtral decode
    (1, 8, 2048, 1, 6, False),       # Grok-1 decode
    (1, 32, 2048, 256, 1, False),    # 7B prefill chunk
    (1, 8, 2048, 256, 4, False),     # Mixtral prefill chunk
    (1, 32, 8192, 1, 1, False),      # P2's shape
    (2, 8, 512, 16, 4, False),
    (1, 4, 100, 3, 2, False),        # S not a multiple of the tile
    (1, 8, 2048, 1, 4, True),        # the f32 path
    (1, 2, 384, 8, 4, True),
])
def test_split_plan_covers_every_fill(b, kvh, s, t, g, exact):
    block_rows, n_split = ca.split_plan(b, kvh, s, t, g, exact)
    assert block_rows in ca.BLOCK_ROWS[exact]
    small = min(ca.BLOCK_ROWS[exact])
    assert (block_rows == small) == (t * g <= small)
    assert 1 <= n_split <= max(1, math.ceil(s / ca.TILE))
    blocks = math.ceil(t * g / block_rows) * b * kvh
    # one wave of two blocks an SM, as many splits as fit in it
    assert blocks * n_split <= max(blocks, 2 * ca.N_SM)
    if n_split < math.ceil(s / ca.TILE):   # not capped by S
        assert blocks * (n_split + 1) > 2 * ca.N_SM
    for pos0 in range(0, s - t + 1):
        fill = min(pos0 + t, s)
        length = ca.split_len(fill, n_split)
        assert length % ca.TILE == 0 and length > 0
        # the n_split splits of `length` slots hold every slot up to the fill
        assert n_split * length >= fill


@pytest.mark.parametrize("b,h,kvh,s,t,pos0", [
    # decode (T = 1), the grids of tests/test_torch_attention.py
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
    # splits wholly past pos0, and a chunk ending on the last slot
    (1, 4, 2, 512, 1, 5),
    (1, 4, 2, 512, 4, 60),
    (1, 4, 1, 512, 3, 509),
])
def test_split_merge_matches_pallas(b, h, kvh, s, t, pos0):
    q, k, v, q_pos = _inputs(pos0 + s + h + t, b, t, h, kvh, s, pos0)
    want = _pallas(q, k, v, q_pos)
    for n_split in _n_splits(b, h, kvh, s, t):
        np.testing.assert_allclose(_split(q, k, v, q_pos, n_split), want,
                                   **F32_TOL, err_msg=f"n_split={n_split}")


@pytest.mark.parametrize("t", [1, 4])
def test_split_merge_per_row_pos0(t):
    """A different pos0 per row: each row has its own split length."""
    q, k, v, q_pos = _inputs(9 + t, 3, t, 4, 2, 256, [3, 100, 250])
    want = _pallas(q, k, v, q_pos)
    for n_split in (1, 2, 4):
        np.testing.assert_allclose(_split(q, k, v, q_pos, n_split), want,
                                   **F32_TOL, err_msg=f"n_split={n_split}")


@pytest.mark.parametrize("pos0,t,n_split", [
    ([0], 1, 4), ([0], 16, 4), ([130], 1, 8), ([3, 200], 8, 4), ([63, 64], 2, 3)])
def test_merge_reads_exactly_the_nonempty_splits(pos0, t, n_split):
    """The merge's rule, c <= the row's last slot // split_len, picks the
    splits in which the row sees at least one slot: every other split's
    partial is empty (l = 0, m = NEG_INF), and would weigh 0."""
    b = len(pos0)
    q, k, v, q_pos = _inputs(3 + t, b, t, 4, 2, 256, pos0, hs=32)
    m, l, _, used = ca.split_partials(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(q_pos),
                                      n_split)
    u = used[:, :, :, None, None].expand_as(l)
    assert bool((l[u] > 0).all())
    assert bool((l[~u] == 0).all()) and bool((m[~u] == ca.NEG_INF).all())
    assert bool(used[0].all())             # every row sees slot 0


def test_split_merge_e4m3_cache_matches_plain():
    """An e4m3 cache under bf16 q, against the Pallas kernel in interpret
    mode on the same cache bits (as tests/test_torch_f8.py runs it): the
    split math upcasts the cache to q's dtype, rounds p to bf16 for P.V and
    outputs bf16, as the JAX kernel does. With one split the two round the
    same weights and agree bit for bit. With more, each split rounds its p
    to bf16 at its own max, not at the row's, so the weights' roundings
    (2^-9 relative each) differ: the outputs agree within one bf16 ulp of
    the largest output (2^-7 of it, the tolerance chip_smoke.py holds the
    kernel to)."""
    def bits(a):
        return torch.from_numpy(np.array(a).view(np.uint8)).view(ca.F8_DTYPE)

    # (seed, b, t, h, kvh, s, pos0, hs): a short chunk, a decode step, a
    # 16-token chunk, a different pos0 per row
    for seed, b, t, h, kvh, s, pos0, hs in (
            (21, 1, 4, 8, 2, 256, 70, 64), (5, 1, 1, 8, 2, 512, 300, 128),
            (7, 1, 16, 8, 2, 512, 100, 64), (8, 2, 3, 4, 2, 256, [10, 200], 32)):
        q, k, v, q_pos = _inputs(seed, b, t, h, kvh, s, pos0, hs=hs)
        k8 = jnp.asarray(k, jnp.float8_e4m3fn)
        v8 = jnp.asarray(v, jnp.float8_e4m3fn)
        want = np.asarray(jax_flash_attention(
            jnp.asarray(q, jnp.bfloat16), k8, v8, jnp.asarray(q_pos), interpret=True),
            np.float32)
        qb = torch.from_numpy(q).to(torch.bfloat16)
        qp = torch.from_numpy(q_pos)
        for n_split in (1, 2, 3, 4, 8):
            got = ca.flash_attention_split_reference(qb, bits(k8), bits(v8), qp, n_split)
            assert got.dtype == torch.bfloat16
            if n_split == 1:
                np.testing.assert_array_equal(got.float().numpy(), want)
            else:
                np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                           atol=2.0 ** -7 * np.abs(want).max(),
                                           err_msg=f"seed {seed}, n_split={n_split}")
