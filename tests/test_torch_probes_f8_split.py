"""The host-side rules of the port's fp8-cache flash-decode probe (ops/
cuda_probes.py, P2): the split plan (blocks a row, from the shapes and the
cache type), the warp ranges each block derives from pos on the device
(f8_split_ranges), and the split-and-merge math in plain PyTorch
(f8_split_partials, f8_merge_partials), held against the dense plain
version and, at one case, against the JAX repository's Pallas probe
tools/exp_f8_flash.py in TPU interpret mode. The CUDA kernel computes the
same ranges and merge on the card; chip_smoke.py holds it there and checks
that its own plan export equals f8_split_plan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu_torch.ops import cuda_probes as cp
from test_torch_probes import _tool
from test_torch_probes_f8 import CACHE_IN, HS, _inputs, _torch

# one bf16 ulp of the largest output: each range rounds p to bf16 against
# its own max, the dense version against the row's, and both round the
# output once
BF16_ULP = 2.0 ** -7
# (b, kvh, S, pos): pos 0; pos 15, the last slot of a 16-slot stage and of a
# warp range at one block a row (4 ranges of 4), and pos 16, the first of the
# next; S - 1; past S (clamped to S - 1); and two batch rows apart
POS_CASES = [(1, 2, 1024, [0]), (1, 2, 1024, [15]), (1, 2, 1024, [16]), (1, 2, 1024, [1023]),
             (1, 2, 1024, [5000]), (2, 2, 1024, [100, 900])]


def _covered(start, count, fill):
    """Every slot below fill exactly once, in order, across a row's ranges."""
    seen = torch.zeros(int(fill), dtype=torch.int64)
    end = 0
    for s, c in zip(start.tolist(), count.tolist()):
        assert c >= 0
        if c:
            assert s == end   # contiguous, in unit order
            end = s + c
            seen[s:s + c] += 1
    return end == fill and bool((seen == 1).all())


@pytest.mark.parametrize("mode", cp.F8_MODES)
@pytest.mark.parametrize("rows,s_len", [(32, 8192), (64, 8192), (2, 1024), (300, 4096), (4, 100)])
def test_split_plan_is_one_wave_of_the_cache_types_blocks(mode, rows, s_len):
    n = cp.f8_split_plan(rows, s_len, mode)
    per_sm = cp.F8_BLOCKS_PER_SM["bf16" if mode == "plain" else "e4m3"]
    most = -(-s_len // (cp.F8_WARPS * cp.F8_STAGE))
    assert 1 <= n <= most
    assert n == 1 or rows * n <= cp.F8_SMS * per_sm
    assert n == most or rows * (n + 1) > cp.F8_SMS * per_sm


def test_split_plan_at_the_tools_shape():
    """B 1, KVH 32, S 8192: one block an SM for bf16, four for e4m3."""
    assert cp.f8_split_plan(32, 8192, "plain") == 4
    for mode in ("astype", "bits", "bitsflush"):
        assert cp.f8_split_plan(32, 8192, mode) == 16


@pytest.mark.parametrize("n_split", [1, 2, 4, 16])
@pytest.mark.parametrize("b,kvh,s_len,pos", POS_CASES)
def test_split_ranges_cover_every_visible_slot_once(b, kvh, s_len, pos, n_split):
    start, count = cp.f8_split_ranges(torch.tensor(pos, dtype=torch.int32), kvh, s_len, n_split)
    assert tuple(start.shape) == (b * kvh, n_split * cp.F8_WARPS)
    for row in range(b * kvh):
        fill = min(pos[row // kvh], s_len - 1) + 1
        assert _covered(start[row], count[row], fill)


def test_split_ranges_balance_the_warps():
    """Ranges differ by at most ceil(fill / units) - floor(fill / units)
    slots but the last, which takes the rest."""
    start, count = cp.f8_split_ranges(torch.tensor([7680], dtype=torch.int32), 32, 8192, 16)
    per = -(-7681 // (16 * cp.F8_WARPS))
    assert bool((count[:, :-1] == per).all()) and int(count[0, -1]) == 7681 - per * (count.shape[1] - 1)


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("b,kvh,s_len,pos", POS_CASES)
@pytest.mark.parametrize("mode", cp.F8_MODES)
def test_split_and_merge_match_the_dense_version(mode, b, kvh, s_len, pos, n_split):
    q, caches = _inputs(sum(pos) + n_split, b, kvh, s_len)
    k, v = caches[CACHE_IN[mode]]
    args = (mode, torch.tensor(pos, dtype=torch.int32), _torch(q), _torch(k), _torch(v))
    m, l, acc = cp.f8_split_partials(*args, n_split)
    units = n_split * cp.F8_WARPS
    assert tuple(m.shape) == tuple(l.shape) == (b * kvh, units)
    assert tuple(acc.shape) == (b * kvh, units, HS)
    empty = l == 0   # ranges with no slot weigh nothing
    assert bool((m[empty] == -1e30).all()) and bool((acc[empty] == 0).all())
    got = cp.f8_merge_partials(m, l, acc)
    want = cp.f8_flash_decode_reference(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULP * want.float().abs().max().item()


@pytest.mark.parametrize("mode", cp.F8_MODES)
def test_split_on_the_cpu_matches_pallas(mode):
    """The split pass's plain version against the TPU tool, B 2 with pos
    per batch row, 16 blocks a row (64 warp ranges)."""
    pos = [200, 700]
    q, caches = _inputs(4, 2, 2, 1024)
    k, v = caches[CACHE_IN[mode]]
    pos_j = jnp.asarray(pos, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_f8_flash").build(mode, 2, 2, 1024, HS)(pos_j, q, k, v))
    before = cp.f8_flash_decode.launches
    got = cp.f8_flash_decode_split(mode, _torch(pos_j), _torch(q), _torch(k), _torch(v), 16)
    assert cp.f8_flash_decode.launches == before
    err = np.abs(got.float().numpy() - want.astype(np.float32)).max()
    assert err <= BF16_ULP * np.abs(want.astype(np.float32)).max()


def test_split_refuses_bad_arguments():
    q, caches = _inputs(0, 1, 1, 256)
    k, v = caches["bf16"]
    pos = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError, match="n_split"):
        cp.f8_flash_decode_split("plain", pos, _torch(q), _torch(k), _torch(v), 0)
    with pytest.raises(ValueError, match="mode"):
        cp.f8_flash_decode_split("f16", pos, _torch(q), _torch(k), _torch(v), 2)
