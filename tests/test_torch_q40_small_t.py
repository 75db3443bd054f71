"""Port kernel K1 at small batches and at widths that are no multiple of 256
(distributed_llama_tpu_torch/ops/cuda_q40.py): the rule that routes a
launch among its four kernels, the plans of the tensor-core path at the tp
shard widths and of the small-batch GEMV on the tensor cores, and the
product at 2-8 tokens against the JAX package's Pallas q40_matmul in
interpret mode, on the same inputs made with numpy from a seed. On the CPU
the wrapper runs its plain version; the kernels themselves are held
against it on the card by chip_smoke.py.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as jax_q40_matmul
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu_torch.models.convert import q40_from_lane_order
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor

BF16, F32 = torch.bfloat16, torch.float32
RULE_TS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 44, 256)
RULE_NS = (64, 128, 2752, 4096, 4128, 5504, 11008)
# Llama-2-7B's five projections (d, n) and one rank's shards of them at
# tp = 2 and 4 (wqkv, w13, wcls cut their rows, wo and w2 their columns),
# and Mixtral 8x7B's dense expert shapes
LLAMA_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w13": (22016, 4096),
            "w2": (4096, 11008), "wcls": (32000, 4096)}
SHAPES = {**{f"{k} tp=1": v for k, v in LLAMA_7B.items()},
          **{f"{k} tp={tp}": ((d, n // tp) if k in ("wo", "w2") else (d // tp, n))
             for tp in (2, 4) for k, (d, n) in LLAMA_7B.items()},
          "moe_gate_up": (14336, 4096), "moe_down": (4096, 14336)}


def _want_path(dt, t, aligned):
    """The rule as stated: bf16 in and out takes the tensor-core path from
    TC_MIN_T tokens on, the small-batch GEMV at 2 <= t <= MMA_MAX_T below
    that, both with aligned operands; t = 1 the decode GEMV; the rest (f32
    at t >= 2, unaligned bf16 operands) the older GEMV."""
    if dt == BF16 and aligned and t >= cuda_q40.TC_MIN_T:
        return "tc"
    if dt == BF16 and aligned and 2 <= t <= cuda_q40.MMA_MAX_T:
        return "mma"
    return "gemv1" if t == 1 else "gemv"


@pytest.mark.parametrize("t", RULE_TS)
def test_k1_routing_rule(t):
    """Every (dtype, n, aligned) at t: k1_path gives the stated path, and
    uses_tc_path agrees with it. Every width here is a multiple of 32, so
    the width never decides: 2752, 4128 and 5504 (no multiple of 256) take
    the same path as 4096."""
    for dt in (BF16, F32):
        for n in RULE_NS:
            for aligned in (True, False):
                got = cuda_q40.k1_path(dt, dt, t, n, aligned)
                assert got == _want_path(dt, t, aligned), (dt, n, aligned)
                assert cuda_q40.uses_tc_path(dt, dt, t, n, aligned) is (got == "tc")


def test_small_batches_take_the_mma_gemv():
    """bf16 at 2-8 tokens (a batch step's B, a verify forward's 1 + k)
    takes the small-batch GEMV; the tensor-core path starts where it ends,
    at the crossing chip_smoke.py measures; mixed dtypes keep the GEMVs."""
    assert cuda_q40.MMA_MAX_T == 8 and cuda_q40.TC_MIN_T == cuda_q40.MMA_MAX_T + 1
    for t in range(2, 9):
        assert cuda_q40.k1_path(BF16, BF16, t, 4096) == "mma"
        assert cuda_q40.k1_path(BF16, F32, t, 4096) == "gemv"
        assert cuda_q40.k1_path(F32, BF16, t, 4096) == "gemv"
    assert cuda_q40.k1_path(BF16, BF16, 9, 5504) == "tc"


def test_forced_paths_for_side_by_side_timing():
    """chip_smoke.py forces each bf16 path through _launch's private
    arguments: the older GEMV (tc_min_t past MAX_T, mma_max_t 0), the
    small-batch GEMV (tc_min_t past MAX_T) at t <= 8, the tensor cores
    (tc_min_t 1) at any t."""
    off = cuda_q40.MAX_T + 1
    for t in (2, 4, 8):
        assert cuda_q40.k1_path(BF16, BF16, t, 4096, tc_min_t=off, mma_max_t=0) == "gemv"
        assert cuda_q40.k1_path(BF16, BF16, t, 4096, tc_min_t=off) == "mma"
        assert cuda_q40.k1_path(BF16, BF16, t, 4096, tc_min_t=1) == "tc"
    assert cuda_q40.k1_path(BF16, BF16, 9, 4096, tc_min_t=off) == "gemv"


def _stages(n, split):
    """The 64-value stages each cluster rank of the tensor-core kernel
    loads and consumes (csrc/q40_matmul.cu: groups of 256 values, the last
    one partial; a stage wholly past n is skipped), as (first, count)."""
    groups = -(-n // cuda_q40.TC_GROUP)
    per = -(-groups // split)
    out = []
    for rank in range(split):
        g0, g1 = rank * per, min(groups, rank * per + per)
        count = (min(g1 * 256, n) - g0 * 256 + 63) // 64 if g1 > g0 else 0
        out.append((g0 * 4, count))
    return out


@pytest.mark.parametrize("n", [5504, 2752])
@pytest.mark.parametrize("t", [9, 44, 128, 256])
def test_tc_plan_covers_every_group_of_a_shard(n, t):
    """At the tp shards' widths the plan counts the partial last group
    (5504 = 21.5 groups, 2752 = 10.75): the split never exceeds the
    groups, the ranks' stages cover [0, ceil(n / 64)) once each, and the
    CTAs are the tiles times the split."""
    d = 4096
    bn, split = cuda_q40.tc_plan(t, n, d)
    groups = -(-n // cuda_q40.TC_GROUP)
    assert groups == {5504: 22, 2752: 11}[n]
    assert bn in cuda_q40.TC_TOKENS and 1 <= split <= min(2, groups)
    covered = []
    for first, count in _stages(n, split):
        covered += range(first, first + count)
    assert covered == list(range(-(-n // 64)))
    assert cuda_q40.tc_ctas(t, n, d) == -(-t // bn) * -(-d // cuda_q40.TC_ROWS) * split


def test_tc_plan_at_a_shard_chunk():
    """A tp rank's 256-token chunk: the 4096-row shards split n in two
    clusters as the full-width wo and w2 do, and fill a wave."""
    for n in (5504, 2752):
        assert cuda_q40.tc_plan(256, n, 4096) == (128, 2)
        assert cuda_q40.tc_ctas(256, n, 4096) == 128


@pytest.mark.parametrize("name", list(SHAPES))
def test_mma_plan_covers_every_row_and_chunk(name):
    """The small-batch GEMV's plan at every 7B projection, its tp shards
    and Mixtral's dense experts: rows a CTA a multiple of 16, at most 128,
    the CTAs cover d once and fit one wave of two a streaming
    multiprocessor; the chunk-major items, dealt to the 8 warps in
    contiguous runs, cover every (chunk, row tile) once, and the chunks
    cover n."""
    d, n = SHAPES[name]
    rows, chunk = cuda_q40.mma_rows(d), cuda_q40.MMA_CHUNK
    ctas = cuda_q40.mma_ctas(d)
    assert chunk == 256
    assert rows % cuda_q40.MMA_ROWS == 0 and 16 <= rows <= cuda_q40.MMA_MAX_ROWS
    assert ctas * rows >= d > (ctas - 1) * rows
    assert ctas <= 2 * cuda_q40.TC_SMS
    chunks, tiles = -(-n // chunk), rows // 16
    assert chunks * chunk >= n > (chunks - 1) * chunk
    items = chunks * tiles
    seen = []
    for warp in range(8):
        i0, i1 = warp * items // 8, (warp + 1) * items // 8
        seen += [(i // tiles, i % tiles) for i in range(i0, i1)]
    assert seen == [(c, r) for c in range(chunks) for r in range(tiles)]


def test_mma_plan_is_one_wave_of_equal_ctas():
    """The rows follow d alone: 7B's wo and w2 16 rows (256 CTAs), wqkv
    48, w13 96, wcls 128; d past the wave's reach caps at 128 rows."""
    want = {"wqkv tp=1": 48, "wo tp=1": 16, "w13 tp=1": 96, "w2 tp=1": 16,
            "wcls tp=1": 128, "w2 tp=2": 16, "w13 tp=2": 48}
    for name, rows in want.items():
        d, n = SHAPES[name]
        assert cuda_q40.mma_rows(d) == rows, name
    assert cuda_q40.mma_rows(128256) == 128
    assert cuda_q40.mma_rows(1) == 16


def test_wrapper_counts_the_mma_launches(monkeypatch):
    """Through the CUDA branch with the kernel library faked: a bf16 launch
    at 2-8 tokens passes mma_max_t and counts one K1 launch and one
    small-batch launch; t = 16, f32, a forced older GEMV and scales that
    are not 16-byte aligned (a view 2 bytes into its storage, which the
    small-batch GEMV's 16-byte scale copies cannot take) count none of the
    latter; a refused launch raises and counts nothing."""
    class Fake:
        def __init__(self, rc=0):
            self.rc, self.calls = rc, []

        def __call__(self, *args):
            self.calls.append(args)
            return self.rc

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    meta = functools.partial(torch.empty, device="meta")
    w = QuantizedTensor(meta((8, 32), dtype=torch.uint8), meta((8, 2), dtype=torch.float16))
    k1 = Fake()
    monkeypatch.setattr(cuda_q40, "_lib", lambda: k1)

    def counts():
        return cuda_q40.q40_matmul.launches, cuda_q40.q40_gemv_mma.launches

    before = counts()
    cuda_q40._launch(meta((4, 64), dtype=BF16), w, BF16)
    assert k1.calls[-1][9:11] == (cuda_q40.TC_MIN_T, cuda_q40.MMA_MAX_T)
    assert counts() == (before[0] + 1, before[1] + 1)
    cuda_q40._launch(meta((16, 64), dtype=BF16), w, BF16)
    cuda_q40._launch(meta((4, 64)), w, F32)
    cuda_q40._launch(meta((4, 64), dtype=BF16), w, BF16, tc_min_t=cuda_q40.MAX_T + 1,
                     mma_max_t=0)
    assert counts() == (before[0] + 4, before[1] + 1)
    odd = QuantizedTensor(w.packed, meta((8 * 2 + 1,), dtype=torch.float16)[1:].view(8, 2))
    assert odd.scales.is_contiguous() and odd.scales.data_ptr() % 16 == 2
    cuda_q40._launch(meta((4, 64), dtype=BF16), odd, BF16)
    assert k1.calls[-1][3] % 16 == 2
    assert counts() == (before[0] + 5, before[1] + 1)
    refuse = Fake(rc=1)
    monkeypatch.setattr(cuda_q40, "_lib", lambda: refuse)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cuda_q40._launch(meta((4, 64), dtype=BF16), w, BF16)
    assert counts() == (before[0] + 5, before[1] + 1)


def _weights(rng, d, n, scale=0.1):
    """(JAX QuantizedTensor, port QuantizedTensor) of one random weight."""
    w = rng.standard_normal((d, n), dtype=np.float32) * scale
    scales, packed = quantize_q40(w)
    jq = JaxQT.from_numpy(scales, packed)
    pq = q40_from_lane_order(np.asarray(jq.packed), np.asarray(jq.scales), "cpu")
    return jq, pq


@pytest.mark.parametrize("n", [2752, 5504])
@pytest.mark.parametrize("t", [2, 4, 8])
def test_small_t_matches_pallas_bf16(t, n):
    """bf16 in and out at 2-8 tokens and the tp shards' widths: below 16
    tokens the TPU kernel contracts in f32 and rounds once to bf16, as
    the port's plain version does, so only the order of the f32 sums
    differs. x is bf16-exact. Tolerance: one bf16 ulp of the largest
    output (2^-7 of it) absolute, plus 2^-7 relative: each side's single
    rounding of sums that agree to f32 accuracy."""
    rng = np.random.default_rng(100 * t + n)
    d = 48
    jq, pq = _weights(rng, d, n)
    x = torch.from_numpy(rng.standard_normal((t, n), dtype=np.float32)).to(BF16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax_q40_matmul(xj, jq, out_dtype=jnp.bfloat16, interpret=True),
                      np.float32)
    got = cuda_q40.q40_matmul(x, pq, out_dtype=BF16)
    assert got.dtype == BF16 and tuple(got.shape) == (t, d)
    ulp = 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ulp * np.abs(want).max(), rtol=ulp)


@pytest.mark.parametrize("name", ["stages3", "stages4", "chunk16", "shuffle", "rows32",
                                  "no_x", "no_dequant"])
def test_ablation_variants_apply_to_the_source(name):
    """tools/k1_mma_ablations.py builds each variant by replacing lines of
    csrc/q40_matmul.cu: every line it replaces is in the source once, so a
    change to the kernel that breaks a variant shows here, not on the
    card; the ring variant is the source itself."""
    from distributed_llama_tpu_torch.ops import cuda_build
    from distributed_llama_tpu_torch.tools import k1_mma_ablations

    src = (cuda_build.CSRC / "q40_matmul.cu").read_text()
    assert k1_mma_ablations.variant_source("ring", src) == src
    assert k1_mma_ablations.variant_source(name, src) != src
    first = k1_mma_ablations.VARIANTS[name][0][0]
    with pytest.raises(ValueError, match="occurs 0 times"):
        k1_mma_ablations.variant_source(name, src.replace(first, ""))


def test_ablation_tool_raises_without_a_card():
    """`python -m ...tools.k1_mma_ablations` runs on cuda unless told
    otherwise: with no card it raises before building or timing anything."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "distributed_llama_tpu_torch.tools.k1_mma_ablations"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "[mma-ablation]" not in res.stdout
