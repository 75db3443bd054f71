"""Port kernel K1 (distributed_llama_tpu_torch/ops/cuda_q40.py) held against
the JAX package's Pallas q40_matmul in interpret mode, on the same inputs
made with numpy from a seed. On the CPU the port's wrapper runs its plain
version; the CUDA kernel itself is compared with that plain version on the
card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as jax_q40_matmul
from distributed_llama_tpu.quants.jax_codec import (QuantizedTensor as JaxQT,
                                                    dequantize_q40_jax)
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu_torch.models.convert import q40_from_lane_order
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops.matmul import matmul
from distributed_llama_tpu_torch.quants.torch_codec import (
    QuantizedTensor, dequantize_q40_torch)

# f32: both sides are f32 on the CPU and differ only in summation order
# (and the TPU kernel's -8 fold) — the JAX package's own kernel tolerance
F32_TOL = dict(atol=2e-4, rtol=1e-4)


def _weights(rng, d, n, scale=0.1):
    """(JAX QuantizedTensor, port QuantizedTensor) of one random weight."""
    w = rng.standard_normal((d, n), dtype=np.float32) * scale
    scales, packed = quantize_q40(w)
    jq = JaxQT.from_numpy(scales, packed)
    pq = q40_from_lane_order(np.asarray(jq.packed), np.asarray(jq.scales), "cpu")
    return jq, pq


@pytest.mark.parametrize("d,n,t", [
    (256, 1024, 1),
    (256, 1024, 4),
    (704, 128 * 32, 2),
    (128, 704, 1),
    (96, 256, 16),
    (64, 128, 256),
])
def test_q40_matmul_matches_pallas_f32(d, n, t):
    rng = np.random.default_rng(d * 7 + n + t)
    jq, pq = _weights(rng, d, n)
    x = rng.standard_normal((t, n), dtype=np.float32)
    want = np.asarray(jax_q40_matmul(jnp.asarray(x), jq, interpret=True))
    got = cuda_q40.q40_matmul(torch.from_numpy(x), pq)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_q40_matmul_leading_dims():
    rng = np.random.default_rng(3)
    jq, pq = _weights(rng, 128, 256)
    x = rng.standard_normal((2, 3, 256), dtype=np.float32)
    want = np.asarray(jax_q40_matmul(jnp.asarray(x), jq, interpret=True))
    got = cuda_q40.q40_matmul(torch.from_numpy(x), pq)
    assert tuple(got.shape) == (2, 3, 128)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("t", [16, 44, 64, 256])
def test_q40_matmul_bf16_out(t):
    """bf16 out_dtype with t >= 16: the TPU kernel feeds its MXU bf16
    operands (dequantized weights rounded to bf16); the port keeps f32
    operands and rounds once at the output. x is made bf16-exact so only
    those roundings differ. Tolerance: one bf16 ulp of the largest output
    (2^-7 of it) absolute, plus 2^-7 relative — the two output roundings
    and the weight roundings summed over n = 1024 terms stay inside."""
    rng = np.random.default_rng(t)
    d, n = 128, 1024
    jq, pq = _weights(rng, d, n)
    x = torch.from_numpy(rng.standard_normal((t, n), dtype=np.float32))
    x = x.to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax_q40_matmul(xj, jq, out_dtype=jnp.bfloat16,
                                     interpret=True), np.float32)
    got = cuda_q40.q40_matmul(x, pq, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ulp * np.abs(want).max(), rtol=ulp)


def test_lane_order_conversion_dequantizes_bit_equal():
    """params_from_jax's layout conversion: the port's dequantize of the
    converted bytes is bit-equal to dequantize_q40_jax in f32."""
    rng = np.random.default_rng(11)
    jq, pq = _weights(rng, 96, 512)
    want = np.asarray(dequantize_q40_jax(jq, dtype=jnp.float32))
    got = dequantize_q40_torch(pq, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_from_host_layout_is_the_file_order():
    """QuantizedTensor.from_host keeps the file's block-major bytes: the
    first 16 bytes of a row are its first block."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 64), dtype=np.float32)
    scales, packed = quantize_q40(w)
    q = QuantizedTensor.from_host(scales, packed, "cpu")
    assert tuple(q.packed.shape) == (4, 32) and q.scales.dtype == torch.float16
    np.testing.assert_array_equal(q.packed.numpy()[:, :16], packed[:, 0, :])
    assert q.shape == (4, 64)


def test_matmul_above_max_t_takes_dequant_path():
    """t > MAX_T: dequantize then torch.matmul, still the same product."""
    rng = np.random.default_rng(7)
    jq, pq = _weights(rng, 64, 128)
    x = rng.standard_normal((1, cuda_q40.MAX_T + 44, 128), dtype=np.float32)
    before = cuda_q40.q40_matmul.launches
    got = matmul(torch.from_numpy(x), pq, compute_dtype=torch.float32)
    wd = np.asarray(dequantize_q40_jax(jq, dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), x @ wd.T, **F32_TOL)
    assert cuda_q40.q40_matmul.launches == before
    assert not cuda_q40.supports_kernel(pq, cuda_q40.MAX_T + 1)
    assert cuda_q40.supports_kernel(pq, cuda_q40.MAX_T)


# every Llama-2-7B projection (wqkv, wo, w13, w2) and the Mixtral 8x7B
# expert shapes (gate/up, down), (d, n)
PROJECTIONS = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w13": (22016, 4096),
               "w2": (4096, 11008), "moe_gate_up": (14336, 4096),
               "moe_down": (4096, 14336)}


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_tc_plan_fills_the_card_at_every_projection(name):
    """At t = 256 every 7B and Mixtral projection's plan launches a wave's
    worth of CTAs (>= 96 of the 132, 128 and up wherever the tiles allow),
    with a split only where the n axis has a group for each CTA of the
    cluster; the plan depends on the shapes alone."""
    d, n = PROJECTIONS[name]
    bn, split = cuda_q40.tc_plan(256, n, d)
    assert bn in cuda_q40.TC_TOKENS and split in (1, 2)
    assert cuda_q40.tc_ctas(256, n, d) >= 96
    assert split <= n // cuda_q40.TC_GROUP
    assert cuda_q40.tc_ctas(256, n, d) == \
        -(-256 // bn) * -(-d // cuda_q40.TC_ROWS) * split
    assert cuda_q40.tc_plan(256, n, d) == (bn, split)


def test_tc_plan_splits_the_4096_row_weights():
    """wo, w2 and the expert down projection have 4096 rows, 32 row tiles
    of 128: one 256-token tile would leave 100 of 132 SMs idle, so their
    plan splits n across a 2-CTA cluster and cuts 128-token tiles."""
    for name in ("wo", "w2", "moe_down"):
        d, n = PROJECTIONS[name]
        assert cuda_q40.tc_plan(256, n, d) == (128, 2)
        assert cuda_q40.tc_ctas(256, n, d) == 128


def test_tc_plan_is_the_timed_best_at_a_7b_chunk():
    """At t = 256 the plan is the fastest of the six plans timed on the
    H100 at each shape (PERF.md): one 256-token tile where the row
    tiles fill a wave, a split of n where they do not."""
    want = {"wqkv": (256, 1), "wo": (128, 2), "w13": (256, 2), "w2": (128, 2),
            "moe_gate_up": (256, 1), "moe_down": (128, 2)}
    for name, (d, n) in PROJECTIONS.items():
        assert cuda_q40.tc_plan(256, n, d) == want[name], name


@pytest.mark.parametrize("t", [9, 44, 128, 256])
def test_tc_plan_covers_every_token(t):
    """Ragged chunks: the tiles cover t tokens, and a chunk of at most 64
    tokens takes the narrowest tile."""
    for d, n in PROJECTIONS.values():
        bn, _ = cuda_q40.tc_plan(t, n, d)
        assert -(-t // bn) * bn >= t
        if t <= 64:
            assert bn == 64


@pytest.mark.parametrize("n,t,dtypes,aligned,want", [
    (4096, 256, "bf16", True, True),       # a 7B chunk
    (11008, 44, "bf16", True, True),       # w2's n, a ragged last chunk
    (4096, cuda_q40.TC_MIN_T - 1, "bf16", True, False),  # below the crossing
    (4096, 256, "f32", True, False),       # f32 operands: the GEMV path
    (64, 256, "bf16", True, True),         # the tiny fixtures' widths
    (128, 256, "bf16", True, True),
    (4096 + 32, 256, "bf16", True, True),  # n not a multiple of 256
    (4096, 256, "bf16", False, False),     # an unaligned operand
])
def test_tc_path_rule(n, t, dtypes, aligned, want):
    """The stated rule that routes a launch: bf16 in and out, t >=
    TC_MIN_T, any width K1 takes (n % 32 == 0: a partial last group of 256
    values is zero-filled) and aligned operands take the tensor-core path;
    every other launch takes a GEMV path, never a fallback on failure."""
    dt = torch.bfloat16 if dtypes == "bf16" else torch.float32
    assert cuda_q40.uses_tc_path(dt, dt, t, n, aligned) is want


def test_model_widths_pass_the_tc_rule():
    """Every 7B, Mixtral and Grok-1 input width, the tp shards' (5504,
    2752) and the tiny fixtures' (64, 128) reach the tensor-core path in a
    prefill chunk; a width that is no multiple of 32 is no Q40 width."""
    for n in (4096, 11008, 14336, 6144, 32768, 5504, 2752):
        assert cuda_q40.uses_tc_path(torch.bfloat16, torch.bfloat16, 256, n)
    for n in (64, 128):
        assert cuda_q40.uses_tc_path(torch.bfloat16, torch.bfloat16, 256, n)
    assert not cuda_q40.uses_tc_path(torch.bfloat16, torch.bfloat16, 256, 48)
