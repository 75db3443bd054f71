"""The port's GEMV design probes P3 (ops/cuda_probes.py q40_pk_gemv) and
P5 (q40_matmul_scales) held against the JAX repository's Pallas probes
tools/exp_pk_decode.py build(mode, ...) and tools/exp_scale_f16.py
q40_matmul_u16, and against the JAX package's K1 (ops/pallas_q40.py
q40_matmul), run in TPU interpret mode on the CPU on the same inputs made
with numpy from a seed. On the CPU the wrappers run their plain versions;
the CUDA kernels are held against those on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.ops.pallas_q40 import _f16_bits_to_f32, q40_matmul
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu_torch.models.convert import q40_lane_to_block_major
from distributed_llama_tpu_torch.ops import cuda_probes
from test_torch_probes import _tool
from distributed_llama_tpu_torch.quants.numpy_codec import quantize_q40
from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor

# f32 on both sides, the same products, sums taken in another order
SUM_ORDER_TOL = 1e-5
# pk: x1 . pk and x2 . hi are each ~16x the result and cancel, so the sum
# order's rounding is amplified about 16x (measured 1.1e-5 here)
PK_TOL = 1e-4


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _pk_case(d, n, seed):
    """tools/exp_pk_decode.py main()'s inputs: the weight quantized from
    N(0, 0.05) (block-major bytes and f16 scales from quantize_q40), moved
    to the TPU lane order for the JAX probe; x1, x2 and xs in each side's
    order (lane order m = j*nb + b there, block-major b*16 + j here)."""
    nb, m = n // 32, n // 2
    rng = np.random.default_rng(seed)
    scales, packed = quantize_q40(rng.standard_normal((d, n)).astype(np.float32) * 0.05)
    x = rng.standard_normal((1, n)).astype(np.float32)
    xr = x.reshape(nb, 32)
    lo, hi = xr[:, :16], xr[:, 16:]
    jax_args = {"pk": jnp.asarray(packed.transpose(0, 2, 1).reshape(d, m)),
                "s": jnp.asarray(scales.view(np.uint16)),
                "x1": jnp.asarray(lo.T.reshape(1, m)),
                "x2": {"base": jnp.asarray(hi.T.reshape(1, m)),
                       "pk": jnp.asarray((hi - 16.0 * lo).T.reshape(1, m))},
                "xs": jnp.asarray(xr.sum(axis=1).reshape(1, nb))}
    port = {"w": QuantizedTensor.from_host(scales, packed, "cpu"),
            "x1": torch.from_numpy(lo.reshape(1, m).copy()),
            "x2": {"base": torch.from_numpy(hi.reshape(1, m).copy()),
                   "pk": torch.from_numpy((hi - 16.0 * lo).reshape(1, m).copy())},
            "xs": torch.from_numpy(xr.sum(axis=1).reshape(1, nb).copy())}
    return jax_args, port


@pytest.mark.parametrize("mode,tol", [("base", SUM_ORDER_TOL), ("pk", PK_TOL)])
@pytest.mark.parametrize("d,m,td", [(512, 128, 256), (1024, 256, 1024)])
def test_pk_gemv_matches_pallas(d, m, td, mode, tol):
    j, p = _pk_case(d, 2 * m, seed=d + m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_pk_decode").build(mode, d, m, td)(
            j["x1"], j["x2"][mode], j["xs"], j["pk"], j["s"]))
    got = cuda_probes.q40_pk_gemv(mode, p["x1"], p["x2"][mode], p["xs"], p["w"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, d)
    assert _rel_err(got, want) <= tol


def test_pk_and_base_agree_on_the_same_weight():
    """The substitution is an identity: pk's result is base's, within the
    amplified rounding (the TPU's bf16-fed dots lost 6.4% here)."""
    _, p = _pk_case(512, 256, seed=2)
    y = {mode: cuda_probes.q40_pk_gemv(mode, p["x1"], p["x2"][mode], p["xs"], p["w"])
         for mode in cuda_probes.PK_MODES}
    assert _rel_err(y["pk"], y["base"]) <= PK_TOL


def _scale_case(d, n, seed):
    """Lane-order bytes (tools/exp_scale_f16.py main()) and scales in
    [0.001, 0.005) rounded to f16, so the u16 and the f32 scales hold the
    same values."""
    nb = n // 32
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (d, 16 * nb), dtype=np.uint8)
    s16 = (rng.random((d, nb), dtype=np.float32) * 0.004 + 0.001).astype(np.float16)
    x = rng.standard_normal((1, n)).astype(np.float32)
    return packed, s16, x


@pytest.mark.parametrize("oracle", ["q40_matmul_u16", "q40_matmul"])
@pytest.mark.parametrize("scales", ["u16", "f32"])
def test_matmul_scales_matches_pallas(scales, oracle):
    """Both scale types against the probe's u16 kernel and against K1 with
    f32 scales, 512 x 256, t = 1."""
    packed, s16, x = _scale_case(512, 256, seed=5)
    with pltpu.force_tpu_interpret_mode():
        if oracle == "q40_matmul_u16":
            want = _tool("exp_scale_f16").q40_matmul_u16(
                jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s16.view(np.uint16)))
        else:
            want = q40_matmul(jnp.asarray(x), JaxQT(jnp.asarray(packed),
                                                    jnp.asarray(s16.astype(np.float32))))
    sc = s16.view(np.uint16) if scales == "u16" else s16.astype(np.float32)
    w = q40_lane_to_block_major(packed, sc, "cpu")
    assert w.scales.dtype == (torch.uint16 if scales == "u16" else torch.float32)
    got = cuda_probes.q40_matmul_scales(torch.from_numpy(x), w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 512)
    assert _rel_err(got, want) <= SUM_ORDER_TOL


def test_f16_bits_decode_every_finite_pattern():
    """All 63,488 finite f16 patterns: the port's integer decode equals
    numpy's float16 -> float32 and the JAX package's _f16_bits_to_f32 bit
    for bit, normals, subnormals and signed zeros."""
    bits = np.arange(65536, dtype=np.uint16)
    bits = bits[np.isfinite(bits.view(np.float16))]
    assert bits.size == 63488
    got = cuda_probes.f16_bits_to_f32(torch.from_numpy(bits)).numpy()
    want = bits.view(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    jax_f = np.asarray(_f16_bits_to_f32(jnp.asarray(bits.astype(np.int32))))
    np.testing.assert_array_equal(got.view(np.uint32), jax_f.view(np.uint32))


def test_gemv_probes_plain_calls_count_no_launches():
    _, p = _pk_case(64, 256, seed=1)
    packed, s16, x = _scale_case(64, 256, seed=1)
    fns = (cuda_probes.q40_pk_gemv, cuda_probes.q40_matmul_scales)
    before = [f.launches for f in fns]
    for mode in cuda_probes.PK_MODES:
        cuda_probes.q40_pk_gemv(mode, p["x1"], p["x2"][mode], p["xs"], p["w"])
    for sc in (s16.view(np.uint16), s16.astype(np.float32)):
        cuda_probes.q40_matmul_scales(torch.from_numpy(x),
                                      q40_lane_to_block_major(packed, sc, "cpu"))
    assert [f.launches for f in fns] == before
