"""The port's Q40 decode-GEMV design probes (distributed_llama_tpu_torch/ops/
cuda_probes.py) held against the JAX repository's Pallas probes in
tools/ (kernel_ladder.py, kernel_experiments.py, exp_int8_dot.py), run in
TPU interpret mode on the CPU, on the same inputs made with numpy from a
seed. On the CPU the port's wrappers run their plain versions; the CUDA
kernels are held against those plain versions on the card by chip_smoke.py.

The ladder's stages before `dot` are defined for the card (each consumes
every byte of the weight) and have no JAX counterpart value: they are held
against numpy computations of their definitions.
"""

import functools
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.ops.pallas_q40 import _split_activation
from distributed_llama_tpu.quants.jax_codec import (QuantizedTensor as JaxQT,
                                                    dequantize_q40_jax)
from distributed_llama_tpu_torch.models.convert import q40_lane_to_block_major
from distributed_llama_tpu_torch.ops import cuda_probes
from distributed_llama_tpu_torch.quants.torch_codec import (QuantizedTensor,
                                                            dequantize_q40_torch)

ROOT = Path(__file__).resolve().parent.parent
# f32 on both sides, the same products, sums taken in another order
SUM_ORDER_TOL = 1e-5
# tools/kernel_experiments.py check(): A and B against the dequantized
# product, relative to its largest value
CHECK_REL = 2e-2


@functools.cache
def _tool(name: str):
    """A probe module of the repository's tools/ (not a package). The tools
    put a fixed directory on sys.path when they load; it is restored, so
    later imports in this process resolve from this checkout only."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "path", list(sys.path)):
        spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol=SUM_ORDER_TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _lane_q40(rng, d, n):
    """Random lane-order Q40 bytes (d, 16*nb) u8 and f32 scales (d, nb), as
    tools/kernel_ladder.py makes them."""
    nb = n // 32
    packed = rng.integers(0, 256, (d, 16 * nb), dtype=np.uint8)
    scales = rng.random((d, nb), dtype=np.float32) * 0.004
    return packed, scales


def _jax_ladder(stage, x, packed, scales, td):
    """tools/kernel_ladder.py make_kernel(stage) under run_stage's
    pallas_call spec (t = 1, td output rows per grid step)."""
    d, m = packed.shape
    nb = m // 16
    x_lo, x_hi = _split_activation(jnp.asarray(x), nb)
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(_tool("kernel_ladder").make_kernel(stage), nb=nb),
            grid=(d // td,),
            in_specs=[vmem((1, m), lambda i: (0, 0)), vmem((1, m), lambda i: (0, 0)),
                      vmem((td, m), lambda i: (i, 0)), vmem((td, nb), lambda i: (i, 0))],
            out_specs=vmem((1, td), lambda i: (0, i)),
            out_shape=jax.ShapeDtypeStruct((1, d), jnp.float32))
        return np.asarray(call(x_lo, x_hi, jnp.asarray(packed), jnp.asarray(scales)))


@pytest.mark.parametrize("d,n,td", [(256, 256, 256), (512, 512, 256)])
def test_ladder_dot_matches_pallas(d, n, td):
    rng = np.random.default_rng(d + n)
    packed, scales = _lane_q40(rng, d, n)
    x = rng.standard_normal((1, n), dtype=np.float32)
    want = _jax_ladder("dot", x, packed, scales, td)
    w = q40_lane_to_block_major(packed, scales, "cpu")
    got = cuda_probes.q40_ladder("dot", torch.from_numpy(x), w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, d)
    _close(got, want)


def _stage_oracle(stage, packed, scales):
    """numpy of each stage's definition on block-major bytes (d, n/2) and
    f32 scales (d, nb): read and unpack as int32 bits, convert and mul in
    f64."""
    d, nb = scales.shape
    sbits = np.bitwise_xor.reduce(scales.view("<u4"), axis=1)
    lo = (packed & 0xF).astype(np.int64)
    hi = (packed >> 4).astype(np.int64)
    if stage == "read":
        y = np.bitwise_xor.reduce(packed.view("<u4"), axis=1) ^ sbits
    elif stage == "unpack":
        y = (lo + hi).sum(1).astype(np.uint32) ^ sbits
    elif stage == "convert":
        return ((lo + hi).sum(1) + scales.astype(np.float64).sum(1))[None]
    else:  # mul: byte i of a row lies in block i // 16
        nib = (lo + hi).reshape(d, nb, 16).sum(-1)
        return (nib * scales.astype(np.float64)).sum(1)[None]
    return y.view(np.int32)[None]


@pytest.mark.parametrize("n", [256, 96])
@pytest.mark.parametrize("stage", ["read", "unpack", "convert", "mul"])
def test_ladder_stage_matches_its_definition(stage, n):
    """n = 96: three blocks, an odd count of scales and of 32-bit words."""
    rng = np.random.default_rng(n)
    d = 64
    packed = rng.integers(0, 256, (d, n // 2), dtype=np.uint8)
    scales = rng.random((d, n // 32), dtype=np.float32) * 0.004
    w = QuantizedTensor(torch.from_numpy(packed), torch.from_numpy(scales))
    got = cuda_probes.q40_ladder(stage, torch.ones((1, n)), w).numpy()
    want = _stage_oracle(stage, packed, scales)
    if stage in ("read", "unpack"):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _p4_inputs(seed, d, n):
    """tools/kernel_experiments.py _q40 (one layer): (d, 16, nb) lane-order
    bytes and f16 scales; bf16 x. Returns the JAX weight, the port's weight
    (the same bytes block-major, the scales as the f32 the kernels read)
    and x for both."""
    jw = _tool("kernel_experiments")._q40(d, n, layers=1, seed=seed)
    jw = JaxQT(jw.packed[0], jw.scales[0])
    d_, _, nb = jw.packed.shape
    pw = q40_lane_to_block_major(np.asarray(jw.packed).reshape(d, 16 * nb),
                                 np.asarray(jw.scales).astype(np.float32), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal((1, n), dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return jw, pw, xb


def _jax_x(xb):
    return jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)


def _jax_variant(variant, xb, jw):
    fn = getattr(_tool("kernel_experiments"), f"q40_matmul_{variant}")
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(_jax_x(xb), jw, td=256))


@pytest.mark.parametrize("variant", ["a", "b"])
def test_bf16_variant_dequantizes_like_pallas(variant):
    """x = the identity (t = n): each output row is one weight column, with
    no sum to reorder, so A's and B's dequantized bf16 weights (B's with its
    -8 s correction) must equal the TPU variants' bit for bit."""
    d, n = 256, 256
    jw, pw, _ = _p4_inputs(5, d, n)
    eye = torch.eye(n, dtype=torch.bfloat16)
    want = _jax_variant(variant, eye, jw)
    got = getattr(cuda_probes, f"q40_matmul_{variant}")(eye, pw)
    assert tuple(got.shape) == (n, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("d,n", [(256, 512), (512, 256)])
def test_bf16_variant_matches_pallas(variant, d, n):
    """The same bf16 weights against a random x. Interpret mode does not sum
    bf16 x bf16 dots exactly in f32 (it lands up to 1.3e-3 of the largest
    output from an f64 sum, the port's plain version within 1e-7), so the
    tolerance is one bf16 ulp (2^-7) of the largest output."""
    jw, pw, xb = _p4_inputs(d * 3 + n, d, n)
    want = _jax_variant(variant, xb, jw)
    got = getattr(cuda_probes, f"q40_matmul_{variant}")(xb, pw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, d)
    _close(got, want, tol=2.0 ** -7)


@pytest.mark.parametrize("variant", ["a", "b"])
def test_bf16_variant_matches_dequantized_product(variant):
    """check()'s oracle, on the packed bytes reshaped to the codec's
    (d, 16*nb): x . dequantize_q40_jax(W), within its 2e-2 relative bound."""
    d, n = 256, 512
    jw, pw, xb = _p4_inputs(1, d, n)
    flat = JaxQT(jw.packed.reshape(d, -1), jw.scales)
    want = np.asarray(_jax_x(xb).astype(jnp.float32)
                      @ dequantize_q40_jax(flat, jnp.float32).T)
    got = getattr(cuda_probes, f"q40_matmul_{variant}")(xb, pw).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < CHECK_REL


def test_int8_gemv_matches_pallas_bit_for_bit(monkeypatch):
    e8 = _tool("exp_int8_dot")
    d, k = 512, 256
    monkeypatch.setattr(e8, "D", d)      # int8_gemv reads them at call time
    monkeypatch.setattr(e8, "K", k)
    rng = np.random.default_rng(8)
    pk = rng.integers(0, 256, (d, k // 2), dtype=np.uint8)
    sc = rng.random((d, 1), dtype=np.float32)
    xq = rng.integers(-8, 8, (1, k), dtype=np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(e8.int8_gemv(jnp.asarray(xq), jnp.asarray(pk),
                                       jnp.asarray(sc)))
    got = cuda_probes.int8_gemv(torch.from_numpy(xq), torch.from_numpy(pk),
                                torch.from_numpy(sc))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_to_block_major_keeps_f32_scales():
    """The probes' weights carried across: bytes block-major, f32 scales
    bit for bit, and the dequantized weight equal to dequantize_q40_jax."""
    rng = np.random.default_rng(4)
    packed, scales = _lane_q40(rng, 32, 256)
    w = q40_lane_to_block_major(packed, scales, "cpu")
    assert w.scales.dtype == torch.float32
    np.testing.assert_array_equal(w.scales.numpy(), scales)
    want = np.asarray(dequantize_q40_jax(JaxQT(jnp.asarray(packed),
                                               jnp.asarray(scales)), jnp.float32))
    np.testing.assert_array_equal(dequantize_q40_torch(w).numpy(), want)


def test_plain_versions_count_no_launches():
    rng = np.random.default_rng(2)
    packed, scales = _lane_q40(rng, 32, 64)
    w = q40_lane_to_block_major(packed, scales, "cpu")
    fns = (cuda_probes.q40_ladder, cuda_probes.q40_matmul_a,
           cuda_probes.q40_matmul_b, cuda_probes.int8_gemv)
    before = [f.launches for f in fns]
    cuda_probes.q40_ladder("dot", torch.ones((1, 64)), w)
    cuda_probes.q40_matmul_a(torch.ones((1, 64), dtype=torch.bfloat16), w)
    cuda_probes.q40_matmul_b(torch.ones((1, 64), dtype=torch.bfloat16), w)
    cuda_probes.int8_gemv(torch.ones((1, 64), dtype=torch.int8), w.packed,
                          torch.ones((32, 1)))
    assert [f.launches for f in fns] == before
