"""The port's fp8-cache flash-decode probe (ops/cuda_probes.py
f8_flash_decode, P2) held against the JAX repository's Pallas probe
tools/exp_f8_flash.py build(mode, ...), run in TPU interpret mode on the
CPU, on the same inputs made with numpy from a seed. On the CPU the wrapper
runs its plain version; the CUDA kernel is held against that plain version
on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu_torch.ops import cuda_probes
from test_torch_probes import _tool

HS = 128
# one bf16 ulp of the largest output: both sides round p to bf16 before
# P.V, the TPU kernel against a running max per 512-slot block and the
# plain version against the row's max, and both round the output once
BF16_ULP = 2.0 ** -7
CACHE_IN = {"plain": "bf16", "astype": "f8", "bits": "u8", "bitsflush": "u8"}


def _torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor, bf16 and e4m3 moved as bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _inputs(seed, b, kvh, s):
    """q and a cache from N(0, 1) in bf16, the cache also as e4m3 and as
    its uint8 bits, as tools/exp_f8_flash.py main() makes them."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b * kvh, 1, HS)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b * kvh, s, HS)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b * kvh, s, HS)), jnp.bfloat16)
    k8, v8 = k.astype(jnp.float8_e4m3fn), v.astype(jnp.float8_e4m3fn)
    u8 = functools.partial(jax.lax.bitcast_convert_type, new_dtype=jnp.uint8)
    return q, {"bf16": (k, v), "f8": (k8, v8), "u8": (u8(k8), u8(v8))}


def _both(mode, pos, b, kvh, s, seed):
    q, caches = _inputs(seed, b, kvh, s)
    k, v = caches[CACHE_IN[mode]]
    pos_j = jnp.asarray(pos, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_f8_flash").build(mode, b, kvh, s, HS)(pos_j, q, k, v))
    got = cuda_probes.f8_flash_decode(mode, _torch(pos_j), _torch(q), _torch(k), _torch(v))
    return got, want.astype(np.float32)


@pytest.mark.parametrize("pos", [0, 511, 700, 1023])
@pytest.mark.parametrize("mode", cuda_probes.F8_MODES)
def test_f8_flash_decode_matches_pallas(mode, pos):
    got, want = _both(mode, [pos], 1, 2, 1024, seed=pos)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 1, HS)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ULP * np.abs(want).max()


@pytest.mark.parametrize("mode", cuda_probes.F8_MODES)
def test_f8_flash_decode_pos_per_batch_row(mode):
    """B = 2: rows 0-1 see up to pos[0], rows 2-3 up to pos[1]."""
    got, want = _both(mode, [300, 900], 2, 2, 1024, seed=9)
    assert tuple(got.shape) == (4, 1, HS)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ULP * np.abs(want).max()


def test_f8_flash_decode_bits_equals_astype_bit_for_bit():
    """The same cache through the integer reassembly and through the e4m3
    conversion gives the same bf16 output, subnormal codes included."""
    q, caches = _inputs(3, 1, 2, 512)
    (k8, v8), (ku, vu) = caches["f8"], caches["u8"]
    codes = np.asarray(ku)
    assert ((codes & 0x7F) < 8).any() and not ((codes & 0x7F) == 0x7F).any()
    pos = torch.tensor([400], dtype=torch.int32)
    a = cuda_probes.f8_flash_decode("astype", pos, _torch(q), _torch(k8), _torch(v8))
    b = cuda_probes.f8_flash_decode("bits", pos, _torch(q), _torch(ku), _torch(vu))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("flush", [False, True])
def test_f8_bits_helper_over_every_code(flush):
    """All 254 non-NaN e4m3 codes: the port's helper equals the JAX tool's
    _f8_bits_to_bf16 bit for bit, and torch's e4m3 -> f32 conversion, with
    flush zeroing (signed) every code whose magnitude is below 8."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    assert codes.size == 254
    got = cuda_probes.f8_bits_to_bf16(torch.from_numpy(codes), flush)
    want_jax = np.asarray(_tool("exp_f8_flash")._f8_bits_to_bf16(jnp.asarray(codes), flush))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want_jax.view(np.int16))
    ref = torch.from_numpy(codes).view(torch.float8_e4m3fn).to(torch.float32)
    sub = torch.from_numpy((codes & 0x7F) < 8)
    if flush:
        ref = torch.where(sub, torch.zeros_like(ref) * torch.sign(ref), ref)
        assert bool((got[sub] == 0).all())
    assert torch.equal(got.to(torch.float32), ref)
    assert torch.equal(torch.signbit(got.to(torch.float32)), torch.from_numpy(codes >= 0x80))


def test_f8_flash_decode_plain_calls_count_no_launches():
    q, caches = _inputs(1, 1, 1, 256)
    before = cuda_probes.f8_flash_decode.launches
    for mode in cuda_probes.F8_MODES:
        k, v = caches[CACHE_IN[mode]]
        cuda_probes.f8_flash_decode(mode, torch.tensor([100], dtype=torch.int32),
                                    _torch(q), _torch(k), _torch(v))
    assert cuda_probes.f8_flash_decode.launches == before
