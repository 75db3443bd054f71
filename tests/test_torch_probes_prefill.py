"""The port's unpack/MMA overlap probe (ops/cuda_probes.py q40_matmul_sub,
P6) held against the JAX repository's Pallas probe
tools/exp_unpack_overlap.py matmul_sub, run in TPU interpret mode on the
CPU on the same inputs made with numpy from a seed. On the CPU the wrapper
runs its plain version; the CUDA kernel, for every (td, n_sub), is held
against that plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu_torch.models.convert import q40_lane_to_block_major
from distributed_llama_tpu_torch.ops import cuda_probes
from test_torch_probes import _tool

D, N, T = 512, 256, 16
# one bf16 ulp of the largest output: both sides sum the same bf16
# products in f32 in another order and round the output to bf16 once
BF16_ULP = 2.0 ** -7
JAX_TD = 256     # the TPU tool's row tile: D % td == 0 and (td / n_sub) % 32 == 0


@pytest.fixture
def small_tool(monkeypatch):
    """The JAX tool at D x N, T tokens. All five shape globals: NB and M
    are computed from N when the module loads, so D and N alone would
    leave them at the full shape."""
    mod = _tool("exp_unpack_overlap")
    for name, value in dict(D=D, N=N, T=T, NB=N // 32, M=16 * (N // 32)).items():
        monkeypatch.setattr(mod, name, value)
    return mod


def _inputs(seed):
    """tools/exp_unpack_overlap.py main()'s inputs at D x N: lane-order
    bytes, f16 scales in [0, 0.004) as uint16 bits, x rounded to bf16 (the
    kernel feeds bf16; the JAX tool gets the same values in f32)."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (D, N // 2), dtype=np.uint8)
    s16 = (rng.random((D, N // 32), dtype=np.float32) * 0.004).astype(np.float16)
    xb = torch.from_numpy(rng.standard_normal((T, N), dtype=np.float32)).to(torch.bfloat16)
    jw = JaxQT(jnp.asarray(packed), jnp.asarray(s16.view(np.uint16)))
    return jw, q40_lane_to_block_major(packed, s16, "cpu"), xb


@pytest.mark.parametrize("n_sub", cuda_probes.SUB_NS)
def test_matmul_sub_matches_pallas(small_tool, n_sub):
    jw, pw, xb = _inputs(n_sub)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(small_tool.matmul_sub(jnp.asarray(xb.float().numpy()), jw,
                                                n_sub, JAX_TD)).astype(np.float32)
    for td in cuda_probes.SUB_TDS:
        got = cuda_probes.q40_matmul_sub(xb, pw, n_sub, td)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, D)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_ULP * np.abs(want).max()


def test_matmul_sub_refuses_variants_it_has_no_kernel_for():
    _, pw, xb = _inputs(0)
    for n_sub, td in ((3, 64), (2, 256), (16, 128)):
        with pytest.raises(ValueError, match="n_sub"):
            cuda_probes.q40_matmul_sub(xb, pw, n_sub, td)


def test_matmul_sub_plain_calls_count_no_launches():
    _, pw, xb = _inputs(1)
    before = cuda_probes.q40_matmul_sub.launches
    cuda_probes.q40_matmul_sub(xb, pw, 2, 64)
    assert cuda_probes.q40_matmul_sub.launches == before
