"""The Q80 activation round trip fused into K1's and K2's t = 1 launch
(ops/cuda_q40.py activation_q80, csrc/q40_matmul.cu q80_block), held
against the JAX package on the CPU with the same inputs made by numpy from
a seed:

  * q40_matmul(..., activation_q80=True) at t = 1 against the JAX matmul
    with activation_q80 (its Pallas kernel in interpret mode), f32 and
    bf16 in and out, with a zero block and values at rounding halves, and
    on blocks holding a NaN, +inf or -inf (NaN at the same positions);
  * q40_expert_matmul the same against the JAX fused_expert_matmul, with x
    shared by the experts and one per expert;
  * the dispatch rule of ops/matmul.py: a Q40 weight at t = 1 takes the
    fused round trip and never the standalone kernel; t >= 2, a dense
    weight and the path above MAX_T take the standalone one, once;
  * the LLAMA and MIXTRAL tiny forwards' round trips per decode step and
    prefill chunk, fused and standalone, as chip_smoke.py counts them.

On the CPU the wrappers run their plain versions (the codec's round trip,
then the product); the kernel is held bit for bit against the unfused
pair and within TOL of the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.matmul import \
    fused_expert_matmul as jax_fused_expert_matmul
from distributed_llama_tpu.ops.matmul import matmul as jax_matmul
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu_torch.io.model_file import read_model
from distributed_llama_tpu_torch.models import transformer
from distributed_llama_tpu_torch.models.convert import q40_from_lane_order
from distributed_llama_tpu_torch.models.params import (fuse_layer_weights,
                                                       load_params)
from distributed_llama_tpu_torch.models.spec import ArchType
from distributed_llama_tpu_torch.ops import cuda_q40, cuda_q80
from distributed_llama_tpu_torch.ops.matmul import fused_expert_matmul, matmul
from distributed_llama_tpu_torch.testing import write_fixture

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
PAIRS = [(i, o) for i in DTYPES for o in DTYPES]
# f32 out: both sides round-trip the same x bit for bit, then differ only
# in the product's summation order and the TPU kernel's -8 fold: the
# tolerance of tests/test_torch_q80.py test_matmul_activation_q80_matches_jax
F32_TOL = dict(atol=2e-4, rtol=1e-4)
# bf16 out: one bf16 ulp (2^-7) of the largest output absolute, plus 2^-7
# relative (tests/test_torch_q40.py test_q40_matmul_bf16_out): the JAX
# side rounds its dequantized weights and its products to bf16, the port
# keeps f32 operands and rounds once at the output
BF16_ULP = 2.0 ** -7
# a NaN or +-inf in a block, or a finite absmax whose scale (absmax / 127)
# is past f16's range: each block comes out of the round trip non-finite
SPECIALS = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf, "huge": 3e7}


def _assert_close(got: torch.Tensor, want: np.ndarray, out: str):
    """NaN at the same positions; the finite values within the stated
    tolerance of the output type."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert np.isfinite(got[~nan]).all()
    if (~nan).any():
        g, w = got[~nan], want[~nan]
        if out == "f32":
            np.testing.assert_allclose(g, w, **F32_TOL)
        else:
            np.testing.assert_allclose(g, w, atol=BF16_ULP * np.abs(w).max(),
                                       rtol=BF16_ULP)


def _activations(rng, shape):
    """Values of very different sizes; past one block a zero block, past
    two a block whose absmax is 127 holding values at rounding halves
    (0.5, 1.5, -2.5)."""
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= rng.uniform(0.01, 30, (*shape[:-1], 1)).astype(np.float32)
    if shape[-1] > 32:
        x[..., :32] = 0.0
    if shape[-1] >= 96:
        x[..., 32:64] = np.clip(x[..., 32:64], -100, 100)
        x[..., 32:36] = (127.0, 0.5, 1.5, -2.5)
    return x


def _weights(rng, *shape):
    w = rng.standard_normal(shape, dtype=np.float32) * 0.1
    scales, packed = quantize_q40(w)
    jq = JaxQT.from_numpy(scales, packed)
    return jq, q40_from_lane_order(np.asarray(jq.packed),
                                   np.asarray(jq.scales), "cpu")


def _both(x: np.ndarray, inp: str):
    """x in the input type, for each side (bf16: the same rounded values)."""
    xt = torch.from_numpy(x).to(DTYPES[inp][0])
    return xt, jnp.asarray(xt.float().numpy()).astype(DTYPES[inp][1])


@pytest.mark.parametrize("inp,out", PAIRS)
@pytest.mark.parametrize("n", [32, 96, 1024, 1056])
def test_q40_matmul_fused_q80_matches_jax(n, inp, out):
    rng = np.random.default_rng(n + 10 * len(inp + out))
    for d in (4, 12, 40):
        jq, pq = _weights(rng, d, n)
        xt, xj = _both(_activations(rng, (1, n)), inp)
        want = jax_matmul(xj, jq, activation_q80=True,
                          compute_dtype=DTYPES[out][1], use_pallas=True,
                          pallas_interpret=True)
        got = cuda_q40.q40_matmul(xt, pq, DTYPES[out][0], activation_q80=True)
        assert got.dtype == DTYPES[out][0] and tuple(got.shape) == (1, d)
        _assert_close(got, want, out)
        # the round trip is really applied: it moves the result
        plain = cuda_q40.q40_matmul(xt, pq, DTYPES[out][0])
        assert not torch.equal(plain, got)


@pytest.mark.parametrize("special", list(SPECIALS))
@pytest.mark.parametrize("inp,out", PAIRS)
def test_q40_matmul_fused_q80_nonfinite_blocks_match_jax(inp, out, special):
    """A block holding a NaN or +-inf comes out of the round trip as 32
    NaNs (an inf scale: +-inf, NaN where q is 0), so every output of a
    t = 1 product is NaN, on both sides."""
    rng = np.random.default_rng(3)
    jq, pq = _weights(rng, 12, 1056)
    x = _activations(rng, (1, 1056))
    x[0, 64 + 7] = SPECIALS[special]
    xt, xj = _both(x, inp)
    want = np.asarray(jax_matmul(xj, jq, activation_q80=True,
                                 compute_dtype=DTYPES[out][1], use_pallas=True,
                                 pallas_interpret=True), np.float32)
    got = cuda_q40.q40_matmul(xt, pq, DTYPES[out][0], activation_q80=True)
    assert np.isnan(want).all()
    _assert_close(got, want, out)


@pytest.mark.parametrize("special", [None, *SPECIALS])
@pytest.mark.parametrize("inp,out", PAIRS)
@pytest.mark.parametrize("per_expert", [False, True])
def test_q40_expert_matmul_fused_q80_matches_jax(per_expert, inp, out,
                                                 special):
    """K2 with the round trip fused, x shared by the experts (x_kstride 0)
    or one per expert; a non-finite block in expert 0's x only turns that
    expert's outputs NaN and leaves the other's finite."""
    rng = np.random.default_rng(40 + per_expert)
    n_e, d, n = 4, 40, 1056
    jq, pq = _weights(rng, n_e, d, n)
    idx = np.asarray([3, 1], np.int32)
    x = _activations(rng, (2, 1, n) if per_expert else (1, n))
    if special is not None:
        x.reshape(-1, n)[0, 96 + 31] = SPECIALS[special]
    xt, xj = _both(x, inp)
    got = cuda_q40.q40_expert_matmul(xt, pq, torch.from_numpy(idx),
                                     DTYPES[out][0], activation_q80=True)
    assert got.dtype == DTYPES[out][0] and tuple(got.shape) == (2, 1, d)
    for k, e in enumerate(idx):
        want = jax_fused_expert_matmul(
            xj[k] if per_expert else xj, jq, jnp.int32(e), activation_q80=True,
            compute_dtype=DTYPES[out][1], use_pallas=True,
            pallas_interpret=True)
        _assert_close(got[k], want, out)
    nan = torch.isnan(got.float())
    if special is None:
        assert not nan.any()
    else:
        assert nan[0].all() and (nan[1].all() != per_expert)


@pytest.fixture
def standalone_calls(monkeypatch):
    """Count the standalone round trip's calls, and the fused ones (the
    K1 and K2 wrappers' activation_q80), through the module attributes
    ops/matmul.py calls."""
    calls = {"standalone": 0, "fused": 0, "unfused": 0}
    rt, k1, k2 = cuda_q80.q80_roundtrip, cuda_q40.q40_matmul, cuda_q40.q40_expert_matmul

    def count_rt(*a, **k):
        calls["standalone"] += 1
        return rt(*a, **k)

    def spy(fn):
        def call(*a, activation_q80=False, **k):
            calls["fused" if activation_q80 else "unfused"] += 1
            return fn(*a, activation_q80=activation_q80, **k)
        return call
    monkeypatch.setattr(cuda_q80, "q80_roundtrip", count_rt)
    monkeypatch.setattr(cuda_q40, "q40_matmul", spy(k1))
    monkeypatch.setattr(cuda_q40, "q40_expert_matmul", spy(k2))
    return calls


@pytest.mark.parametrize("case,t,standalone,fused", [
    ("q40", 1, 0, 1),
    ("q40", 2, 1, 0),
    ("q40", 44, 1, 0),
    ("q40 above MAX_T", cuda_q40.MAX_T + 1, 1, 0),
    ("dense", 1, 1, 0),
    ("experts", 1, 0, 1),
    ("experts", 2, 1, 0),
])
def test_dispatch_sends_t1_q40_to_the_fused_round_trip(standalone_calls, case,
                                                       t, standalone, fused):
    """matmul / fused_expert_matmul with activation_q80: a Q40 weight at
    t = 1 calls the standalone round trip 0 times and passes x raw to the
    kernel's fused one; t >= 2, a dense weight and the dequantize path
    above MAX_T call it once. The result is the JAX matmul's either way."""
    rng = np.random.default_rng(t)
    n = 96
    jq, pq = _weights(rng, *((4,) if case == "experts" else ()), 12, n)
    x = _activations(rng, (t, n))
    assert cuda_q40.fuses_q80(pq, t) == (t == 1)
    kw = dict(compute_dtype=torch.float32, activation_q80=True)
    jkw = dict(compute_dtype=jnp.float32, activation_q80=True, use_pallas=True,
               pallas_interpret=True)
    if case == "experts":
        idx = np.asarray([2, 0], np.int32)
        got = fused_expert_matmul(torch.from_numpy(x), pq,
                                  torch.from_numpy(idx), **kw)
        for k, e in enumerate(idx):
            want = jax_fused_expert_matmul(jnp.asarray(x), jq, jnp.int32(e), **jkw)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want), **F32_TOL)
    else:
        w = (torch.from_numpy(np.asarray(
            rng.standard_normal((12, n), dtype=np.float32)))
             if case == "dense" else pq)
        assert cuda_q40.fuses_q80(w, t) == (case != "dense" and t == 1)
        got = matmul(torch.from_numpy(x), w, **kw)
        want = jax_matmul(jnp.asarray(x), jq if case != "dense" else
                          jnp.asarray(w.numpy()), **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert standalone_calls["standalone"] == standalone
    assert standalone_calls["fused"] == fused


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_forward_round_trips_per_step_and_chunk(standalone_calls, tmp_path,
                                                arch):
    """The tiny forwards with activation_q80, as chip_smoke.py counts the
    full-size ones: a decode step fuses every Q40 projection's round trip
    (LLAMA 4 a layer + wcls; MIXTRAL wqkv, wo, gate, up, down a layer +
    wcls) and runs the standalone one only for MIXTRAL's routers; a
    prefill chunk runs it standalone for every input but wcls's (t = 1)."""
    moe = dict(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, _ = write_fixture(tmp_path, seed=33,
                             **(moe if arch == "MIXTRAL" else {}))
    spec, tensors = read_model(mpath)
    params = fuse_layer_weights(load_params(spec, tensors, device="cpu"))
    cache = transformer.KVCache.create(spec, 1, dtype=torch.float32,
                                       device="cpu")
    layers = spec.n_layers
    moe_arch = arch == "MIXTRAL"

    def counted(tokens, pos):
        for k in standalone_calls:
            standalone_calls[k] = 0
        logits = transformer.forward(params, spec, torch.tensor(tokens), pos,
                                     cache, activation_q80=True)
        assert bool(torch.isfinite(logits).all())
        return dict(standalone_calls)

    prompt = [[1, 40, 7, 99, 150, 3, 17, 42, 8]]
    chunk = counted(prompt, 0)
    per_layer = (3 + 3 * spec.n_experts) if moe_arch else 4   # + router
    assert chunk == {"standalone": layers * per_layer, "fused": 1,
                     "unfused": layers * (2 + 3 * spec.n_experts if moe_arch else 4)}
    step = counted([[5]], len(prompt[0]))
    assert step == {"standalone": layers if moe_arch else 0,
                    "fused": layers * (5 if moe_arch else 4) + 1, "unfused": 0}
