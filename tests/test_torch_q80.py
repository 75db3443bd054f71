"""The port's Q80 activation round trip held against the JAX package's, on
the CPU, with the same inputs made by numpy from a seed:

  * the codec (quants/torch_codec.py quantize_q80_torch /
    dequantize_q80_torch) against quantize_q80_jax / dequantize_q80_jax,
    bit for bit, f32 and bf16 in and out, with all-zero blocks and values
    at a rounding half; and on blocks holding a NaN, +inf or -inf, where
    the NaN positions must agree and every finite value be bit-equal
    (the Q80 kernel is held to the same on the card);
  * q80_roundtrip (ops/cuda_q80.py) on the CPU: the codec's plain version;
  * matmul and fused_expert_matmul with activation_q80 against the JAX
    functions with the Pallas kernels in interpret mode;
  * the LLAMA and MIXTRAL tiny forwards with activation_q80 against the
    JAX forward, all f32;
  * both CLIs at their default --buffer-float-type (q80): the same tokens.

The kernel itself is held bit for bit against the plain version on the
card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.transformer import KVCache as JaxKVCache
from distributed_llama_tpu.models.transformer import forward as jax_forward
from distributed_llama_tpu.ops.matmul import \
    fused_expert_matmul as jax_fused_expert_matmul
from distributed_llama_tpu.ops.matmul import matmul as jax_matmul
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu.quants.jax_codec import (dequantize_q80_jax,
                                                    quantize_q80_jax)
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.models import transformer
from distributed_llama_tpu_torch.models.convert import (params_from_jax,
                                                        q40_from_lane_order)
from distributed_llama_tpu_torch.models.params import fuse_layer_weights
from distributed_llama_tpu_torch.ops import cuda_q80
from distributed_llama_tpu_torch.ops.matmul import fused_expert_matmul, matmul
from distributed_llama_tpu_torch.quants.torch_codec import (
    dequantize_q80_torch, quantize_q80_torch)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# matmul after the round trip, f32: both sides quantize the same x bit for
# bit, then differ only in the product's summation order and the TPU
# kernel's -8 fold (tests/test_torch_q40.py's F32_TOL)
F32_TOL = dict(atol=2e-4, rtol=1e-4)
# f32 logits of a 2-layer forward with every matmul input round-tripped
# through Q80: the plain forward's tolerance (tests/test_torch_forward.py).
# A summation-order difference upstream of a round trip could move a value
# across a rounding half (a jump of one Q80 step in that input); on these
# fixtures none does, and the logits agree within 1e-5
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _activations(rng, rows=64, n=4096):
    """Rows scaled from 0.01 to 30, one all-zero block, one block whose
    absmax is 127 holding values at rounding halves (0.5, 1.5, -2.5)."""
    x = rng.standard_normal((rows, n), dtype=np.float32)
    x *= np.geomspace(0.01, 30, rows, dtype=np.float32)[:, None]
    x[0, :32] = 0.0
    x[1, :32] = 0.0
    x[1, :4] = (127.0, 0.5, 1.5, -2.5)
    return x


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("inp", list(DTYPES))
def test_q80_codec_is_bit_equal_to_jax(inp, out):
    tin, jin = DTYPES[inp]
    tout, jout = DTYPES[out]
    x = torch.from_numpy(_activations(np.random.default_rng(0))).to(tin)
    xj = jnp.asarray(x.float().numpy()).astype(jin)
    q, s = quantize_q80_torch(x)
    qj, sj = quantize_q80_jax(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.uint16),
                                  np.asarray(sj).view(np.uint16))
    got = dequantize_q80_torch(q, s, tout)
    want = np.asarray(dequantize_q80_jax(qj, sj, jout)).astype(np.float32)
    assert got.dtype == tout and tuple(got.shape) == tuple(x.shape)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the planted blocks: zeros stay zero with a zero scale; halves round
    # to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2 at scale 1)
    assert not q[0, 0].any() and s[0, 0] == 0
    assert q[1, 0, :4].tolist() == [127, 0, 2, -2]


def _assert_same_bits(got: np.ndarray, want: np.ndarray):
    """NaN at the same positions, every other value bit-equal (NaN
    payloads may differ between the two codecs)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("special", ["nan", "+inf", "-inf"])
@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("inp", list(DTYPES))
def test_q80_codec_matches_jax_on_nonfinite_blocks(inp, out, special):
    """A block holding a NaN (or +-inf) comes out of the round trip as 32
    NaNs with a NaN (inf) scale; the blocks beside it are untouched."""
    tin, jin = DTYPES[inp]
    tout, jout = DTYPES[out]
    x = _activations(np.random.default_rng(2), 4, 128)
    bad = np.float32({"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}[special])
    x[0, 3] = bad            # the first block of row 0
    x[2, 64 + 31] = bad      # the last value of row 2's third block
    xt = torch.from_numpy(x).to(tin)
    xj = jnp.asarray(xt.float().numpy()).astype(jin)
    q, s = quantize_q80_torch(xt)
    qj, sj = quantize_q80_jax(xj)
    s32, sj32 = s.float().numpy(), np.asarray(sj).astype(np.float32)
    _assert_same_bits(s32, sj32)
    finite = np.isfinite(sj32)
    assert finite.sum() == finite.size - 2
    # q of a non-finite block is a cast of NaN (unspecified); elsewhere equal
    np.testing.assert_array_equal(q.numpy()[finite], np.asarray(qj)[finite])
    got = dequantize_q80_torch(q, s, tout).float().numpy()
    want = np.asarray(dequantize_q80_jax(qj, sj, jout)).astype(np.float32)
    _assert_same_bits(got, want)
    assert np.isnan(got[0, :32]).all() and np.isnan(got[2, 64:96]).all()
    assert np.isfinite(got[0, 32:]).all() and np.isfinite(got[1]).all()
    # and the wrapper's CPU path is the same codec
    _assert_same_bits(cuda_q80.q80_roundtrip(xt, tout).float().numpy(), want)


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("inp", list(DTYPES))
def test_q80_roundtrip_on_cpu_is_the_codec(inp, out):
    tin, tout = DTYPES[inp][0], DTYPES[out][0]
    x = torch.from_numpy(_activations(np.random.default_rng(1), 8, 256))
    x = x.to(tin).reshape(2, 4, 256)
    before = cuda_q80.q80_roundtrip.launches
    got = cuda_q80.q80_roundtrip(x, tout)
    q, s = quantize_q80_torch(x)
    assert torch.equal(got, dequantize_q80_torch(q, s, tout))
    assert cuda_q80.q80_roundtrip.launches == before


def _weights(rng, d, n, scale=0.1):
    w = rng.standard_normal((d, n), dtype=np.float32) * scale
    scales, packed = quantize_q40(w)
    jq = JaxQT.from_numpy(scales, packed)
    return jq, q40_from_lane_order(np.asarray(jq.packed),
                                   np.asarray(jq.scales), "cpu")


@pytest.mark.parametrize("t", [1, 5, 44])
def test_matmul_activation_q80_matches_jax(t):
    rng = np.random.default_rng(100 + t)
    jq, pq = _weights(rng, 128, 512)
    x = rng.standard_normal((t, 512), dtype=np.float32)
    want = np.asarray(jax_matmul(jnp.asarray(x), jq, activation_q80=True,
                                 compute_dtype=jnp.float32, use_pallas=True,
                                 pallas_interpret=True))
    got = matmul(torch.from_numpy(x), pq, compute_dtype=torch.float32,
                 activation_q80=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # and the round trip is really applied: it moves the result
    plain = matmul(torch.from_numpy(x), pq, compute_dtype=torch.float32)
    assert not torch.allclose(plain, got, atol=1e-5, rtol=0)


@pytest.mark.parametrize("per_expert", [False, True])
def test_fused_expert_matmul_activation_q80_matches_jax(per_expert):
    rng = np.random.default_rng(7 + per_expert)
    n_e, d, n = 4, 64, 256
    w = rng.standard_normal((n_e, d, n), dtype=np.float32) * 0.1
    scales, packed = quantize_q40(w)
    jq = JaxQT.from_numpy(scales, packed)
    pq = q40_from_lane_order(np.asarray(jq.packed), np.asarray(jq.scales),
                             "cpu")
    idx = np.asarray([2, 0], np.int32)
    x = rng.standard_normal((2, 1, n) if per_expert else (1, n),
                            dtype=np.float32)
    got = fused_expert_matmul(torch.from_numpy(x), pq, torch.from_numpy(idx),
                              compute_dtype=torch.float32,
                              activation_q80=True)
    for k, e in enumerate(idx):
        want = jax_fused_expert_matmul(
            jnp.asarray(x[k] if per_expert else x), jq, jnp.int32(e),
            activation_q80=True, compute_dtype=jnp.float32, use_pallas=True,
            pallas_interpret=True)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                   **F32_TOL)


@pytest.fixture(scope="module", params=["LLAMA", "MIXTRAL"])
def model(request, tmp_path_factory):
    moe = dict(arch=JaxArch.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, _ = write_fixture(tmp_path_factory.mktemp(request.param), seed=33,
                             **(moe if request.param == "MIXTRAL" else {}))
    spec, tensors = read_model(mpath)
    jparams = jax_load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    return spec, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def test_forward_activation_q80_matches_jax(model):
    """Prefill, then decode steps (MIXTRAL's through the fused expert
    path), every matmul input through Q80 on both sides, f32."""
    spec, jparams, np_params = model
    params = fuse_layer_weights(params_from_jax(np_params, spec, "cpu"))
    jcache = JaxKVCache.create(spec, 1, dtype=jnp.float32)
    cache = transformer.KVCache.create(spec, 1, dtype=torch.float32,
                                       device="cpu")

    def both(tokens, pos):
        want, new = jax_forward(jparams, spec, jnp.asarray(tokens, jnp.int32),
                                jnp.int32(pos), jcache,
                                compute_dtype=jnp.float32,
                                activation_q80=True, use_pallas=True,
                                pallas_interpret=True)
        got = transformer.forward(params, spec, torch.tensor(tokens), pos,
                                  cache, activation_q80=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        return new

    prompt = [[1, 40, 7, 99, 150, 3, 17, 42, 8]]
    jcache = both(prompt, 0)
    for i, tok in enumerate((5, 77, 200)):
        jcache = both([[tok]], len(prompt[0]) + i)


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_cli_defaults_print_jax_cli_tokens(tmp_path, capsys, arch):
    """No --buffer-float-type on either side: both CLIs default to q80,
    and print the same tokens."""
    moe = dict(arch=JaxArch.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, tpath = write_fixture(tmp_path, seed=44,
                                 **(moe if arch == "MIXTRAL" else {}))
    common = ["generate", "--model", mpath, "--tokenizer", tpath,
              "--prompt", "hello world", "--steps", "16", "--seed", "9",
              "--temperature", "0", "--compute-dtype", "f32",
              "--cache-dtype", "f32"]
    assert jax_dllama.build_argparser().parse_args(
        common[:1]).buffer_float_type == "q80"
    assert dllama.build_argparser().parse_args(
        common[:1]).buffer_float_type == "q80"
    jax_dllama.main(common)
    want = capsys.readouterr().out.splitlines()
    before = cuda_q80.q80_roundtrip.launches
    dllama.main(common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert cuda_q80.q80_roundtrip.launches == before   # the CPU: plain only

    def text(lines):
        return lines[next(k for k, line in enumerate(lines)
                          if line.startswith("💡")):]

    assert text(got) == text(want)


def test_cli_q80_default_turns_on_the_round_trip(tmp_path, monkeypatch):
    """The port CLI's engine gets activation_q80 for a Q40 model at the
    default flags and not with --buffer-float-type f32."""
    from distributed_llama_tpu_torch.runtime import engine as engine_mod

    mpath, tpath = write_fixture(tmp_path, seed=2)
    seen = []
    real = engine_mod.Engine.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("activation_q80"))
        real(self, *a, **kw)

    monkeypatch.setattr(engine_mod.Engine, "__init__", spy)
    base = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt",
            "ab", "--steps", "2", "--temperature", "0", "--device", "cpu"]
    dllama.main(base)
    dllama.main(base + ["--buffer-float-type", "f32"])
    assert seen == [True, False]
