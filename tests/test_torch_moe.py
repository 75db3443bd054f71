"""The port's MoE path held against the JAX package's, on the CPU, with the
same inputs made by numpy from a seed:

  * K2 (ops/cuda_q40.py q40_expert_matmul), through its plain version,
    against the Pallas q40_expert_matmul in interpret mode, for every
    expert; the K-expert batched call against K single calls;
  * the routing (moe_route) against the JAX package's softmax + lax.top_k,
    ties included;
  * MIXTRAL and GROK1 tiny forwards (prefill, then decode steps through
    the fused expert path), the engines' greedy and seeded tokens, and the
    streamed loader, all f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from unittest import mock

from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.models.transformer import KVCache as JaxKVCache
from distributed_llama_tpu.models.transformer import forward as jax_forward
from distributed_llama_tpu.ops.pallas_q40 import \
    q40_expert_matmul as jax_q40_expert_matmul
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models import transformer
from distributed_llama_tpu_torch.models.convert import (params_from_jax,
                                                        q40_from_lane_order)
from distributed_llama_tpu_torch.models.loader import load_params_streamed
from distributed_llama_tpu_torch.models.params import (fuse_layer_weights,
                                                       synthetic_q40_params)
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops.matmul import fused_expert_matmul
from distributed_llama_tpu_torch.quants.torch_codec import take_expert
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.testing import tiny_spec, write_fixture

# K1's f32 tolerance (tests/test_torch_q40.py): summation order and the TPU
# kernel's -8 fold
F32_TOL = dict(atol=2e-4, rtol=1e-4)
# f32 forwards through 2 layers (tests/test_torch_forward.py)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# the smallest gap allowed between the k-th and (k+1)-th routing
# probability in a fixture: far above f32 rounding (~1e-7 here), so the two
# packages cannot pick different experts for rounding's sake
MIN_ROUTE_MARGIN = 1e-4
# fixture seeds whose every routing decision clears MIN_ROUTE_MARGIN
ARCHS = {"MIXTRAL": dict(seed=33),
         "GROK1": dict(seed=34, hidden_act=HiddenAct.GELU)}
N_E, D, N = 8, 256, 1024     # the grid of tests/test_pallas_q40.py:48-62


def _moe_fixture(dirpath, arch):
    kw = dict(ARCHS[arch])
    seed = kw.pop("seed")
    mpath, tpath = write_fixture(dirpath, seed=seed, arch=ArchType[arch],
                                 n_experts=4, n_active_experts=2, **kw)
    spec, tensors = read_model(mpath)
    jparams = jax_load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    return spec, jparams, jax.tree_util.tree_map(np.asarray, jparams), mpath


@pytest.fixture(scope="module", params=list(ARCHS))
def moe_model(request, tmp_path_factory):
    return _moe_fixture(tmp_path_factory.mktemp(request.param), request.param)


@pytest.fixture(scope="module")
def expert_stack():
    """(JAX stack, port stack) of N_E random (D, N) Q40 experts."""
    rng = np.random.default_rng(48)
    qs = [JaxQT.from_numpy(*quantize_q40(
        rng.standard_normal((D, N), dtype=np.float32) * 0.1))
        for _ in range(N_E)]
    jstack = JaxQT(jnp.stack([q.packed for q in qs]),
                   jnp.stack([q.scales for q in qs]))
    pstack = q40_from_lane_order(np.asarray(jstack.packed),
                                 np.asarray(jstack.scales), "cpu")
    return jstack, pstack


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("e", range(N_E))
def test_expert_matmul_matches_pallas(expert_stack, e, t):
    jstack, pstack = expert_stack
    x = np.random.default_rng(100 * e + t).standard_normal(
        (t, N), dtype=np.float32)
    want = np.asarray(jax_q40_expert_matmul(jnp.asarray(x), jstack,
                                            jnp.int32(e), interpret=True))
    got = cuda_q40.q40_expert_matmul(torch.from_numpy(x), pstack,
                                     torch.tensor([e], dtype=torch.int32))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, t, D)
    np.testing.assert_allclose(got[0].numpy(), want, **F32_TOL)


@pytest.mark.parametrize("per_expert", [False, True])
def test_batched_experts_equal_single_calls(expert_stack, per_expert):
    """One call over K experts gives each expert's single call; x is shared
    (gate, up) or one per expert (down)."""
    _, pstack = expert_stack
    idx = torch.tensor([5, 2, 7])
    rng = np.random.default_rng(6)
    shape = (3, 2, N) if per_expert else (2, N)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    got = cuda_q40.q40_expert_matmul(x, pstack, idx)
    assert tuple(got.shape) == (3, 2, D)
    for k, e in enumerate(idx.tolist()):
        one = cuda_q40.q40_expert_matmul(x[k] if per_expert else x, pstack,
                                         torch.tensor([e]))[0]
        np.testing.assert_array_equal(got[k].numpy(), one.numpy())
        solo = cuda_q40.q40_matmul(x[k] if per_expert else x,
                                   take_expert(pstack, e))
        np.testing.assert_allclose(got[k].numpy(), solo.numpy(), **F32_TOL)


def test_expert_index_is_clamped_like_a_dynamic_index(expert_stack):
    _, pstack = expert_stack
    x = torch.ones((1, N))
    hi = cuda_q40.q40_expert_matmul(x, pstack, torch.tensor([N_E + 3]))
    last = cuda_q40.q40_expert_matmul(x, pstack, torch.tensor([N_E - 1]))
    np.testing.assert_array_equal(hi.numpy(), last.numpy())


def test_take_expert_is_a_view_at_the_slab_offset(expert_stack):
    _, pstack = expert_stack
    w = take_expert(pstack, 3)
    assert w.packed.data_ptr() == pstack.packed.data_ptr() + 3 * D * N // 2
    assert w.scales.data_ptr() == pstack.scales.data_ptr() + 3 * D * N // 32 * 2
    assert w.packed.is_contiguous() and w.packed.data_ptr() % 16 == 0
    assert w.shape == (D, N)


def test_fused_expert_matmul_dense_stack():
    """A dense (E, d, n) stack (dense-weight mode) is gathered on the
    device and multiplied: the same as each expert's own product."""
    rng = np.random.default_rng(9)
    stack = torch.from_numpy(rng.standard_normal((4, 16, 32), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 32), dtype=np.float32))
    got = fused_expert_matmul(x, stack, torch.tensor([3, 1]))
    for k, e in enumerate((3, 1)):
        np.testing.assert_allclose(got[k].numpy(), (x @ stack[e].T).numpy(),
                                   atol=1e-6, rtol=1e-6)


def _jax_route(logits, k):
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    top_p, top_idx = lax.top_k(probs, k)
    return np.asarray(top_p / top_p.sum(axis=-1, keepdims=True)), \
        np.asarray(top_idx)


@pytest.mark.parametrize("case", ["tie", "random"])
def test_moe_route_matches_lax_top_k(case):
    """Top-k with ties broken toward the lower index, as lax.top_k does
    (torch.topk picks [2, 4] on the planted tie)."""
    if case == "tie":
        logits = np.asarray([[0.3, 0.5, 0.5, 0.1, 0.5]], np.float32)
    else:
        logits = np.random.default_rng(3).standard_normal(
            (3, 5, 8)).astype(np.float32)
    w_want, i_want = _jax_route(logits, 2)
    w, i = transformer.moe_route(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(i.numpy(), i_want)
    np.testing.assert_allclose(w.numpy(), w_want, atol=1e-7, rtol=1e-6)
    if case == "tie":
        assert i.tolist() == [[1, 2]]


def _route_margins():
    """Patch moe_route to record each decision's gap between the k-th and
    (k+1)-th probability."""
    margins, route = [], transformer.moe_route

    def record(logits, k):
        p = torch.softmax(logits.float(), -1).sort(-1, descending=True).values
        margins.append((p[..., k - 1] - p[..., k]).min().item())
        return route(logits, k)
    return margins, mock.patch.object(transformer, "moe_route", record)


def test_moe_forward_prefill_then_decode_matches_jax(moe_model):
    """Prefill, then 4 decode steps: the JAX side runs its Pallas kernels
    in interpret mode, so its decode takes the fused expert kernel; the
    port's decode goes through K2's plain version."""
    spec, jparams, np_params, _ = moe_model
    params = fuse_layer_weights(params_from_jax(np_params, spec, "cpu"))
    jcache = JaxKVCache.create(spec, 1, dtype=jnp.float32)
    cache = transformer.KVCache.create(spec, 1, dtype=torch.float32,
                                       device="cpu")

    def jax_run(tokens, pos):
        return jax_forward(jparams, spec, jnp.asarray(tokens, jnp.int32),
                           jnp.int32(pos), jcache, compute_dtype=jnp.float32,
                           use_pallas=True, pallas_interpret=True)

    margins, recording = _route_margins()
    prompt = np.asarray([[1, 40, 7, 99, 150, 3, 17, 42, 8]], np.int32)
    with recording:
        want, jcache = jax_run(prompt, 0)
        got = transformer.forward(params, spec, torch.from_numpy(prompt), 0,
                                  cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        pos = prompt.shape[1]
        for tok in (5, 77, 200, 12):
            want, jcache = jax_run([[tok]], pos)
            got = transformer.forward(params, spec, torch.tensor([[tok]]),
                                      pos, cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **LOGIT_TOL)
            pos += 1
    assert len(margins) == 5 * spec.n_layers
    assert min(margins) >= MIN_ROUTE_MARGIN
    np.testing.assert_allclose(cache.k[1].numpy(), np.asarray(jcache.k[1]),
                               **LOGIT_TOL)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 1234)])
def test_moe_engines_give_identical_tokens(moe_model, temperature, seed):
    spec, jparams, np_params, _ = moe_model
    prompt = [1, 72, 101, 108, 108, 111, 44, 32, 119]
    jeng = JaxEngine(spec, jparams, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32, pallas_interpret=True,
                     prefill_chunk=4)
    eng = Engine(spec, params_from_jax(np_params, spec, "cpu"), device="cpu",
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 prefill_chunk=4)
    want = jeng.generate(prompt, 12, JaxSampler(
        spec.vocab_size, temperature, 0.9, seed, backend="python")).tokens
    got = eng.generate(prompt, 12, Sampler(
        spec.vocab_size, temperature, 0.9, seed)).tokens
    assert len(got) == 12 and got == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_streamed_loader_on_a_moe_file(tmp_path, arch):
    """The streamed loader, which copies each expert into its slot of a
    device stack as it streams past, gives what params_from_jax makes of
    the JAX loader's params, fused. The experts are made wide enough that
    one layer's stack outweighs every other tensor: the host high-water
    mark stays below one stack, so no host stack was built."""
    mpath, _ = write_fixture(tmp_path, seed=5, arch=ArchType[arch],
                             hidden_dim=1024, n_experts=4, n_active_experts=2)
    spec, tensors = read_model(mpath)
    jparams = jax_load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    want = fuse_layer_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), spec, "cpu"))
    got, stats = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32)
    assert got.keys() == want.keys()
    for lg, lw in zip(got["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for k in lw:
            if hasattr(lw[k], "packed"):
                assert torch.equal(lg[k].packed, lw[k].packed), k
                assert torch.equal(lg[k].scales, lw[k].scales), k
            else:
                assert lg[k].dtype == lw[k].dtype and torch.equal(lg[k], lw[k])
    stack = got["layers"][0]["moe_up"]
    stack_bytes = stack.packed.numel() + 2 * stack.scales.numel()
    assert 0 < stats.peak_host_bytes < stack_bytes


@pytest.mark.parametrize("arch", list(ARCHS))
def test_synthetic_q40_params_moe_layout(arch):
    spec = tiny_spec(arch=ArchType[arch], n_experts=4, n_active_experts=2)
    p = synthetic_q40_params(spec, seed=0, device="cpu")
    lw = p["layers"][0]
    hd, d = spec.hidden_dim, spec.dim
    assert lw["moe_up"].shape == lw["moe_gate"].shape == (4, hd, d)
    assert lw["moe_down"].shape == (4, d, hd)
    assert tuple(lw["moe_router"].shape) == (4, d)
    assert lw["moe_router"].dtype == torch.bfloat16
    assert ("rms_moe" in lw) == ("rms_ffn2" in lw) == (arch == "GROK1")
    assert "w13" not in lw and "wqkv" in lw
