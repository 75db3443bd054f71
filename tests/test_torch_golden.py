"""The port's LLAMA and GROK1 blocks against the reference's own golden
vectors: the 4096 floats of one Llama-2-7B-shaped block at the reference's
1e-5 (ref: llama2-tasks-test.cpp:12-525, tests/data/llama2_golden_block.npy)
and the three ranges of one Grok-shaped MoE block at its 3.5e-5 (ref:
grok1-tasks-test.cpp:13-15,86-88).

The inputs are those of tests/test_reference_golden.py (the JAX package's
xorshift port draws the weights); the block under test is the port's
models/transformer._layer on the CPU, f32, dense weights.
"""

import os

import numpy as np
import pytest
import torch

from distributed_llama_tpu import native

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not native.available(),
        reason="native library not built (make -C native)"),
]


DATA = os.path.join(os.path.dirname(__file__), "data")


def _draw(state: int, n: int, div: float) -> tuple[int, np.ndarray]:
    state, raw = native.rng_fill_f32(state, n)
    return state, (raw.astype(np.float64) / div).astype(np.float32)


def _run_block(spec, tensors: dict, x: np.ndarray) -> np.ndarray:
    """One port _layer forward at pos 0, f32, dense weights: the residual
    stream (dim,) the reference's task loop leaves in x."""
    from distributed_llama_tpu_torch.io.model_file import HostTensor
    from distributed_llama_tpu_torch.models.params import load_params
    from distributed_llama_tpu_torch.models.transformer import (KVCache, _layer,
                                                                cache_write)
    from distributed_llama_tpu_torch.ops.rope import rope_angles
    from distributed_llama_tpu_torch.quants.types import FloatType

    def host(name, arr):
        return HostTensor(name, FloatType.F32, arr.shape, data=arr)

    tensors = {**tensors,
               "tok_emb": host("tok_emb", np.zeros((spec.vocab_size, spec.dim), np.float32)),
               "rms_final": host("rms_final", np.ones(spec.dim, np.float32)),
               "wcls": host("wcls", np.zeros((spec.vocab_size, spec.dim), np.float32))}
    params = load_params(spec, tensors, mode="dense", dtype=torch.float32,
                         device="cpu")
    cache = KVCache.create(spec, 1, device="cpu")
    q_pos = torch.zeros((1, 1), dtype=torch.int32)
    out = _layer(torch.from_numpy(x)[None, None, :], params["layers"][0],
                 spec, cache.k[0], cache.v[0], q_pos,
                 rope_angles(q_pos, spec.head_size, spec.rope_theta),
                 cache_write(q_pos, spec.n_kv_heads, spec.seq_len, False),
                 torch.float32)
    return out.reshape(-1).numpy()


def test_llama2_golden_block_through_the_port():
    """The reference's 4096 expected floats at its own 1e-5 (ref:
    llama2-tasks-test.cpp:588-607; tests/test_reference_golden.py:84 holds
    the JAX block to the same data): rms_att and rms_ffn drawn first, then
    q, k, v, wo, w1, w2, w3, then x, each float32(float64(raw) / 120)."""
    from distributed_llama_tpu_torch.io.model_file import HostTensor
    from distributed_llama_tpu_torch.models.spec import (ArchType, HiddenAct,
                                                         ModelSpec)
    from distributed_llama_tpu_torch.quants.types import FloatType

    dim, hidden = 4096, 11008
    spec = ModelSpec(arch=ArchType.LLAMA, dim=dim, hidden_dim=hidden,
                     n_layers=1, n_heads=32, n_kv_heads=32, vocab_size=8,
                     seq_len=16, hidden_act=HiddenAct.SILU, rope_theta=10000.0)

    def host(name, arr):
        return HostTensor(name, FloatType.F32, arr.shape, data=arr)

    st = 800000010
    st, rms_att = _draw(st, dim, 120.0)
    st, rms_ffn = _draw(st, dim, 120.0)
    tensors = {}
    for name, shape in (("wq", (dim, dim)), ("wk", (dim, dim)),
                        ("wv", (dim, dim)), ("wo", (dim, dim)),
                        ("w1", (hidden, dim)), ("w2", (dim, hidden)),
                        ("w3", (hidden, dim))):
        st, w = _draw(st, shape[0] * shape[1], 120.0)
        tensors[f"layers.0.{name}"] = host(name, w.reshape(shape))
    tensors["layers.0.rms_att"] = host("rms_att", rms_att)
    tensors["layers.0.rms_ffn"] = host("rms_ffn", rms_ffn)
    st, x = _draw(st, dim, 120.0)
    got = _run_block(spec, tensors, x)
    want = np.load(os.path.join(DATA, "llama2_golden_block.npy"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_grok1_golden_block_through_the_port():
    from distributed_llama_tpu_torch.io.model_file import HostTensor
    from distributed_llama_tpu_torch.models.spec import (ArchType, HiddenAct,
                                                         ModelSpec)
    from distributed_llama_tpu_torch.quants.types import FloatType

    dim, hidden, n_exp = 6144, 1024, 8
    spec = ModelSpec(arch=ArchType.GROK1, dim=dim, hidden_dim=hidden,
                     n_layers=1, n_heads=48, n_kv_heads=8, vocab_size=8,
                     seq_len=16, n_experts=n_exp, n_active_experts=2,
                     hidden_act=HiddenAct.GELU, rope_theta=10000.0)

    def host(name, arr):
        return HostTensor(name, FloatType.F32, arr.shape, data=arr)

    st = 123456789
    tensors = {}
    for name, shape in (("wq", (dim, dim)), ("wk", (spec.kv_dim, dim)),
                        ("wv", (spec.kv_dim, dim)), ("wo", (dim, dim))):
        st, w = _draw(st, shape[0] * shape[1], 100.0)
        tensors[f"layers.0.{name}"] = host(name, w.reshape(shape))
    st, router = _draw(st, n_exp * dim, 100.0)
    tensors["layers.0.moe_router"] = host("moe_router",
                                          router.reshape(n_exp, dim))
    for e in range(n_exp):
        for name, shape in (("up", (hidden, dim)), ("gate", (hidden, dim)),
                            ("down", (dim, hidden))):
            st, w = _draw(st, shape[0] * shape[1], 100.0)
            tensors[f"layers.0.experts.{e}.{name}"] = host(
                name, w.reshape(shape))
    for name in ("rms_att", "rms_ffn", "rms_moe", "rms_ffn2"):
        st, w = _draw(st, dim, 100.0)
        tensors[f"layers.0.{name}"] = host(name, w)
    scale = np.float32(78.38367176906169)
    st, raw = native.rng_fill_f32(st, dim)
    x_stored = ((raw.astype(np.float64) / 100.0)
                / np.float64(scale)).astype(np.float32)
    x = (x_stored * scale).astype(np.float32)

    got = _run_block(spec, tensors, x)
    for lo, want in ((0, [0.00940248929, 0.0191232786, 0.0147766126,
                          0.0102868658]),
                     (256, [0.0191071425, 0.0134582901, 0.0146755828,
                            0.019181719]),
                     (5012, [0.0126675405, 0.0169415697, 0.0183475353,
                             0.0182626117])):
        np.testing.assert_allclose(got[lo:lo + 4],
                                   np.asarray(want, np.float32),
                                   atol=3.5e-5, rtol=0)
