"""Sequence parallelism of the port (parallel/ring_attention.py, Engine
over an sp mesh, dllama --sp) held against the JAX package on the CPU.

The port's ranks are gloo processes (parallel/launch.RankPool: one pool
of 2 and one of 4 ranks); the JAX oracle runs on make_mesh(sp=...) over
conftest's 8 virtual CPU devices. The same numpy-seeded inputs and
weights go to both (tests/torch_mesh_cases.py).

  * block_attn and merge, in this process, against the JAX _block_attn
    and _merge, rows with no visible key included;
  * the ring (ring_attention_local, each rank its chunk) against the JAX
    ring_attention at sp = 2 and 4: GQA, a position offset, and a first
    chunk whose later blocks are fully masked (tests/test_ring_attention.py
    cases); sp_cache_attention_local against the JAX sp_cache_attention;
  * the engine at sp = 2, tp = 1 and 2: the ring prefill of the prompt
    and greedy decode over the sequence-sharded cache, f32 logits within
    AXES_F32_TOL and the JAX tokens, bf16 within BF16_TOL; a rank's cache
    holds S/sp positions; the loader replicates every weight; a session
    saved over sp is the one-device file, and loads back;
  * the refusals: seq_len % sp in the JAX words; the prefix cache over an
    sp-sharded cache builds the JAX engine's arena.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.parallel import make_mesh as jax_make_mesh
from distributed_llama_tpu.parallel.ring_attention import _block_attn, _merge
from distributed_llama_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from distributed_llama_tpu.parallel.ring_attention import \
    sp_cache_attention as jax_sp_cache
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.parallel.ring_attention import (block_attn,
                                                                 merge)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import (AXES_F32_TOL, BF16, BF16_TOL, F32, GRID, GRID_FILE,
                              JAX_BF16, JOBS, Case, axes_check, grid_run)

# the attention functions in f32 on both sides: the same einsums and
# exponentials, summed in another order; observed up to 5e-7 on
# unit-normal inputs
ATT_TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT = [1, 5, 9, 33, 7, 101, 12, 64, 3, 200, 17, 99, 4, 8, 15]
N_TOKENS = 8


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


def _qkv(seed, b, t, h, kvh, hs):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hs)).astype(np.float32),
            rng.standard_normal((b, t, kvh, hs)).astype(np.float32),
            rng.standard_normal((b, t, kvh, hs)).astype(np.float32))


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("k0", [0, 6, 40], ids=["diag", "past", "future"])
def test_block_attn_and_merge_match_jax(k0, h, kvh):
    """One block's statistics (k0 = 40 puts every key after every query:
    rows with no visible key, m = -inf, l = 0) and the merge of two."""
    q, k, v = _qkv(k0 + h, 2, 8, h, kvh, 16)
    q_pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32), (2, 8))
    k_pos = np.broadcast_to(np.arange(k0, k0 + 8, dtype=np.int32), (2, 8))
    scale = 0.25
    got = block_attn(*(torch.from_numpy(a) for a in (q, k, v)),
                     torch.from_numpy(q_pos.copy()),
                     torch.from_numpy(k_pos.copy()), scale)
    want = _block_attn(q, k, v, jnp.asarray(q_pos), jnp.asarray(k_pos), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)
    other = block_attn(*(torch.from_numpy(a) for a in (v[..., :1, :].repeat(
        h, 2), k, q[:, :, :kvh])), torch.from_numpy(q_pos.copy()),
        torch.from_numpy(q_pos.copy()), scale)
    got_m = merge(*got, *other)
    want_m = _merge(*want, *(jnp.asarray(o.numpy()) for o in other))
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)


@pytest.mark.parametrize("case", [
    dict(b=2, t=32, h=4, kvh=4, hs=16, pos0=0),
    dict(b=2, t=32, h=8, kvh=2, hs=16, pos0=0),
    dict(b=1, t=16, h=4, kvh=4, hs=8, pos0=100),
    dict(b=1, t=8, h=2, kvh=2, hs=4, pos0=0),
], ids=["mha", "gqa", "offset", "masked-first-blocks"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_the_jax_ring(sp, case, pool2, pool4):
    q, k, v = _qkv(sp + case["t"], case["b"], case["t"], case["h"],
                   case["kvh"], case["hs"])
    mesh = jax_make_mesh(tp=1, sp=sp)
    want = np.asarray(jax.jit(lambda *a: jax_ring(*a, mesh, pos0=case["pos0"]))(
        q, k, v))
    got = (pool2 if sp == 2 else pool4).run(f"{JOBS}:ring", sp, q, k, v,
                                            case["pos0"])
    t = case["t"] // sp
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[:, i * t:(i + 1) * t], **ATT_TOL)
    if case["t"] == 8:      # token 0 sees only itself
        np.testing.assert_allclose(got[0][0, 0], v[0, 0], atol=1e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_cache_attention_matches_jax(sp, pool2, pool4):
    """Queries at positions 20-22 of row 0 and 50-52 of row 1 against a
    64-slot cache (slots past a query masked, as unwritten ones are)."""
    rng = np.random.default_rng(sp)
    b, t, h, kvh, hs, s = 2, 3, 8, 2, 16, 64
    q = rng.standard_normal((b, t, h, hs)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, s, hs)).astype(np.float32)
    q_pos = np.asarray([[20, 21, 22], [50, 51, 52]], np.int32)
    mesh = jax_make_mesh(tp=1, sp=sp)
    want = np.asarray(jax.jit(lambda *a: jax_sp_cache(*a, mesh))(
        q, kc, vc, q_pos))
    got = (pool2 if sp == 2 else pool4).run(f"{JOBS}:sp_cache", sp, q, kc,
                                            vc, q_pos)
    for g in got:
        np.testing.assert_allclose(g, want, **ATT_TOL)


def _check(pool, grid, case, **kw):
    return axes_check(pool, grid, case, PROMPT, N_TOKENS, **kw)


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_sp2_ring_prefill_and_sharded_decode_match_jax(arch, pool2):
    case = Case(arch, "q40", seed=41)
    res = _check(pool2, dict(sp=2), case)
    s = case.spec.seq_len
    for r in res:
        pl = r["placement"]
        assert pl["cache"] == (case.spec.n_layers, 1, case.spec.n_kv_heads,
                               s // 2)
        # the ring's two rotations a layer and decode's three all-reduces
        assert r["stats"]["collectives"] > 0


def test_sp2_tp2(pool4):
    case = Case("LLAMA", "q40", seed=42)
    res = _check(pool4, dict(sp=2, tp=2), case)
    for r in res:
        assert r["placement"]["cache"][2:] == (case.spec.n_kv_heads // 2,
                                               case.spec.seq_len // 2)


def test_sp2_bf16_within_the_logits_tolerance(pool2):
    _check(pool2, dict(sp=2), Case("LLAMA", "q40", seed=43), tol=BF16_TOL,
           port_kw=BF16, jax_kw=JAX_BF16)


def test_sp2_cache_holds_half_the_positions(pool2, tmp_path):
    """From the streamed loader: every weight on every rank (sp
    replicates them), half of one device's cache bytes."""
    mpath, _ = write_fixture(tmp_path, seed=44)
    from distributed_llama_tpu_torch.io.model_file import read_spec
    from distributed_llama_tpu_torch.models.loader import (
        load_params_streamed, param_bytes)
    spec = read_spec(mpath)
    whole, _ = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32)
    one = Engine(spec, whole, device="cpu", **F32)
    want = one.generate(PROMPT, N_TOKENS, Sampler(spec.vocab_size, 0.0, 0.9, 1))
    res = pool2.run(GRID_FILE, dict(sp=2), mpath, F32,
                    [("generate", (PROMPT, N_TOKENS, Sampler(
                        spec.vocab_size, 0.0, 0.9, 1)), {})])
    one_cache = sum(t.numel() * t.element_size()
                    for t in (*one.cache.k, *one.cache.v))
    for r in res:
        assert r["loaded_bytes"] == param_bytes(whole)
        assert r["placement"]["cache_bytes"] * 2 == one_cache
        assert r["results"][0].tokens == want.tokens


def test_sp2_session_is_the_one_device_file(pool2, tmp_path):
    """A session saved over sp gathers the shards' positions into the one
    device engine's file (the same entries; the cached K/V within
    AXES_F32_TOL, as the ring computes them in chunks); loaded back over
    sp, decode goes on as one device's does."""
    case = Case("LLAMA", "q40", seed=45)
    one = Engine(case.pspec, case.params(), device="cpu", **F32)
    greedy = Sampler(case.pspec.vocab_size, 0.0, 0.9, 1)
    one.generate(PROMPT, 4, greedy)
    one.save_session(str(tmp_path / "one.npz"))
    want = one.step(np.asarray([[7]], np.int32), one.pos).numpy()
    path = str(tmp_path / "sp.npz")
    got = grid_run(pool2, dict(sp=2), case, [
        ("generate", (PROMPT, 4, greedy), {}),
        ("save_session", (path,), {}),
        ("load_session", (str(tmp_path / "one.npz"),), {}),
        ("step", (np.asarray([[7]], np.int32), len(PROMPT) + 3), {})],
        **F32)[0]["results"]
    a, b = np.load(path), np.load(str(tmp_path / "one.npz"))
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        if f[0] in "kv" and f[1:].isdigit():
            np.testing.assert_allclose(a[f], b[f], **AXES_F32_TOL)
        else:
            np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_allclose(got[3], want, **AXES_F32_TOL)


def test_sp_refusals(pool2):
    spec = Case("LLAMA", "q40").pspec
    from distributed_llama_tpu_torch.parallel.sharding import \
        check_axis_constraints
    needle = "sp=3 must divide max_seq_len=64 (sp-sharded KV cache)"
    with pytest.raises(ValueError) as e:
        check_axis_constraints(spec, sp=3)
    assert str(e.value) == needle
    with pytest.raises(AssertionError) as e:
        Case("LLAMA", "q40").jax_engine(sp=3)
    assert needle in str(e.value)
    # the prefix arena over sp: the JAX engine's shape, every kv head
    case = Case("LLAMA", "q40", seed=46)
    got = pool2.run(GRID, dict(sp=2), case.blob, F32,
                    [("new_prefix_arena", (4, 8), {})])
    want = case.jax_engine(sp=2).new_prefix_arena(4, 8)
    for arena, jarena in zip(got[0]["results"][0] + got[1]["results"][0],
                             want + want):
        assert arena.shape == tuple(jarena.shape) == (
            4, case.spec.n_layers, case.spec.n_kv_heads, 8,
            case.spec.head_size)
        assert not arena.any()
