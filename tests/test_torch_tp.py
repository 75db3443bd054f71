"""Tensor parallelism of the port (parallel/, Engine(mesh=), dllama --tp)
held against the JAX package on the CPU.

The port's ranks are gloo processes (parallel/launch.RankPool, one pool of
2 and one of 4 ranks a module, each job bounded by the pool's timeout);
the JAX oracle is its Engine on make_mesh(tp=...) over conftest's 8
virtual CPU devices, its Q40 matmuls on the plain XLA path, as the JAX
tests run them. The same numpy-seeded weights go to both
(tests/torch_mesh_cases.py).

  * the collectives: q80_psum_2shot, q80_psum and q80_all_gather on the
    same per-rank partials, at 2 and 4 ranks and on the d % (32 n) != 0
    fallback, against the JAX ones;
  * the column shard of a Q40 weight dequantizes to the JAX
    repack_col_tp shard, and every leaf of the _SPLIT table gets its
    shard (the loader's shard equal to shard_params');
  * greedy tokens at tp = 2, f32 with the exact reduce, LLAMA, MIXTRAL and
    GROK1, dense and Q40: equal to the port on one device and to the JAX tp = 2
    engine, logits within F32_TOL; with Q80 collectives equal to the JAX
    q80 engine's, logits within Q80_TOL; tp = 4 on a wider spec, and tp
    above n_kv_heads (the kv heads replicated);
  * the shard path forced on a 1-rank mesh (JAX force_mesh_kernels);
  * `dllama generate --tp 2` prints the JAX CLI's text; the entry points
    of serving over ranks (ROADMAP item 18: sessions, the prefix arena,
    the slot steps, speculation) run on a tp = 2 mirrored engine and give
    one device's results; the CLI refuses, in the JAX CLI's words, what
    the JAX CLI refuses over ranks, the sp, ep and pp axes included.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.parallel import make_mesh as jax_make_mesh
from distributed_llama_tpu.parallel import q80_all_gather, q80_psum, q80_psum_2shot
from distributed_llama_tpu.parallel.compat import shard_map
from distributed_llama_tpu.parallel.sharding import _SPLIT as JAX_SPLIT
from distributed_llama_tpu.parallel.tp_q80 import repack_col_tp
from distributed_llama_tpu.quants.jax_codec import QuantizedTensor as JaxQT
from distributed_llama_tpu.quants.jax_codec import dequantize_q40_jax
from distributed_llama_tpu.quants.numpy_codec import quantize_q40
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.io.model_file import read_spec
from distributed_llama_tpu_torch.models.loader import load_params_streamed
from distributed_llama_tpu_torch.parallel import sharding
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.parallel.wrappers import TpColWeight, TpRowWeight
from distributed_llama_tpu_torch.quants.torch_codec import (QuantizedTensor,
                                                            dequantize_q40_torch)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import (ENGINE, F32, JOBS, Case, jax_greedy,
                              jax_step_and_generate, step_and_generate)

# f32 logits (these weights give |logits| up to ~0.07), tp ranks against
# one device and against the JAX tp engine: the split changes only the
# order of the f32 sums (the column split's partial sums added by the
# reduce, the JAX psum's order on its side); observed up to 2e-8
F32_TOL = dict(atol=1e-6, rtol=1e-5)
# with Q80 collectives each column split's partial sums are quantized
# twice on both sides; a partial that differs in its last f32 bit between
# the packages may flip a rounding boundary: one int8 step of its block,
# absmax / 127 of partials up to ~0.05, i.e. 4e-4, carried on to the
# logits. Observed: no flip, up to 2e-8
Q80_TOL = dict(atol=4e-4, rtol=1e-3)
PROMPT = [1, 5, 9, 33, 7, 101]
N_TOKENS = 8


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


def _jax_collective(op: str, xs: np.ndarray) -> np.ndarray:
    n = xs.shape[0]
    mesh = jax_make_mesh(tp=n)
    fn = {"q80_psum_2shot": lambda v: q80_psum_2shot(v, "tp", n),
          "q80_psum": lambda v: q80_psum(v, "tp"),
          "q80_all_gather": lambda v: q80_all_gather(v, "tp")}[op]
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P("tp"),
                  out_specs=P("tp"), check_vma=False)
    return np.asarray(jax.jit(f)(xs))


@pytest.mark.parametrize("d", [512, 96], ids=["blocks", "fallback"])
@pytest.mark.parametrize("op", ["q80_psum_2shot", "q80_psum", "q80_all_gather"])
@pytest.mark.parametrize("n", [2, 4])
def test_q80_collectives_match_jax(n, op, d, pool2, pool4):
    """Each rank's result equals the JAX collective's on that device, bit
    for bit: the same codec, the same quantize order, and sums of n f32
    terms in rank order (d = 96 is not a multiple of 32 n: the two-shot
    falls back to q80_psum, as in JAX)."""
    rng = np.random.default_rng(n * 1000 + d)
    xs = rng.standard_normal((n, 3, d)).astype(np.float32)
    xs *= np.geomspace(0.01, 10, d, dtype=np.float32)
    pool = pool2 if n == 2 else pool4
    got = pool.run(f"{JOBS}:collective", n, op, list(xs))
    want = _jax_collective(op, xs)
    for r in range(n):
        np.testing.assert_array_equal(got[r], want[r])


def test_exact_all_reduce_is_the_sum(pool4):
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((4, 5, 64)).astype(np.float32)
    got = pool4.run(f"{JOBS}:collective", 4, "all_reduce", list(xs))
    for r in range(4):
        np.testing.assert_allclose(got[r], xs.sum(0), atol=1e-6)
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("tp", [2, 4])
def test_column_shard_dequantizes_to_the_jax_repack(tp):
    """Rank k's column shard of a Q40 weight (per-row byte and scale
    slices of the block-major layout) holds the values of the JAX
    repack_col_tp shard k (a lane-order relayout)."""
    rng = np.random.default_rng(tp)
    w = rng.standard_normal((2, 24, 1024)).astype(np.float32)   # an expert stack
    scales, packed = quantize_q40(w.reshape(-1, 1024))
    scales = scales.reshape(2, 24, -1)
    packed = packed.reshape(2, 24, -1, 16)
    port = QuantizedTensor.from_host(scales, packed, "cpu")
    jw = repack_col_tp(JaxQT.from_numpy(scales, packed), tp).w
    for k in range(tp):
        got = dequantize_q40_torch(sharding.col_shard(port, tp, k)).numpy()
        want = np.asarray(dequantize_q40_jax(JaxQT(jw.packed[k], jw.scales[k]),
                                             dtype=np.float32))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, w_deq_cols(port, tp, k))


def w_deq_cols(w, tp, k):
    full = dequantize_q40_torch(w).numpy()
    n = full.shape[-1] // tp
    return full[..., k * n:(k + 1) * n]


@pytest.mark.parametrize("mode", ["q40", "dense"])
@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_every_split_leaf_gets_its_shard(arch, mode, tmp_path):
    """The port's _SPLIT is the JAX table; shard_params cuts every split
    leaf (row: output rows / tp, col: input columns / tp, marked), keeps
    the rest whole, fuses the rank's row shards; the streamed loader's
    shard of the same file is equal, leaf for leaf, Q40 weights kept
    packed or dequantized (dense)."""
    assert sharding._SPLIT == JAX_SPLIT
    moe = dict(n_experts=4, n_active_experts=2) if arch == "MIXTRAL" else {}
    from distributed_llama_tpu.models import ArchType as JArch
    mpath, _ = write_fixture(tmp_path, seed=3, arch=JArch[arch], **moe)
    spec = read_spec(mpath)
    full, _ = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32,
                                   mode=mode)
    unfused = {"wq": spec.dim, "wk": spec.kv_dim, "wv": spec.kv_dim}
    for k in range(2):
        mine = sharding.shard_params(full, spec, 2, k, vocab=True)
        loaded, stats = load_params_streamed(spec, mpath, "cpu", tp=2, rank=k,
                                             dtype=torch.float32, mode=mode,
                                             shard_vocab=True)
        assert stats.device_bytes < sum(
            t.numel() * t.element_size() for t in _tensors(full))
        assert mine["tok_emb"].shape == (spec.vocab_size // 2, spec.dim)
        assert isinstance(mine["wcls"], TpRowWeight)
        lw = mine["layers"][0]
        assert lw["wqkv"].shape == (sum(unfused.values()) // 2, spec.dim)
        assert isinstance(lw["wo"], TpColWeight)
        assert lw["wo"].shape == (spec.dim, spec.dim // 2)
        if arch == "MIXTRAL":
            e, hd = spec.n_experts, spec.hidden_dim
            assert lw["moe_up"].shape == (e, hd // 2, spec.dim)
            assert lw["moe_gate"].shape == (e, hd // 2, spec.dim)
            assert isinstance(lw["moe_down"], TpColWeight)
            assert lw["moe_down"].shape == (e, spec.dim, hd // 2)
            assert lw["moe_router"] is full["layers"][0]["moe_router"]
        else:
            assert lw["w13"].shape == (spec.hidden_dim, spec.dim)
            assert lw["w2"].shape == (spec.dim, spec.hidden_dim // 2)
        for a, b in zip(_tensors(mine), _tensors(loaded)):
            assert torch.equal(a, b)


def _tensors(p):
    def leaf(v):
        v = getattr(v, "w", v)
        return [v.packed, v.scales] if isinstance(v, QuantizedTensor) else [v]
    out = []
    for name in ("tok_emb", "rms_final", "wcls"):
        out += leaf(p[name])
    for lw in p["layers"]:
        for name in sorted(lw):
            out += leaf(lw[name])
    return out


def _one_device(case, prompt=PROMPT, n=N_TOKENS, **kw):
    eng = Engine(case.pspec, case.params(), device="cpu", **F32, **kw)
    logits = eng.fetch_logits(eng.step(np.asarray([prompt], np.int32), 0))
    eng.reset()
    greedy = Sampler(case.pspec.vocab_size, 0.0, 0.9, 1)
    return logits, eng.generate(prompt, n, greedy).tokens


def _ranks(pool, case, tp, prompt=PROMPT, n=N_TOKENS, **kw):
    greedy = Sampler(case.pspec.vocab_size, 0.0, 0.9, 1)
    res = pool.run(ENGINE, tp, 1, case.blob, dict(F32, **kw),
                   step_and_generate(prompt, n, greedy))
    for r in res[1:]:       # every rank saw the same logits and tokens
        np.testing.assert_array_equal(r["results"][0], res[0]["results"][0])
        assert r["results"][2].tokens == res[0]["results"][2].tokens
    return res[0]


@pytest.mark.parametrize("mode", ["dense", "q40"])
@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL", "GROK1"])
def test_tp2_greedy_matches_one_device_and_jax(arch, mode, pool2):
    case = Case(arch, mode, seed=11)
    want_logits, want = jax_step_and_generate(case.jax_engine(tp=2),
                                              PROMPT, N_TOKENS,
                                              jax_greedy(case.spec.vocab_size))
    one_logits, one = _one_device(case)
    got = _ranks(pool2, case, 2)
    assert got["tp_reduce"] == "exact" and got["shard_vocab"]
    assert got["results"][2].tokens == want == one
    np.testing.assert_allclose(got["results"][0], want_logits, **F32_TOL)
    np.testing.assert_allclose(got["results"][0], one_logits, **F32_TOL)


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_tp2_q80_collectives_match_the_jax_q80_engine(arch, pool2):
    case = Case(arch, "q40", seed=12)
    want_logits, want = jax_step_and_generate(
        case.jax_engine(tp=2, activation_q80=True), PROMPT, N_TOKENS,
        jax_greedy(case.spec.vocab_size))
    got = _ranks(pool2, case, 2, activation_q80=True)
    assert got["tp_reduce"] == "q80"
    assert got["results"][2].tokens == want
    np.testing.assert_allclose(got["results"][0], want_logits, **Q80_TOL)


@pytest.mark.parametrize("kvh", [4, 2], ids=["kv4", "kv2-replicated"])
@pytest.mark.parametrize("q80", [False, True], ids=["exact", "q80"])
def test_tp4_on_a_wider_spec(kvh, q80, pool4):
    """tp = 4 needs dim % (32 tp) == 0 for Q40 columns; n_kv_heads = 2
    below tp replicates each kv head to two ranks (JAX kv_replication)."""
    case = Case("LLAMA", "q40", seed=13, dim=128, hidden_dim=256, n_heads=8,
                n_kv_heads=kvh)
    want_logits, want = jax_step_and_generate(
        case.jax_engine(tp=4, activation_q80=q80), PROMPT, N_TOKENS,
        jax_greedy(case.spec.vocab_size))
    got = _ranks(pool4, case, 4, activation_q80=q80)
    assert got["results"][2].tokens == want
    np.testing.assert_allclose(got["results"][0], want_logits,
                               **(Q80_TOL if q80 else F32_TOL))
    if not q80:
        one_logits, one = _one_device(case)
        assert one == want
        np.testing.assert_allclose(got["results"][0], one_logits, **F32_TOL)


def test_forced_shard_path_on_one_rank_equals_the_plain_engine():
    """force_mesh_kernels on a 1-rank mesh (JAX test_parallel.py:397): the
    marked weights and the reduce over a group of one, tokens and logits
    equal to the plain engine's bit for bit."""
    case = Case("LLAMA", "q40", seed=14)
    want_logits, want = _one_device(case)
    with RankPool(1, device_type="cpu", timeout_s=60) as pool:
        got = _ranks(pool, case, 1, force_mesh_kernels=True)
    assert got["results"][2].tokens == want
    np.testing.assert_array_equal(got["results"][0], want_logits)
    assert got["stats"]["collectives"] > 0


def test_default_mesh_on_gloo_ranks_is_not_the_cpu(pool2):
    """make_mesh with no device_type runs on the GPU whatever the backend
    (gloo joins ranks that share a card): without a card it raises, as
    resolve_device does, and never lands on the CPU unasked."""
    got = pool2.run(f"{JOBS}:default_mesh_device", 2)
    for dev in got:
        assert not dev.startswith("cpu"), dev
        if not torch.cuda.is_available():
            assert "no CUDA device is available" in dev, dev


def test_mesh_engine_refuses_the_entry_points_of_item_18(pool2, tmp_path):
    """The entry points a mesh engine refused until serving over ranks was
    ported (ROADMAP item 18) run on a tp = 2 engine now, every rank
    running them (the SPMD form: no control channel), and give the one
    device engine's results: a session saved and loaded back, a prefix
    arena of each rank's kv heads, the slot prefill and decode steps'
    logits and prompt lookup's greedy tokens."""
    case = Case("LLAMA", "q40", seed=15)
    path = str(tmp_path / "s.npz")
    seg = np.asarray([PROMPT[:4]], np.int64)
    calls = [("step", (np.asarray([PROMPT], np.int32), 0), {}),
             ("save_session", (path,), {}),
             ("load_session", (path,), {}),
             ("new_prefix_arena", (4, 8), {}),
             ("slot_prefill_chunk", (seg, np.zeros(1), np.asarray([3])), {}),
             ("slot_decode_step", (np.asarray([[7]]), np.asarray([4])), {}),
             ("reset", (), {}),
             ("generate_lookup", (PROMPT, 6), {})]
    got = pool2.run(ENGINE, 2, 1, case.blob, dict(F32, shard_vocab=False),
                    calls)[0]["results"]
    one = Engine(case.pspec, case.params(), device="cpu", **F32)
    want = [one.step(np.asarray([PROMPT], np.int32), 0).numpy()]
    one.save_session(str(tmp_path / "one.npz"))
    want.append(one.load_session(str(tmp_path / "one.npz")))
    want.append(tuple(a.shape for a in one.new_prefix_arena(4, 8)))
    want.append(one.slot_prefill_chunk(seg, np.zeros(1), np.asarray([3])).numpy())
    want.append(one.slot_decode_step(np.asarray([[7]]), np.asarray([4])).numpy())
    one.reset()
    want.append(one.generate_lookup(PROMPT, 6).tokens)
    np.testing.assert_allclose(got[0], want[0], **F32_TOL)
    assert got[2] == want[1] == []
    kvh, hs = case.pspec.n_kv_heads, case.pspec.head_size
    assert [a.shape for a in got[3]] == [(4, 2, kvh // 2, 8, hs)] * 2
    assert want[2] == ((4, 2, kvh, 8, hs),) * 2
    np.testing.assert_allclose(got[4], want[3], **F32_TOL)
    np.testing.assert_allclose(got[5], want[4], **F32_TOL)
    assert got[7].tokens == want[5]


def test_cli_generate_tp2_prints_the_jax_cli_text(tmp_path, capsys, monkeypatch):
    """`dllama generate --tp 2 --device cpu`: one command, rank 0 prints;
    at the CLI's defaults (Q80 activations and collectives) the text of
    the JAX CLI's --tp 2 on its 8-device mesh."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = write_fixture(tmp_path, seed=44)
    common = ["generate", "--model", mpath, "--tokenizer", tpath,
              "--prompt", "hello world", "--steps", "12", "--seed", "9",
              "--temperature", "0", "--compute-dtype", "f32",
              "--cache-dtype", "f32", "--tp", "2"]
    jax_dllama.main(common)
    want = capsys.readouterr().out.splitlines()
    dllama.main(common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert any("gloo" in line for line in got)

    def text(lines):
        return lines[next(k for k, line in enumerate(lines)
                          if line.startswith("💡")):]

    assert text(got) == text(want)


@pytest.mark.parametrize("argv,needle", [
    # the JAX engine's chat on a dp engine stops at its batch-1 assert
    (["chat", "--dp", "2"], "assert self.batch == 1, runtime/engine.py:838"),
    (["api", "--serve-batch", "2", "--dp", "2"],
     "--serve-batch needs a single-process engine (no --dp/--sp/--ep/--pp; "
     "--tp composes)"),
    (["generate", "--dp", "2", "--lookup-decode", "3"],
     "--lookup-decode with --dp is greedy-only (Engine.generate_batch_lookup); "
     "set --temperature 0"),
    (["generate", "--dp", "2", "--draft", "self:1"],
     "--draft is single-sequence outside api mode and per-slot inside it; it "
     "does not compose with --dp"),
    (["api", "--tp", "2", "--draft", "model:x.m"],
     "--draft model:PATH needs a mesh-less engine (use --draft self:<depth>, "
     "which shares the target's sharded buffers)"),
    (["api", "--serve-batch", "2", "--sp", "2"],
     "--serve-batch needs a single-process engine (no --dp/--sp/--ep/--pp; "
     "--tp composes)"),
    (["generate", "--ep", "2", "--draft", "model:x.m"],
     "--draft model:PATH needs a mesh-less engine (use --draft self:<depth>, "
     "which shares the target's sharded buffers)"),
    (["generate", "--pp", "2", "--draft", "self:1"],
     "--draft does not compose with --pp (stage-stacked layers cannot be "
     "depth-sliced)"),
], ids=["chat", "api", "lookup", "draft", "draft-model", "sp", "ep", "pp"])
def test_cli_refuses_what_does_not_run_over_ranks(argv, needle):
    """What the JAX CLI refuses over ranks, refused in its words (JAX
    apps/dllama.py:800-806, :1318-1324, apps/api_server.py:1684-1686,
    :1978-1986), the sp, ep and pp axes included. Each before any model
    load or rank spawn."""
    with pytest.raises(SystemExit) as e:
        dllama.main(argv + ["--model", "x.m", "--tokenizer", "x.t"])
    assert needle in str(e.value)


def test_cli_shard_vocab_on_needs_tp_in_the_jax_words():
    for cli in (dllama, jax_dllama):
        with pytest.raises(SystemExit) as e:
            cli.main(["generate", "--model", "x.m", "--tokenizer", "x.t",
                      "--shard-vocab", "on"])
        assert "--shard-vocab on needs a tensor-parallel mesh" in str(e.value)
