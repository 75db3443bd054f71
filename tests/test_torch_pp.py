"""Pipeline stages of the port (parallel/pp.py, Engine over a pp mesh,
dllama --pp) held against the JAX package's mesh engine on the CPU.

The port's ranks are gloo processes (parallel/launch.RankPool: one pool
of 2 and one of 4 ranks, each job bounded by the pool's timeout); the
JAX oracle is its Engine on make_mesh(pp=...) over conftest's 8 virtual
CPU devices, its matmuls on the plain XLA path (use_pallas=False, as on
the CPU by default), the port's on the kernels' plain versions. The same
numpy-seeded weights go to both (tests/torch_mesh_cases.py).

  * gpipe_microbatches, the port's copy, against the JAX function;
  * prefill (a 128-token chunk on GPipe with M = 4, then a 12-token tail
    on the stage relay) and greedy decode at pp = 2, tp = 1 and 2, LLAMA
    Q40 and MIXTRAL (K2 in a stage at tp = 1): f32 logits within F32_TOL
    and the JAX tokens; GPipe off gives the same; bf16 within BF16_TOL;
  * pp x ep and pp x sp at 4 ranks, and dp = 2 x pp = 2 (generate_batch
    over the dp rows);
  * placement: a rank holds L/pp layers and their cache, from the engine
    and from the streamed loader on a fixture file; the vocab split
    widened over (pp, tp);
  * the JAX refusals in its words: sessions and the prefix cache under
    pp, n_layers % pp, Q80 collectives with pp.
"""

import pytest
import torch

from distributed_llama_tpu.parallel.pp import \
    gpipe_microbatches as jax_gpipe_microbatches
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.parallel.pp import gpipe_microbatches
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import (BF16, BF16_TOL, F32, GRID_FILE, JAX_BF16, Case,
                              axes_check, grid_run, jax_greedy)

# 140 tokens in 128-token chunks: GPipe (M = 4) on the first, the relay
# on the 12-token tail
PROMPT = [(7 * i + 3) % 250 + 1 for i in range(140)]
CHUNK = 128
N_TOKENS = 8


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


def _case(arch="LLAMA", seed=21, **kw):
    return Case(arch, "q40", seed=seed, seq_len=256, **kw)


def _check(pool, grid, case, **kw):
    return axes_check(pool, grid, case, PROMPT, N_TOKENS, prefill_chunk=CHUNK,
                      **kw)


@pytest.mark.parametrize("t", [1, 7, 32, 63, 64, 96, 128, 140, 256, 300])
@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_gpipe_microbatches_is_the_jax_rule(t, pp):
    assert gpipe_microbatches(t, pp) == jax_gpipe_microbatches(t, pp)


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
def test_pp2_gpipe_and_relay_match_the_jax_pp_engine(arch, pool2):
    case = _case(arch)
    res = _check(pool2, dict(pp=2), case)
    n = case.spec.n_layers
    for r in res:
        pl = r["placement"]
        assert pl["layers"] == n // 2
        assert pl["cache"] == (n // 2, 1, case.spec.n_kv_heads, 256)
        # the stage hop and the broadcast: 4 microbatches, a tail, decode
        assert r["stats"]["collectives"] > 0
    assert sorted(r["coords"]["pp"] for r in res) == [0, 1]


def test_pp2_all_stages_without_gpipe_gives_the_same(pool2):
    case = _case(seed=22)
    _check(pool2, dict(pp=2), case, pp_gpipe=False)


def test_pp2_bf16_within_the_logits_tolerance(pool2):
    _check(pool2, dict(pp=2), _case(seed=23), tol=BF16_TOL, port_kw=BF16,
           jax_kw=JAX_BF16)


def test_pp2_tp2_splits_the_vocab_over_both(pool4):
    case = _case(seed=24)
    res = _check(pool4, dict(pp=2, tp=2), case)
    for r in res:
        assert r["vocab_axis"] == "pp,tp"
        assert r["placement"]["layers"] == 1
        assert r["placement"]["cache"] == (1, 1, case.spec.n_kv_heads // 2,
                                           256)


def test_pp2_ep2_places_layers_and_experts(pool4):
    case = _case("MIXTRAL", seed=25)
    res = _check(pool4, dict(pp=2, ep=2), case)
    for r in res:
        assert (r["placement"]["layers"], r["placement"]["experts"]) == (1, 2)


def test_pp2_sp2_shards_the_stage_cache(pool4):
    case = _case(seed=26)
    res = _check(pool4, dict(pp=2, sp=2), case)
    for r in res:
        assert r["placement"]["cache"] == (1, 1, case.spec.n_kv_heads, 128)


def test_dp2_pp2_generates_the_batch_rows(pool4):
    case = _case(seed=27)
    prompts = [PROMPT[:70], PROMPT[5:60]]
    jeng = case.jax_engine(dp=2, pp=2, batch=2, prefill_chunk=CHUNK)
    want = jeng.generate_batch(prompts, N_TOKENS,
                               jax_greedy(case.spec.vocab_size))
    res = grid_run(pool4, dict(dp=2, pp=2), case,
                   [("generate_batch", (prompts, N_TOKENS, Sampler(
                       case.spec.vocab_size, 0.0, 0.9, 1)), {})],
                   batch=2, prefill_chunk=CHUNK, **F32)
    assert res[0]["results"][0] == want
    for r in res:
        assert r["placement"]["cache"][:2] == (1, 1)   # a stage, a row


def test_streamed_loader_keeps_a_stage(pool2, tmp_path):
    """Each rank streams the fixture file and keeps its stage's layers:
    its bytes are the whole file's less the other stage's layers, its
    engine's tokens one device's."""
    mpath, _ = write_fixture(tmp_path, seed=28, n_layers=4)
    res = pool2.run(GRID_FILE, dict(pp=2), mpath, F32,
                    [("generate", (PROMPT[:20], N_TOKENS, Sampler(
                        288, 0.0, 0.9, 1)), {})])
    from distributed_llama_tpu_torch.io.model_file import read_spec
    from distributed_llama_tpu_torch.models.loader import (
        load_params_streamed, param_bytes)
    spec = read_spec(mpath)
    whole, _ = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32)
    from distributed_llama_tpu_torch.runtime.engine import Engine
    one = Engine(spec, whole, device="cpu", **F32)
    want = one.generate(PROMPT[:20], N_TOKENS, Sampler(288, 0.0, 0.9, 1))
    layer_bytes = param_bytes(dict(whole, layers=whole["layers"][:1])) - \
        param_bytes(dict(whole, layers=[]))
    for r in res:
        assert r["placement"]["layers"] == 2
        assert r["loaded_bytes"] == param_bytes(whole) - 2 * layer_bytes
        assert r["results"][0].tokens == want.tokens


def test_pp_refusals_in_the_jax_words(pool2, tmp_path):
    case = _case(seed=29)
    calls = [("save_session", (str(tmp_path / "s.npz"),), {}),
             ("load_session", (str(tmp_path / "s.npz"),), {}),
             ("new_prefix_arena", (4, 8), {})]
    got = grid_run(pool2, dict(pp=2), case, calls, **F32)[0]["results"]
    assert got == ["ValueError: session save/restore does not support --pp"] * 2 \
        + ["ValueError: prefix cache does not support --pp"]


def test_pp_that_does_not_divide_the_layers_is_refused():
    from distributed_llama_tpu_torch.parallel.sharding import \
        check_axis_constraints
    spec = _case().pspec
    with pytest.raises(ValueError, match=r"pp=3 must divide n_layers=2"):
        check_axis_constraints(spec, pp=3)
    with pytest.raises(ValueError, match="not supported with --pp"):
        check_axis_constraints(spec, pp=2, q80_collectives=True)
    with pytest.raises(AssertionError, match=r"pp=3 must divide n_layers=2"):
        _case().jax_engine(pp=3)
    with pytest.raises(AssertionError, match="pp uses exact tp reduces"):
        _case().jax_engine(pp=2, tp=2, activation_q80=True)
