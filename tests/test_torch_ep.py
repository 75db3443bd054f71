"""Expert placement of the port (parallel/ep_moe.py, Engine over an ep
mesh, dllama --ep) held against the JAX package's mesh engine on the CPU.

The port's ranks are gloo processes (parallel/launch.RankPool: one pool
of 2 and one of 4 ranks); the JAX oracle is its Engine on
make_mesh(ep=...) over conftest's 8 virtual CPU devices. The same
numpy-seeded weights go to both (tests/torch_mesh_cases.py).

  * prefill and greedy decode at ep = 2, tp = 1 and 2, MIXTRAL and GROK1,
    Q40 and dense: f32 logits within AXES_F32_TOL and the JAX tokens;
    bf16 within BF16_TOL;
  * the JAX quirk, on one layer's MoE output: with Q80 activations the
    experts' products skip the round trip (the JAX body calls
    local_matmul without it) while the router keeps it; with Q80 collectives at tp = 2 the two-shot over tp then the exact
    sum over ep, within Q80_TOL;
  * placement: a rank holds E/ep experts of every MoE stack (EpRowWeight /
    EpColWeight), from the engine and from the streamed loader on a
    fixture file;
  * the JAX refusals in its words: --ep on a dense model, n_experts % ep.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import ArchType as JArch
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import (AXES_F32_TOL, BF16, BF16_TOL, F32, GRID_FILE,
                              JAX_BF16, JOBS, Case, axes_check)

# Q80 collectives: each tp partial sum is quantized twice on both sides;
# a partial differing in its last f32 bit may flip one int8 step of its
# block (absmax / 127 of partials up to ~0.05, 4e-4) into the logits, as
# in tests/test_torch_tp.py
Q80_TOL = dict(atol=4e-4, rtol=1e-3)
PROMPT = [1, 5, 9, 33, 7, 101, 12, 64, 3, 200, 17, 99]
N_TOKENS = 8


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


def _check(pool, grid, case, **kw):
    return axes_check(pool, grid, case, PROMPT, N_TOKENS, **kw)


@pytest.mark.parametrize("mode", ["q40", "dense"])
@pytest.mark.parametrize("arch", ["MIXTRAL", "GROK1"])
def test_ep2_matches_the_jax_ep_engine(arch, mode, pool2):
    case = Case(arch, mode, seed=31)
    res = _check(pool2, dict(ep=2), case)
    e = case.spec.n_experts
    for r in res:
        assert r["placement"]["experts"] == e // 2
        assert r["placement"]["layers"] == case.spec.n_layers
    assert sorted(r["coords"]["ep"] for r in res) == [0, 1]


def test_ep2_holds_half_the_expert_bytes(pool2):
    """A rank's parameter bytes: one device's less half of every expert
    stack's."""
    case = Case("MIXTRAL", "q40", seed=32)
    res = _check(pool2, dict(ep=2), case)
    from distributed_llama_tpu_torch.models.loader import param_bytes
    full = case.params()
    experts = sum(param_bytes(dict(full, layers=[
        {k: lw[k] for k in ("moe_up", "moe_gate", "moe_down")}]))
        - param_bytes(dict(full, layers=[])) for lw in full["layers"])
    for r in res:
        assert r["placement"]["param_bytes"] == param_bytes(full) - experts // 2


def test_ep2_bf16_within_the_logits_tolerance(pool2):
    _check(pool2, dict(ep=2), Case("MIXTRAL", "q40", seed=33), tol=BF16_TOL,
           port_kw=BF16, jax_kw=JAX_BF16)


@pytest.mark.parametrize("q80", [False, True], ids=["plain", "q80"])
def test_ep2_moe_layer_skips_the_q80_round_trip_as_in_jax(q80, pool2):
    """The MoE FFN of one layer at ep = 2 against the JAX one on the same
    activations: with Q80 activations the router's input takes the round
    trip and the local experts' inputs do not (JAX _ep_body calls
    local_matmul without activation_q80). One expert input through the
    round trip moves this output by ~1e-4, far past AXES_F32_TOL (the
    logits, where the MoE adds little to the residual, would not show
    it)."""
    import jax.numpy as jnp
    from distributed_llama_tpu.models.transformer import _moe_ffn as jax_moe

    case = Case("MIXTRAL", "q40", seed=34)
    x = np.random.default_rng(34).standard_normal(
        (1, 5, case.spec.dim)).astype(np.float32)
    jeng = case.jax_engine(ep=2, activation_q80=q80)
    cfg = {k: v for k, v in jeng._forward_kwargs().items() if k in (
        "activation_q80", "compute_dtype", "use_pallas", "tp_mesh",
        "tp_reduce", "pallas_interpret")}
    want = np.asarray(jax_moe(jnp.asarray(x), jeng.params["layers"][0],
                              jeng.spec, cfg))
    got = pool2.run(f"{JOBS}:moe_layer", dict(ep=2), case.blob,
                    dict(F32, activation_q80=q80), x)
    for g in got:
        np.testing.assert_allclose(g, want, **AXES_F32_TOL)


@pytest.mark.parametrize("q80", [False, True], ids=["exact", "q80"])
def test_ep2_tp2_reduces_over_both(q80, pool4):
    case = Case("MIXTRAL", "q40", seed=35)
    res = _check(pool4, dict(ep=2, tp=2), case,
                 tol=Q80_TOL if q80 else AXES_F32_TOL, activation_q80=q80)
    for r in res:
        assert r["tp_reduce"] == ("q80" if q80 else "exact")
        assert r["placement"]["experts"] == case.spec.n_experts // 2


def test_streamed_loader_keeps_its_experts(pool2, tmp_path):
    """Each rank streams the fixture file and keeps its E/ep experts of
    every stack; its engine's tokens are one device's."""
    mpath, _ = write_fixture(tmp_path, seed=36, arch=JArch.MIXTRAL,
                             n_experts=4, n_active_experts=2)
    from distributed_llama_tpu_torch.io.model_file import read_spec
    from distributed_llama_tpu_torch.models.loader import (
        load_params_streamed, param_bytes)
    from distributed_llama_tpu_torch.runtime.engine import Engine
    spec = read_spec(mpath)
    whole, _ = load_params_streamed(spec, mpath, "cpu", dtype=torch.float32)
    want = Engine(spec, whole, device="cpu", **F32).generate(
        PROMPT, N_TOKENS, Sampler(spec.vocab_size, 0.0, 0.9, 1))
    res = pool2.run(GRID_FILE, dict(ep=2), mpath, F32,
                    [("generate", (PROMPT, N_TOKENS, Sampler(
                        spec.vocab_size, 0.0, 0.9, 1)), {})])
    stack = sum(param_bytes(dict(whole, layers=[
        {k: lw[k] for k in ("moe_up", "moe_gate", "moe_down")}]))
        - param_bytes(dict(whole, layers=[])) for lw in whole["layers"])
    for r in res:
        assert r["placement"]["experts"] == 2
        assert r["loaded_bytes"] == param_bytes(whole) - stack // 2
        assert r["results"][0].tokens == want.tokens


@pytest.mark.parametrize("arch,ep,needle", [
    ("LLAMA", 2, "--ep requires a MoE model (experts to place)"),
    ("MIXTRAL", 3, "ep=3 must divide n_experts=4"),
])
def test_ep_refusals_in_the_jax_words(arch, ep, needle):
    from distributed_llama_tpu_torch.parallel.sharding import \
        check_axis_constraints
    case = Case(arch, "q40", seed=37)
    with pytest.raises(ValueError) as e:
        check_axis_constraints(case.pspec, ep=ep)
    assert str(e.value) == needle
    with pytest.raises(AssertionError, match=needle.replace("(", r"\(")
                       .replace(")", r"\)")):
        case.jax_engine(ep=ep)
