"""Shared inputs of the port's mesh tests (tests/test_torch_tp.py,
test_torch_vocab_shard.py, test_torch_dp.py, and the other axes' files
test_torch_pp.py, test_torch_ep.py, test_torch_sp.py):
the same weights for the JAX package and the port, made by numpy from a
seed, and the JAX engine that the port's ranks are held against.

The port's ranks are spawned processes (parallel/launch.RankPool) that
import only the port: what they get is a pack() of the port's spec and
params, never an object of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_llama_tpu.models import ArchType as JArch
from distributed_llama_tpu.models import HiddenAct as JAct
from distributed_llama_tpu.models import ModelSpec as JSpec
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.models.params import random_tensors
from distributed_llama_tpu.parallel import make_mesh
from distributed_llama_tpu.runtime import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models import ModelSpec
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.models.params import unfuse_layer_weights
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct
from distributed_llama_tpu_torch.parallel.launch import pack
from distributed_llama_tpu_torch.quants.types import FloatType
from distributed_llama_tpu_torch.sampler import Sampler

ENGINE = "distributed_llama_tpu_torch.parallel.jobs:engine_calls"
JOBS = "distributed_llama_tpu_torch.parallel.jobs"
GRID = f"{JOBS}:grid_calls"
GRID_FILE = f"{JOBS}:grid_file_calls"


def jax_spec(arch: str = "LLAMA", **kw) -> JSpec:
    """A small spec (the tiny fixtures' widths unless overridden)."""
    base = dict(arch=JArch[arch], dim=64, hidden_dim=128, n_layers=2,
                n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=64,
                hidden_act=JAct.SILU, rope_theta=10000.0)
    if arch != "LLAMA":
        base.update(n_experts=4, n_active_experts=2)
    base.update(kw)
    return JSpec(**base)


def port_spec(spec: JSpec) -> ModelSpec:
    """The same spec as the port's own class (picklable without jax)."""
    fields = {f: getattr(spec, f) for f in ModelSpec.__dataclass_fields__}
    fields.update(arch=ArchType(int(spec.arch)),
                  hidden_act=HiddenAct(int(spec.hidden_act)),
                  weights_float_type=FloatType(int(spec.weights_float_type)))
    return ModelSpec(**fields)


class Case:
    """One model's weights in both packages: `jparams()` a fresh JAX params
    tree (the JAX engine may fuse one in place), `blob` the port's spec and
    unfused params packed for the ranks, `params()` them in this process."""

    def __init__(self, arch="LLAMA", mode="q40", seed=5, wcls_scale=1.0,
                 **spec_kw):
        self.spec = jax_spec(arch, **spec_kw)
        self.mode = mode
        self._host = random_tensors(self.spec, seed=seed, scale=0.05)
        if wcls_scale != 1.0:       # peaked logits: a sampled nucleus of few
            self._host["wcls"].data = self._host["wcls"].data * wcls_scale
        self.pspec = port_spec(self.spec)
        tree = jax.tree_util.tree_map(np.asarray, self.jparams())
        self._port = unfuse_layer_weights(
            params_from_jax(tree, self.pspec, "cpu"), self.pspec)
        self.blob = pack((self.pspec, self._port))

    def jparams(self):
        return jax_load_params(self.spec, self._host, mode=self.mode,
                               dtype=jnp.float32)

    def params(self) -> dict:
        return dict(self._port, layers=[dict(lw) for lw in self._port["layers"]])

    def jax_engine(self, tp=1, dp=1, sp=1, ep=1, pp=1, **kw):
        mesh = (make_mesh(tp=tp, dp=dp, sp=sp, ep=ep, pp=pp)
                if tp * dp * sp * ep * pp > 1 else None)
        kw = dict(dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32),
                  **kw)
        return JaxEngine(self.spec, self.jparams(), mesh, **kw)


def jax_greedy(vocab):
    return JaxSampler(vocab, 0.0, 0.9, 1, backend="python")


def jax_step_and_generate(eng, prompt, n, sampler):
    """The JAX engine's prompt logits, then a fresh generate's tokens."""
    logits = np.asarray(eng.step(np.asarray([prompt], np.int32), 0))
    eng.reset()
    return logits, eng.generate(prompt, n, sampler).tokens


def step_and_generate(prompt, n, sampler):
    """The calls an engine job makes for jax_step_and_generate's pair."""
    return [("step", (np.asarray([prompt], np.int32), 0), {}),
            ("reset", (), {}),
            ("generate", (prompt, n, sampler), {})]


def jax_prefill_and_generate(eng, prompt, n, sampler):
    """The JAX engine's prefill logits (the ring segment over sp, GPipe
    over pp for a long chunk), then a fresh generate's tokens."""
    logits = np.asarray(eng.prefill(prompt), np.float32)
    eng.reset()
    return logits, eng.generate(prompt, n, sampler).tokens


def prefill_and_generate(prompt, n, sampler):
    """The calls an engine job makes for jax_prefill_and_generate's pair."""
    return [("prefill", (prompt,), {}), ("reset", (), {}),
            ("generate", (prompt, n, sampler), {})]


def grid_run(pool, grid: dict, case, calls, job=None, source=None, **kw):
    """`calls` on an engine over `grid` in `pool` (every rank of the grid);
    every rank's report, after checking that the ranks saw the same
    results (each the whole model's: logits, tokens). `job` and `source`
    default to grid_calls on the case's params."""
    res = pool.run(job or GRID, grid, case.blob if source is None else source,
                   kw, calls)
    for r in res[1:]:
        for a, b in zip(r["results"], res[0]["results"]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            elif hasattr(a, "tokens"):
                assert a.tokens == b.tokens
            else:
                assert a == b
    return res


# the other axes' f32 logits against the JAX mesh engine (|logits| up to
# ~0.07): stages, experts and the ring change the order of some f32 sums
# only; observed up to 2e-8
AXES_F32_TOL = dict(atol=1e-6, rtol=1e-5)
# bf16 compute and cache on both sides: the packages round at the same
# places but may sum a product's terms in another order, an activation's
# bf16 ulp (2^-8 relative) carried to the logits; observed up to 2.5e-4
# (Mixtral ep = 2; pp = 2 1.3e-4, sp = 2 1.7e-4)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
BF16 = dict(compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
JAX_BF16 = dict(compute_dtype=jnp.bfloat16, cache_dtype=jnp.bfloat16)


def axes_check(pool, grid: dict, case, prompt, n, *, tol=AXES_F32_TOL,
               port_kw=F32, jax_kw=None, **engine_kw):
    """Prefill logits and greedy tokens of the port's engine over `grid`
    against the JAX mesh engine's on the same grid (engine_kw to both,
    port_kw / jax_kw to each side); the ranks' reports. In bf16 (BF16_TOL)
    the logits alone: a bf16 ulp may flip a near-tie's argmax."""
    want_logits, want = jax_prefill_and_generate(
        case.jax_engine(**grid, **(jax_kw or {}), **engine_kw), prompt, n,
        jax_greedy(case.spec.vocab_size))
    res = grid_run(pool, grid, case, prefill_and_generate(
        prompt, n, Sampler(case.spec.vocab_size, 0.0, 0.9, 1)),
        **port_kw, **engine_kw)
    got = res[0]["results"]
    np.testing.assert_allclose(got[0], want_logits, **tol)
    if tol is not BF16_TOL:
        assert got[2].tokens == want
    return res
