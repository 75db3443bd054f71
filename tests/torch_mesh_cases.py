"""Shared inputs of the port's tensor-parallel and data-axis tests
(tests/test_torch_tp.py, test_torch_vocab_shard.py, test_torch_dp.py):
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

ENGINE = "distributed_llama_tpu_torch.parallel.jobs:engine_calls"
JOBS = "distributed_llama_tpu_torch.parallel.jobs"


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

    def jax_engine(self, tp=1, dp=1, **kw):
        mesh = make_mesh(tp=tp, dp=dp) if tp * dp > 1 else None
        return JaxEngine(self.spec, self.jparams(), mesh,
                         compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                         **kw)


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


F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
