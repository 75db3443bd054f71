"""The decode-wire model of the port (runtime/netstats.py) against the JAX
package's: the S column of `inference` and every kB of its breakdown, for
every axis the mesh has, and the drift check."""

import types

import pytest

from distributed_llama_tpu.models.spec import ArchType as JArch
from distributed_llama_tpu.models.spec import ModelSpec as JSpec
from distributed_llama_tpu.runtime import netstats as jax_netstats
from distributed_llama_tpu_torch.models.spec import ArchType, ModelSpec
from distributed_llama_tpu_torch.runtime import netstats

DENSE = dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
             n_kv_heads=32, vocab_size=32000, seq_len=2048)
MOE = dict(dim=4096, hidden_dim=14336, n_layers=32, n_heads=32, n_kv_heads=8,
           vocab_size=32000, seq_len=4096, n_experts=8, n_active_experts=2)
MESHES = [dict(tp=2), dict(tp=4), dict(tp=2, dp=2), dict(sp=2),
          dict(sp=2, tp=2), dict(pp=2), dict(pp=2, tp=2), dict(ep=2),
          dict(ep=2, tp=2), dict(dp=2)]


def _mesh(axes):
    return types.SimpleNamespace(shape={a: axes.get(a, 1)
                                        for a in ("dp", "sp", "ep", "pp", "tp")})


# ep places experts: MoE models only
CASES = [(axes, moe) for axes in MESHES for moe in (False, True)
         if moe or axes.get("ep", 1) == 1]


@pytest.mark.parametrize("axes,moe", CASES, ids=[
    "-".join(f"{k}{v}" for k, v in a.items()) + ("-moe" if m else "-dense")
    for a, m in CASES])
@pytest.mark.parametrize("q80,shard_vocab,batch",
                         [(False, False, 1), (True, True, 1), (True, False, 4)])
def test_decode_wire_is_the_jax_model(axes, moe, q80, shard_vocab, batch):
    dims = MOE if moe else DENSE
    arch = "MIXTRAL" if moe else "LLAMA"
    spec = ModelSpec(arch=ArchType[arch], **dims)
    jspec = JSpec(arch=JArch[arch], **dims)
    kw = dict(q80=q80, act_bytes=2, batch=batch, shard_vocab=shard_vocab,
              vocab_topk=32)
    got = netstats.estimate_decode_wire(spec, _mesh(axes), **kw)
    want = jax_netstats.estimate_decode_wire(jspec, _mesh(axes), **kw)
    assert got == want
    assert got.sent_kb_per_token > 0 or axes == dict(dp=2)


def test_one_device_sends_nothing():
    spec = ModelSpec(arch=ArchType.LLAMA, **DENSE)
    assert netstats.estimate_decode_wire(spec, None) == (0.0, {})


@pytest.mark.parametrize("measured,modeled", [(400.0, 400.0), (300.0, 400.0),
                                              (390.0, 400.0), (100.0, 0.0),
                                              (0.0, 0.0)])
def test_reconcile_wire_is_the_jax_check(measured, modeled):
    assert netstats.reconcile_wire(measured, modeled) == \
        jax_netstats.reconcile_wire(measured, modeled)
