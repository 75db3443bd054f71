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


# -- the fleet's estimates and the trace readers --------------------------------

SERVE_CASES = [(axes, b, occ) for axes in (None, dict(tp=2), dict(tp=4, dp=2))
               for b, occ in ((4, None), (4, 1.5), (8, 0.0), (2, 9.0))]


@pytest.mark.parametrize("axes,batch,occ", SERVE_CASES)
@pytest.mark.parametrize("q80", [False, True])
def test_serve_wire_is_the_jax_model(axes, batch, occ, q80):
    spec, jspec = ModelSpec(arch=ArchType.LLAMA, **DENSE), JSpec(arch=JArch.LLAMA, **DENSE)
    mesh = None if axes is None else _mesh(axes)
    kw = dict(batch=batch, occupancy=occ, q80=q80, act_bytes=2)
    assert netstats.estimate_serve_wire(spec, mesh, **kw) == \
        jax_netstats.estimate_serve_wire(jspec, mesh, **kw)


@pytest.mark.parametrize("axes", [None, dict(tp=2), dict(sp=2, tp=2)])
@pytest.mark.parametrize("saved,copied,cache_bytes", [(256, None, 2.0), (96, 2048, 1.0),
                                                     (0, 0, 4.0)])
def test_prefix_reuse_is_the_jax_model(axes, saved, copied, cache_bytes):
    spec, jspec = ModelSpec(arch=ArchType.LLAMA, **DENSE), JSpec(arch=JArch.LLAMA, **DENSE)
    mesh = None if axes is None else _mesh(axes)
    kw = dict(tokens_saved=saved, tokens_copied=copied, cache_bytes=cache_bytes, q80=True)
    assert netstats.estimate_prefix_reuse(spec, mesh, **kw) == \
        jax_netstats.estimate_prefix_reuse(jspec, mesh, **kw)


@pytest.mark.parametrize("tokens,block_len,link,tps", [
    (300, 32, None, None), (288, 32, 100.0, 2000.0), (31, 32, 10.0, 50.0),
    (1024, 16, 400.0, 50000.0), (0, 8, 1.0, 1.0)])
@pytest.mark.parametrize("axes", [None, dict(tp=2)])
def test_block_transfer_is_the_jax_model(tokens, block_len, link, tps, axes):
    spec, jspec = ModelSpec(arch=ArchType.LLAMA, **DENSE), JSpec(arch=JArch.LLAMA, **DENSE)
    mesh = None if axes is None else _mesh(axes)
    kw = dict(tokens=tokens, block_len=block_len, cache_bytes=2, link_gbps=link,
              prefill_tok_per_s=tps, mesh=mesh, q80=True)
    got = netstats.estimate_block_transfer(spec, **kw)
    assert got == jax_netstats.estimate_block_transfer(jspec, **kw)


def _chrome_trace(path, events):
    import json
    import os

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_readers_over_a_profiler_trace(tmp_path):
    """per_step_op_ms, per_trace_attribution and per_module_ms over a
    torch.profiler Chrome trace: steps are the replayed graphs (each
    cudaGraphLaunch and the device kernels carrying its correlation id),
    modules the kernels' names; a trace with no device events (a CPU run)
    reads as the JAX readers' no-device answers."""
    ev = []
    for i, corr in enumerate((11, 12)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": 100.0 * i, "dur": 5.0, "args": {"correlation": corr}})
        ev += [{"ph": "X", "cat": "kernel", "name": "void q40_gemv1_kernel<true, 8>(float*)",
                "ts": 100.0 * i + 10, "dur": 40.0, "args": {"correlation": corr}},
               {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                "ts": 100.0 * i + 60, "dur": 10.0 * (i + 1), "args": {"correlation": corr}}]
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 300.0,
               "dur": 2.0, "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 50.0})
    _chrome_trace(tmp_path / "gpu", ev)
    assert netstats.per_step_op_ms(str(tmp_path / "gpu")) == [0.01, 0.02]
    assert netstats.per_step_op_ms(str(tmp_path / "gpu"), markers=("gemv1",)) == [0.04, 0.04]
    assert netstats.per_step_op_ms(str(tmp_path / "gpu"), module_hint="nope") == []
    mods, sync = netstats.per_trace_attribution(str(tmp_path / "gpu"))
    assert mods == {"q40_gemv1_kernel": 0.08,
                    "ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.03,
                    "Memcpy DtoH": 0.002} and sync == 0.03
    assert netstats.per_module_ms(str(tmp_path / "gpu")) == mods
    _chrome_trace(tmp_path / "cpu", [e for e in ev if e["cat"] == "cpu_op"])
    assert netstats.per_step_op_ms(str(tmp_path / "cpu")) == []
    assert netstats.per_trace_attribution(str(tmp_path / "cpu")) == ({}, 0.0)
    assert netstats.per_module_ms(str(tmp_path / "empty")) == {}
