"""The port's chip-time tools on the CPU (--device cpu, the kernels' plain
versions, small shapes): tools/microbench.py, profile_decode.py,
profile_prefill.py, exp_prefill_chunk.py and exp_decode_profile.py each run
and print the JAX tool's keys; the prefill ladder's logits after the prompt
agree across chunk sizes (the dequantize path above MAX_T included) and
with the JAX engine's prefill at chunk 256 on the same file; each tool
raises without a card unless asked for the CPU. On the card the same
tools run from chip_smoke.py's phase 17.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.model_file import read_model as jax_read_model
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu_torch.io.model_file import read_model
from distributed_llama_tpu_torch.models import bench_specs
from distributed_llama_tpu_torch.models.params import load_params
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.tools import (exp_decode_profile, exp_prefill_chunk,
                                               microbench, profile_decode,
                                               profile_prefill, rehearse_70b)

ROOT = Path(__file__).resolve().parent.parent
TOOLS = {"microbench": microbench, "profile_decode": profile_decode,
         "profile_prefill": profile_prefill, "exp_prefill_chunk": exp_prefill_chunk,
         "exp_decode_profile": exp_decode_profile}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes on one intra-op thread: with other test processes on the
    host, torch's thread pool waits far longer than the work takes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_microbench_prints_the_jax_tools_rows(monkeypatch, capsys):
    for k, v in dict(L=2, D=64, H=96, SEQ=32, KVH=2, HS=16).items():
        monkeypatch.setattr(microbench, k, v)
    rows = microbench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == ["gemv", "gemv_q40", "gemv_pallas", "attn", "cache"]
    for label in ("gemv dense bf16", "gemv q40 dequantize", "gemv q40 K1",
                  "attention (seq=32) K3", "cache update"):
        assert f"[microbench] {label}:" in out
    assert rows[0]["bytes"] == 2 * 96 * 64 * 2
    assert rows[2]["bytes"] == 2 * (96 * 32 + 96 * 2 * 2)
    assert all(r["bound_ms"] > 0 and r["ms"] is None for r in rows)
    assert len(microbench.main(["attn", "--device", "cpu"])) == 1


JAX_DECODE_KEYS = {"mode", "layers", "tokens", "ms_per_token", "weight_gb", "cache_gb",
                   "eff_bw_gbps"}


@pytest.mark.parametrize("mode", ["q40_kernel", "q40_xla", "dense_bf16", "q40_pallas"])
def test_profile_decode_modes(mode, monkeypatch, capsys):
    calls = {"n": 0}
    real = cuda_q40.q40_matmul

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(cuda_q40, "q40_matmul", counted)
    for k, v in dict(PROF_MODE=mode, PROF_MODEL="TINY", PROF_LAYERS="2",
                     PROF_TOKENS="4", PROF_SEQ="64").items():
        monkeypatch.setenv(k, v)
    out = profile_decode.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_DECODE_KEYS <= set(line) and line == out
    assert line["mode"] == profile_decode.ALIASES.get(mode, mode)
    assert line["layers"] == 2 and line["tokens"] == 4 and line["device"] == "cpu"
    # the kernel route reaches K1's wrapper; the dequantize route and the
    # dense weights never do
    assert (calls["n"] > 0) == (line["mode"] == "q40_kernel")
    if line["mode"] == "dense_bf16":
        assert line["weight_gb"] > 0


def test_profile_decode_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="PROF_MODE"):
        profile_decode.run("q40_tpu", device="cpu")


def test_profile_prefill_splits_a_chunk(monkeypatch, capsys):
    for k, v in dict(T=32, FILL=64, PROMPT=128).items():
        monkeypatch.setattr(profile_prefill, k, v)
    spec = dataclasses.replace(bench_specs.TINY, n_layers=2)
    out = profile_prefill.run(spec=spec, device="cpu")
    text = capsys.readouterr().out
    assert "[profile_prefill] whole-model:" in text and "everything else" in text
    assert list(out["parts"]) == ["qkv+o", "ffn", "attn (T=32, fill=64)"]
    assert out["tokens"] == 128 and out["per_chunk_ms"] == out["whole_ms"] / 4
    assert all(p["bound_ms_per_layer"] > 0 for p in out["parts"].values())


@pytest.fixture(scope="module")
def ladder_file(tmp_path_factory):
    """A Q40 file at TINY's widths with a 1024-token context: chunks above
    MAX_T take the dequantize path on a 1024-token prompt."""
    spec = dataclasses.replace(rehearse_70b.spec70(2), dim=128, hidden_dim=256, n_heads=4,
                               n_kv_heads=4, vocab_size=256, seq_len=1024)
    path = str(tmp_path_factory.mktemp("ladder") / "m.m")
    rehearse_70b.write_file(path, spec, seed=3)
    return path


def test_prefill_ladder_agrees_across_chunks_and_with_the_jax_engine(ladder_file, capsys):
    spec, tensors = read_model(ladder_file)
    params = load_params(spec, tensors, mode="q40", dtype=torch.float32, device="cpu")
    chunks = (128, 256, 512, 1024)
    out = exp_prefill_chunk.run(spec=spec, params=params, device="cpu",
                                prompt_len=1024, chunks=chunks)
    assert "[exp_prefill_chunk] chunk=  512" in capsys.readouterr().out
    assert [r["chunk"] for r in out["rows"]] == list(chunks)
    assert [r["kernel_path"] for r in out["rows"]] == [True, True, False, False]
    assert cuda_q40.MAX_T == 256
    # f32 on the CPU: the chunkings agree to rounding
    assert out["logits_max_rel_diff"] < 1e-5
    assert len({r["argmax"] for r in out["rows"]}) == 1
    jspec, jt = jax_read_model(ladder_file)
    jeng = JaxEngine(jspec, jax_load_params(jspec, jt, mode="q40", dtype=jnp.float32),
                     compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                     activation_q80=True, prefill_chunk=256, max_seq_len=1024)
    tokens = np.random.default_rng(0).integers(1, spec.vocab_size, 1024).tolist()
    want = jeng.fetch_logits(jeng.prefill(tokens))[0]
    got = out["logits"][256]
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0)


def test_exp_decode_profile_on_the_cpu(capsys):
    spec = dataclasses.replace(bench_specs.TINY, n_layers=2)
    out = exp_decode_profile.run(spec=spec, device="cpu", n_steps=4, fill=16)
    text = capsys.readouterr().out
    assert "[exp_decode_profile] decode:" in text and "split not measured" in text
    assert out["ms_per_token"] > 0 and out["device_busy_ms"] is None
    assert out["steps"] == 4 and out["fill"] == 16


@pytest.mark.parametrize("name,want", [
    ("void q40_gemv1_kernel<__nv_bfloat16, __nv_bfloat16, true, 8>(...)", "K1"),
    ("q40_matmul_wgmma_kernel", "K1"), ("flash_mma_kernel<__nv_bfloat16>", "K3"),
    ("flash_merge_kernel", "K3"), ("void q80_roundtrip_kernel<float, float>", "Q80"),
    ("Memcpy DtoH (Device -> Pinned)", "memcpy"), ("Memset (Device)", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "torch:elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "torch:reduce"),
    ("void at::native::indexFuncLargeIndex<...>", "torch:index/copy"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "torch:gemm"),
    ("void at::native::CatArrayBatchedCopy<...>", "torch:cat"),
    ("something_else", "torch:other")])
def test_decode_profile_groups_cuda_kernel_names(name, want):
    assert exp_decode_profile.group(name) == want


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_each_tool_needs_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PROF_MODE", "q40_kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[tool].main([])


def test_bench_specs_are_the_jax_benchs_field_for_field():
    import bench

    for name, spec in bench_specs.BENCH_SPECS.items():
        want = getattr(bench, name)
        assert set(dataclasses.asdict(spec)) == set(dataclasses.asdict(want))
        for field in dataclasses.fields(want):
            got, exp = getattr(spec, field.name), getattr(want, field.name)
            assert (got.value if hasattr(got, "value") else got) == \
                (exp.value if hasattr(exp, "value") else exp), (name, field.name)


def test_chip_smoke_tools_entries_carry_every_contract_key():
    """chip_smoke.py's phase 17 kernel rows: every key of the kernels line,
    launches summed over the tools' run and each mesh's rank 0."""
    import chip_smoke

    row = dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, library_ms=None, bound_ms=0.5,
               bound_by="bytes")
    t17 = {"kernels": {"k1": row, "k3": row, "q80": row},
           "counts": {"K1": 10, "K3": 4, "Q80": 3}}
    r17 = {"configs": [{"rank0": {"counts": {"K1": 1, "K3": 2, "Q80": 0}}},
                       {"rank0": {"counts": {"K1": 5, "K3": 1, "Q80": 1}}}]}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    entries = chip_smoke.tools_entries(t17, r17)
    assert [e["launches"] for e in entries] == [16, 7, 4]
    for e in entries:
        assert keys <= set(e) and e["route"] == "cuda"
        assert (ROOT / e["source"]).is_file()
