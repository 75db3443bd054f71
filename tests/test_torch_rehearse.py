"""The port's 70B rehearsal (tools/rehearse_70b.py) at narrow 70B-shaped
widths on the CPU: 4 gloo ranks over tp = 4 (2 kv heads, so each is held
by two ranks) and tp = 2 x pp = 2, from one file the tool writes. The two
meshes' tokens are identical and equal the JAX engine's on one CPU device
for the same file; each rank's peak host bytes stay within twice the
largest tensor; the artifact has the JAX tool's keys.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llama_tpu.io.model_file import read_model as jax_read_model
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu_torch.tools import rehearse_70b

# the JAX tool's artifact keys (tools/rehearse_70b.py:195-223, 268-274)
JAX_CONFIG_KEYS = {
    "config", "mesh_devices", "file_gb", "load_seconds", "peak_host_mb_during_load",
    "per_device_param_mb", "per_device_layer_mb", "per_device_vocab_mb",
    "per_device_replicated_mb", "shard_vocab",
    "per_device_param_gb_extrapolated_80_layers", "budget_met_80_layers",
    "collectives_decode_step", "greedy_tokens"}
JAX_ARTIFACT_KEYS = {"model_widths", "n_layers_on_disk", "full_depth",
                     "cross_mesh_greedy_match", "configs"}
GRIDS = ({"tp": 4}, {"tp": 2, "pp": 2})
SPEC = dataclasses.replace(rehearse_70b.spec70(4), dim=128, hidden_dim=256, n_heads=8,
                           n_kv_heads=2, vocab_size=256, seq_len=64)


def _jax_tokens(path, prompt, n):
    spec, tensors = jax_read_model(path)
    eng = JaxEngine(spec, jax_load_params(spec, tensors, mode="q40", dtype=jnp.float32),
                    compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                    activation_q80=True, max_seq_len=64)
    lg = eng.fetch_logits(eng.prefill(list(prompt)))[0]
    toks = [int(np.argmax(lg))]
    for _ in range(n - 1):
        lg = eng.fetch_logits(eng.step(np.asarray([[toks[-1]]], np.int32), eng.pos))[0]
        toks.append(int(np.argmax(lg)))
    return toks


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    d = tmp_path_factory.mktemp("r70")
    path = str(d / "narrow70.m")
    out = str(d / "MULTICHIP_70B.json")
    art = rehearse_70b.rehearse(device="cpu", spec=SPEC, grids=GRIDS, n_tokens=4,
                                model_path=path, out_path=out, timeout_s=120,
                                prompt=[1, 5, 9, 2, 7])
    return art, path, out


def test_meshes_agree_with_each_other_and_with_the_jax_engine(rehearsal):
    art, path, _ = rehearsal
    a, b = art["configs"]
    assert (a["config"], b["config"]) == ("tp=4", "tp=2,pp=2")
    assert a["greedy_tokens"] == b["greedy_tokens"] and len(a["greedy_tokens"]) == 4
    assert a["greedy_tokens"] == _jax_tokens(path, [1, 5, 9, 2, 7], 4)
    assert art["cross_mesh_greedy_match"] is True
    # f32 on the CPU: the two partitionings' logits agree to rounding
    assert a["logits_max_rel_diff"] == 0.0 and b["logits_max_rel_diff"] < 1e-5
    assert art["cross_mesh_logits_max_rel_diff"] == b["logits_max_rel_diff"]


def test_shards_kv_replication_and_host_bytes(rehearsal):
    art, path, _ = rehearsal
    a, b = art["configs"]
    biggest = SPEC.vocab_size * SPEC.dim * 4 + (1 << 20)
    for cfg in (a, b):
        for r in cfg["ranks"]:
            assert 0 < r["peak_host_bytes"] <= 2 * biggest
            assert r["backend"] == "gloo" and r["shard_vocab"]
            # the plain versions run on the CPU: no kernel launch is counted
            assert r["counts"] == {"K1": 0, "K2": 0, "Q80F": 0, "K3": 0, "Q80": 0}
    # tp = 4: every rank holds all 4 layers at a quarter of each projection
    # but a whole kv head of 2 (the replication); tp = 2 x pp = 2: 2 layers
    # a rank at half of each: the same projection bytes, but for the kv
    # heads and the two norms of the 2 more layers tp = 4 holds
    assert {r["layers_held"] for r in a["ranks"]} == {4}
    assert {r["layers_held"] for r in b["ranks"]} == {2}
    kv = 2 * SPEC.head_size * SPEC.dim // 32 * 18      # wk + wv, one kv head
    norms = 2 * SPEC.dim * 4
    assert {r["layer_bytes"] for r in a["ranks"]} == \
        {r["layer_bytes"] + 2 * (kv + norms) for r in b["ranks"]}
    assert a["collectives_decode_step"] > 0
    assert b["collectives_decode_step"] > 0


def test_artifact_has_the_jax_tools_keys(rehearsal):
    art, _, out = rehearsal
    with open(out) as f:
        written = json.load(f)
    assert JAX_ARTIFACT_KEYS <= set(written)
    for cfg in written["configs"]:
        assert JAX_CONFIG_KEYS <= set(cfg)
        assert cfg["budget_met_80_layers"] is None    # no card on the CPU
    assert written["n_layers_on_disk"] == 4 and written["full_depth"] == 80


def test_write_file_gives_valid_q40_blocks(tmp_path):
    from distributed_llama_tpu_torch.io.model_file import read_model

    spec = dataclasses.replace(SPEC, n_layers=2)
    path = str(tmp_path / "m.m")
    size = rehearse_70b.write_file(path, spec)
    got, tensors = read_model(path)
    assert got == spec and size > 0
    w = tensors["layers.0.w1"]
    scales = w.scales.astype(np.float32)
    assert w.packed.shape == (spec.hidden_dim, spec.dim // 32, 16)
    assert 0.005 <= float(scales.min()) and float(scales.max()) <= 0.02
    assert abs(float(tensors["layers.1.rms_att"].to_f32().mean()) - 1.0) < 0.05


def test_rehearsal_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rehearse_70b.rehearse(spec=SPEC, grids=GRIDS, out_path=None)


def test_rehearsal_refuses_a_pool_of_another_size():
    import types

    with pytest.raises(ValueError, match="the pool has 2 ranks, the grids need 4"):
        rehearse_70b.rehearse(device="cpu", spec=SPEC, grids=GRIDS, out_path=None,
                              pool=types.SimpleNamespace(world=2))
