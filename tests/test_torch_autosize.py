"""The port's auto-sizing and its operator surface held against the JAX
package's, on the CPU: ``resolve_auto_shape``'s decision records for the
same ledger inputs (allocator numbers injected through ``device_stats=``)
in every basis, the ledgerless refusal, the autotune artifact's four
validators (the port's profiler and dlprof, the JAX package's two), the
CLI's parse-time refusals in the JAX words, the ``autosize`` and
``admission`` blocks of /stats and /metrics, POST /admin/reset_breaker on
a broken supervisor (JAX tests/test_apps.py:1209), and the repaired
``device_memory_stats`` (the allocator's reserved bytes plus the free
bytes cudaMemGetInfo reports) with CUDA's memory calls faked.
"""

import http.client
import json
import sys
import threading
import time
import types
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import profiler as jax_profiler
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import profiler
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.resilience import BROKEN, READY
from distributed_llama_tpu_torch.tools import dlprof

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import dlprof as jax_dlprof  # noqa: E402  (tools/ is no package)

SEQ = 64
F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def engines():
    """tests/test_autotune.py's tiny engine in both packages, batch 1."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jspec, jax_params.random_tensors(
        jspec, seed=3, scale=0.05), mode="dense", dtype=jnp.float32)
    return (Engine(spec, params, device="cpu", batch=1, compute_dtype=torch.float32,
                   cache_dtype=torch.float32),
            JaxEngine(jspec, jp, batch=1, compute_dtype=jnp.float32,
                      cache_dtype=jnp.float32))


def _artifact(knee_rows=4, curve=None):
    return {"kind": "dllama-autotune", "version": 1, "model": "tiny",
            "backend": "cpu", "created_unix": 0.0,
            "decode_curve": curve if curve is not None else [],
            "knee": {"knee_rows": knee_rows, "method": "marginal_throughput"}}


PER_SLOT = 2 * 2 * 2 * SEQ * 16 * 4      # 2 x layers x kv heads x S x hs x f32
PER_BLOCK16 = 2 * 2 * 2 * 16 * 16 * 4
ACCOUNTED = 460544                       # the tiny engine's ledgered bytes
CURVE = [{"rows": 4, "p50_ms": 10.0}, {"rows": 8, "p50_ms": 11.0},
         {"rows": 16, "p50_ms": 14.0}, {"rows": 32, "p50_ms": 25.0}]

# (resolve_auto_shape keywords, the basis each case must reach): JAX
# tests/test_autotune.py:112-209, every basis
CASES = {
    "hbm_cap": (dict(serve_batch="auto", autotune=_artifact(32),
                     device_stats={"bytes_in_use": 0, "bytes_limit": 5 * PER_SLOT}),
                ("hbm_cap", "static")),
    "hbm_cap_slo": (dict(serve_batch="auto", slo_itl_ms=80.0, autotune=_artifact(8, CURVE),
                         device_stats={"bytes_in_use": 0, "bytes_limit": 5 * PER_SLOT}),
                    ("hbm_cap", "static")),
    "autotune": (dict(serve_batch="auto", autotune=_artifact(4),
                      device_stats={"bytes_in_use": 0, "bytes_limit": 1 << 40}),
                 ("autotune", "static")),
    "default_heuristic": (dict(serve_batch="auto", autotune=None, device_stats=None),
                          ("default_heuristic", "static")),
    "slo_curve": (dict(serve_batch="auto", slo_itl_ms=80.0,
                       autotune=_artifact(8, CURVE), device_stats=None),
                  ("slo_curve", "static")),
    "static": (dict(serve_batch=6, slo_itl_ms=80.0, autotune=_artifact(8, CURVE),
                    device_stats=None), ("static", "static")),
    "blocks_hbm_cap": (dict(serve_batch=2, prefix_blocks="auto", prefix_block_len=16,
                            autotune=_artifact(),
                            device_stats={"bytes_in_use": 0, "bytes_limit": 8 * PER_BLOCK16}),
                       ("static", "hbm_cap")),
    "blocks_context": (dict(serve_batch=2, prefix_blocks="auto", prefix_block_len=16,
                            device_stats=None), ("static", "context_heuristic")),
    "budget_only": (dict(serve_batch="auto", prefix_blocks="auto",
                         device_stats={"bytes_limit": ACCOUNTED + 10 * PER_SLOT}),
                    ("hbm_cap", "hbm_cap")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolve_auto_shape_matches_jax(engines, case):
    kw, (batch_basis, blocks_basis) = CASES[case]
    mine = profiler.resolve_auto_shape(engines[0], **kw)
    theirs = jax_profiler.resolve_auto_shape(engines[1], **kw)
    assert mine == theirs
    assert (mine["serve_batch_basis"], mine["prefix_blocks_basis"]) == \
        (batch_basis, blocks_basis)


def test_resolve_auto_shape_numbers(engines):
    """JAX tests/test_autotune.py's numbers: 5 slots of headroom cap a
    knee of 32 at 5 (and the curve's 16 at 5), the curve raises a knee of
    8 to 16 under an 80 ms ITL SLO, the arena takes half the headroom."""
    eng = engines[0]
    res = {k: profiler.resolve_auto_shape(eng, **CASES[k][0]) for k in CASES}
    assert res["hbm_cap"]["serve_batch"] == 5
    assert res["hbm_cap"]["inputs"]["slots_addable"] == 5
    assert res["hbm_cap_slo"]["serve_batch"] == 5
    assert res["hbm_cap_slo"]["inputs"]["rows_under_itl_slo"] == 16
    assert all(r["inputs"]["replicas"] == 1 for r in res.values())
    assert res["autotune"]["serve_batch"] == 4
    assert res["default_heuristic"]["serve_batch"] == profiler.DEFAULT_KNEE_ROWS == 32
    assert res["slo_curve"]["serve_batch"] == 16
    assert res["slo_curve"]["inputs"]["rows_under_itl_slo"] == 16
    assert res["static"]["serve_batch"] == 6
    assert res["blocks_hbm_cap"]["prefix_blocks"] == 4
    assert res["blocks_context"]["prefix_blocks"] == 2 * 2 * SEQ // 16


def test_auto_refuses_ledgerless_engine():
    """An engine without weights or a cache cannot be ledgered: the JAX
    ValueError, word for word."""
    template = types.SimpleNamespace(seq_len=SEQ, spec=None)
    with pytest.raises(ValueError, match="ledger-capable") as mine:
        profiler.resolve_auto_shape(template, serve_batch="auto")
    with pytest.raises(ValueError) as theirs:
        jax_profiler.resolve_auto_shape(template, serve_batch="auto")
    assert str(mine.value) == str(theirs.value)


# -- the artifact ------------------------------------------------------------

_GOOD = _artifact()
ARTIFACTS = {"good": _GOOD, "bad_version": dict(_GOOD, version=99),
             "bad_kind": dict(_GOOD, kind="bogus"), "kneeless": dict(_GOOD, knee={}),
             "curveless": {k: v for k, v in _GOOD.items() if k != "decode_curve"},
             "not_a_dict": [1, 2]}


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_four_validators_agree(name):
    art = ARTIFACTS[name]
    want = jax_profiler.validate_autotune(art)
    assert profiler.validate_autotune(art) == dlprof.validate_autotune(art) == \
        jax_dlprof.validate_autotune(art) == want
    assert (not want) is (name == "good")


def test_loaders_refuse_garbage_with_the_jax_message(tmp_path):
    p = tmp_path / "AUTOTUNE.json"
    p.write_text(json.dumps(ARTIFACTS["bad_version"]))
    msgs = []
    for load in (profiler.load_autotune, dlprof.load_autotune,
                 jax_profiler.load_autotune):
        with pytest.raises(ValueError, match="version") as ei:
            load(str(p))
        msgs.append(str(ei.value))
    assert len(set(msgs)) == 1
    p.write_text(json.dumps(_GOOD))
    assert profiler.load_autotune(str(p))["knee"]["knee_rows"] == 4


def test_committed_artifact_validates():
    """The committed AUTOTUNE.json (the JAX package's CPU calibration)
    satisfies the port's loaders."""
    art = profiler.load_autotune(str(ROOT / "AUTOTUNE.json"))
    assert dlprof.load_autotune(str(ROOT / "AUTOTUNE.json")) == art
    assert art["knee"]["knee_rows"] >= 1 and art["prefill_ms_by_width"]
    assert (profiler.AUTOTUNE_KIND, profiler.AUTOTUNE_VERSION) == \
        (jax_profiler.AUTOTUNE_KIND, jax_profiler.AUTOTUNE_VERSION)


# -- the CLI's parse-time refusals (JAX tests/test_autotune.py:383-437) --------

BASE = ["api", "--model", "m", "--tokenizer", "t"]
REFUSALS = {
    "itl-needs-batch": (["--slo-itl-ms", "50"], "--serve-batch"),
    "ttft-needs-batch": (["--slo-ttft-ms", "500"], "--serve-batch"),
    "slo-positive": (["--serve-batch", "2", "--slo-itl-ms", "-5"], "> 0"),
    "ttft-positive": (["--serve-batch", "2", "--slo-ttft-ms", "0"], "> 0"),
    "autotune-needs-auto": (["--serve-batch", "2", "--autotune", "AUTOTUNE.json"], "auto"),
    "autotune-missing": (["--serve-batch", "auto", "--autotune", "no-such-artifact.json"],
                         "error: --autotune no-such-artifact.json: "),
    "auto-ttft-positive": (["--serve-batch", "auto", "--slo-ttft-ms", "-1"], "> 0"),
    "freeze-needs-batch": (["--freeze-compiles"], "--freeze-compiles"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_parse_time_refusals_match_jax(name):
    argv, needle = REFUSALS[name]
    with pytest.raises(SystemExit) as mine:
        dllama.main(BASE + argv)
    with pytest.raises(SystemExit) as theirs:
        jax_dllama.main(BASE + argv)
    assert needle in str(mine.value)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["--serve-batch", "auto", "--replica-procs", "2"],
    ["--serve-batch", "2", "--replica-hosts", "h1:9001,h2:9001", "--slo-itl-ms", "80"]])
def test_replica_tier_combinations_get_the_ports_refusal(argv):
    """The JAX server refuses auto sizes with the process tier and SLOs
    with remote workers; the port has no replica tier, so the tier's own
    flag is refused as not ported."""
    with pytest.raises(SystemExit) as mine:
        dllama.main(BASE + argv)
    assert "not ported" in str(mine.value) and "ROADMAP item 16" in str(mine.value)


def test_bad_artifact_refused_before_engine_work(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "nope"}))
    argv = BASE + ["--serve-batch", "auto", "--autotune", str(bad)]
    with pytest.raises(SystemExit) as mine:
        dllama.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jax_dllama.main(argv)
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value).startswith(f"error: --autotune {bad}: ") and "kind" in str(mine.value)


def test_auto_sentinels_parse():
    ap = dllama.build_argparser()
    args = ap.parse_args(["api", "--serve-batch", "auto", "--prefix-blocks", "AUTO"])
    assert args.serve_batch == "auto" and args.prefix_blocks == "auto"
    assert ap.parse_args(["api", "--serve-batch", " 3 "]).serve_batch == 3
    for bad in (["--serve-batch", "many"], ["--serve-batch", "-1"],
                ["--prefix-blocks", "lots"]):
        with pytest.raises(SystemExit):
            ap.parse_args(["api", *bad])


# -- the server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(42), seq_len=96)


def _req(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_stats_and_metrics_carry_autosize_and_admission(files, tmp_path, capsys):
    """`dllama api --serve-batch auto --prefix-cache --prefix-blocks auto
    --autotune FILE --slo-itl-ms 80` resolves as the JAX server does
    (startup line, decision record) and /stats and /metrics carry the
    autosize and admission blocks and families as the JAX server's."""
    mpath, tpath = files
    art = tmp_path / "art.json"
    art.write_text(json.dumps(_artifact(3)))
    flags = ["--serve-batch", "auto", "--serve-chunk", "16", "--prefix-cache",
             "--prefix-blocks", "auto", "--autotune", str(art), "--slo-itl-ms", "80"]
    argv = ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
            "--seed", "3", *F32]
    args = dllama.build_argparser().parse_args(
        argv + flags + ["--host", "127.0.0.1", "--port", "0", "--device", "cpu"])
    server, state = api_server.build_server(args)
    assert "auto-sized: --serve-batch 3 (autotune), --prefix-blocks" in capsys.readouterr().out
    jargs = jax_dllama.build_argparser().parse_args(argv)
    jengine, jtok, jsampler = jax_dllama.build_engine(jargs)
    jauto = jax_profiler.resolve_auto_shape(
        jengine, serve_batch="auto", prefix_blocks="auto", prefix_block_len=32,
        autotune=json.loads(art.read_text()), slo_itl_ms=80.0)
    assert state.autosize == jauto
    assert state.serve_batch == jauto["serve_batch"] == 3
    jstate = jax_api.ApiState(jengine, jtok, jsampler, model_name="dllama",
                              serve_batch=3, serve_chunk=16, prefix_cache=True,
                              prefix_blocks=jauto["prefix_blocks"], slo_itl_ms=80.0,
                              autosize=jauto)
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), jax_api.make_handler(jstate))
    _start(server)
    _start(jserver)
    try:
        body = {"prompt": "abab", "max_tokens": 4, "temperature": 0}
        stats = []
        for srv in (server, jserver):
            assert _req(srv.server_address, "POST", "/v1/completions", body)[0] == 200
            stats.append(json.loads(_req(srv.server_address, "GET", "/stats")[1]))
        mine, theirs = stats
        assert mine["autosize"] == theirs["autosize"] == jauto
        live = ("itl_ewma_ms", "ttft_ewma_ms")
        assert {k: v for k, v in mine["admission"].items() if k not in live} == \
            {k: v for k, v in theirs["admission"].items() if k not in live}
        assert mine["admission"]["chunk_ladder"] == [16, 8, 4, 2]
        texts = [_req(srv.server_address, "GET", "/metrics")[1] for srv in (server, jserver)]

        def families(text):
            return sorted(ln for ln in text.splitlines()
                          if ln.startswith(("dllama_autosize_", "# HELP dllama_autosize",
                                            "# TYPE dllama_autosize",
                                            "dllama_admission_chunk",
                                            "# HELP dllama_admission",
                                            "# TYPE dllama_admission")))
        assert families(texts[0]) == families(texts[1])
        assert 'dllama_autosize_serve_batch{basis="autotune"} 3' in texts[0]
        assert "dllama_admission_itl_ewma_ms " in texts[0]
    finally:
        for srv, st in ((server, state), (jserver, jstate)):
            srv.shutdown()
            if st._scheduler is not None:
                st._scheduler.close()


def test_build_server_refuses_a_decision_over_the_headroom(files, tmp_path, monkeypatch):
    """Both auto caps read the same headroom (the JAX arithmetic), so B
    slots plus an arena of half the headroom can exceed it: the server
    exits naming both numbers before it allocates, and builds a decision
    that fits."""
    mpath, tpath = files
    art = tmp_path / "art.json"
    art.write_text(json.dumps(_artifact(3)))
    argv = ["api", "--model", mpath, "--tokenizer", tpath, *F32, "--serve-batch", "auto",
            "--prefix-cache", "--prefix-blocks", "auto", "--autotune", str(art),
            "--host", "127.0.0.1", "--port", "0", "--device", "cpu"]
    args = dllama.build_argparser().parse_args(argv)
    per_slot = profiler.hbm_ledger(dllama.build_engine(args)[0],
                                   device_stats=None)["per_slot_bytes"]
    limit = 3 * per_slot + per_slot // 2
    monkeypatch.setattr(profiler, "device_memory_stats",
                        lambda device: {"bytes_in_use": 0, "bytes_limit": limit})
    with pytest.raises(SystemExit) as ei:
        api_server.build_server(args)
    # B = 3 slots (the knee) and 5 blocks of a third of a slot (half of
    # the 10 the headroom holds): 4.67 slots' bytes against 3.5
    need = 3 * per_slot + 5 * (per_slot // 3)
    assert str(ei.value) == (
        f"error: the auto-sized --serve-batch 3 and --prefix-blocks 5 need {need} "
        f"bytes of KV slots and arena, over the device's {limit} bytes of headroom: "
        "pass a smaller --serve-batch or --prefix-blocks")
    monkeypatch.setattr(profiler, "device_memory_stats",
                        lambda device: {"bytes_in_use": 0, "bytes_limit": 1 << 40})
    server, state = api_server.build_server(args)
    try:
        assert (state.serve_batch, state.autosize["prefix_blocks"]) == (3, 18)
    finally:
        server.server_close()
        if state._scheduler is not None:
            state._scheduler.close()


def test_admin_reset_breaker_restores_a_broken_supervisor(files):
    """JAX tests/test_apps.py:1209: every step crashes until the breaker
    opens (/readyz 503); with the fault gone, POST /admin/reset_breaker is
    the operator's half-open and service resumes."""
    mpath, tpath = files
    args = dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
         "--seed", "3", *F32, "--device", "cpu", "--serve-batch", "2",
         "--host", "127.0.0.1", "--port", "0"])
    server, state = api_server.build_server(args)
    _start(server)
    addr = server.server_address
    body = {"prompt": "ab", "max_tokens": 2, "temperature": 0}
    sup = state._scheduler
    try:
        assert _req(addr, "POST", "/v1/completions", body)[0] == 200
        FAULTS.arm("step_raise", times=0)
        t0 = time.perf_counter()
        while sup.state != BROKEN and time.perf_counter() - t0 < 60.0:
            _req(addr, "POST", "/v1/completions", {**body, "max_tokens": 4})
            time.sleep(0.05)
        assert sup.state == BROKEN, sup.state
        assert _req(addr, "GET", "/readyz")[0] == 503
        FAULTS.clear()
        assert _req(addr, "POST", "/admin/reset_breaker", {"replica": 1})[0] == 400
        status, raw = _req(addr, "POST", "/admin/reset_breaker", {})
        assert status == 200 and json.loads(raw)["status"] == "ok"
        t0 = time.perf_counter()
        while sup.state != READY and time.perf_counter() - t0 < 30.0:
            time.sleep(0.05)
        assert _req(addr, "POST", "/v1/completions", body)[0] == 200
    finally:
        FAULTS.clear()
        server.shutdown()
        sup.close()


def test_freeze_compiles_sets_the_ledger_freeze(files):
    """--freeze-compiles freezes the graph ledger for the server's engines
    (the sentinel refuses only on an engine its warmup marked warm)."""
    args = dllama.build_argparser().parse_args(
        ["api", "--serve-batch", "2", "--freeze-compiles"])
    try:
        api_server.configure_observability(args)
        assert profiler.COMPILES.freeze
    finally:
        profiler.COMPILES.reset()


# -- the allocator's real limit ------------------------------------------------


def test_device_memory_stats_counts_reserved_plus_free(engines, monkeypatch):
    """The limit is what the allocator could hold: its reserved bytes plus
    the free bytes cudaMemGetInfo reports (never the card's total, which
    counts the CUDA context and memory torch does not own); in use is the
    allocated bytes.
    Headroom and slots follow."""
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d=None: {"allocated_bytes.all.current": 5 * gib})
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 6 * gib)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (70 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: pytest.fail("the card's total is not the limit"))
    stats = profiler.device_memory_stats(torch.device("cuda"))
    assert stats == {"bytes_in_use": 5 * gib, "bytes_limit": 76 * gib}
    led = profiler.hbm_ledger(engines[0], device_stats=stats)
    assert led["headroom_bytes"] == 71 * gib
    assert led["slots_addable"] == 71 * gib // PER_SLOT
    assert led["device_bytes_limit"] == 76 * gib
    assert profiler.device_memory_stats(torch.device("cpu")) is None
    assert led == jax_profiler.hbm_ledger(engines[1], device_stats=stats)
