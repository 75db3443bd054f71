"""The port's calibration tools held against the repo's tools/autotune.py and
tools/dlprof.py, on the CPU: the knee estimator, the artifact builder, the
drift comparison and the batch recommendation on seeded synthetic curves;
a tiny calibration on the CPU whose artifact every validator accepts;
the port's dlprof self-test; and the port's dlprof report on a trace
directory the port's server code wrote, equal to the JAX tool's report on
the same files.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu.runtime import profiler as jax_profiler
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import profiler
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.scheduler import Scheduler
from distributed_llama_tpu_torch.runtime.trace import TRACER
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.tools import autotune, dlprof

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import dlprof as jax_dlprof  # noqa: E402  (tools/ is no package)


def _jax_autotune():
    spec = importlib.util.spec_from_file_location("jax_autotune_tool",
                                                  ROOT / "tools" / "autotune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _curve(seed: int):
    """A seeded decode curve: flat, then bending up somewhere."""
    rng = np.random.default_rng(seed)
    rows = sorted(set(int(r) for r in rng.choice([1, 2, 4, 8, 16, 32, 64, 128],
                                                 size=int(rng.integers(1, 8)),
                                                 replace=False)))
    bend = float(rng.uniform(0.0, 0.3))
    base = float(rng.uniform(3.0, 20.0))
    return [(r, round(base * (1 + bend * r ** float(rng.uniform(0.5, 1.2))), 4))
            for r in rows]


@pytest.mark.parametrize("seed", range(12))
def test_knee_estimate_matches_jax(seed):
    curve = _curve(seed)
    assert dlprof.knee_estimate(curve) == jax_dlprof.knee_estimate(curve)
    assert dlprof.knee_estimate([]) is jax_dlprof.knee_estimate([]) is None


@pytest.mark.parametrize("seed", range(6))
def test_build_artifact_matches_jax(seed):
    points = [{"rows": r, "p50_ms": ms, "mean_ms": ms, "n": 31} for r, ms in _curve(seed)]
    hbm = {"slots_addable": int(np.random.default_rng(seed).integers(0, 50))}
    common = dict(model="7b", chunk=32, seq_len=256, steps_per_batch=32,
                  decode_curve=points, prefill_ms_by_width={"32": 4.0, "16": 2.2},
                  prefix={"stats": None}, hbm=hbm, created_unix=0.0)
    mine = autotune.build_artifact(backend="cuda", torch_version="2.x",
                                   device={"name": "x", "power_limit": None}, **common)
    theirs = _jax_autotune().build_artifact(backend="tpu", jax_version="0.x", **common)
    assert mine.pop("torch") == "2.x" and mine.pop("device") == {"name": "x",
                                                                  "power_limit": None}
    assert mine.pop("backend") == "cuda" and theirs.pop("backend") == "tpu"
    assert theirs.pop("jax") == "0.x"
    assert mine == theirs
    for validate in (profiler.validate_autotune, jax_profiler.validate_autotune,
                     dlprof.validate_autotune, jax_dlprof.validate_autotune):
        assert validate(dict(mine, backend="cuda")) == []


def test_kneeless_sweep_is_refused():
    with pytest.raises(ValueError, match="knee"):
        autotune.build_artifact(model="x", backend="cpu", torch_version="x",
                                device={}, chunk=32, seq_len=256, steps_per_batch=1,
                                decode_curve=[])


@pytest.mark.parametrize("seed", range(6))
def test_autotune_comparison_and_recommendation_match_jax(seed):
    rng = np.random.default_rng(seed)
    art = {"knee": {"knee_rows": int(rng.choice([2, 4, 8, 16]))}, "model": "7b",
           "backend": "cuda", "created_unix": 1.0}
    knee = dlprof.knee_estimate(_curve(seed))
    for k in (knee, None, {"knee_rows": int(rng.choice([2, 4, 8, 16, 32]))}):
        assert dlprof.autotune_comparison(k, art) == jax_dlprof.autotune_comparison(k, art)
    for hbm in (None, {"slots_addable": None}, {"slots_addable": int(rng.integers(0, 9))}):
        assert dlprof.serve_batch_recommendation(knee, hbm) == \
            jax_dlprof.serve_batch_recommendation(knee, hbm)


def test_tiny_calibration_on_the_cpu(tmp_path):
    """`calibrate(model="tiny", batches=(2, 4))` on the CPU: a curve point a
    batch, the ladder's widths timed, and an artifact every validator and
    both loaders accept; main() writes it. On one intra-op thread: the
    tiny model's ~1000 small products take ~2 s so, while all of torch's
    threads, on a host that other test processes share, waited for each
    other for minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _tiny_calibration(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _tiny_calibration(tmp_path):
    art = autotune.calibrate(model="tiny", batches=(2, 4), steps=8, device="cpu",
                             log=lambda *a, **k: None)
    assert [p["rows"] for p in art["decode_curve"]] == [2, 4]
    assert list(art["prefill_ms_by_width"]) == ["32", "16", "8", "4"]
    assert art["backend"] == "cpu" and art["device"] == {"name": "cpu", "power_limit": None}
    assert art["torch"] == torch.__version__ and art["knee"]["knee_rows"] in (2, 4)
    assert art["prefix"]["stats"]["hits"] >= 1
    for validate in (profiler.validate_autotune, jax_profiler.validate_autotune,
                     dlprof.validate_autotune, jax_dlprof.validate_autotune):
        assert validate(art) == []
    out = tmp_path / "AUTOTUNE.json"
    assert autotune.main(["--model", "tiny", "--device", "cpu", "--batches", "2",
                          "--steps", "4", "--out", str(out)]) == 0
    for load in (profiler.load_autotune, jax_profiler.load_autotune):
        assert load(str(out))["decode_curve"][0]["rows"] == 2


def test_autotune_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.calibrate(model="tiny", batches=(2,))


def test_dlprof_selftest_passes(capsys):
    assert dlprof.main(["--selftest"]) == 0
    assert "dlprof selftest: OK" in capsys.readouterr().out


def _greedy():
    return Sampler(128, 0.0, 0.9, 1)


def test_dlprof_report_on_a_port_trace_dir_matches_jax(tmp_path):
    """A port scheduler serves under the flight recorder with a sink; the
    port's dlprof and the JAX tool read the same files and give the same
    report and markdown, with a bench row and an artifact as well."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    eng = Engine(spec, params, device="cpu", batch=2, compute_dtype=torch.float32,
                 cache_dtype=torch.float32)
    trace_dir = tmp_path / "trace"
    sched = Scheduler(eng, chunk=8)
    sched.warmup()
    TRACER.configure(capacity=4096, decode_every=2, sink_dir=str(trace_dir))
    try:
        reqs = [sched.submit(p, n, _greedy()) for p, n in
                (([1, 9, 23, 54, 7], 6), ([2, 40, 77] * 5, 5), ([5, 6], 7), ([9] * 9, 4))]
        for _ in range(400):
            if all(r.finished.is_set() for r in reqs):
                break
            sched.step()
        assert all(r.finished.is_set() for r in reqs)
    finally:
        TRACER.reset()  # closes the sink
        sched.close()
    events = dlprof.load_trace_dir(str(trace_dir))
    assert events == jax_dlprof.load_trace_dir(str(trace_dir))
    assert {e["kind"] for e in events} >= {"enqueue", "admit", "first_token", "finish",
                                           "step"}
    bench_row = {"metric": "row", "step_timeline": {
        "dec2_pre0_c0": {"n": 99, "p50_ms": 3.0, "p99_ms": 4.0, "mean_ms": 3.1}},
        "hbm": {"weights_bytes": 1, "slots_addable": 2}}
    art = {"kind": "dllama-autotune", "version": 1, "model": "tiny", "backend": "cpu",
           "created_unix": 0.0, "decode_curve": [], "knee": {"knee_rows": 4}}
    for kwargs in (dict(), dict(bench_rows=[bench_row], autotune=art,
                                slo_ttft_ms=5.0, slo_itl_ms=2.0)):
        mine = dlprof.analyze(events, **kwargs)
        theirs = jax_dlprof.analyze(events, **kwargs)
        assert mine == theirs
        assert mine["requests"]["completed"] == 4
        assert dlprof.render_markdown(mine) == jax_dlprof.render_markdown(theirs)
    out = tmp_path / "report"
    assert dlprof.main(["--trace-dir", str(trace_dir), "--out", str(out)]) == 0
    assert json.loads((tmp_path / "report.json").read_text()) == \
        json.loads(json.dumps(jax_dlprof.analyze(events)))
    assert (tmp_path / "report.md").read_text().startswith("# dlprof report")
