"""The port's copies of the JAX package's jax-free serving plumbing, held
against the originals on the same inputs: runtime/stats.py (percentile,
RequestStats, ServeStats, SupervisorStats),
runtime/trace.py (render_prometheus, text for text),
runtime/faults.py (the same arm spec fires at the same invocations),
runtime/sampling.FullLogitsView and Sampler.next_seed; then the port's
own device-tier ledgers (runtime/profiler.py) on the CPU.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu import sampler as jax_sampler
from distributed_llama_tpu.runtime import faults as jax_faults
from distributed_llama_tpu.runtime import sampling as jax_sampling
from distributed_llama_tpu.runtime import stats as jax_stats
from distributed_llama_tpu.runtime import trace as jax_trace
from distributed_llama_tpu_torch import sampler
from distributed_llama_tpu_torch.runtime import faults, profiler, sampling, stats, trace


@pytest.mark.parametrize("xs", [[], [3.0], [1.0, 2.0], [5, 1, 4, 2, 3], list(range(101))])
@pytest.mark.parametrize("p", [-5, 0, 50, 99, 100, 150])
def test_percentile_matches_jax(xs, p):
    assert stats.percentile(xs, p) == jax_stats.percentile(xs, p)


def _fill_serve(mod):
    s = mod.ServeStats(window=4)
    for i in range(6):
        r = mod.RequestStats(n_prompt=3)
        r.t_submit = 1.0 + i
        if i % 3:
            r.t_first = 1.25 + i
            r.n_out = i
            r.t_done = 2.0 + i * 1.5
        s.requests.append(r)
        s.occupancy.append(i % 3)
        s.queue_depth.append(5 - i)
    s.requests_submitted, s.requests_finished, s.tokens_out, s.steps = 6, 5, 17, 9
    s.requests_failed, s.requests_expired, s.requests_rejected = 2, 1, 3
    return s


def test_serve_stats_summary_matches_jax():
    assert _fill_serve(stats).summary() == _fill_serve(jax_stats).summary()


def test_supervisor_stats_match_jax():
    mine, theirs = stats.SupervisorStats(), jax_stats.SupervisorStats()
    for s in (mine, theirs):
        s.crashes, s.watchdog_trips, s.recoveries = 2, 1, 3
        s.consecutive_failures, s.rejected_unready = 1, 4
        s.recovery_ms.extend([12.5, 3.25, 40.0])
    got, want = mine.summary(), theirs.summary()
    assert got == want


def _summary():
    sup = stats.SupervisorStats()
    sup.crashes, sup.recoveries = 1, 1
    sup.recovery_ms.append(7.5)
    return {**_fill_serve(stats).summary(), "state": "ready",
            "resilience": sup.summary(),
            "compiles": {"after_warmup": 1, "by_key": {"slot_decode": {
                "count": 1, "ms": 12.5}}},
            "hbm": {"weights_bytes": 10, "vocab_bytes": 2, "kv_slot_bytes": 8,
                    "logits_workspace_bytes": 4, "device_bytes_in_use": None,
                    "slots_addable": None},
            "device_time": {"sampled_steps": 2, "by_entry": {
                "scheduler_step": {"n": 2, "p50_ms": 1.5}}}}


# the one-hot states of the JAX renderer that the port's renderer lacks:
# none since the fleet (a router's "degraded"; "idle" is rendered though
# the port builds its supervisor before the server binds)
_JAX_ONLY_STATES = ()


@pytest.mark.parametrize("kw", [dict(mode="scheduler"), dict(mode="legacy", state="off"),
                                dict(mode="scheduler", state="recovering")])
def test_render_prometheus_matches_jax(kw):
    """The same summary gives the JAX text, line for line, less the
    one-hot lines of the states the port has not got."""
    summary = _summary()
    build = {"version": "0.1.0", "torch": "x", "device": "cpu"}
    got = trace.render_prometheus(summary, model="tiny", build=build, **kw)
    want = jax_trace.render_prometheus(summary, model="tiny", build=build, **kw)
    assert got.splitlines() == [ln for ln in want.splitlines() if ln not in _JAX_ONLY_STATES]
    assert trace.render_prometheus(None, **kw).splitlines() == [
        ln for ln in jax_trace.render_prometheus(None, **kw).splitlines()
        if ln not in _JAX_ONLY_STATES]


def test_render_prometheus_has_no_unported_families():
    """Without a tracer the renderer renders no step family. Every family
    is ported now: the router, replica, transfer and fleet blocks of a
    summary render as the JAX renderer's, and so do the prefix cache's
    and the autosize block."""
    summary = _summary()
    summary["hbm"] = {**summary["hbm"], "prefix_arena_bytes": 6, "prefix_blocks_addable": 3}
    summary["prefix_cache"] = {"lookups": 4, "hits": 3, "blocks_in_use": 2}
    fleet = {"router": {"routed": 5}, "replicas": [{"replica": 0, "tokens_out": 1}],
             "kv_transfer": {"fills_ok": 1, "enabled": True},
             "fleet": {"enabled": True, "ticks": 3, "sheds_by_reason": {"shed": 1}}}
    text = trace.render_prometheus({**summary, **fleet})
    assert text == jax_trace.render_prometheus({**summary, **fleet})
    assert "dllama_router_routed_total 5" in text
    assert 'dllama_replica_tokens_out_total{replica="0"} 1' in text
    assert "dllama_kv_transfer_fills_total 1" in text
    assert 'dllama_fleet_sheds_by_reason_total{reason="shed"} 1' in text
    text = trace.render_prometheus(summary)
    auto = {"serve_batch": 4, "serve_batch_basis": "autotune", "prefix_blocks": 0,
            "prefix_blocks_basis": "static",
            "inputs": {"knee_rows": 4, "knee_basis": "autotune"}}
    with_auto = trace.render_prometheus({**summary, "autosize": auto})
    assert with_auto.splitlines() == [
        ln for ln in jax_trace.render_prometheus({**summary, "autosize": auto}).splitlines()
        if ln not in _JAX_ONLY_STATES]
    assert 'dllama_autosize_serve_batch{basis="autotune"} 4' in with_auto
    assert "dllama_autosize_prefix_blocks" not in with_auto
    assert "dllama_step_ms" not in text and "router" not in text and "replica" not in text
    assert 'dllama_hbm_bytes{category="kv_slots"} 8' in text
    assert 'dllama_hbm_bytes{category="prefix_arena"} 6' in text
    assert "dllama_hbm_prefix_blocks_addable 3" in text
    assert "dllama_prefix_cache_hits_total 3" in text
    assert "dllama_prefix_cache_blocks_in_use 2" in text
    assert text.splitlines() == [ln for ln in jax_trace.render_prometheus(
        summary).splitlines() if ln not in _JAX_ONLY_STATES]


@pytest.mark.parametrize("spec", [dict(after=2, times=2), dict(after=0, times=0),
                                  dict(after=5, times=1)])
@pytest.mark.parametrize("site", ["step_raise", "prefill_raise"])
def test_faults_fire_like_jax(site, spec):
    mine, theirs = faults.FaultRegistry(), jax_faults.FaultRegistry()
    mine.arm(site, **spec)
    theirs.arm(site, **spec)
    pattern = []
    for reg, err in ((mine, faults.FaultError), (theirs, jax_faults.FaultError)):
        fired = []
        for _ in range(9):
            try:
                reg.fire(site)
                fired.append(False)
            except err as e:
                fired.append(str(e))
        pattern.append(fired)
    assert pattern[0] == pattern[1]
    assert mine.fired(site) == theirs.fired(site)
    assert set(faults.SITES) <= set(jax_faults.SITES)


def test_faults_env_spec_matches_jax():
    env = {"DLLAMA_FAULTS": "step_raise:after=1;times=2,slow_step:ms=1;times=0"}
    mine, theirs = faults.FaultRegistry(), jax_faults.FaultRegistry()
    mine.load_env(env)
    theirs.load_env(env)
    for site in faults.SITES:
        assert mine.armed(site) == theirs.armed(site)


def test_full_logits_view_matches_jax():
    lg = np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32)
    mine, theirs = sampling.FullLogitsView(lg), jax_sampling.FullLogitsView(lg)
    for row in range(3):
        assert mine.argmax(row, 40) == theirs.argmax(row, 40)
        np.testing.assert_array_equal(mine.row(row), theirs.row(row))
        a = sampler.Sampler(50, 0.8, 0.9, 11 + row)
        b = jax_sampler.Sampler(50, 0.8, 0.9, 11 + row, backend="python")
        assert [mine.sample(a, row) for _ in range(5)] == \
            [theirs.sample(b, row) for _ in range(5)]


def test_next_seed_matches_jax():
    a = sampler.Sampler(32, 0.7, 0.9, 123)
    b = jax_sampler.Sampler(32, 0.7, 0.9, 123, backend="python")
    seeds = [a.next_seed() for _ in range(6)]
    assert seeds == [b.next_seed() for _ in range(6)]
    assert len(set(seeds)) == 6 and a.rng_state == b.rng_state


# -- the port's device-tier ledgers, on the CPU -----------------------------


def test_compile_ledger_sentinel_and_freeze():
    class Eng:
        _compile_warm = False

    led, eng = profiler.CompileLedger(), Eng()
    led.pre_compile(eng, "slot_decode")
    led.record(eng, "slot_decode", 12.5)
    led.record(eng, 1, 3.0)
    eng._compile_warm = True
    led.pre_compile(eng, ("dsample", 0.5, 0.9, 32, (2,)))
    s = led.summary()
    assert s["total"] == 2 and s["after_warmup"] == 1
    assert set(s["by_key"]) == {"slot_decode", "seg:1"}
    assert profiler.compile_key_str(("dsample", 0.5, 0.9, 32, (2, 7))) == \
        "dsample:0.5:0.9:32:2x7"
    led.freeze = True
    from distributed_llama_tpu_torch.runtime.scheduler import RequestError
    with pytest.raises(RequestError) as ei:
        led.pre_compile(eng, "new_key")
    assert ei.value.code == "compile_after_warmup" and not ei.value.retryable
    led.reset()
    assert led.summary()["total"] == 0 and not led.freeze


def test_hbm_ledger_build_info_and_profiler_on_cpu():
    from distributed_llama_tpu_torch.models.params import load_params, random_tensors
    from distributed_llama_tpu_torch.runtime.engine import Engine
    from distributed_llama_tpu_torch.testing import tiny_spec

    spec = tiny_spec()
    params = load_params(spec, random_tensors(spec, seed=1), mode="q40",
                         dtype=torch.float32, device="cpu")
    eng = Engine(spec, params, device="cpu", batch=3, compute_dtype=torch.float32,
                 cache_dtype=torch.float32, max_seq_len=32)
    h = profiler.hbm_ledger(eng)
    kv = 2 * spec.n_layers * 3 * spec.n_kv_heads * 32 * spec.head_size * 4
    assert h["kv_slot_bytes"] == kv and h["per_slot_bytes"] == kv // 3
    assert h["weights_bytes"] > 0 and h["vocab_bytes"] > 0
    assert h["device_bytes_in_use"] is None and h["slots_addable"] is None
    info = profiler.build_info(eng)
    assert info["device"] == "cpu" and info["card"] == "none"
    assert info["torch"] == torch.__version__

    prof = profiler.Profiler()
    prof.sample_every = 2
    assert prof.step_begin() is None     # not this step's turn
    assert prof.step_begin() is None     # its turn, but no card: no time
    assert prof.summary()["sample_failures"] == 1 and prof.sampled == 0
