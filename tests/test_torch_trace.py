"""The port's flight recorder (runtime/trace.py, stats.StepTimelineStats)
and its event sites held against the JAX package's, on the CPU.

The same event sequence fed to both Tracers gives equal records, timestamps
aside: the ring bound, the span index, deterministic sink sampling and
sink rotation; the step windows and the /metrics trace families render
equal. The same request mix through both schedulers (plain, with the radix
prefix cache, with a self-draft; f32, dense weights) gives each request
the same span, event for event, fields that time nothing included, and the
same step timeline; the supervisor's failure and recovery, a fired fault
and the compile ledger record the JAX package's events. Off, the recorder
records and allocates nothing; on, it adds no graph capture and no host
read of a device value to a serve (CUDA's graph API faked).
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import draft as jax_draft
from distributed_llama_tpu.runtime import faults as jax_faults
from distributed_llama_tpu.runtime import prefix_cache as jax_pc
from distributed_llama_tpu.runtime import profiler as jax_prof
from distributed_llama_tpu.runtime import resilience as jax_res
from distributed_llama_tpu.runtime import scheduler as jax_sched
from distributed_llama_tpu.runtime import stats as jax_stats
from distributed_llama_tpu.runtime import trace as jax_trace
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import (draft, faults, prefix_cache, profiler,
                                                 resilience, scheduler, stats, trace)
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64
# fields that hold a time: they differ between any two runs
TIMED = {"ts", "ts_wall", "ms", "queue_ms", "ttft_ms", "wall_ms", "msg"}


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in TIMED} for e in events]


@pytest.fixture(autouse=True)
def clean():
    for t in (trace.TRACER, jax_trace.TRACER):
        t.reset()
    for f in (faults.FAULTS, jax_faults.FAULTS):
        f.clear()
    yield
    for t in (trace.TRACER, jax_trace.TRACER):
        t.reset()
    for f in (faults.FAULTS, jax_faults.FAULTS):
        f.clear()
    profiler.COMPILES.reset()
    jax_prof.COMPILES.reset()


def _feed(t):
    """One event sequence: 40 requests' spans, tid-0 events and steps."""
    for i in range(40):
        tid = t.new_id()
        t.event("enqueue", tid, rid=i, n_prompt=3 + i % 5, max_tokens=8, key=None)
        if i % 3:
            t.event("admit", tid, slot=i % 4, queue_ms=0.5, key=None)
            t.step(decode_rows=i % 4, prefill_rows=1, chunk=16, queue_depth=i % 2,
                   wall_ms=1.0 + i)
            t.event("finish", tid, reason="stop", n_out=i)
        else:
            t.event("fault", 0, site="step_raise", key=None, n=i)
    t.step(decode_rows=2, prefill_rows=0, chunk=0, queue_depth=0, wall_ms=3.0, key="r0")


@pytest.mark.parametrize("capacity", [16, 8192], ids=["ring-bound", "roomy"])
def test_tracer_records_match_jax(capacity):
    """Equal records (timestamps aside), spans, summaries and windows."""
    mine, theirs = trace.Tracer(), jax_trace.Tracer()
    for t in (mine, theirs):
        t.configure(capacity=capacity, decode_every=3)
        _feed(t)
    assert _untimed(mine.recent(0)) == _untimed(theirs.recent(0))
    assert _untimed(mine.recent(5)) == _untimed(theirs.recent(5))
    assert len(mine.recent(0)) == min(capacity, len(theirs.recent(0)))
    for tid in (1, 2, 17, 40, 41):
        assert _untimed(mine.by_id(tid)) == _untimed(theirs.by_id(tid))
    assert mine.summary() == theirs.summary()
    assert mine.step_timeline() == theirs.step_timeline()
    assert mine.decode_every == theirs.decode_every == 3
    assert abs(mine.to_wall(mine.anchor_mono) - mine.anchor_wall) < 1e-9


def test_sampled_matches_jax():
    for rate in (0.0, 0.1, 0.3, 0.5, 1.0):
        picks = [trace._sampled(tid, rate) for tid in range(1, 3000)]
        assert picks == [jax_trace._sampled(tid, rate) for tid in range(1, 3000)]


@pytest.mark.parametrize("sample", [1.0, 0.3])
def test_sink_sampling_and_rotation_match_jax(tmp_path, sample):
    """The rotating JSONL sink: the same lines and sampled spans as the JAX
    sink (untimed fields), and its rotation rule: a file rotates past
    max_bytes (by one line at most), the oldest go past max_files. Where
    a file ends depends on the timestamps' printed lengths, so the
    rotated files are checked by that rule, the lines without rotation."""
    lines = {}
    for name, t in (("port", trace.Tracer()), ("jax", jax_trace.Tracer())):
        for rotate in (False, True):
            d = tmp_path / f"{name}-{rotate}"
            t.configure(capacity=64, sample=sample, sink_dir=str(d),
                        sink_max_bytes=2000 if rotate else 1 << 20, sink_max_files=3)
            _feed(t)
            t.reset()
            files = sorted(d.glob("trace-*.jsonl"))
            if rotate:
                assert len(files) == 3 and files[0].name != "trace-00000001.jsonl", name
                assert all(f.stat().st_size < 2000 + 400 for f in files)
            else:
                assert [f.name for f in files] == ["trace-00000001.jsonl"]
                lines[name] = _untimed([json.loads(ln) for ln in files[0].read_text().splitlines()])
    assert lines["port"] == lines["jax"]
    spans = {e["tid"] for e in lines["port"]} - {0}
    assert spans == {tid for tid in range(1, 41) if trace._sampled(tid, sample)}


def test_disabled_records_nothing_and_is_allocation_free():
    """The off path (JAX tests/test_trace.py:90): no ring growth, and the
    call-site guard allocates nothing."""
    import gc

    t = trace.TRACER
    assert not t.enabled
    t.event("enqueue", 1, n_prompt=5)
    t.step(decode_rows=1, prefill_rows=0, chunk=0, queue_depth=0, wall_ms=1.0)
    assert t.recent(0) == [] and t.step_timeline() == {}

    def guarded_loop(n):
        for _ in range(n):
            if t.enabled:
                t.event("decode", 1, n_out=1)

    guarded_loop(10)
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        guarded_loop(10_000)
        grew = sys.getallocatedblocks() - before
    finally:
        gc.enable()
    assert grew < 50, f"disabled guard allocated {grew} blocks"


def test_step_timeline_stats_match_jax():
    mine, theirs = stats.StepTimelineStats(window=8, max_keys=3), \
        jax_stats.StepTimelineStats(window=8, max_keys=3)
    rng = np.random.default_rng(5)
    for _ in range(60):
        row = (int(rng.integers(0, 4)), int(rng.integers(0, 2)), 16, float(rng.random()))
        mine.record(*row)
        theirs.record(*row)
    assert mine.summary() == theirs.summary()
    assert mine.summary_json() == theirs.summary_json()
    assert mine.overflow == theirs.overflow > 0


def test_render_prometheus_trace_families_match_jax():
    """The same tracer state renders the same dllama_step_ms, trace and
    composition families, around the same summary."""
    mine, theirs = trace.Tracer(), jax_trace.Tracer()
    for t in (mine, theirs):
        t.configure(capacity=256)
        _feed(t)
    summary = {"requests_submitted": 3, "tokens_out": 9, "steps": 4,
               "device_time": {"sampled_steps": 2, "by_entry": {
                   "slot_decode": {"n": 2, "p50_ms": 1.5}},
                   "sync": {"n": 2, "sync_p50_ms": 0.0, "sync_p99_ms": 0.0,
                            "sync_share": 0.0}}}
    got = trace.render_prometheus(summary, tracer=mine, model="tiny")
    want = jax_trace.render_prometheus(summary, tracer=theirs, model="tiny")
    assert got == want
    assert 'dllama_step_ms{decode_rows="2",prefill_rows="0",chunk="0",quantile="0.5"} 3.0' in got
    assert "dllama_trace_next_id 40" in got and "dllama_step_sync_share 0.0" in got
    assert "dllama_step_ms" not in trace.render_prometheus(summary, model="tiny")


# -- the event sites -----------------------------------------------------------


@pytest.fixture(scope="module")
def pkgs():
    """Both packages over tests/test_draft.py's model (4 layers, dense f32,
    seed 41): engines, their scheduler, prefix cache, supervisor and draft
    constructors, their TRACER and FAULTS."""
    kw = dict(dim=64, hidden_dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jsp = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=41, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jsp, jax_params.random_tensors(
        jsp, seed=41, scale=0.05), mode="dense", dtype=jnp.float32)
    out = {}
    for name, engine, mods, greedy in (
            ("jax", lambda b: JaxEngine(jsp, jp, batch=b, compute_dtype=jnp.float32,
                                        cache_dtype=jnp.float32),
             (jax_sched, jax_pc, jax_res, jax_draft, jax_trace, jax_faults, jax_prof),
             lambda: JaxSampler(128, 0.0, 0.9, 1, backend="python")),
            ("port", lambda b: Engine(spec, params, device="cpu", batch=b,
                                      compute_dtype=torch.float32,
                                      cache_dtype=torch.float32),
             (scheduler, prefix_cache, resilience, draft, trace, faults, profiler),
             lambda: Sampler(128, 0.0, 0.9, 1))):
        sch, pc, res, dr, tr, flt, prof = mods
        out[name] = types.SimpleNamespace(
            engine=engine, two=engine(2), Scheduler=sch.Scheduler,
            PrefixCache=pc.PrefixCache, EngineSupervisor=res.EngineSupervisor,
            DraftModel=dr.DraftModel, TRACER=tr.TRACER, FAULTS=flt.FAULTS,
            COMPILES=prof.COMPILES, greedy=greedy)
    return out


def _spans(pk, reqs):
    return [_untimed(pk.TRACER.by_id(r.trace_id)) for r in reqs]


def _steps(pk):
    return _untimed([e for e in pk.TRACER.recent(0) if e["kind"] == "step"])


def _serve(pk, sched):
    """Staggered joins, an eos stop, a zero budget and a cancel: 4
    requests over 2 slots, stepped to completion."""
    pk.TRACER.configure(capacity=4096, decode_every=2)
    reqs = [sched.submit([7, 9, 23, 54, 11, 3, 88, 61, 5], 6, pk.greedy()),
            sched.submit([7, 9, 23, 54, 11, 3, 88, 61, 40, 2], 7, pk.greedy(), eos_id=13)]
    sched.step()
    reqs.append(sched.submit([2, 40, 77], 0, pk.greedy()))
    reqs.append(sched.submit([1, 2, 3, 4, 5], 9, pk.greedy()))
    for _ in range(4):
        sched.step()
    reqs[3].cancel()
    for _ in range(200):
        if all(r.finished.is_set() for r in reqs):
            break
        sched.step()
    assert all(r.finished.is_set() for r in reqs)
    return reqs


@pytest.mark.parametrize("mode", ["plain", "prefix-cache", "self-draft"])
def test_scheduler_spans_match_jax(pkgs, mode):
    """Each request's span (enqueue, admit, seed, prefill, first_token,
    decode, spec, finish) and every step record equal to the JAX
    scheduler's, untimed fields included; the step timeline's
    compositions and counts too."""
    got = {}
    for name, pk in pkgs.items():
        kw = {}
        if mode == "prefix-cache":
            kw["prefix_cache"] = pk.PrefixCache(pk.two, num_blocks=16, block_len=4)
        elif mode == "self-draft":
            kw.update(draft_factory=lambda e, pk=pk: pk.DraftModel.self_draft(e, 2),
                      draft_len=3, draft_vocab=128)
        sched = pk.Scheduler(pk.two, chunk=4, **kw)
        reqs = _serve(pk, sched)
        timeline = {k: v["n"] for k, v in pk.TRACER.step_timeline().items()}
        got[name] = (_spans(pk, reqs), _steps(pk), timeline, [r.trace_id for r in reqs])
        sched.close()
        pk.TRACER.reset()
    assert got["port"] == got["jax"]
    spans = got["port"][0]
    assert [e["kind"] for e in spans[0]][:3] == ["enqueue", "admit"] + (
        ["seed"] if mode == "prefix-cache" else ["prefill"])
    assert spans[0][-1]["kind"] == "finish" and spans[3][-1]["reason"] == "cancelled"
    if mode == "self-draft":
        assert any(e["kind"] == "spec" for span in spans for e in span)


def test_supervisor_failure_and_recovery_events_match_jax(pkgs):
    """A crash mid-decode: the request's error event, the fired fault,
    engine_failure and recovery (and the rebuilt engine's compile events),
    in the JAX supervisor's order and fields."""
    import time

    got = {}
    for name, pk in pkgs.items():
        pk.TRACER.configure(capacity=4096)
        sup = pk.EngineSupervisor(lambda pk=pk: pk.engine(2), chunk=8, stall_timeout=60.0,
                                  backoff_base=0.01, breaker_threshold=5)
        try:
            pk.FAULTS.arm("slow_step", times=0, ms=20.0)
            req = sup.submit([1, 9, 23, 54], 40, pk.greedy())
            it = req.tokens(timeout=30.0)
            next(it)
            pk.FAULTS.arm("step_raise")
            with pytest.raises(Exception):
                list(it)
            end = time.monotonic() + 30
            while not sup.ready and time.monotonic() < end:
                time.sleep(0.01)
            assert sup.ready
        finally:
            pk.FAULTS.clear()
            sup.close()
        kinds = [e for e in _untimed(pk.TRACER.recent(0))
                 if e["kind"] in ("error", "fault", "engine_failure", "recovery")]
        # the fault's count and the tokens out before it land depend on
        # where the step thread was when the test armed the fault
        assert all(e["n_out"] >= 1 for e in kinds if e["kind"] == "error")
        got[name] = [{k: v for k, v in e.items() if k not in ("n", "n_out")} for e in kinds
                     if not (e["kind"] == "fault" and e["site"] == "slow_step")]
        pk.TRACER.reset()
    assert got["port"] == got["jax"]
    assert [e["kind"] for e in got["port"]] == ["fault", "engine_failure", "error",
                                                 "recovery"]


def test_breaker_events_match_jax(pkgs):
    """The breaker opening after failed rebuilds, and the operator's
    half-open: the same circuit events."""
    import time

    got = {}
    for name, pk in pkgs.items():
        pk.TRACER.configure(capacity=1024)
        n = {"made": 0}

        def factory(pk=pk, n=n):
            n["made"] += 1
            if n["made"] > 1:
                raise RuntimeError("factory down")
            return pk.engine(2)
        sup = pk.EngineSupervisor(factory, chunk=8, stall_timeout=60.0,
                                  backoff_base=0.01, breaker_threshold=2)
        try:
            pk.FAULTS.arm("step_raise")
            req = sup.submit([1, 9], 4, pk.greedy())
            with pytest.raises(Exception):
                list(req.tokens(timeout=30.0))
            end = time.monotonic() + 30
            while sup.state != "broken" and time.monotonic() < end:
                time.sleep(0.01)
            assert sup.state == "broken"
            sup.reset_breaker()
        finally:
            pk.FAULTS.clear()
            sup.close()
        # up to the half-open: the rebuild it starts races the close
        circuit = [e for e in _untimed(pk.TRACER.recent(0)) if e["kind"] == "circuit"]
        got[name] = circuit[:2]
        pk.TRACER.reset()
    assert got["port"] == got["jax"]
    assert [e["state"] for e in got["port"]] == ["open", "half_open"]


def test_compile_ledger_events_match_jax():
    """compile and compile_after_warmup events (a capture in the port, a
    jit in the JAX package): the same keys, warm flags and freeze."""
    class Eng:
        _compile_warm = False

    got = {}
    for name, mod, tr in (("port", profiler, trace), ("jax", jax_prof, jax_trace)):
        tr.TRACER.configure(capacity=64)
        led, eng = mod.CompileLedger(), Eng()
        led.record(eng, "slot_decode", 12.5)
        eng._compile_warm = True
        led.pre_compile(eng, ("slot_verify", 8, 128))
        led.record(eng, ("slot_verify", 8, 128), 3.0)
        got[name] = _untimed(tr.TRACER.recent(0))
        tr.TRACER.reset()
    assert got["port"] == got["jax"]
    assert [e["kind"] for e in got["port"]] == ["compile", "compile_after_warmup", "compile"]
    assert got["port"][2] == {"kind": "compile", "tid": 0, "key": "slot_verify:8:128",
                              "warm": True}


def test_fault_event_matches_jax():
    got = {}
    for name, reg, tr, err in (("port", faults.FaultRegistry(), trace, faults.FaultError),
                               ("jax", jax_faults.FaultRegistry(), jax_trace,
                                jax_faults.FaultError)):
        tr.TRACER.configure(capacity=64)
        reg.arm("prefill_raise", after=1, times=2)
        for _ in range(4):
            try:
                reg.fire("prefill_raise")
            except err:
                pass
        got[name] = _untimed(tr.TRACER.recent(0))
        tr.TRACER.reset()
    assert got["port"] == got["jax"] == [
        {"kind": "fault", "tid": 0, "site": "prefill_raise", "key": None, "n": n}
        for n in (1, 2)]


def test_tracing_adds_no_capture_and_no_host_read(pkgs, monkeypatch):
    """With CUDA's graph capture faked (a replay reruns the step eagerly):
    a serve with tracing on captures exactly the graphs of the serve with
    it off, and reads the device exactly as often (Tensor.item, tolist,
    cpu, numpy, __bool__ counted): no event reads a device value."""
    from distributed_llama_tpu_torch.runtime import engine as engine_mod
    from distributed_llama_tpu_torch.runtime import graphs

    def fake_capture(fn):
        out = fn()

        def leaves(o):
            return [o] if isinstance(o, torch.Tensor) else list(o or ())

        def replay():
            for a, b in zip(leaves(out), leaves(fn())):
                a.copy_(b)
        return graphs.CapturedStep(types.SimpleNamespace(replay=replay, reset=lambda: None),
                                   out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.001, 0)
    monkeypatch.setattr(engine_mod, "capture", fake_capture)
    reads = {"n": 0}
    for meth in ("item", "tolist", "cpu", "numpy", "__bool__"):
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, real=real, **k):
            reads["n"] += 1
            return real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counted)
    pk = pkgs["port"]
    runs = []
    for on in (False, True):
        eng = pk.engine(2)
        eng.cuda_graphs = True
        sched = pk.Scheduler(eng, chunk=4)
        sched.warmup()
        profiler.COMPILES.reset()
        trace.TRACER.reset()
        if on:
            trace.TRACER.configure(capacity=4096, decode_every=1)
        reads["n"] = 0
        reqs = [sched.submit([7, 9, 23, 54, 11, 3, 88, 61, 5], 6, pk.greedy()),
                sched.submit([1, 2, 3], 5, pk.greedy())]
        while not all(r.finished.is_set() for r in reqs):
            sched.step()
        runs.append((reads["n"], profiler.COMPILES.summary()["total"],
                     sorted(map(str, eng.graphs)), [r.trace_id for r in reqs]))
        sched.close()
    assert runs[0][:3] == runs[1][:3]
    assert runs[0][1] == 0 and runs[0][2] == ["slot_decode"]
    assert runs[0][3] == [0, 0] and runs[1][3] == [1, 2]
