"""The port's fleet brain (distributed_llama_tpu_torch/runtime/fleet.py)
against the JAX package's runtime/fleet.py: the same inputs through both
classes, compared step by step.

  * host units: parse_tenant_budgets, WFQueue order over random appends
    and pops (priorities, tenants, weights, token budgets on an injected
    clock), TenantLedger refills, ShedLadder rungs and Retry-After under
    random pressure (hypothesis);
  * FleetController decisions over one fake door (tick-driven): scale-up
    on sustained pressure, the scale_flap and spawn_stall fault arming,
    the memory ceiling, spawn failures into backoff, scale-down to the
    floor, the ladder's no_spec rung on every local scheduler;
  * one thread-tier scale round trip on the port's router over a tiny
    engine: grow, serve the oracle's tokens, reap, serve again.
"""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llama_tpu.models import ArchType as JaxArch
from distributed_llama_tpu.models import HiddenAct as JaxAct
from distributed_llama_tpu.models import ModelSpec as JaxSpec
from distributed_llama_tpu.models.params import load_params as jax_load
from distributed_llama_tpu.models.params import random_tensors as jax_random
from distributed_llama_tpu.runtime import fleet as jax_fleet
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.faults import FAULTS as JAX_FAULTS
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import fleet
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.router import build_front_door
from distributed_llama_tpu_torch.sampler import Sampler

PKGS = {"port": (fleet, FAULTS), "jax": (jax_fleet, JAX_FAULTS)}


@pytest.fixture(autouse=True)
def clean_faults():
    FAULTS.clear()
    JAX_FAULTS.clear()
    yield
    FAULTS.clear()
    JAX_FAULTS.clear()


class Req:
    """The slice of a ServeRequest the WFQueue reads."""

    def __init__(self, tenant, priority, cost, tag):
        self.tenant = tenant
        self.priority = priority
        self.prompt = list(range(max(cost - 1, 1)))
        self.max_tokens = 1
        self.tag = tag


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- host units -----------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, "", "acme=3:5000,free=1:200", " a=1 , b=2.5:0 ,", "gold=4",
    "bad", "a=x", "a=0", "a=1:-1", "a=1:y", "a=-2:5"])
def test_parse_tenant_budgets_matches_jax(spec):
    def run(mod):
        try:
            return ("ok", mod.parse_tenant_budgets(spec))
        except ValueError as e:
            return ("error", str(e))
    assert run(fleet) == run(jax_fleet)


OPS = st.lists(st.one_of(
    st.tuples(st.just("append"), st.sampled_from(["a", "b", "c", None]),
              st.sampled_from(["high", "normal", "low", "bogus"]),
              st.integers(1, 40)),
    st.tuples(st.just("pop")),
    st.tuples(st.just("tick"), st.floats(0.0, 3.0))), max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=OPS, budgets=st.sampled_from([None, "a=3:20,b=1:5", "a=1,b=4", "c=2:1"]))
def test_wfq_order_and_ledger_match_jax(ops, budgets):
    """The same appends, pops and clock ticks through both packages'
    WFQueue over a TenantLedger on an injected clock: the same requests
    pop in the same order, lengths and depths agree at every step, and
    the ledgers' summaries are equal at the end."""
    runs = {}
    for name, (mod, _) in PKGS.items():
        clock = Clock()
        ledger = (mod.TenantLedger(mod.parse_tenant_budgets(budgets), burst_secs=2.0,
                                   clock=clock) if budgets else None)
        q = mod.WFQueue(ledger)
        trace = []
        for i, op in enumerate(ops):
            if op[0] == "append":
                q.append(Req(op[1], op[2], op[3], i))
            elif op[0] == "pop":
                try:
                    trace.append(("pop", q.popleft().tag))
                except IndexError as e:
                    trace.append(("empty", str(e)))
            else:
                clock.t += op[1]
            trace.append((len(q), bool(q), q.snapshot_depths()))
        runs[name] = (trace, ledger.summary() if ledger else None)
    assert runs["port"] == runs["jax"]


@settings(max_examples=60, deadline=None)
@given(obs=st.lists(st.tuples(st.floats(0.0, 2.0), st.integers(0, 200),
                              st.floats(0.0, 50.0)), max_size=40),
       kw=st.sampled_from([{}, dict(up_after=1, down_after=1, cooldown=0),
                           dict(hi=0.5, lo=0.4, up_after=3, cooldown=1, clamp_tokens=8)]),
       asks=st.lists(st.tuples(st.integers(-1, 200), st.booleans()), max_size=3))
def test_shed_ladder_matches_jax(obs, kw, asks):
    """Random pressure through both packages' ShedLadder: the same rung
    after every observation, the same admit() answers for a few requests
    at each rung, the same Retry-After and summary."""
    runs = {}
    for name, (mod, _) in PKGS.items():
        lad = mod.ShedLadder(**kw)
        trace = []
        for p, queued, drained in obs:
            trace.append(lad.observe(p, queued=queued, drained=drained))
            trace.append((lad.name, lad.spec_degraded, lad.retry_after()))
            trace += [lad.admit(max_tokens=m, prefix_hit=h) for m, h in asks]
        runs[name] = (trace, lad.summary())
    assert runs["port"] == runs["jax"]


def test_shed_reject_and_constants_match_jax():
    for a in ("PRIORITIES", "DEFAULT_TENANT", "LADDER_RUNGS"):
        assert getattr(fleet, a) == getattr(jax_fleet, a)
    mine, theirs = fleet.ShedReject("shed", 2.5), jax_fleet.ShedReject("shed", 2.5)
    assert (str(mine), mine.reason, mine.retry_after) == \
        (str(theirs), theirs.reason, theirs.retry_after)
    assert vars(fleet.FleetConfig(max_replicas=3)) == vars(jax_fleet.FleetConfig(max_replicas=3))


# -- FleetController decisions over a fake door ----------------------------


class FakeSched:
    def __init__(self):
        self.spec_degraded = False


class FakeSup:
    def __init__(self):
        self.ready = True
        self._sched = FakeSched()


class FakeHandle:
    has_local_engine = True

    def __init__(self, rid, tier="mixed", load=0):
        self.id = rid
        self.tier = tier
        self.reap = False
        self.draining = False
        self.sup = FakeSup()
        self._load = load

    def load(self):
        return self._load

    def drain(self, timeout=30.0):
        return True

    def close(self, timeout=30.0):
        pass

    def note_routed(self, prompt):
        pass


class FakeDoor:
    def __init__(self, n=1, tier="mixed", batch=4):
        self.engine = types.SimpleNamespace(batch=batch)
        self.replicas = [FakeHandle(i, tier) for i in range(n)]
        self.scaling = None
        self._spawn_factory = lambda rid, tier: FakeHandle(rid, tier)
        self._kv_transfer = False
        self._summary = {}
        self.reaped = []

    def summary(self):
        return dict(self._summary)

    def add_replica(self, handle):
        self.replicas.append(handle)

    def reap_replica(self, rid, timeout=30.0):
        self.reaped.append(rid)
        self.replicas = [h for h in self.replicas if h.id != rid]


def _settle(fc):
    for t in list(fc._scaling_threads):
        t.join(timeout=30.0)
        assert not t.is_alive()


def _drive(mod, faults, script):
    """One scenario on one package: a fake door of one replica whose load
    follows `loads` (set on every live replica before each tick), the
    faults armed in `arm`, the door's hbm block and a spawn that may
    raise. Returns every tick's observation and the controller's summary
    and the door's replica ids after each tick."""
    door = FakeDoor(n=script.get("n", 1), tier=script.get("tier", "mixed"))
    if script.get("fail_spawn"):
        def boom(rid, tier):
            raise RuntimeError("spawn died")
        door._spawn_factory = boom
    if "hbm" in script:
        door._summary = {"replicas": [{"hbm": {"slots_addable": script["hbm"]}}]}
    for site, kw in script.get("arm", {}).items():
        faults.arm(site, **kw)
    ladder = mod.ShedLadder(up_after=1, down_after=1, cooldown=0) \
        if script.get("ladder") else None
    fc = mod.FleetController(door, config=mod.FleetConfig(
        min_replicas=script.get("min", 1), max_replicas=script.get("max", 3), up_after=2,
        down_after=2, cooldown_ticks=script.get("cooldown", 0),
        spawn_backoff_ticks=3, ewma_alpha=1.0), ladder=ladder)
    trace = []
    for load in script["loads"]:
        for h in door.replicas:
            h._load = load
        o = fc.tick()
        _settle(fc)
        trace.append((o["obs"], o["queued"], [h.id for h in door.replicas],
                      [h.sup._sched.spec_degraded for h in door.replicas], door.scaling))
    faults.clear()
    s = fc.summary()
    fc.close()
    return trace, s


SCRIPTS = {
    "scale-up": dict(loads=[8, 8, 8, 8, 8, 8]),
    "ceiling": dict(loads=[8] * 10, max=2),
    "hbm-ceiling": dict(loads=[8] * 4, hbm=1),
    "spawn-failure-backoff": dict(loads=[8] * 8, fail_spawn=True),
    "scale-down-to-floor": dict(n=3, loads=[0] * 10, min=1),
    "never-reap-last": dict(n=1, loads=[0] * 6, min=1, max=1),
    "scale-flap": dict(loads=[4] * 8, arm={"scale_flap": dict(times=0)}),
    "spawn-stall-other-key": dict(loads=[8] * 4, arm={"spawn_stall": dict(key="r9", ms=5000.0)}),
    "ladder-no-spec": dict(n=2, loads=[8, 8, 8, 0, 0, 0, 0], ladder=True, max=2),
    "prefill-tier": dict(n=2, tier="prefill", loads=[8, 8, 8], max=3),
    "cooldown": dict(loads=[8] * 6, cooldown=2),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_controller_decisions_match_jax(name):
    """The same synthetic pressure (and fault arming) through both
    packages' FleetController over identical fake doors: every tick's
    observation, replica set, degrade flags and scaling state, and the
    final summary, equal."""
    script = SCRIPTS[name]
    mine = _drive(fleet, FAULTS, script)
    theirs = _drive(jax_fleet, JAX_FAULTS, script)
    assert mine == theirs
    if name == "scale-up":
        assert [h for _, _, h, _, _ in mine[0]][-1] == [0, 1, 2]
    if name == "scale-flap":
        assert mine[1]["scale_ups"] == 0 and mine[1]["scale_downs"] == 0


def test_controller_admit_matches_jax():
    """The door's admission walk: the same clamps and sheds (with their
    per-tenant accounting and Retry-After) on both packages."""
    runs = {}
    for name, (mod, _) in PKGS.items():
        ledger = mod.TenantLedger({"acme": (2.0, 0.0)}, clock=Clock())
        lad = mod.ShedLadder(up_after=1, cooldown=0, clamp_tokens=8)
        fc = mod.FleetController(FakeDoor(), ladder=lad, ledger=ledger)
        out = []
        for p in (2.0, 2.0, 2.0, 2.0):
            lad.observe(p, queued=10, drained=5.0)
            for tenant, mt, hit in (("acme", 100, False), (None, 4, True)):
                try:
                    out.append(fc.admit(tenant=tenant, n_prompt=9, max_tokens=mt,
                                        prefix_hit=hit))
                except mod.ShedReject as e:
                    out.append((e.reason, e.retry_after))
        runs[name] = (out, fc.summary())
        fc.close()
    assert runs["port"] == runs["jax"]


# -- the thread tier grows and shrinks ---------------------------------------


SEQ = 64


@pytest.fixture(scope="module")
def tiny():
    fields = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **fields)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05), mode="dense",
                         dtype=torch.float32, device="cpu")
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **fields)
    jparams = jax_load(jspec, jax_random(jspec, seed=3, scale=0.05), mode="dense",
                       dtype=jnp.float32)
    return spec, params, jspec, jparams


def test_fleet_scale_roundtrip_thread_tier(tiny):
    """A real scale-up on the port's thread tier (a fresh supervised
    replica over the template's weights, through Router._spawn_factory),
    the JAX engine's greedy tokens through the grown fleet, then a
    scale-down that reaps the newest replica with the totals carried."""
    spec, params, jspec, jparams = tiny
    tmpl = Engine(spec, params, device="cpu", compute_dtype=torch.float32,
                  cache_dtype=torch.float32)
    router = build_front_door(tmpl, serve_batch=2, serve_chunk=8, replicas=2)
    fc = fleet.FleetController(router, config=fleet.FleetConfig(
        min_replicas=2, max_replicas=3, up_pressure=-1.0, down_pressure=-2.0, up_after=1,
        down_after=1, cooldown_ticks=0, ewma_alpha=1.0))
    p = [2, 4, 6]
    want = JaxEngine(jspec, jparams, batch=1, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32).generate(
        p, 3, JaxSampler(128, temperature=0.0, topp=0.9, seed=1)).tokens
    try:
        fc.tick()                       # pressure 0 > -1: scale up
        _settle(fc)
        assert [h.id for h in router.replicas] == [0, 1, 2]
        assert fc.stats.scale_ups == 1 and router.ready and router.state == "ready"
        # the new replica shares the template's weights: no copy
        w = router.replicas[2].sup.engine.params["layers"][0]["wqkv"]
        assert w.data_ptr() == tmpl.params["layers"][0]["wqkv"].data_ptr()
        for h in router.replicas[:2]:
            h.draining = True
        r = router.submit(p, 3, Sampler(128, 0.0, 0.9, 1))
        assert list(r.tokens(timeout=60.0)) == want and r.replica_id == 2
        for h in router.replicas[:2]:
            h.draining = False
        before = router.summary()["requests_finished"]
        fc.config.up_pressure = fc.config.down_pressure = 10.0
        fc.tick()                       # idle reads as scale-down pressure
        _settle(fc)
        assert [h.id for h in router.replicas] == [0, 1]
        assert fc.stats.scale_downs == 1 and router.summary()["requests_finished"] >= before
        assert list(router.submit(p, 3, Sampler(128, 0.0, 0.9, 1)).tokens(
            timeout=60.0)) == want
    finally:
        fc.close()
        router.close()
