"""The port's radix prefix cache (runtime/prefix_cache.py), its scheduler
path and the engine's seed and publish, held against the JAX package's on
the CPU, all f32.

Each of the ten cases of tests/test_prefix_cache.py runs the same requests
through the JAX PrefixCache and Scheduler and through the port's: both keep
the JAX test's assertions (greedy tokens equal to a cold sequential
generate, whole blocks only, pinned blocks never evicted, a rebuilt
supervisor starting from an empty tree), and afterwards both show the same
tree with the same block ids, the same free list, the same stats, and the
same bytes in every block the tree references (within 1e-6; published K/V
is a prefill's output). Then: the e4m3 seeding guard in both packages,
seed and publish bit for bit, the cache tensors never rebound, the memory
ledger and the /metrics families against the JAX ones.
"""

import dataclasses
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime import faults as jax_faults
from distributed_llama_tpu.runtime import prefix_cache as jax_pc
from distributed_llama_tpu.runtime import resilience as jax_res
from distributed_llama_tpu.runtime import scheduler as jax_sched
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import faults, prefix_cache, resilience, scheduler
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64
SYS = [7, 9, 23, 54, 11, 3, 88, 61]  # the shared "system prompt": 2 blocks of 4
ARENA_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_prefix_cache.py's model in both packages: dense f32
    weights, seed 3. Returns {"jax": pkg, "port": pkg}, each a namespace
    of that package's constructors over the same weights."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    jp = jax_params.load_params(jspec, jax_params.random_tensors(
        jspec, seed=3, scale=0.05), mode="dense", dtype=jnp.float32)

    def port_engine(batch, cache=torch.float32):
        return Engine(spec, params, device="cpu", batch=batch,
                      compute_dtype=torch.float32, cache_dtype=cache)

    def jax_engine(batch, cache=jnp.float32):
        return JaxEngine(jspec, jp, batch=batch, compute_dtype=jnp.float32,
                         cache_dtype=cache)

    pkgs = {}
    for name, engine, mod_pc, mod_sched, mod_res, flt, samp, arena in (
            ("jax", jax_engine, jax_pc, jax_sched, jax_res, jax_faults.FAULTS,
             lambda: JaxSampler(128, 0.0, 0.9, 1, backend="python"), np.asarray),
            ("port", port_engine, prefix_cache, scheduler, resilience, faults.FAULTS,
             lambda: Sampler(128, 0.0, 0.9, 1), lambda t: t.numpy())):
        one = engine(1)

        def oracle(prompt, n, one=one, samp=samp):
            one.reset()
            return one.generate(prompt, n, samp()).tokens
        pkgs[name] = types.SimpleNamespace(
            name=name, engine=engine, two=engine(2), PrefixCache=mod_pc.PrefixCache,
            Scheduler=mod_sched.Scheduler, RequestError=mod_sched.RequestError,
            EngineSupervisor=mod_res.EngineSupervisor, FAULTS=flt, greedy=samp,
            oracle=oracle, arena=arena)
    return pkgs


@pytest.fixture(autouse=True)
def clean_faults():
    jax_faults.FAULTS.clear()
    faults.FAULTS.clear()
    yield
    jax_faults.FAULTS.clear()
    faults.FAULTS.clear()


def _sched(pk, *, blocks=16, block_len=4, chunk=4):
    pc = pk.PrefixCache(pk.two, num_blocks=blocks, block_len=block_len)
    return pk.Scheduler(pk.two, chunk=chunk, prefix_cache=pc), pc


def _run(sched, req, limit=500):
    for _ in range(limit):
        if req.finished.is_set():
            return list(req.tokens(timeout=5.0))
        sched.step()
    raise AssertionError("scheduler did not finish the request")


def _tree(node) -> dict:
    return {k: (c.block, c.refs, _tree(c)) for k, c in node.children.items()}


def _blocks(node) -> list[int]:
    out = []
    for c in node.children.values():
        out += [c.block] + _blocks(c)
    return out


def _state(pk, pc) -> dict:
    live = sorted(_blocks(pc._root))
    return dict(tree=_tree(pc._root), free=list(pc._free), stats=dataclasses.asdict(pc.stats),
                live=live, k=pk.arena(pc.arena_k)[live], v=pk.arena(pc.arena_v)[live])


def _both(tiny, body):
    """Run `body(pk)` for the JAX package, then the port: both must return
    equal tokens and leave equal prefix-cache state."""
    out = {name: body(pk) for name, pk in tiny.items()}
    (jtoks, jstate), (ptoks, pstate) = out["jax"], out["port"]
    assert ptoks == jtoks
    for key in ("tree", "free", "stats", "live"):
        assert pstate[key] == jstate[key], key
    np.testing.assert_allclose(pstate["k"], jstate["k"], **ARENA_TOL)
    np.testing.assert_allclose(pstate["v"], jstate["v"], **ARENA_TOL)
    return out


def test_hit_parity_vs_cold_prefill(tiny):
    """A hit (seeded blocks + suffix prefill) emits exactly the cold run's
    greedy tokens."""
    def body(pk):
        sched, pc = _sched(pk)
        pA, pB = SYS + [101, 5, 17], SYS + [40, 77]
        rA = sched.submit(pA, 6, pk.greedy())
        a = _run(sched, rA)
        assert a == pk.oracle(pA, 6)
        assert pc.stats.hits == 0 and pc.stats.blocks_published >= 2
        rB = sched.submit(pB, 6, pk.greedy())
        b = _run(sched, rB)
        assert b == pk.oracle(pB, 6)
        assert pc.stats.hits == 1 and pc.stats.tokens_saved == len(SYS)
        s = sched.stats.summary()
        assert s["prefix_cache"]["hit_rate"] == 0.5
        assert s["prefix_cache"]["tokens_saved"] == len(SYS)
        return [a, b], _state(pk, pc)     # _state compares every counter
    _both(tiny, body)


def test_partial_block_returns_whole_blocks_only(tiny):
    """A non-block-aligned shared prefix matches its whole blocks only, and
    a prompt equal to a cached prefix is capped at len - 1."""
    def body(pk):
        sched, pc = _sched(pk)
        base = SYS + [33, 2]
        _run(sched, sched.submit(base, 3, pk.greedy()))
        p1 = base[:9] + [90, 14]
        t1 = _run(sched, sched.submit(p1, 4, pk.greedy()))
        assert t1 == pk.oracle(p1, 4) and pc.stats.tokens_saved == 8
        t2 = _run(sched, sched.submit(list(base), 4, pk.greedy()))
        assert t2 == pk.oracle(base, 4)
        assert pc.stats.tokens_saved == 16 and pc.stats.hits == 2
        return [t1, t2], _state(pk, pc)
    _both(tiny, body)


def test_refcount_protected_eviction_under_full_pool(tiny):
    """With every block pinned by an in-flight slot, a publish that needs
    a block drops instead of evicting; once unpinned, the same pressure
    evicts the LRU leaf."""
    def body(pk):
        sched, pc = _sched(pk, blocks=2)
        p_shared = SYS + [101]
        other = [2, 40, 77, 12, 9, 31, 66, 90]
        _run(sched, sched.submit(p_shared, 1, pk.greedy()))
        assert pc.stats.blocks_published == 2 and not pc._free
        r1 = sched.submit(p_shared, 30, pk.greedy())
        for _ in range(6):
            sched.step()
        assert not r1.finished.is_set() and pc.stats.hits == 1
        r2 = sched.submit(other, 1, pk.greedy())
        while not r2.finished.is_set():
            sched.step()
        assert pc.stats.publish_drops >= 1 and pc.stats.evictions == 0
        assert len(pc._walk(p_shared, 2)) == 2
        mid = _state(pk, pc)
        while not r1.finished.is_set():
            sched.step()
        t1 = _run(sched, r1)
        assert t1 == pk.oracle(p_shared, 30)
        _run(sched, sched.submit(other, 1, pk.greedy()))
        assert pc.stats.evictions >= 1
        return [t1, mid["tree"], mid["stats"]], _state(pk, pc)
    _both(tiny, body)


def test_publish_never_evicts_its_own_walk_path(tiny):
    """A publish whose allocation pressure lands on its own walk path
    drops instead of evicting the node it stands on."""
    def body(pk):
        sched, pc = _sched(pk, blocks=2)
        prompt_b = SYS + [5, 17, 40, 77]
        _run(sched, sched.submit(SYS + [101], 1, pk.greedy()))
        assert pc.stats.blocks_in_use == 2 and not pc._free
        _run(sched, sched.submit(prompt_b + [33], 1, pk.greedy()))
        assert len(pc._walk(prompt_b, 3)) == 2
        assert pc.stats.publish_drops >= 1 and pc.stats.evictions == 0
        assert pc.stats.blocks_in_use == 2 and not pc._free
        mid = _state(pk, pc)
        _run(sched, sched.submit([2, 6, 10, 14, 18, 22, 26, 30], 1, pk.greedy()))
        assert pc.stats.evictions >= 1
        return [mid["tree"], mid["stats"]], _state(pk, pc)
    _both(tiny, body)


def test_supervisor_rebuild_invalidates_tree(tiny):
    """Crash recovery starts the new generation from an empty tree (the
    arena died with the engine); after it, requests still give the cold
    run's tokens and re-warm their own tree. In the port the failed
    generation's arena is released."""
    def body(pk):
        sup = pk.EngineSupervisor(lambda: pk.engine(2), chunk=8, stall_timeout=60.0,
                                  backoff_base=0.01, prefix_blocks=16,
                                  prefix_block_len=4)
        try:
            prompt = SYS + [101, 5]
            t0 = list(sup.submit(prompt, 3, pk.greedy()).tokens(timeout=30.0))
            assert t0 == pk.oracle(prompt, 3)
            pc_old = sup.prefix_cache
            assert pc_old.stats.blocks_published >= 2
            pk.FAULTS.arm("step_raise")
            r1 = sup.submit(prompt, 8, pk.greedy())
            with pytest.raises(pk.RequestError):
                list(r1.tokens(timeout=30.0))
            end = time.perf_counter() + 30.0
            while time.perf_counter() < end and sup.sup_stats.recoveries < 1:
                time.sleep(0.01)
            assert sup.sup_stats.recoveries == 1
            pc_new = sup.prefix_cache
            assert pc_new is not pc_old and pc_old.stats.invalidations >= 1
            assert pc_new.stats.blocks_in_use == 0 and pc_new.stats.lookups == 0
            assert not pc_new._root.children
            if pk.name == "port":
                assert pc_old.arena_k is None and pc_new.arena_k is not None
            t2 = list(sup.submit(prompt, 3, pk.greedy()).tokens(timeout=30.0))
            assert t2 == pk.oracle(prompt, 3)
            assert pc_new.stats.hits == 0 and pc_new.stats.blocks_published >= 2
            return [t0, t2, dataclasses.asdict(pc_old.stats)], _state(pk, pc_new)
        finally:
            sup.close()
    _both(tiny, body)


def test_late_unpin_after_invalidate_cannot_double_allocate(tiny):
    """unpin() after invalidate() never resurrects a detached node into
    the eviction heap (its block is also on the rebuilt free list)."""
    def body(pk):
        sched, pc = _sched(pk, blocks=2)
        prompt = SYS + [101]
        _run(sched, sched.submit(prompt, 1, pk.greedy()))
        n, ids, pins = pc.lookup_pin(prompt)
        assert n == len(SYS) and len(pins) == 2
        pc.invalidate()
        pc.unpin(pins)
        blocks = [pc._alloc() for _ in range(2)]
        assert sorted(blocks) == [0, 1] and pc._alloc() is None
        assert pc.stats.evictions == 0 and pc.stats.blocks_in_use == 0
        return [ids, blocks], _state(pk, pc)
    _both(tiny, body)


def test_cancel_and_deadline_release_pins(tiny):
    """Cancel mid-decode and deadline expiry both release the seed pins."""
    def body(pk):
        sched, pc = _sched(pk)
        _run(sched, sched.submit(SYS + [101], 1, pk.greedy()))
        r1 = sched.submit(SYS + [40], 30, pk.greedy())
        for _ in range(5):
            sched.step()
        assert pc.stats.hits == 1
        r1.cancel()
        sched.step()
        assert r1.finished.is_set() and r1.finish_reason == "cancelled"
        assert all(not s.pins for s in sched.slots)
        assert all(n.refs == 0 for n in pc._root.children.values())
        r2 = sched.submit(SYS + [77], 30, pk.greedy(), deadline=time.perf_counter() + 0.15)
        for _ in range(5):
            sched.step()
        time.sleep(0.2)
        sched.step()
        assert r2.finished.is_set()
        assert all(not s.pins for s in sched.slots)
        assert all(n.refs == 0 for n in pc._root.children.values())
        return [r1.finish_reason, r2.finish_reason], _state(pk, pc)
    _both(tiny, body)


def test_eviction_heap_stays_bounded(tiny):
    """Pushes past the bound compact the lazy heap back to live
    candidates."""
    def body(pk):
        sched, pc = _sched(pk, blocks=2)
        _run(sched, sched.submit(SYS + [101], 1, pk.greedy()))
        for _ in range(200):
            _, _, pins = pc.lookup_pin(SYS + [40])
            pc.unpin(pins)
        assert len(pc._heap) <= max(4 * pc.num_blocks, 64) + 1
        return [len(pc._heap)], _state(pk, pc)
    _both(tiny, body)


def test_warmup_on_full_pool_preserves_published_blocks(tiny):
    """Re-warming an idle scheduler whose pool is full skips the scratch
    publish, so a same-prefix request still seeds exactly."""
    def body(pk):
        sched, pc = _sched(pk, blocks=2)
        _run(sched, sched.submit(SYS + [101], 1, pk.greedy()))
        assert not pc._free
        before = _state(pk, pc)
        sched.warmup()
        after = _state(pk, pc)
        np.testing.assert_array_equal(after["k"], before["k"])
        p = SYS + [40, 77]
        t = _run(sched, sched.submit(p, 4, pk.greedy()))
        assert t == pk.oracle(p, 4) and pc.stats.hits == 1
        return [t], _state(pk, pc)
    _both(tiny, body)


def test_warmup_is_state_neutral(tiny):
    """warmup with the cache attached perturbs no later output and
    indexes nothing."""
    def body(pk):
        sched, pc = _sched(pk)
        sched.warmup()
        assert pc.stats.blocks_in_use == 0
        p = SYS + [101, 5, 17]
        t = _run(sched, sched.submit(p, 6, pk.greedy()))
        assert t == pk.oracle(p, 6)
        return [t], _state(pk, pc)
    _both(tiny, body)


# -- the port's own: guard, bit-exact copies, pinned addresses ---------------


def test_f8_seed_saturates_nan_codes_like_jax(tiny):
    """An e4m3 arena block holding every byte code seeds a slot row in
    both packages with 0x7F and 0xFF saturated to +448 and -448 and every
    other code as it is."""
    pk_j, pk_p = tiny["jax"], tiny["port"]
    codes = np.arange(256, dtype=np.uint8)
    got = {}
    jeng = pk_j.engine(2, jnp.float8_e4m3fn)
    ak, av = jeng.new_prefix_arena(2, 16)
    blk = np.resize(codes, ak.shape[1:]).view(jnp.float8_e4m3fn)
    ak, av = ak.at[1].set(blk), av.at[1].set(blk)
    ids = np.zeros((SEQ // 16,), np.int32)
    ids[0] = 1
    jeng.slot_seed_prefix(ak, av, 1, ids)
    got["jax"] = [np.asarray(c[1, :, :16].astype(jnp.float32))
                  for c in (*jeng.cache.k, *jeng.cache.v)]
    peng = pk_p.engine(2, torch.float8_e4m3fn)
    ak, av = peng.new_prefix_arena(2, 16)
    for a in (ak, av):
        a[1].view(torch.uint8).copy_(torch.from_numpy(np.resize(codes, a.shape[1:])))
    peng.slot_seed_prefix(ak, av, 1, [1])
    got["port"] = [c[1, :, :16].float().numpy() for c in (*peng.cache.k, *peng.cache.v)]
    want = torch.from_numpy(codes).view(torch.float8_e4m3fn).float()
    want[0x7F], want[0xFF] = 448.0, -448.0
    want = np.resize(want.numpy(), got["port"][0].shape)
    for j, p in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(p, want)
        np.testing.assert_array_equal(j, want)


def test_seed_and_publish_are_bit_exact(tiny):
    """A published block holds the cache slice it came from, bit for bit,
    and a seeded row holds its blocks, in the order asked for."""
    eng = tiny["port"].engine(2)
    gen = torch.Generator().manual_seed(5)
    for c in (*eng.cache.k, *eng.cache.v):
        c.copy_(torch.randn(c.shape, generator=gen))
    ak, av = eng.new_prefix_arena(4, 8)
    eng.slot_publish_block(ak, av, 0, 8, [3])
    eng.slot_publish_block(ak, av, 0, 16, [1])
    for l in range(eng.spec.n_layers):
        assert torch.equal(ak[3, l], eng.cache.k[l][0, :, 8:16])
        assert torch.equal(av[1, l], eng.cache.v[l][0, :, 16:24])
    eng.slot_seed_prefix(ak, av, 1, [1, 3])
    for l in range(eng.spec.n_layers):
        assert torch.equal(eng.cache.k[l][1, :, :8], eng.cache.k[l][0, :, 16:24])
        assert torch.equal(eng.cache.v[l][1, :, 8:16], eng.cache.v[l][0, :, 8:16])
    # several consecutive blocks in one call, in the order asked for
    eng.slot_publish_block(ak, av, 1, 8, [2, 0])
    for l in range(eng.spec.n_layers):
        for c, a in ((eng.cache.k[l], ak), (eng.cache.v[l], av)):
            assert torch.equal(a[2, l], c[1, :, 8:16]) and torch.equal(a[0, l], c[1, :, 16:24])
            assert torch.equal(a[3, l], c[0, :, 8:16])     # untouched


def test_seed_publish_and_reset_never_rebind_the_cache(tiny):
    """The captured graphs read and write the cache's addresses: seeds,
    publishes, resets and a scheduler run with hits keep every cache
    tensor (and the arena) where it was."""
    pk = tiny["port"]
    sched, pc = _sched(pk)
    eng = pk.two
    ptrs = [t.data_ptr() for t in (*eng.cache.k, *eng.cache.v, pc.arena_k, pc.arena_v)]
    sched.warmup()
    for extra in ([101], [40, 77], [5]):
        _run(sched, sched.submit(SYS + extra, 3, pk.greedy()))
    assert pc.stats.hits == 2
    eng.reset()
    assert [t.data_ptr() for t in (*eng.cache.k, *eng.cache.v, pc.arena_k,
                                   pc.arena_v)] == ptrs


def test_memory_ledger_and_metrics_match_jax(tiny):
    """hbm_ledger counts the arena as the JAX ledger does, and the /stats
    summary of a scheduler with hits renders the JAX families line for
    line. The port's summary is the JAX one plus tokens_prefilled, so its
    /metrics shows the tokens_prefilled family that both renderers
    declare."""
    from distributed_llama_tpu.runtime import profiler as jax_prof
    from distributed_llama_tpu.runtime import trace as jax_trace
    from distributed_llama_tpu_torch.runtime import profiler, trace

    ledgers, summaries = {}, {}
    for name, pk in tiny.items():
        sched, pc = _sched(pk, blocks=8, block_len=4)
        for extra in ([101], [40, 77]):
            _run(sched, sched.submit(SYS + extra, 2, pk.greedy()))
        led = (jax_prof if name == "jax" else profiler).hbm_ledger(pk.two, pc)
        ledgers[name] = {k: led[k] for k in ("prefix_arena_bytes", "per_block_bytes",
                                             "kv_slot_bytes")}
        summaries[name] = sched.stats.summary()
        prompt_tokens = 2 * len(SYS) + 3
        summaries[name]["hbm"] = {k: led[k] for k in ("prefix_arena_bytes",
                                                      "kv_slot_bytes")}
    assert ledgers["port"] == ledgers["jax"]
    assert ledgers["port"]["prefix_arena_bytes"] == 2 * 8 * 2 * 2 * 4 * 16 * 4
    port_pc = dict(summaries["port"]["prefix_cache"])
    prefilled = port_pc.pop("tokens_prefilled")
    assert port_pc == summaries["jax"]["prefix_cache"]
    assert prefilled + port_pc["tokens_saved"] == prompt_tokens and port_pc["hits"] == 1
    text = trace.render_prometheus(summaries["port"], model="tiny")
    assert text == jax_trace.render_prometheus(summaries["port"], model="tiny")
    assert "dllama_prefix_cache_hits_total 1" in text
    assert f"dllama_prefix_cache_tokens_prefilled_total {prefilled}" in text
    assert 'dllama_hbm_bytes{category="prefix_arena"} 16384' in text


def test_kv_match_len_peeks_without_side_effects(tiny):
    pk = tiny["port"]
    sched, pc = _sched(pk)
    assert sched.kv_match_len(SYS + [1]) == 0
    _run(sched, sched.submit(SYS + [101], 1, pk.greedy()))
    before = pc.stats.summary()
    assert sched.kv_match_len(SYS + [1]) == 8 and sched.kv_match_len(SYS) == 4
    assert pc.stats.summary() == before
    assert pk.Scheduler(pk.two, chunk=4).kv_match_len(SYS + [1]) == 0


def test_prefix_cache_refuses_transfer_and_foreign_engines(tiny):
    pk = tiny["port"]
    # transfer=True is ported: the cache takes part in the block-transfer
    # plane (runtime/kv_transfer.py)
    assert pk.PrefixCache(pk.two, num_blocks=4, block_len=4, transfer=True).transfer
    pc = pk.PrefixCache(pk.engine(2), num_blocks=4, block_len=4)
    with pytest.raises(ValueError, match="different engine"):
        pk.Scheduler(pk.two, chunk=4, prefix_cache=pc)
