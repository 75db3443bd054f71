"""The port's KV block transfer (distributed_llama_tpu_torch/runtime/
kv_transfer.py, PrefixCache's transfer half, Engine.block_export and
slot_import_block) against the JAX package's: local and wire fills give
the greedy tokens of transfer off and of the JAX engine; the wire ledger
reconciles exactly with block_payload_bytes and estimate_block_transfer;
codec faults and a donor's kvx_exit degrade to a re-prefill; a donor's
QUERY miss clears the router's stale shadow; prefill/decode tiers route,
fill and fall back; and the CLI refuses the dead flags in the JAX CLI's
words."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import ArchType as JaxArch
from distributed_llama_tpu.models import HiddenAct as JaxAct
from distributed_llama_tpu.models import ModelSpec as JaxSpec
from distributed_llama_tpu.models.params import load_params as jax_load
from distributed_llama_tpu.models.params import random_tensors as jax_random
from distributed_llama_tpu.runtime import kv_transfer as jax_kvx
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.resilience import EngineSupervisor as JaxSupervisor
from distributed_llama_tpu.runtime.stats import KVTransferStats as JaxKVStats
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.parallel.multihost import frame_bytes
from distributed_llama_tpu_torch.runtime import kv_transfer as kvx
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.faults import FAULTS
from distributed_llama_tpu_torch.runtime.netstats import (estimate_block_transfer,
                                                          reconcile_wire)
from distributed_llama_tpu_torch.runtime.replica_worker import (
    REPLICA_PROTOCOL_VERSION, ReplicaServer, WorkerClient, WorkerProc, classify_exit)
from distributed_llama_tpu_torch.runtime.resilience import EngineSupervisor
from distributed_llama_tpu_torch.runtime.router import RemoteReplicaHandle, Router
from distributed_llama_tpu_torch.runtime.stats import KVTransferStats
from distributed_llama_tpu_torch.runtime.trace import render_prometheus
from distributed_llama_tpu_torch.sampler import Sampler

SEQ, BL = 64, 8
FIELDS = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
SEED, SCALE = 3, 0.05


@pytest.fixture(scope="module")
def tiny():
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **FIELDS)
    params = load_params(spec, random_tensors(spec, seed=SEED, scale=SCALE), mode="dense",
                         dtype=torch.float32, device="cpu")
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **FIELDS)
    jparams = jax_load(jspec, jax_random(jspec, seed=SEED, scale=SCALE), mode="dense",
                       dtype=jnp.float32)
    return spec, params, jspec, jparams


@pytest.fixture(autouse=True)
def clean_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()
    FAULTS.release()


def _greedy(cls=Sampler):
    return cls(128, temperature=0.0, topp=0.9, seed=1)


def _oracle(tiny, prompt, n):
    _, _, jspec, jparams = tiny
    return JaxEngine(jspec, jparams, batch=1, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32).generate(prompt, n, _greedy(JaxSampler)).tokens


def _sup(tiny, *, blocks=16, transfer=True, key=None):
    spec, params, _, _ = tiny
    return EngineSupervisor(
        lambda: Engine(spec, params, device="cpu", batch=2, compute_dtype=torch.float32,
                       cache_dtype=torch.float32),
        prefix_blocks=blocks, prefix_block_len=BL, kv_transfer=transfer,
        stall_timeout=60.0, fault_key=key)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 128, n).astype(np.int64).tolist()


def _unpinned(node):
    return node.refs == 0 and all(_unpinned(c) for c in node.children.values())


# -- the engine's block copies -------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_block_export_import_roundtrip_bit_for_bit(tiny, dtype):
    """Engine.block_export gives one arena block as host tensors of
    (layers, kv_heads, block_len, head_size); slot_import_block writes
    such a pair into another arena block bit for bit, and refuses a block
    of another shape or dtype; the payload size is block_payload_bytes."""
    spec, params, _, _ = tiny
    eng = Engine(spec, params, device="cpu", batch=2, cache_dtype=dtype,
                 compute_dtype=torch.float32)
    ak, av = eng.new_prefix_arena(4, BL)
    g = torch.Generator().manual_seed(5)
    for a in (ak, av):
        a.copy_(torch.randn(a.shape, generator=g).to(dtype))
    k, v = eng.block_export(ak, av, 2)
    assert tuple(k.shape) == (spec.n_layers, spec.n_kv_heads, BL, spec.head_size)
    assert len(kvx.block_bytes(k)) * 2 == kvx.block_payload_bytes(
        spec.n_layers, spec.n_kv_heads, BL, spec.head_size, dtype)
    eng.slot_import_block(ak, av, k, v, 0)
    for a in (ak, av):
        assert kvx.block_bytes(a[0]) == kvx.block_bytes(a[2])
    with pytest.raises(ValueError, match="does not fit"):
        eng.slot_import_block(ak, av, k.float() if dtype != torch.float32 else k.half(), v, 1)
    assert kvx.block_payload_bytes(2, 2, BL, 16, dtype) == jax_kvx.block_payload_bytes(
        2, 2, BL, 16, {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16,
                       torch.float8_e4m3fn: jnp.float8_e4m3fn}[dtype])


# -- the thread tier's local fill -----------------------------------------------------


def test_local_fill_parity_and_miss_match_jax(tiny):
    """A warm donor's blocks import into a cold sibling: the seeded
    request emits the JAX oracle's tokens; a prefix neither holds is a
    MISS; the verdicts and the transfer counters equal the JAX
    package's on the same requests; every donor pin is released."""
    _, _, jspec, jparams = tiny
    prompt, other = _prompt(3 * BL + 3, seed=0), _prompt(2 * BL + 1, seed=9)
    want = _oracle(tiny, prompt, 8)

    def run(make_sup, mod, stats, smp):
        s0, s1 = make_sup("r0"), make_sup("r1")
        try:
            got0 = list(s0.submit(prompt, 8, smp()).tokens(timeout=60))
            a1 = mod.local_fill(s0, s1, prompt, stats=stats)
            got1 = list(s1.submit(prompt, 8, smp()).tokens(timeout=60))
            a2 = mod.local_fill(s0, s1, other, stats=stats)
            pcs = s1.prefix_cache.stats
            pins = all(_unpinned(c) for c in s0.prefix_cache._root.children.values())
            keys = ("fills_requested", "fills_ok", "fill_fallbacks", "fill_misses",
                    "tokens_filled", "blocks_filled", "bytes_rx", "bytes_tx",
                    "blocks_exported", "queries_served", "query_misses")
            return (got0, got1, a1, a2, pcs.hits, pcs.tokens_saved, pins,
                    {k: getattr(stats, k) for k in keys})
        finally:
            s0.close()
            s1.close()

    mine = run(lambda key: _sup(tiny, key=key), kvx, KVTransferStats(enabled=True),
               _greedy)
    theirs = run(lambda key: JaxSupervisor(
        lambda: JaxEngine(jspec, jparams, batch=2, compute_dtype=jnp.float32,
                          cache_dtype=jnp.float32),
        prefix_blocks=16, prefix_block_len=BL, kv_transfer=True, stall_timeout=60.0,
        fault_key=key), jax_kvx, JaxKVStats(enabled=True), lambda: _greedy(JaxSampler))
    assert mine == theirs
    assert mine[0] == mine[1] == want and mine[2] == 3 * BL and mine[3] == 0


# -- the wire path, in-process servers -------------------------------------------------


class Cluster:
    """Two of the port's ReplicaServers behind a connect-mode Router:
    real TCP and frames, no subprocess."""

    def __init__(self, tiny, *, tiers=("mixed", "mixed"), blocks=16,
                 policy="round_robin", kv_transfer=True):
        self.servers = [ReplicaServer(
            (lambda k: (lambda: _sup(tiny, blocks=blocks, key=k)))(f"r{i}"),
            kv_transfer=kv_transfer, tier=tiers[i], fault_key=f"r{i}")
            for i in range(2)]
        self.ports = [s.start() for s in self.servers]
        self.handles = [RemoteReplicaHandle(i, address=("127.0.0.1", self.ports[i]),
                                            block_len=BL, poll_interval=0.1)
                        for i in range(2)]
        hs = self.handles
        self.router = Router(None, policy=policy, kv_transfer=kv_transfer,
                             handle_factories=[lambda: hs[0], lambda: hs[1]],
                             fill_min_tokens=BL)

    def close(self):
        self.router.close()
        for s in self.servers:
            s.shutdown()


def test_wire_fill_parity_and_ledger_reconcile_exactly(tiny):
    """Round-robin places the repeat request on the cold replica, which
    fetches the donor's blocks over RMSG_BLOCK_* and emits the oracle's
    tokens; the importer's BLOCK_DATA ledger equals blocks x
    frame_bytes(1, block_payload_bytes) and estimate_block_transfer's
    modeled bytes (drift 0.0); the donor's pins are released; the
    router's aggregate and /metrics carry the record."""
    spec = tiny[0]
    c = Cluster(tiny)
    try:
        prompt = _prompt(4 * BL + 1, seed=1)
        want = _oracle(tiny, prompt, 8)
        r0 = c.router.submit(prompt, 8, _greedy())
        assert list(r0.tokens(timeout=60)) == want
        r1 = c.router.submit(prompt, 8, _greedy())
        assert list(r1.tokens(timeout=60)) == want and r1.replica_id != r0.replica_id
        tgt, don = c.servers[r1.replica_id].kvx_stats, c.servers[r0.replica_id].kvx_stats
        assert (tgt.fills_ok, tgt.tokens_filled, don.queries_served,
                don.blocks_exported) == (1, 4 * BL, 1, 4)
        per = kvx.block_payload_bytes(spec.n_layers, spec.n_kv_heads, BL, spec.head_size,
                                      torch.float32)
        assert tgt.bytes_rx == don.bytes_tx == 4 * per == tgt.blocks_filled * per
        measured = tgt.wire.peer_bytes(r0.replica_id, "BLOCK_DATA", "rx")
        assert reconcile_wire(measured, 4 * frame_bytes(1, per))["drift_frac"] == 0.0
        est = estimate_block_transfer(spec, tokens=4 * BL, block_len=BL, cache_bytes=4)
        assert est["modeled_data_bytes"] == measured
        pc0 = c.servers[r0.replica_id].sup.prefix_cache
        assert all(_unpinned(ch) for ch in pc0._root.children.values())
        summ = c.router.summary()
        assert summ["kv_transfer"]["enabled"] and summ["kv_transfer"]["fills_ok"] == 1
        text = render_prometheus(summ)
        assert "dllama_kv_transfer_fills_total 1" in text
        assert "dllama_replica_kv_transfer_blocks_exported_total" in text
    finally:
        c.close()


def test_query_miss_clears_stale_shadow_entry(tiny):
    """A donor that evicted a path the router's shadow still promises
    answers the QUERY with a miss: the shadow entry goes, the request
    re-prefills with the oracle's tokens."""
    c = Cluster(tiny, blocks=4)
    try:
        fam_a = _prompt(2 * BL + 1, seed=10)
        ra = c.router.submit(fam_a, 6, _greedy())
        assert list(ra.tokens(timeout=60)) == _oracle(tiny, fam_a, 6)
        donor = c.handles[ra.replica_id]
        wc = WorkerClient("127.0.0.1", c.ports[donor.id])
        for s in (11, 12):
            for _ in wc.submit(_prompt(2 * BL + 1, seed=s), 4, _greedy()).tokens(timeout=60):
                pass
        assert c.servers[donor.id].sup.prefix_cache.match_len(fam_a) == 0
        assert donor.shadow.match_len(fam_a) == 2 * BL
        rb = c.router.submit(fam_a, 6, _greedy())
        assert list(rb.tokens(timeout=60)) == _oracle(tiny, fam_a, 6)
        tgt = c.servers[rb.replica_id].kvx_stats
        assert (tgt.fills_requested, tgt.fills_ok, tgt.fill_misses) == (1, 0, 1)
        assert donor.shadow.match_len(fam_a) == 0 and c.router.kvx.shadow_truncates >= 1
    finally:
        c.close()


def test_disaggregated_tiers_route_fill_and_fall_back(tiny):
    """--tier prefill,decode: the prompt runs on the prefill replica, the
    decode replica admits seeded through a fill and prefills only the
    suffix, the prefill replica serves no request; with it drained the
    mixed path serves."""
    c = Cluster(tiny, tiers=("prefill", "decode"))
    try:
        assert [h.tier for h in c.handles] == ["prefill", "decode"]
        prompt = _prompt(3 * BL + 3, seed=3)
        want = _oracle(tiny, prompt, 8)
        r = c.router.submit(prompt, 8, _greedy())
        assert list(r.tokens(timeout=60)) == want and r.replica_id == 1
        assert c.router.kvx.prefill_passes == 1
        tgt = c.servers[1].kvx_stats
        assert tgt.fills_ok == 1 and tgt.tokens_filled == 3 * BL
        pcs = c.servers[1].sup.prefix_cache.stats
        assert pcs.tokens_saved == 3 * BL
        c.handles[0].draining = True
        assert list(c.router.submit(prompt, 8, _greedy()).tokens(timeout=60)) == want
        assert c.router.kvx.prefill_pass_fallbacks == 1
    finally:
        c.close()


# -- faults at the transfer sites: a donor in its own process -------------------------


def test_codec_faults_and_donor_exit_degrade_to_reprefill(tiny, tmp_path):
    """A donor worker process (the test's codec faults fire in this
    process only): a recv_stall past the transfer's deadline and a torn
    QUERY both degrade to a re-prefill (the first keeps the donor's
    answer as its verdict, the second has none); then the donor's
    kvx_exit lands between its first and second BLOCK_DATA frames and the
    fill degrades too. Every request serves the oracle's tokens, none
    fails."""
    cfg = {"test_spec": FIELDS, "seed": SEED, "scale": SCALE, "device": "cpu",
           "compute_dtype": "f32", "batch": 2, "prefix_cache": True, "prefix_blocks": 16,
           "prefix_block_len": BL, "kv_transfer": True, "fault_key": "r0",
           "serve": {"stall_timeout": 60.0}}
    # three block exports before the kill's fill (the stalled fill's),
    # then the kill's first block passes and its second exits
    proc = WorkerProc(0, cfg, workdir=str(tmp_path), faults="kvx_exit:key=r0;after=4")
    proc.spawn()
    sup1 = _sup(tiny, key="r1")
    try:
        port = proc.wait_ready(timeout=120.0)
        prompt = _prompt(3 * BL + 2, seed=2)
        want = _oracle(tiny, prompt, 8)
        assert list(WorkerClient("127.0.0.1", port).submit(
            prompt, 8, _greedy()).tokens(timeout=60)) == want
        st = KVTransferStats(enabled=True)

        def fill(**kw):
            return kvx.fill_from_wire(sup1._sched, prompt, "127.0.0.1", port, 3 * BL,
                                      stats=st, protocol_version=REPLICA_PROTOCOL_VERSION,
                                      **kw)
        # this process's recvs: HELLO_ACK, BLOCK_ACK, then the first DATA
        FAULTS.arm("recv_stall", after=2, times=1, ms=5000.0)
        t0 = time.perf_counter()
        assert fill(io_timeout=1.0, deadline_s=1.0) == 3 * BL
        FAULTS.clear()
        FAULTS.release()
        assert time.perf_counter() - t0 < 10.0
        assert (st.fill_fallbacks, st.fills_ok) == (1, 0)
        # this process's sends: HELLO, then the QUERY, torn
        FAULTS.arm("frame_truncate", after=1, times=1)
        assert fill(io_timeout=2.0, deadline_s=2.0) == -1
        FAULTS.clear()
        assert st.fill_fallbacks == 2
        assert fill(io_timeout=5.0, deadline_s=5.0) in (-1, 3 * BL)
        assert (st.fills_ok, st.fill_fallbacks) == (0, 3)
        assert _wait_exit(proc) and classify_exit(proc.poll()) == "fault_exit"
        assert list(sup1.submit(prompt, 8, _greedy()).tokens(timeout=60)) == want
        assert sup1._sched.stats.requests_failed == 0
    finally:
        sup1.close()
        proc.stop(timeout=10.0)


def _wait_exit(proc, timeout=30.0):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if proc.poll() is not None:
            return True
        time.sleep(0.02)
    return False


# -- the CLI --------------------------------------------------------------------------


DEAD_FLAGS = {
    "transfer-needs-cache": ["--kv-transfer", "--replicas", "2"],
    "transfer-needs-two": ["--kv-transfer", "--prefix-cache"],
    "one-process-replica": ["--kv-transfer", "--prefix-cache", "--replica-procs", "1"],
    "tier-needs-transfer": ["--prefix-cache", "--replicas", "2", "--tier",
                            "prefill,decode"],
    "tier-needs-decode": ["--prefix-cache", "--replicas", "2", "--kv-transfer",
                          "--tier", "prefill"],
    "tier-count": ["--prefix-cache", "--replicas", "3", "--kv-transfer", "--tier",
                   "prefill,decode"],
    "tier-role": ["--prefix-cache", "--replicas", "2", "--kv-transfer", "--tier",
                  "prefill,bogus"],
    "tier-hosts": ["--prefix-cache", "--kv-transfer", "--replica-hosts", "h:1,h:2",
                   "--tier", "prefill,decode"],
    "replicas-zero": ["--replicas", "0"],
    "procs-and-hosts": ["--replica-procs", "2", "--replica-hosts", "h:1"],
    "threads-and-procs": ["--replicas", "2", "--replica-procs", "2"],
    "hosts-draft": ["--replica-hosts", "h:1", "--draft", "self:1"],
    "budget-alone": ["--retry-budget", "2"],
    "min-over-max": ["--replicas", "2", "--min-replicas", "3", "--max-replicas", "2"],
    "max-hosts": ["--replica-hosts", "h:1,h:2", "--max-replicas", "3"],
    "max-no-tier": ["--max-replicas", "3"],
    "budgets-hosts": ["--replica-hosts", "h:1", "--tenant-budgets", "a=1"],
    "budgets-bad": ["--tenant-budgets", "a=0"],
    "hosts-bad": ["--replica-hosts", "nohost"],
    "tp-replicas": ["--replicas", "2", "--tp", "2"],
}


@pytest.mark.parametrize("name", list(DEAD_FLAGS))
def test_cli_dead_flag_validation(name):
    """Each refusal of the transfer plane, the replica tier and the
    fleet's flags in the JAX server's words, before any engine work."""
    argv = ["api", "--model", "x.m", "--tokenizer", "x.t", "--serve-batch", "2",
            *DEAD_FLAGS[name]]
    with pytest.raises(SystemExit) as mine:
        dllama.main(argv)

    with pytest.raises(SystemExit) as theirs:
        jax_api.serve(jax_dllama.build_argparser().parse_args(argv))
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value).startswith("error: ")


def test_cli_refuses_fleet_flags_without_serve_batch():
    argv = ["api", "--model", "x.m", "--tokenizer", "x.t", "--tenant-budgets", "a=1"]
    with pytest.raises(SystemExit) as mine:
        dllama.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jax_api.serve(jax_dllama.build_argparser().parse_args(argv))
    assert str(mine.value) == str(theirs.value)
    for mode in ("generate", "chat"):
        with pytest.raises(SystemExit, match="are api-mode flags"):
            dllama.main([mode, "--model", "x.m", "--tokenizer", "x.t", "--replicas", "2"])
