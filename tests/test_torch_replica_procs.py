"""The port's process replicas (distributed_llama_tpu_torch/runtime/
replica_worker.py and router.RemoteReplicaHandle) against the JAX
package's: the RMSG frames the two packages' clients and servers write
for the same request, refusal, stats and block payloads are byte-equal;
then the port's worker processes (`python -m
distributed_llama_tpu_torch.runtime.replica_worker`, on the CPU): greedy
tokens equal to the JAX oracle over the wire, a `worker_exit` fault read
as a retryable EOF before the first token, a real SIGKILL mid-stream with
zero unstreamed failures, the exit classified, the respawn routable and
the /stats totals carried across it."""

import json
import os
import signal
import socket
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import ArchType as JaxArch
from distributed_llama_tpu.models import HiddenAct as JaxAct
from distributed_llama_tpu.models import ModelSpec as JaxSpec
from distributed_llama_tpu.models.params import load_params as jax_load
from distributed_llama_tpu.models.params import random_tensors as jax_random
from distributed_llama_tpu.runtime import kv_transfer as jax_kvx
from distributed_llama_tpu.runtime import replica_worker as jax_rw
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.runtime.stats import KVTransferStats as JaxKVStats
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.parallel.multihost import _recv_frame
from distributed_llama_tpu_torch.runtime import kv_transfer as kvx
from distributed_llama_tpu_torch.runtime import replica_worker as rw
from distributed_llama_tpu_torch.runtime.router import RemoteReplicaHandle, Router
from distributed_llama_tpu_torch.runtime.scheduler import PromptTooLong, RequestError
from distributed_llama_tpu_torch.runtime.stats import KVTransferStats
from distributed_llama_tpu_torch.sampler import Sampler

SEQ = 64
FIELDS = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
SEED, SCALE = 3, 0.05
CFG = {"test_spec": FIELDS, "seed": SEED, "scale": SCALE, "device": "cpu",
       "compute_dtype": "f32", "batch": 2, "serve": {"stall_timeout": 60.0}}
SPAWN_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def oracle():
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **FIELDS)
    jparams = jax_load(jspec, jax_random(jspec, seed=SEED, scale=SCALE), mode="dense",
                       dtype=jnp.float32)
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            eng = JaxEngine(jspec, jparams, batch=1, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
            memo[key] = eng.generate(prompt, n, JaxSampler(128, 0.0, 0.9, 1)).tokens
        return memo[key]
    return run


def _greedy():
    return Sampler(128, temperature=0.0, topp=0.9, seed=1)


def _wait(pred, timeout=120.0):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- the frames, byte for byte ------------------------------------------------


class Recorder:
    """A TCP peer that records every frame it receives, raw, and answers
    each with the canned frames the test gives for its kind."""

    def __init__(self, replies):
        self.replies = replies
        self.frames = []
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,), daemon=True).start()

    def _conn(self, conn):
        from distributed_llama_tpu_torch.parallel.multihost import _send_frame
        while True:
            got = []
            try:
                fr = _recv_frame(conn, timeout=10.0,
                                 acct=lambda kind, n: got.append(n))
            except Exception:  # noqa: BLE001
                return
            if fr is None:
                return
            self.frames.append(fr)
            for kind, ints, payload in self.replies.get(fr[0], ()):
                _send_frame(conn, kind, ints, payload, timeout=10.0)

    def close(self):
        self.srv.close()


def _client_frames(mod, sampler_cls, verb):
    """The frames mod's WorkerClient writes for one verb, against a peer
    that answers the JAX worker's frames."""
    done = json.dumps({"finish_reason": "length"}).encode()
    rec = Recorder({100: [(101, [5, 1, 2, 64, 4242], b"")],
                    102: [(103, [7, -1, 0], b""), (105, [42], b""), (106, [], done)],
                    110: [(111, [0], json.dumps({"ready": True}).encode())],
                    112: [(113, [], b"{}")],
                    114: [(117, [], b'{"ok": true}')]})
    try:
        c = mod.WorkerClient("127.0.0.1", rec.port, io_timeout=10.0)
        if verb == "submit":
            rs = c.submit([1, 9, 23], 6, sampler_cls(128, 0.7, 0.9, 12345),
                          eos_id={2, 5}, trace_id=77, fill=("10.0.0.5", 9100, 64, 3),
                          tenant="acme", priority="high")
            toks = list(rs.tokens(timeout=10.0))
            out = (toks, rs.finish_reason, rs.fill_answer, rs.fill_expected)
        elif verb == "control":
            out = (c.ping(), c.stats_summary(), c.reset_breaker())
        c.close()
        return rec.frames, out
    finally:
        rec.close()


@pytest.mark.parametrize("verb", ["submit", "control"])
def test_client_frames_are_the_jax_clients(verb):
    """HELLO, SUBMIT (the header with the sampler's bits, eos ids, trace
    id, fill instruction, priority and tenant), and the control verbs:
    the same frames from both packages' WorkerClient, and the same
    reading of the answers."""
    mine = _client_frames(rw, Sampler, verb)
    theirs = _client_frames(jax_rw, JaxSampler, verb)
    assert mine == theirs
    assert mine[0][0] == (100, [rw.REPLICA_PROTOCOL_VERSION], b"")


def _server_bytes(mod, call):
    """The raw bytes a server-side call writes to a socket."""
    a, b = socket.socketpair()
    try:
        call(mod, a)
        a.close()
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        b.close()


@pytest.mark.parametrize("payload", [
    {"code": "queue_full", "message": "queue full (3/3)", "retry_after": 1.5},
    {"code": "unready", "message": "engine not ready", "state": "recovering",
     "retry_after": 0.2},
    {"code": "prompt_too_long", "message": "prompt is 70 tokens; context is 64"}])
def test_refusal_and_ok_frames_are_the_jax_servers(payload):
    fake = types.SimpleNamespace(_io=5.0)

    def refuse(mod, sock):
        mod.ReplicaServer._refuse(fake, sock, payload)
        mod.ReplicaServer._ok(fake, sock)
    assert _server_bytes(rw, refuse) == _server_bytes(jax_rw, refuse)


def test_exit_classes_and_constants_match_jax():
    for rc in (None, 0, 2, 86, 1, -9, -15, -11, -99):
        assert rw.classify_exit(rc) == jax_rw.classify_exit(rc)
    assert rw.classify_exit(-9) == "signal:SIGKILL"
    for name in ("REPLICA_PROTOCOL_VERSION", "EXIT_WORKER_FAULT", "_SUBMIT_HEADER",
                 *[n for n in dir(jax_rw) if n.startswith("RMSG_")]):
        assert getattr(rw, name) == getattr(jax_rw, name), name
    for name in [n for n in dir(jax_kvx) if n.startswith("RMSG_")] + [
            "DTYPE_CODES", "TIERS", "EXIT_KVX_FAULT", "KVX_KIND_NAMES"]:
        assert getattr(kvx, name) == getattr(jax_kvx, name), name


class _FakeSched:
    """The slice of a scheduler BlockDonor reads, over fixed blocks."""

    def __init__(self, blocks, bl, spec, dtype):
        self.blocks = blocks
        self.prefix_cache = types.SimpleNamespace(block_len=bl)
        self.engine = types.SimpleNamespace(spec=spec, cache_dtype=dtype)
        self.unpinned = []

    def kv_export_pin(self, tokens):
        n = min(len(self.blocks), len(tokens) // self.prefix_cache.block_len)
        return n * self.prefix_cache.block_len, list(range(n)), ("pin",)

    def kv_export_block(self, i):
        return self.blocks[i]

    def kv_unpin(self, pins):
        self.unpinned.append(pins)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_block_frames_are_the_jax_donors(dtype):
    """A donor serving the same three blocks of K/V (the same bits, as a
    torch tensor and as a JAX array) writes the same BLOCK_ACK,
    BLOCK_DATA and BLOCK_END frames; the port's fetch_prefix reads them
    back bit for bit, and the wire ledgers count the same bytes."""
    import ml_dtypes

    L, KVH, BL, HS = 2, 2, 4, 16
    rng = np.random.default_rng(7)
    spec = types.SimpleNamespace(n_layers=L, n_kv_heads=KVH, head_size=HS)
    raw = rng.standard_normal((3, 2, L, KVH, BL, HS)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
           "float8_e4m3fn": ml_dtypes.float8_e4m3fn}[dtype]
    tblocks = [tuple(torch.from_numpy(raw[i, j]).to(tdt) for j in (0, 1)) for i in range(3)]
    jblocks = [tuple(raw[i, j].astype(jdt) for j in (0, 1)) for i in range(3)]
    tokens = list(range(1, 14))
    query = (120, [1, 0, *tokens], b"")

    def serve(mod, blocks, stats, dt):
        a, b = socket.socketpair()
        sched = _FakeSched(blocks, BL, spec, dt)
        donor = mod.BlockDonor(lambda: types.SimpleNamespace(_sched=sched), stats,
                               io_timeout=5.0)
        from distributed_llama_tpu_torch.parallel.multihost import _send_frame
        _send_frame(b, 122, [0, 3], timeout=5.0)      # the FETCH, queued ahead
        donor.serve(a, query)
        a.close()
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            out += chunk
        b.close()
        return out, sched.unpinned
    mine = serve(kvx, tblocks, KVTransferStats(), tdt)
    theirs = serve(jax_kvx, jblocks, JaxKVStats(), jdt)
    assert mine == theirs
    per = kvx.block_payload_bytes(L, KVH, BL, HS, tdt)
    assert per == jax_kvx.block_payload_bytes(L, KVH, BL, HS, jdt)
    # the importer's side reads the same bits back
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def donor_main():
        conn, _ = srv.accept()
        fr = _recv_frame(conn, timeout=5.0)
        from distributed_llama_tpu_torch.parallel.multihost import _send_frame
        _send_frame(conn, 101, [rw.REPLICA_PROTOCOL_VERSION, 1, 2, SEQ, 1], timeout=5.0)
        fr = _recv_frame(conn, timeout=5.0)
        sched = _FakeSched(tblocks, BL, spec, tdt)
        kvx.BlockDonor(lambda: types.SimpleNamespace(_sched=sched), KVTransferStats(),
                       io_timeout=5.0).serve(conn, fr)
        conn.close()
    th = threading.Thread(target=donor_main)
    th.start()
    wire = KVTransferStats().wire
    n, start, got = kvx.fetch_prefix("127.0.0.1", port, tokens, 0, block_len=BL,
                                     block_shape=(L, KVH, BL, HS), dtype=tdt,
                                     protocol_version=rw.REPLICA_PROTOCOL_VERSION,
                                     wire=wire, peer=0)
    th.join(5.0)
    srv.close()
    assert (n, start, len(got)) == (12, 0, 3)
    for (k, v), (k0, v0) in zip(got, tblocks):
        assert kvx.block_bytes(k) == kvx.block_bytes(k0)
        assert kvx.block_bytes(v) == kvx.block_bytes(v0)
    from distributed_llama_tpu_torch.parallel.multihost import frame_bytes
    assert wire.peer_bytes(0, "BLOCK_DATA", "rx") == 3 * frame_bytes(1, per)


def test_worker_config_from_cli_args_matches_jax():
    """The config the api server ships to its workers: the JAX keys and
    values (the draft spec, its length default, the tenant budgets), plus
    the port's device and activation type."""
    from distributed_llama_tpu.apps import dllama as jax_dllama
    from distributed_llama_tpu_torch.apps import dllama

    argv = ["api", "--model", "m.m", "--tokenizer", "t.t", "--serve-batch", "2",
            "--prefix-cache", "--draft", "self:1", "--tenant-budgets", "a=2",
            "--slo-itl-ms", "80", "--kv-transfer", "--replica-procs", "2"]
    mine = rw.config_from_cli_args(dllama.build_argparser().parse_args(argv), 2)
    theirs = jax_rw.config_from_cli_args(jax_dllama.build_argparser().parse_args(argv), 2)
    extra = {"device", "buffer_float_type"}
    assert set(mine) - extra == set(theirs) - {"pallas"}
    assert {k: v for k, v in mine.items() if k not in extra} == \
        {k: v for k, v in theirs.items() if k != "pallas"}
    assert mine["device"] == "cuda" and mine["draft_len"] == 7


# -- worker processes on the CPU -----------------------------------------------


def _handle(rid, workdir, faults=None):
    proc = rw.WorkerProc(rid, dict(CFG, fault_key=f"r{rid}"), workdir=str(workdir),
                         faults=faults)
    return RemoteReplicaHandle(rid, proc=proc, poll_interval=0.1,
                               spawn_backoff_base=0.05, spawn_timeout=SPAWN_TIMEOUT,
                               respawn_timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two port worker processes (decode paced by slow_step so a kill
    lands mid-stream) behind a round-robin Router, spawned side by
    side."""
    d = tmp_path_factory.mktemp("workers")
    handles = [None, None]

    def build(i):
        handles[i] = _handle(i, d, faults="slow_step:times=0;ms=40")
    ths = [threading.Thread(target=build, args=(i,)) for i in (0, 1)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert all(handles), "worker spawn failed"
    router = Router(None, policy="round_robin", retry_budget=1,
                    handle_factories=[lambda: handles[0], lambda: handles[1]])
    yield router
    router.close()


def test_worker_pair_roundtrip_parity_and_verbs(pair, oracle):
    """Greedy tokens over the wire equal the JAX oracle on each worker;
    refusals keep their types; stats, reset and rebuild answer, and the
    rebuild carries the counters."""
    p = [1, 9, 23, 54, 7]
    reqs = [pair.submit(p, 6, _greedy()) for _ in range(2)]
    assert [list(r.tokens(timeout=60.0)) for r in reqs] == [oracle(p, 6)] * 2
    assert sorted(r.replica_id for r in reqs) == [0, 1]
    c = pair.replicas[1].client
    assert (c.batch, c.seq_len) == (2, SEQ)
    with pytest.raises(PromptTooLong):
        c.submit(list(range(1, SEQ + 2)), 2, _greedy())
    before = c.stats_summary()
    assert before["requests_finished"] >= 1 and c.reset_breaker()
    assert c.rebuild(timeout=SPAWN_TIMEOUT)
    after = c.stats_summary()
    assert (after["requests_finished"], after["tokens_out"]) == \
        (before["requests_finished"], before["tokens_out"])
    assert after["kv_transfer"]["enabled"] is False and after["tier"] == "mixed"


def test_sigkill_mid_stream_zero_unstreamed_failures_and_respawn(pair, oracle):
    """kill -9 of a worker serving one request mid-stream and holding one
    not yet streamed: the streamed one fails non-retryable, the other
    fails over with the oracle's tokens; the exit is classified
    signal:SIGKILL, the worker respawns routable, and the /stats totals
    never go back."""
    router = pair
    h0 = router.replicas[0]
    assert _wait(lambda: all(h.ready for h in router.replicas))
    p = [1, 9, 23, 54, 7]
    before = router.summary()
    router._rr = 0
    req_a = router.submit(p, 8, _greedy())
    req_b = router.submit(p, 8, _greedy())
    it_a = req_a.tokens(timeout=120.0)
    got_a = [next(it_a)]
    req_c = router.submit(p, 8, _greedy())
    assert (req_a.replica_id, req_b.replica_id, req_c.replica_id) == (0, 1, 0)
    os.kill(h0._proc.proc.pid, signal.SIGKILL)
    with pytest.raises(RequestError) as ei:
        for t in it_a:
            got_a.append(t)
    assert ei.value.retryable is False and "already streamed" in str(ei.value)
    assert list(req_b.tokens(timeout=120.0)) == oracle(p, 8)
    assert list(req_c.tokens(timeout=120.0)) == oracle(p, 8)
    assert req_c.retries == 1 and req_c.replica_id == 1
    assert router.ready
    assert _wait(lambda: h0.proc_stats.exit_classes.get("signal:SIGKILL") == 1)
    assert _wait(lambda: h0.ready)
    assert h0.proc_stats.respawns == 1
    after = router.summary()
    for k in ("requests_submitted", "requests_finished", "tokens_out"):
        assert after[k] >= before[k], k
    assert after["replicas"][0]["proc"]["exit_classes"] == {"signal:SIGKILL": 1}
    r = router.submit(p, 8, _greedy())
    assert list(r.tokens(timeout=120.0)) == oracle(p, 8)


def test_worker_exit_fault_is_retryable_eof_pre_token(tmp_path):
    """A worker armed with worker_exit (key r5) exits before its first
    token frame: the client sees the structured retryable replica_lost
    error with nothing streamed, and the exit classifies fault_exit."""
    proc = rw.WorkerProc(5, dict(CFG, fault_key="r5"), workdir=str(tmp_path),
                         faults="worker_exit:key=r5")
    proc.spawn()
    try:
        port = proc.wait_ready(timeout=SPAWN_TIMEOUT)
        rs = rw.WorkerClient("127.0.0.1", port).submit([1, 9, 23], 4, _greedy())
        got = []
        with pytest.raises(RequestError) as ei:
            for t in rs.tokens(timeout=60.0):
                got.append(t)
        assert got == [] and ei.value.code == "replica_lost" and ei.value.retryable
        assert _wait(lambda: proc.poll() is not None, 30.0)
        assert rw.classify_exit(proc.poll()) == "fault_exit"
    finally:
        proc.stop(timeout=10.0)


def test_worker_config_errors_exit_fast(tmp_path):
    """A config with no model exits 2 (config_error) before any engine
    work; a worker asked for the card without one exits with its error
    instead of serving from the CPU."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"batch": 2}))
    assert rw.main(["--config", str(bad)]) == 2
    proc = rw.WorkerProc(6, dict(CFG, device="cuda"), workdir=str(tmp_path))
    proc.spawn()
    try:
        with pytest.raises(RuntimeError, match="exited during startup"):
            proc.wait_ready(timeout=SPAWN_TIMEOUT)
        assert "no CUDA device" in proc.log_tail()
    finally:
        proc.stop(timeout=10.0)
