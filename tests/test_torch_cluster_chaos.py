"""The port's control star under chaos — the counterpart of
tests/test_cluster_chaos.py, on the port's own modules
(distributed_llama_tpu_torch.parallel.multihost and .cluster_harness,
runtime/faults.py's socket sites, runtime/stats.py's wire ledger).

Real two-OS-process clusters driven by the port's harness, control plane
only (no model, no mesh, no process group, no torch in the harness), with
the JAX suite's bounds (HB 0.15 s, --worker-timeout 1.5 s, exits 43 and
44):

  * a worker that DIES mid-phase is detected within --worker-timeout and
    produces a structured ClusterPeerLost diagnostic naming the node;
  * a worker that WEDGES (recv_stall: socket open, reader stopped) is
    detected by heartbeat silence;
  * a TORN frame (frame_truncate) is detected as a protocol loss;
  * a root killed with SIGKILL takes its workers down;
  * formation retries refused connects with backoff and fails structured
    at --connect-timeout (bounded on the harness's own clock, from its
    start after the interpreter is up), and a protocol-version mismatch
    is a symmetric formation error;
  * the wire ledger's counts equal the frame arithmetic exactly, and the
    port's frames are the JAX codec's bytes.

Every subprocess interaction carries a hard timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = "distributed_llama_tpu_torch.parallel.cluster_harness"

# detection bounds used across the suite: tight enough that a regression
# to unbounded waits fails fast, loose enough for a loaded CI box
HB = "0.15"
TIMEOUT = 1.5      # --worker-timeout (seconds)
SLACK = 6.0        # subprocess/communicate margin over the bound
EXIT_PEER_LOST = 43
EXIT_FORMATION = 44


from torch_cluster import free_port_pair as _free_port


def _spawn(role: str, port: int, *extra, faults: str = ""):
    env = dict(os.environ)
    env.pop("DLLAMA_FAULTS", None)  # never inherit ambient arming
    if faults:
        env["DLLAMA_FAULTS"] = faults
    args = [sys.executable, "-m", HARNESS, role, "--port", str(port),
            "--heartbeat-interval", HB, "--worker-timeout", str(TIMEOUT),
            *extra]
    if role == "worker":
        args += ["--rank", "1"]
    return subprocess.Popen(args, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _events(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]


def _event(events: list[dict], name: str) -> dict:
    hits = [e for e in events if e["event"] == name]
    assert hits, (name, events)
    return hits[0]


def _wait_event(proc, name: str, timeout: float) -> tuple[dict, list[str]]:
    """Stream a harness process's stdout until the named event appears
    (bounded). Returns (event, lines_consumed) — the consumed lines must
    be recombined with communicate()'s remainder for full-event asserts."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    lines: list[str] = []
    end = time.monotonic() + timeout
    try:
        while time.monotonic() < end:
            if not sel.select(timeout=0.2):
                continue
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("{"):
                ev = json.loads(line)
                if ev["event"] == name:
                    return ev, lines
    finally:
        sel.close()
    proc.kill()
    raise AssertionError(
        f"event {name!r} never appeared within {timeout}s; got: {lines}")


def _finish(proc, timeout: float):
    """communicate() with a hard bound — a hung harness process is itself
    the regression this suite exists to catch."""
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate(timeout=10)
        raise AssertionError(
            f"harness process hung past {timeout}s (the unbounded-wait "
            f"regression)\nstdout: {out}\nstderr: {err}")


def test_formation_and_clean_shutdown():
    """Happy path: HELLO handshake, heartbeats, phase ticks, SHUTDOWN —
    both sides exit 0 with structured event streams."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,idle:0.4")
    worker = _spawn("worker", port)
    w_out, w_err = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert root.returncode == 0, (r_out, r_err)
    assert worker.returncode == 0, (w_out, w_err)
    r_ev, w_ev = _events(r_out), _events(w_out)
    assert _event(r_ev, "formed")["peers"] == [1]
    stats = _event(r_ev, "complete")["stats"]
    assert stats["pings_sent"] >= 1 and stats["pongs_received"] >= 1
    assert stats["peers_lost"] == []
    assert _event(w_ev, "shutdown")["stats"]["pongs_sent"] >= 1
    assert [e["phase"] for e in w_ev if e["event"] == "tick"] == [
        "formation", "idle"]


def test_worker_death_mid_prefill_detected():
    """A worker dying abruptly mid-phase is detected within
    --worker-timeout and the root's ClusterPeerLost names the node and
    the phase it died in."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,prefill:20")
    worker = _spawn("worker", port, "--die-after", "0.6")
    w_out, _ = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert root.returncode == EXIT_PEER_LOST, (r_out, r_err)
    lost = _event(_events(r_out), "cluster_peer_lost")
    assert lost["node_id"] == 1
    assert lost["phase"] == "prefill"
    died = _event(_events(w_out), "dying")
    detect_s = lost["t_wall"] - died["t_wall"]
    # an abrupt process death closes the socket: detection is EOF-fast,
    # far inside the heartbeat bound
    assert 0 <= detect_s < TIMEOUT, (detect_s, lost)


def test_worker_stall_mid_decode_detected():
    """recv_stall wedges the worker's control-plane reader: the socket
    stays OPEN (no EOF will ever fire) but PONGs stop — only the
    heartbeat timeout can see it. Detection must land within
    --worker-timeout of the last frame; before this control plane
    existed, this exact shape hung the cluster forever (the reference's
    unbounded socket read)."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,decode:30")
    # after=2: let the HELLO_ACK recv and an early ping through, then
    # wedge every subsequent recv (times=0)
    worker = _spawn("worker", port, faults="recv_stall:after=2;times=0")
    try:
        r_out, r_err = _finish(root, TIMEOUT + 30)
        assert root.returncode == EXIT_PEER_LOST, (r_out, r_err)
        lost = _event(_events(r_out), "cluster_peer_lost")
        assert lost["node_id"] == 1
        assert lost["reason"] == "timeout"  # silence, not EOF
        assert lost["phase"] == "decode"
        # last_seen at detection ~= the timeout bound: the detector fired
        # as soon as the contract allows, not after some larger slop
        assert TIMEOUT <= lost["last_seen_s"] < TIMEOUT + 1.0, lost
    finally:
        worker.kill()  # the wedged reader never exits on its own
        worker.communicate(timeout=10)


def test_truncated_frame_detected():
    """frame_truncate tears the worker's next PONG mid-frame and closes
    the socket: the root must classify it as a protocol loss immediately
    (no waiting out the heartbeat bound)."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,run:20")
    # after=1: the HELLO send goes through, the first PONG tears
    worker = _spawn("worker", port, faults="frame_truncate:after=1;times=1")
    try:
        r_out, r_err = _finish(root, 30)
        assert root.returncode == EXIT_PEER_LOST, (r_out, r_err)
        lost = _event(_events(r_out), "cluster_peer_lost")
        assert lost["node_id"] == 1
        # a torn write surfaces as a mid-frame EOF/reset at the reader
        assert ("truncated" in lost["reason"] or lost["reason"]
                in ("eof", "reset")), lost
        assert lost["last_seen_s"] < TIMEOUT, lost  # no timeout wait
    finally:
        worker.kill()
        worker.communicate(timeout=10)


def test_root_sigkill_worker_exits():
    """SIGKILL the root mid-phase: every worker must take its own bounded
    diagnostic exit (EXIT_PEER_LOST, structured line naming node 0) —
    the pre-change behavior parked workers in an unbounded read until
    jax.distributed teardown happened to notice."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,decode:30")
    worker = _spawn("worker", port)
    _, pre_lines = _wait_event(worker, "formed", 60)  # cluster is up
    # wall clock ON PURPOSE: detect_s below subtracts the subprocess's
    # own t_wall event stamp — monotonic clocks do not transfer between
    # processes (the one legitimate cross-process exception to the
    # monotonic-interval rule, docs/observability.md)
    t_kill = time.time()
    root.send_signal(signal.SIGKILL)
    root.communicate(timeout=10)
    w_out, w_err = _finish(worker, TIMEOUT + SLACK)
    assert worker.returncode == EXIT_PEER_LOST, (w_out, w_err)
    lost = _event(_events("".join(pre_lines) + w_out), "cluster_peer_lost")
    assert lost["node_id"] == 0
    detect_s = lost["t_wall"] - t_kill
    assert 0 <= detect_s < TIMEOUT + 1.0, (detect_s, lost)


def test_connect_retry_backoff_then_success():
    """conn_refused fails the first two connect attempts deterministically;
    the worker's backoff loop must absorb them and still form."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,idle:0.3")
    worker = _spawn("worker", port, faults="conn_refused:times=2")
    w_out, w_err = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert worker.returncode == 0, (w_out, w_err)
    assert root.returncode == 0, (r_out, r_err)
    assert _event(_events(w_out), "formed")["retries"] >= 2


def test_connect_timeout_is_bounded_and_structured():
    """No root at all: the worker gives up at --connect-timeout with a
    structured formation error (exit 44), never spins or hangs. The bound
    is on the harness's own clock (its formation_failed stamp against its
    start, taken after the interpreter is up), with an outer wall bound
    on the whole process."""
    port = _free_port()  # nothing listens here
    t0 = time.monotonic()
    worker = _spawn("worker", port, "--connect-timeout", "1.0")
    w_out, w_err = _finish(worker, 20)
    wall = time.monotonic() - t0
    assert worker.returncode == EXIT_FORMATION, (w_out, w_err)
    failed = _event(_events(w_out), "formation_failed")
    assert "--connect-timeout" in failed["error"]
    formation_s = failed["t_wall"] - failed["t_start"]
    assert 1.0 <= formation_s < 1.0 + 1.5, formation_s
    assert wall < 1.0 + SLACK + 10.0, wall


def test_hello_version_mismatch_is_symmetric_error():
    """A worker speaking the wrong protocol version must produce a clear
    formation error on BOTH sides — never a half-formed cluster."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,idle:5",
                  "--connect-timeout", "5")
    worker = _spawn("worker", port, "--protocol-version", "99")
    w_out, w_err = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert worker.returncode == EXIT_FORMATION, (w_out, w_err)
    assert root.returncode == EXIT_FORMATION, (r_out, r_err)
    for out in (w_out, r_out):
        failed = _event(_events(out), "formation_failed")
        assert "version" in failed["error"], failed


# -- the measured wire ledger and the cross-node trace ---------------------


def test_cross_node_trace_spans_link_under_one_id():
    """A traced two-process run: the root mints ONE trace id, phase
    frames carry it, the worker's cluster_tick spans ship back via
    MSG_TRACE and land on the root's timeline (origin=node1) under the
    SAME id as the root's own events — the cross-node acceptance bar."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,decode:0.4",
                  "--trace")
    worker = _spawn("worker", port, "--trace")
    w_out, w_err = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert root.returncode == 0, (r_out, r_err)
    assert worker.returncode == 0, (w_out, w_err)
    r_ev = _events(r_out)
    tid = _event(r_ev, "complete")["tid"]
    assert tid > 0
    dump = _event(r_ev, "trace_dump")
    assert dump["tid"] == tid
    evs = dump["events"]
    assert all(e["tid"] == tid for e in evs if e.get("tid")), evs
    root_ticks = [e for e in evs if e["kind"] == "cluster_tick"
                  and "origin" not in e]
    worker_ticks = [e for e in evs if e["kind"] == "cluster_tick"
                    and e.get("origin") == "node1"]
    assert root_ticks and worker_ticks, evs
    assert {e["phase"] for e in worker_ticks} <= {e["phase"]
                                                  for e in root_ticks}
    # every dumped event is wall-stamped (the /admin/trace export shape)
    assert all("ts_wall" in e for e in evs), evs
    # the clean run has no casualty span
    assert not [e for e in evs if e["kind"] == "cluster_lost"], evs


def test_peer_close_death_yields_linked_casualty_span():
    """peer_close tears the worker down at a protocol send (its PONG):
    the root's bounded detection must emit a cluster_lost CASUALTY event
    linked under the session's trace id — on the same timeline as the
    worker's earlier shipped ticks — before its diagnostic exit. The
    cluster twin of a SIGKILLed replica's worker_exit span."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,decode:20",
                  "--trace")
    # after=2: HELLO + one frame pass, then the next send (a PONG) fires
    worker = _spawn("worker", port, "--trace",
                    faults="peer_close:after=2;times=1")
    try:
        r_out, r_err = _finish(root, 30)
        assert root.returncode == EXIT_PEER_LOST, (r_out, r_err)
        r_ev = _events(r_out)
        lost = _event(r_ev, "cluster_peer_lost")
        assert lost["node_id"] == 1
        dump = _event(r_ev, "trace_dump")
        tid = dump["tid"]
        assert tid > 0
        casualty = [e for e in dump["events"]
                    if e["kind"] == "cluster_lost"]
        assert casualty, dump["events"]
        assert casualty[0]["tid"] == tid
        assert casualty[0]["node"] == 1
        assert casualty[0]["reason"] == lost["reason"]
        # linked: the same id also carries the root's own protocol ticks
        assert [e for e in dump["events"]
                if e["kind"] == "cluster_tick" and e["tid"] == tid]
    finally:
        worker.kill()
        worker.communicate(timeout=10)


def test_wire_ledger_counts_match_frame_arithmetic_exactly():
    """The measured-bytes acceptance bar: after a clean harness run,
    every deterministic protocol frame's ledger count equals
    frame_bytes() arithmetic EXACTLY — on both ends of the star
    (root tx == worker rx for RUN/SHUTDOWN; PONG bytes likewise)."""
    from distributed_llama_tpu_torch.parallel.multihost import (_HEADER_LEN,
                                                          frame_bytes)

    port = _free_port()
    phases = [("formation", 0.1), ("prefill", 0.3), ("decode", 0.3)]
    root = _spawn("root", port, "--phases",
                  ",".join(f"{n}:{s}" for n, s in phases))
    worker = _spawn("worker", port)
    w_out, w_err = _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert root.returncode == 0, (r_out, r_err)
    assert worker.returncode == 0, (w_out, w_err)
    root_wire = _event(_events(r_out), "complete")["stats"]["wire"]
    worker_wire = _event(_events(w_out), "shutdown")["stats"]["wire"]
    rtx = root_wire["peers"]["1"]["tx"]
    wrx = worker_wire["peers"]["0"]["rx"]

    run_expected = sum(frame_bytes(_HEADER_LEN, len(n.encode()))
                       for n, _ in phases)
    assert rtx["RUN"]["bytes"] == run_expected, (rtx, run_expected)
    assert wrx["RUN"]["bytes"] == run_expected
    assert rtx["RUN"]["frames"] == len(phases) == wrx["RUN"]["frames"]
    shut_expected = frame_bytes(_HEADER_LEN, 0)
    assert rtx["SHUTDOWN"]["bytes"] == shut_expected
    assert wrx["SHUTDOWN"]["bytes"] == shut_expected
    # heartbeat traffic: counts are timing-dependent but the SHAPE is
    # exact — every PING is frame_bytes(1, 0), every PONG frame_bytes(2,
    # 0) (seq + worker wall clock)
    ping = rtx["PING"]
    assert ping["bytes"] == ping["frames"] * frame_bytes(1, 0), ping
    pong = root_wire["peers"]["1"]["rx"]["PONG"]
    assert pong["bytes"] == pong["frames"] * frame_bytes(2, 0), pong
    # and both ends agree on the heartbeat bytes that actually crossed
    assert pong["bytes"] == worker_wire["peers"]["0"]["tx"]["PONG"]["bytes"]


def test_heartbeat_rtt_and_clock_offset_measured():
    """PING→PONG round trips land in the per-peer RTT histogram and the
    midpoint clock-offset estimate exists (≈0 between processes on one
    host — the bound here is loose on purpose, the ESTIMATE is what the
    MSG_TRACE rebase consumes)."""
    port = _free_port()
    root = _spawn("root", port, "--phases", "formation:0.1,idle:0.6")
    worker = _spawn("worker", port)
    _finish(worker, 30)
    r_out, r_err = _finish(root, 30)
    assert root.returncode == 0, (r_out, r_err)
    peer = _event(_events(r_out), "complete")["stats"]["wire"]["peers"]["1"]
    rtt = peer["rtt_ms"]
    assert rtt["n"] >= 1 and rtt["p50_ms"] >= 0, rtt
    assert rtt["p99_ms"] >= rtt["p50_ms"]
    assert len(rtt["recent"]) == rtt["n"] or len(rtt["recent"]) == 32
    assert abs(peer["clock_offset_ms"]) < 1000.0, peer
    assert peer["best_rtt_ms"] <= rtt["p99_ms"] + 1e-9


# -- in-process shape/codec tests (no subprocess) --------------------------


def _acct_recorder():
    calls = []
    return calls, lambda kind, n: calls.append((kind, n))


def test_torn_send_counts_partial_bytes_exactly_once():
    """frame_truncate writes half the frame then closes: the ledger hook
    must see exactly those partial bytes, once — and peer_close (closes
    without writing) must count zero. The socket fault sites are the
    torn-frame truth the wire counters must survive."""
    from distributed_llama_tpu_torch.parallel.multihost import (
        ClusterProtocolError, _send_frame, frame_bytes)
    from distributed_llama_tpu_torch.runtime.faults import FAULTS

    a, b = socket.socketpair()
    calls, acct = _acct_recorder()
    try:
        FAULTS.arm("frame_truncate", times=1)
        buf_len = frame_bytes(3, 7)
        with pytest.raises(ClusterProtocolError, match="frame_truncate"):
            _send_frame(a, 1, [1, 2, 3], b"payload", timeout=5.0,
                        acct=acct)
        assert calls == [(1, max(1, buf_len // 2))], calls

        calls.clear()
        c, d = socket.socketpair()
        try:
            FAULTS.arm("peer_close", times=1)
            with pytest.raises(ClusterProtocolError, match="peer_close"):
                _send_frame(c, 1, [], b"x", timeout=5.0, acct=acct)
            assert calls == [], calls  # zero bytes crossed: no entry
        finally:
            d.close()
    finally:
        FAULTS.clear()
        a.close()
        b.close()


def test_torn_recv_counts_partial_bytes_exactly_once():
    """A frame torn mid-payload (EOF after the header): the receiving
    ledger counts the bytes that actually arrived, once, under the
    parsed kind — and a successful recv counts the exact frame size."""
    import struct

    from distributed_llama_tpu_torch.parallel.multihost import (
        _FRAME_HDR, _FRAME_MAGIC, ClusterProtocolError, _recv_frame,
        _send_frame, frame_bytes)

    a, b = socket.socketpair()
    calls, acct = _acct_recorder()
    try:
        # clean frame: exact arithmetic
        _send_frame(a, 7, [1, -2], b"pay", timeout=5.0)
        _recv_frame(b, timeout=5.0, acct=acct)
        assert calls == [(7, frame_bytes(2, 3))], calls

        # torn frame: header + one of two ints, then EOF
        calls.clear()
        buf = _FRAME_HDR.pack(_FRAME_MAGIC, 9, 2, 0) + struct.pack("<q", 5)
        a.sendall(buf)
        a.close()
        with pytest.raises(ClusterProtocolError, match="truncated"):
            _recv_frame(b, timeout=5.0, acct=acct)
        assert calls == [(9, len(buf))], calls
    finally:
        b.close()


def test_recv_stall_fault_counts_nothing():
    """recv_stall wedges the reader BEFORE any bytes move: when the
    stall releases into a closed socket, the ledger must show zero for
    the attempt (nothing crossed the wire)."""
    from distributed_llama_tpu_torch.parallel.multihost import _recv_frame
    from distributed_llama_tpu_torch.runtime.faults import FAULTS

    a, b = socket.socketpair()
    calls, acct = _acct_recorder()
    try:
        FAULTS.arm("recv_stall", times=1, ms=50)
        a.close()  # EOF once the stall releases
        out = _recv_frame(b, timeout=5.0, acct=acct)
        assert out is None  # clean EOF at the frame boundary
        assert calls == [], calls
    finally:
        FAULTS.clear()
        b.close()


def test_wire_acct_disabled_path_is_allocation_free():
    """The cost bar: a link's accounting closure with
    no stats object (the pre-formation / off-cluster shape) must be a
    no-op — no allocation over 10k calls — and the codec's acct=None
    default costs nothing."""
    import gc
    import sys as _sys

    from distributed_llama_tpu_torch.parallel import multihost as mh

    link = mh.WorkerLink("127.0.0.1", 1, 1, 2)
    assert link.stats is None
    acct = link._mk_acct(0, "rx")
    acct(mh.MSG_PING, 24)  # warm the closure path

    def growth() -> int:
        gc.collect()
        before = _sys.getallocatedblocks()
        for _ in range(10_000):
            acct(mh.MSG_PING, 24)
        return _sys.getallocatedblocks() - before

    # the least of three trials: other threads of a loaded test process
    # allocate meanwhile, the closure itself does not
    grew = min(growth() for _ in range(3))
    assert grew < 50, f"disabled wire acct allocated {grew} blocks"


def test_wire_ledger_enabled_cost_is_negligible():
    """Enabled-ledger cost bar: one account() call is bounded well under
    2% of even the tiny decode step (~5 ms on CPU-tiny; a control-plane
    frame is heartbeat-cadence anyway, never per-token). Measured
    loosely (CI boxes jitter): 10k accounts in well under a second."""
    from distributed_llama_tpu_torch.runtime.stats import WireStats

    w = WireStats()
    t0 = time.perf_counter()
    for i in range(10_000):
        w.account(1, "PING", "tx", 24)
    per_call_us = (time.perf_counter() - t0) / 10_000 * 1e6
    # 100 µs/call would still be <2% of a decode step at heartbeat
    # cadence; typical is <2 µs — the bar catches accidental O(n) work
    assert per_call_us < 100, per_call_us
    s = w.summary()
    assert s["peers"]["1"]["tx"]["PING"] == {"frames": 10_000,
                                             "bytes": 240_000}


def test_wire_ledger_bounded_keys():
    """Label-cardinality bound: past max_keys distinct kinds per
    (peer, dir) the ledger counts overflow instead of growing."""
    from distributed_llama_tpu_torch.runtime.stats import WireStats

    w = WireStats(max_keys=4)
    for i in range(10):
        w.account(1, f"K{i}", "tx", 8)
    s = w.summary()
    assert len(s["peers"]["1"]["tx"]) == 4
    assert s["key_overflow"] == 6


def test_reconcile_wire_drift_math_golden():
    """Pinned drift math (the 25% bar shared with dlprof's mirror):
    exact match -> 0.0/clean, 25% -> flagged (inclusive), modeled=0 ->
    no division, honest note."""
    from distributed_llama_tpu_torch.runtime.netstats import (WIRE_DRIFT_FRAC,
                                                        reconcile_wire)

    r = reconcile_wire(400.0, 400.0)
    assert r["drift_frac"] == 0.0 and r["drift"] is False

    r = reconcile_wire(300.0, 400.0)  # exactly at the bar: flags
    assert r["drift_frac"] == 0.25 and r["drift"] is True
    assert "25%" in r["note"]

    r = reconcile_wire(390.0, 400.0)
    assert r["drift_frac"] == 0.025 and r["drift"] is False
    assert r["note"] is None

    r = reconcile_wire(100.0, 0.0)
    assert r["drift_frac"] is None and r["drift"] is False
    assert "no model" in r["note"]

    # the dlprof mirror cannot drift from the canonical threshold
    from distributed_llama_tpu_torch.tools import dlprof
    assert dlprof.WIRE_DRIFT_FRAC == WIRE_DRIFT_FRAC


# -- in-process shape and codec tests (no subprocess) ----------------------


def test_cluster_peer_lost_shape():
    from distributed_llama_tpu_torch.parallel.multihost import ClusterPeerLost

    exc = ClusterPeerLost(3, 2.5, "decode", "timeout")
    assert exc.node_id == 3 and exc.phase == "decode"
    s = exc.summary()
    assert s == {"event": "cluster_peer_lost", "node_id": 3,
                 "last_seen_s": 2.5, "phase": "decode",
                 "reason": "timeout"}
    assert "node 3" in str(exc) and "decode" in str(exc)


def test_frame_codec_roundtrip_and_truncation():
    from distributed_llama_tpu_torch.parallel.multihost import (
        _FRAME_HDR, _FRAME_MAGIC, ClusterProtocolError, _recv_frame,
        _send_frame)

    a, b = socket.socketpair()
    try:
        _send_frame(a, 7, [1, -2, 3], b"payload", timeout=5.0)
        kind, ints, payload = _recv_frame(b, timeout=5.0)
        assert (kind, ints, payload) == (7, [1, -2, 3], b"payload")

        # torn frame: half the bytes then EOF -> structured protocol error
        import struct
        buf = _FRAME_HDR.pack(_FRAME_MAGIC, 7, 1, 0) + struct.pack("<q", 9)
        a.sendall(buf[: len(buf) // 2])
        a.close()
        with pytest.raises(ClusterProtocolError, match="truncated"):
            _recv_frame(b, timeout=5.0)
    finally:
        b.close()


def test_frame_codec_rejects_garbage_magic():
    from distributed_llama_tpu_torch.parallel.multihost import (
        ClusterProtocolError, _recv_frame)

    a, b = socket.socketpair()
    try:
        a.sendall(b"GET / HTTP/1.1\r\n")  # a port scanner / wrong service
        with pytest.raises(ClusterProtocolError, match="magic"):
            _recv_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()


def test_socket_fault_sites_registered():
    """The chaos sites exist in the registry and parse from DLLAMA_FAULTS
    (a typo'd site must fail loudly — faults.load_env contract)."""
    from distributed_llama_tpu_torch.runtime.faults import SITES, FaultRegistry

    for site in ("conn_refused", "recv_stall", "frame_truncate",
                 "peer_close"):
        assert site in SITES
    reg = FaultRegistry()
    reg.load_env({"DLLAMA_FAULTS": "conn_refused:times=2,"
                                   "recv_stall:after=2;times=0"})
    assert reg.armed("conn_refused") and reg.armed("recv_stall")
    with pytest.raises(ConnectionRefusedError):
        reg.fire("conn_refused")
    # triggered() consumes counts deterministically
    reg.arm("peer_close", times=1)
    assert reg.triggered("peer_close") is True
    assert reg.triggered("peer_close") is False
    reg.clear()


def test_xfer_bench_header_carries_n_prompt():
    """send_xfer_bench(n_prompt) delivers n_prompt to the worker's RunMsg
    (max_tokens slot) so its measure_prefill_transfer_ms(n_prompt) runs
    the same collective sequence as the root's (the collective half is
    held by tests/test_torch_multinode.py's two-node inference)."""
    import threading

    from distributed_llama_tpu_torch.parallel import multihost as mh

    port = _free_port()
    root = mh.RootLink(2, "", port, heartbeat_interval=0.2,
                       worker_timeout=5.0, connect_timeout=5.0)
    worker = mh.WorkerLink("127.0.0.1", port, 1, 2, connect_timeout=5.0)
    t = threading.Thread(target=root.form)
    t.start()
    worker.form()
    t.join(timeout=10)
    old = mh.get_link()
    try:
        mh.set_link(root)
        mh.send_xfer_bench(37)
        mh.set_link(worker)
        msg = mh.recv_msg(timeout=10.0)
        assert msg.kind == mh.MSG_XFER_BENCH
        assert msg.max_tokens == 37
    finally:
        mh.set_link(old)
        root.close()
        worker.close()


def test_worker_recv_msg_wait_is_supervised():
    """recv_msg's queue wait wakes on root loss and raises the structured
    ClusterPeerLost — an idle worker can never block unboundedly."""
    import threading

    from distributed_llama_tpu_torch.parallel import multihost as mh

    port = _free_port()
    root = mh.RootLink(2, "", port, heartbeat_interval=0.1,
                       worker_timeout=1.0, connect_timeout=5.0)
    worker = mh.WorkerLink("127.0.0.1", port, 1, 2, connect_timeout=5.0)
    t = threading.Thread(target=root.form)
    t.start()
    worker.form()
    t.join(timeout=10)
    try:
        t0 = time.monotonic()
        root.close()  # root goes away while the worker waits for a frame
        with pytest.raises(mh.ClusterPeerLost) as ei:
            worker.recv(timeout=30.0)
        assert ei.value.node_id == 0
        assert time.monotonic() - t0 < 5.0  # EOF-fast, nowhere near 30s
    finally:
        worker.close()


# -- the port's codec against the JAX codec ---------------------------------

FRAMES = [(1, [], b""), (7, [1, -2, 3], b"payload"),
          (2, [0] * 11, b'{"prompt": "hi"}'), (8, [5], b""),
          (9, [5, 1_760_000_000_000_000], b""),
          (3, [(1 << 62), -(1 << 62)], bytes(range(256)) * 9)]


def _wire_bytes(send_frame, kind, ints, payload) -> bytes:
    a, b = socket.socketpair()
    try:
        send_frame(a, kind, ints, payload, timeout=5.0)
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        b.close()


@pytest.mark.parametrize("kind,ints,payload", FRAMES,
                         ids=[str(i) for i in range(len(FRAMES))])
def test_frames_are_the_jax_codec_bytes(kind, ints, payload):
    """The same frame is the same bytes from either package's codec, each
    decodes the other's, and frame_bytes agrees with both."""
    from distributed_llama_tpu.parallel import multihost as jmh
    from distributed_llama_tpu_torch.parallel import multihost as mh

    mine = _wire_bytes(mh._send_frame, kind, ints, payload)
    theirs = _wire_bytes(jmh._send_frame, kind, ints, payload)
    assert mine == theirs
    assert len(mine) == mh.frame_bytes(len(ints), len(payload)) \
        == jmh.frame_bytes(len(ints), len(payload))
    for recv in (mh._recv_frame, jmh._recv_frame):
        a, b = socket.socketpair()
        try:
            a.sendall(theirs if recv is mh._recv_frame else mine)
            assert recv(b, timeout=5.0) == (kind, list(ints), payload)
        finally:
            a.close()
            b.close()


def test_protocol_constants_are_the_jax_ones():
    """Message kinds, names, the header length, the protocol version and
    the exit codes: a port node speaks the JAX protocol."""
    from distributed_llama_tpu.parallel import multihost as jmh
    from distributed_llama_tpu_torch.parallel import multihost as mh

    for name in ("MSG_SHUTDOWN", "MSG_RUN", "MSG_API", "MSG_XFER_BENCH",
                 "MSG_SEED", "MSG_HELLO", "MSG_HELLO_ACK", "MSG_PING",
                 "MSG_PONG", "MSG_TRACE", "MSG_NAMES", "_HEADER_LEN",
                 "PROTOCOL_VERSION", "EXIT_PEER_LOST", "EXIT_FORMATION",
                 "_FRAME_MAGIC"):
        assert getattr(mh, name) == getattr(jmh, name), name
    assert mh.control_port("10.0.0.1:29500") == jmh.control_port(
        "10.0.0.1:29500") == 29501


def test_import_guards_cover_the_multinode_plane():
    """The control star's modules are in the package that the blocked-jax
    import test (tests/test_torch_guards.py) and its per-file import scan
    walk, and the harness starts without torch."""
    from pathlib import Path

    port = Path(REPO) / "distributed_llama_tpu_torch"
    files = {p.relative_to(port).as_posix() for p in port.rglob("*.py")}
    assert {"parallel/multihost.py", "parallel/cluster_harness.py",
            "runtime/netstats.py"} <= files
    code = ("import sys\n"
            "import distributed_llama_tpu_torch.parallel.cluster_harness\n"
            "assert not any(k.split('.')[0] in ('torch', 'jax') "
            "for k in sys.modules), sorted(sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
