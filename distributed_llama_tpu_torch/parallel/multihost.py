"""The multi-node cluster — the port of the JAX package's
parallel/multihost.py.

The reference scales across machines with a hand-rolled TCP star: one root
process drives generation while N workers each hold a weight shard and
lock-step the per-token task list, triggered by a `pos` broadcast
(ref: src/apps/dllama/dllama.cpp:180-193, src/tasks.cpp:165-182,
src/socket.cpp). As in the JAX package, the cluster is split into two
planes, and only the data plane differs from it:

DATA PLANE — torch.distributed: every rank of every node joins ONE process
group (`init_method="tcp://<coordinator>"`, world = the product of the
mesh axes), and the mesh (parallel/mesh.py) lays its axes over those
ranks, tp fastest, so a node's ranks are consecutive. A node runs
world / nnodes local ranks: the first is the process the operator
started, which holds the node's control link, and it spawns the others
(parallel/launch.py run_node). The model's tensors move over the same
collectives as on one host. Host arrays (the startup spec, the config
fingerprints, a pushed weight's raw bytes) move through `_bcast` on a
gloo group of every rank: `bcast_model_tensors` is the reference root
pushing each worker its weights at startup (ref:
src/transformer.cpp:562-621).

CONTROL PLANE — a supervised TCP star (this module, the JAX protocol byte
for byte): the root listens on ``coordinator_port + 1``
(``DLLAMA_CONTROL_PORT`` overrides) and every worker node connects with
retry + exponential backoff bounded by ``--connect-timeout``, then
identifies itself with a versioned ``MSG_HELLO`` handshake. All protocol
messages (the prompt tokens, step budget, sampling params, raw API
bodies — exactly what the reference root pushed over its sockets each
run, ref: src/apps/dllama/dllama.cpp:180-193) ride length-prefixed frames
with per-socket deadlines on EVERY send and recv. A root->worker heartbeat
(``MSG_PING``/``MSG_PONG`` every ``--heartbeat-interval``) bounds failure
detection: a peer that dies (EOF), wedges (no frame within
``--worker-timeout``), or tears a frame is *detected* and surfaced as a
structured :class:`ClusterPeerLost` (node_id, last_seen, phase, reason)
instead of hanging a collective until the process group's timeout — the
raw-TCP fragility the reference ships with (a dead worker hangs the whole
cluster; SURVEY §5.3). The star forms BEFORE the process group, so a
missing node fails formation with a structured error (exit 44) instead
of waiting in the rendezvous. A node's other local ranks get each
protocol message from the node's link holder over a gloo group of the
node's ranks (`_relay`).

Generation itself needs NO per-token control traffic: the logits a host
reads are whole on every rank, and the sampler is a deterministic
xorshift stream whose state rides the run header — each rank reproduces
the root's token choices locally, where the reference had to broadcast
`pos` every step.

Fault injection: the frame codec fires the socket-layer sites of
``runtime/faults.py`` (``conn_refused``/``recv_stall``/``frame_truncate``/
``peer_close``) so two-process chaos tests can kill or stall either side
deterministically (parallel/cluster_harness.py drives the star alone).
The control plane imports no torch: the data-plane functions import
torch and torch.distributed where they run.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np

from ..runtime.faults import FAULTS

# message kinds (root -> workers, except PONG and TRACE)
MSG_SHUTDOWN = 0
MSG_RUN = 1       # one engine.generate(): tokens + budget + sampling params
MSG_API = 2       # one API request: raw JSON body bytes
MSG_XFER_BENCH = 3  # join the collective microbench sequence (header
#                     carries n_prompt so root and workers run IDENTICAL
#                     measure calls — a mismatch deadlocks the mesh)
MSG_SEED = 5      # startup handshake: cluster-wide sampler seed
MSG_HELLO = 6     # worker -> root: version + rank + pid
MSG_HELLO_ACK = 7  # root -> worker: version/status + adopted timing
MSG_PING = 8      # root -> worker heartbeat
MSG_PONG = 9      # worker -> root heartbeat reply: [seq, worker wall µs]
MSG_TRACE = 10    # worker -> root: flight-recorder span ship (JSON
#                   payload of wall-stamped events; the root rebases them
#                   onto its own timeline via the PING/PONG-midpoint
#                   clock-offset estimate — the cluster twin of the
#                   replica tier's RMSG_TRACE)

# MSG kind -> ledger label (the `kind` label of dllama_wire_bytes_total)
MSG_NAMES = {
    MSG_SHUTDOWN: "SHUTDOWN", MSG_RUN: "RUN", MSG_API: "API",
    MSG_XFER_BENCH: "XFER_BENCH", MSG_SEED: "SEED", MSG_HELLO: "HELLO",
    MSG_HELLO_ACK: "HELLO_ACK", MSG_PING: "PING", MSG_PONG: "PONG",
    MSG_TRACE: "TRACE",
}

# [kind, n_payload, payload_is_bytes, max_tokens, seed_lo, seed_hi,
#  temp_bits, topp_bits, reset, lookup, trace_tid]
_HEADER_LEN = 11

# v2: protocol header grew the trace_tid slot and PONG carries the
# worker's wall clock — mixed builds fail the HELLO symmetric
PROTOCOL_VERSION = 2

# diagnostic exit codes (documented in docs/operations.md): distinct from
# generic failure (1) so operators and supervisors can tell "a peer died
# and we detected it" from "we crashed"
EXIT_PEER_LOST = 43   # bounded detection fired: a peer is dead/wedged
EXIT_FORMATION = 44   # cluster never formed (connect timeout, version/rank
#                       mismatch) — nothing was ever at risk

_FRAME_MAGIC = 0x444C4743  # "DLGC"
_FRAME_HDR = struct.Struct("<IIII")  # magic, kind, n_ints, n_payload_bytes
_MAX_INTS = 1 << 16
_MAX_PAYLOAD = 1 << 31
_HELLO_ACK_OK, _HELLO_ACK_BAD_VERSION, _HELLO_ACK_BAD_RANK = 0, 1, 2


class ClusterPeerLost(RuntimeError):
    """Bounded failure detection fired: ``node_id`` has not produced a
    frame within the heartbeat timeout (or its socket died). ``last_seen``
    is seconds since its last frame at detection time, ``phase`` the
    cluster phase the detecting side was in (formation/load/idle/run/...),
    ``reason`` the detector ("timeout", "eof", "reset", "truncated frame",
    "send failed: ..."). The root surfaces this as a diagnostic exit
    (``EXIT_PEER_LOST``); the api-mode supervisor maps it to the BROKEN
    path (runtime/resilience.EngineSupervisor.trip_cluster); workers exit
    cleanly on root loss."""

    def __init__(self, node_id: int, last_seen: float, phase: str,
                 reason: str = "timeout"):
        self.node_id = int(node_id)
        self.last_seen = float(last_seen)
        self.phase = phase
        self.reason = reason
        super().__init__(
            f"cluster peer lost: node {node_id} ({reason}) — last seen "
            f"{last_seen:.2f}s ago, phase={phase}")

    def summary(self) -> dict:
        """The structured diagnostic shape (logged as one JSON line and
        reported in the /stats cluster block)."""
        return {"event": "cluster_peer_lost", "node_id": self.node_id,
                "last_seen_s": round(self.last_seen, 3),
                "phase": self.phase, "reason": self.reason}


class ClusterProtocolError(RuntimeError):
    """Handshake or framing violation (version/rank mismatch, bad magic,
    truncated frame, formation timeout) — a config/deploy error, not a
    peer death."""


# -- frame codec -----------------------------------------------------------

def frame_bytes(n_ints: int, n_payload: int) -> int:
    """Exact on-the-wire size of one frame — header + 8 bytes per int +
    payload. The reconciliation tests (and the bench cluster row) pin
    the measured ledger against this arithmetic: the codec owns the
    format, so the model lives next to it."""
    return _FRAME_HDR.size + 8 * int(n_ints) + int(n_payload)


def _send_frame(sock: socket.socket, kind: int, ints=(), payload: bytes = b"",
                timeout: float | None = None, acct=None) -> None:
    """One framed send with a per-socket deadline. The caller serializes
    concurrent senders (per-peer send lock). Fault sites: frame_truncate
    (half the bytes then close — the peer sees a torn frame), peer_close
    (close without writing).

    ``acct(kind, nbytes)`` is the wire-ledger hook: called EXACTLY ONCE
    per frame attempt (a finally, so fault paths account too) with the
    bytes actually handed to the kernel — a torn frame counts its
    partial bytes once, a peer_close counts zero, and a sendall that
    raises mid-write counts zero (the kernel's share is unknowable; the
    ledger under-reports rather than guesses)."""
    ints = [int(v) for v in ints]
    buf = _FRAME_HDR.pack(_FRAME_MAGIC, kind, len(ints), len(payload))
    if ints:
        buf += struct.pack(f"<{len(ints)}q", *ints)
    buf += payload
    sock.settimeout(timeout)
    sent = 0
    try:
        if FAULTS.triggered("frame_truncate"):
            part = buf[: max(1, len(buf) // 2)]
            try:
                sock.sendall(part)
                sent = len(part)
            finally:
                sock.close()
            raise ClusterProtocolError("injected frame_truncate")
        if FAULTS.triggered("peer_close"):
            sock.close()
            raise ClusterProtocolError("injected peer_close")
        sock.sendall(buf)
        sent = len(buf)
    finally:
        if acct is not None and sent:
            acct(kind, sent)


def _recv_exact(sock: socket.socket, n: int, deadline: float | None, *,
                allow_eof: bool = False, got_box: list | None = None
                ) -> bytes | None:
    """Read exactly n bytes before an ABSOLUTE monotonic deadline. The
    per-chunk socket timeout is re-armed to the REMAINING budget, so a
    peer trickling one byte per timeout window cannot stretch a frame
    read unboundedly — the whole-frame bound is what the detection
    contract advertises. EOF at a frame boundary returns None when
    allowed (clean close); EOF mid-read is a torn frame and raises.
    ``got_box[0]`` accumulates bytes actually read (the ledger's truth
    even when the read dies mid-frame)."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    f"frame read exceeded its deadline ({got}/{n} bytes)")
            sock.settimeout(remaining)
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if allow_eof and got == 0:
                return None
            raise ClusterProtocolError(
                f"truncated frame: EOF after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
        if got_box is not None:
            got_box[0] += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket, timeout: float | None, acct=None
                ) -> tuple[int, list[int], bytes] | None:
    """One framed recv under ONE whole-frame deadline (header + ints +
    payload share it). Returns None on a clean EOF at a frame boundary;
    raises socket.timeout past the deadline and ClusterProtocolError on a
    torn/garbled frame. Fault site: recv_stall (wedges this reader like a
    hung peer — it stops answering heartbeats, so only the PING/PONG
    timeout on the OTHER side detects it).

    ``acct(kind_or_None, nbytes)`` mirrors the send hook: called exactly
    once per frame attempt with the bytes actually read — a frame torn
    mid-payload counts its partial bytes once, under the parsed kind
    when the header survived (None otherwise)."""
    got = [0]
    kind = None
    try:
        # stall fires BEFORE the deadline is armed (as pre-ledger): the
        # whole-frame bound covers the read, not an injected wedge
        FAULTS.fire("recv_stall")
        deadline = None if timeout is None else time.monotonic() + timeout
        sock.settimeout(timeout)
        hdr = _recv_exact(sock, _FRAME_HDR.size, deadline, allow_eof=True,
                          got_box=got)
        if hdr is None:
            return None
        magic, kind, n_ints, n_pay = _FRAME_HDR.unpack(hdr)
        if magic != _FRAME_MAGIC:
            raise ClusterProtocolError(f"bad frame magic 0x{magic:08x}")
        if n_ints > _MAX_INTS or n_pay > _MAX_PAYLOAD:
            raise ClusterProtocolError(
                f"implausible frame header (ints={n_ints}, payload={n_pay})")
        ints: list[int] = []
        if n_ints:
            raw = _recv_exact(sock, 8 * n_ints, deadline, got_box=got)
            ints = list(struct.unpack(f"<{n_ints}q", raw))
        payload = (_recv_exact(sock, n_pay, deadline, got_box=got)
                   if n_pay else b"")
        return kind, ints, payload
    finally:
        if acct is not None and got[0]:
            acct(kind, got[0])


def control_port(coordinator: str) -> int:
    """The control-plane TCP port: coordinator port + 1 on the same host
    (rank 0 runs on the coordinator host — the process group's TCP store
    lives inside rank 0). ``DLLAMA_CONTROL_PORT`` overrides when +1 is
    taken."""
    env = os.environ.get("DLLAMA_CONTROL_PORT")
    if env:
        return int(env)
    return int(coordinator.rsplit(":", 1)[1]) + 1


def _now() -> float:
    return time.monotonic()


class _Peer:
    """Root-side record of one connected worker. The connection is held
    through TWO Python socket objects over the SAME fd (dup): Python
    timeouts live on the socket OBJECT, and the receiver thread re-arms
    its deadline per read while sender threads (heartbeat, broadcast)
    arm worker_timeout per write — on one shared object those
    settimeout() calls race, so a send could run under the receiver's
    near-zero remaining budget (spurious 'send failed' peer-loss) or a
    recv under the sender's full budget (detection bound stretched).
    Distinct objects make each direction's deadline private; the kernel
    socket is one TCP stream either way."""

    def __init__(self, rank: int, sock: socket.socket, pid: int):
        self.rank = rank
        self.sock = sock              # receiver-thread reads
        self.send_sock = sock.dup()   # sender threads, under send_lock
        self.pid = pid
        self.last_seen = _now()
        self.send_lock = threading.Lock()
        self.alive = True
        # wire-ledger hooks (set after _init_stats — formation frames ride
        # before the stats object exists, documented ledger scope)
        self.acct_send = None
        self.acct_recv = None
        # in-flight PING seq -> (mono, wall) send stamps, for the RTT /
        # clock-offset estimate; bounded (stale seqs pruned on insert)
        self.ping_sent: dict[int, tuple] = {}

    def close(self) -> None:
        for s in (self.sock, self.send_sock):
            try:
                s.close()
            except OSError:
                pass


class _LinkBase:
    """State shared by both ends of the control star: heartbeat timing,
    the current phase label (rides every ClusterPeerLost), counters for
    the /stats cluster block, and the peer-lost callback hook."""

    def __init__(self, nnodes: int, rank: int, *,
                 heartbeat_interval: float, worker_timeout: float):
        self.nnodes = int(nnodes)
        self.rank = int(rank)
        self.heartbeat_interval = float(heartbeat_interval)
        self.worker_timeout = float(worker_timeout)
        self.phase = "formation"
        # the trace id the current protocol activity rides (set by the
        # driver — harness root / _announce_run); a ClusterPeerLost
        # casualty span links under it
        self.trace_tid = 0
        self.lost: dict[int, ClusterPeerLost] = {}  # dlrace: guarded-by(self._lock)
        # callback invoked ONCE per lost peer, from the detecting thread
        # (receiver/heartbeat — the main thread may be wedged in a
        # collective and uninterruptible, so the callback is where a
        # diagnostic exit must happen). None = record only; the next
        # send/recv raises.
        self.on_peer_lost = None
        self._lock = threading.Lock()
        self._closing = False  # dlrace: guarded-by(self._lock)
        self.stats = None  # runtime.stats.ClusterStats, set in _init_stats

    def _init_stats(self, connect_retries: int = 0) -> None:
        from ..runtime.stats import ClusterStats

        self.stats = ClusterStats(
            nnodes=self.nnodes, node_rank=self.rank,
            protocol_version=PROTOCOL_VERSION,
            heartbeat_interval_s=self.heartbeat_interval,
            worker_timeout_s=self.worker_timeout,
            connect_retries=connect_retries)

    def set_phase(self, phase: str) -> None:
        self.phase = phase

    def check(self) -> None:
        """Raise the first recorded peer loss (idempotent view — senders
        call this before touching sockets so a loss detected by the
        heartbeat thread surfaces on the driving thread too)."""
        with self._lock:
            if self.lost and not self._closing:
                raise next(iter(self.lost.values()))

    def _mk_acct(self, peer_rank: int, direction: str):
        """One wire-ledger accounting closure for the codec hooks: a
        no-op until _init_stats built the ClusterStats (formation frames
        are out of ledger scope by design)."""
        def acct(kind, nbytes):
            st = self.stats
            if st is not None:
                st.wire.account(peer_rank,
                                MSG_NAMES.get(kind, str(kind)),
                                direction, nbytes)
        return acct

    def _report_lost(self, exc: ClusterPeerLost) -> bool:
        """Record + notify exactly once per peer. Returns True when this
        call was the first detection."""
        with self._lock:
            if self._closing or exc.node_id in self.lost:
                return False
            self.lost[exc.node_id] = exc
        if self.stats is not None:
            self.stats.peers_lost.append(exc.summary())
        from ..runtime.trace import TRACER

        if TRACER.enabled:
            # the casualty span: a lost peer lands on the SAME timeline
            # (and trace id) as the protocol activity it died under —
            # the cluster twin of a SIGKILLed replica's worker_exit event
            TRACER.event("cluster_lost", self.trace_tid,
                         node=exc.node_id, reason=exc.reason,
                         phase=exc.phase,
                         last_seen_s=round(exc.last_seen, 3))
        cb = self.on_peer_lost
        if cb is not None:
            cb(exc)
        return True

    def summary(self) -> dict:
        out = self.stats.summary() if self.stats is not None else {}
        out["phase"] = self.phase
        return out


class RootLink(_LinkBase):
    """Root (rank 0) side of the control star: accepts the versioned
    HELLO handshake from every worker during formation, then runs one
    receiver thread per peer (PONGs update liveness; silence past
    ``worker_timeout`` or a dead socket trips :class:`ClusterPeerLost`)
    and one heartbeat thread PINGing all peers every
    ``heartbeat_interval``."""

    def __init__(self, nnodes: int, bind_host: str, port: int, *,
                 heartbeat_interval: float = 2.0,
                 worker_timeout: float = 10.0,
                 connect_timeout: float = 30.0):
        super().__init__(nnodes, 0, heartbeat_interval=heartbeat_interval,
                         worker_timeout=worker_timeout)
        self.connect_timeout = float(connect_timeout)
        self._bind = (bind_host, int(port))
        self.peers: dict[int, _Peer] = {}
        self._threads: list[threading.Thread] = []

    def form(self) -> None:
        """Bind, accept nnodes-1 HELLOs (each validated for protocol
        version and rank uniqueness, each ACKed with the root's heartbeat
        timing so both sides agree on detection bounds), then start the
        heartbeat machinery. Raises ClusterProtocolError when the cluster
        does not form within ``connect_timeout``."""
        deadline = _now() + self.connect_timeout
        try:
            srv = socket.create_server(self._bind,
                                       backlog=max(self.nnodes, 2),
                                       reuse_port=False)
        except OSError as e:
            raise ClusterProtocolError(
                f"cannot bind the control port {self._bind[1]} "
                f"(coordinator port + 1): {e} — set DLLAMA_CONTROL_PORT "
                "to a free port on every node") from e
        try:
            srv.settimeout(0.2)
            while len(self.peers) < self.nnodes - 1:
                if _now() > deadline:
                    missing = sorted(set(range(1, self.nnodes))
                                     - set(self.peers))
                    raise ClusterProtocolError(
                        f"cluster formation timed out after "
                        f"{self.connect_timeout:.1f}s (--connect-timeout): "
                        f"worker rank(s) {missing} never completed the "
                        f"HELLO handshake on control port {self._bind[1]}")
                try:
                    conn, _addr = srv.accept()
                except socket.timeout:
                    continue
                self._handshake(conn)
        finally:
            srv.close()
        self._init_stats()
        # formation is over: early joiners have been silent BY PROTOCOL
        # while later ranks HELLOed (nothing is sent to a connected peer
        # until every rank is in), so their handshake-time last_seen may
        # be up to connect_timeout stale — liveness clocks start NOW, or
        # a healthy staggered join would false-positive instantly
        for peer in self.peers.values():
            peer.last_seen = _now()
            peer.acct_send = self._mk_acct(peer.rank, "tx")
            peer.acct_recv = self._mk_acct(peer.rank, "rx")
        for peer in self.peers.values():
            t = threading.Thread(target=self._receiver, args=(peer,),
                                 name=f"dllama-cluster-recv-r{peer.rank}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        hb = threading.Thread(target=self._heartbeat,
                              name="dllama-cluster-heartbeat", daemon=True)
        hb.start()
        self._threads.append(hb)

    def _handshake(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            frame = _recv_frame(conn, timeout=5.0)
        except (OSError, ClusterProtocolError):
            conn.close()  # a port-scanner / torn hello: drop, keep waiting
            return
        if frame is None or frame[0] != MSG_HELLO or len(frame[1]) < 3:
            conn.close()
            return
        version, rank, pid = frame[1][:3]
        # the root's timing is authoritative cluster-wide: heartbeat
        # cadence + detection bound AND the formation budget (the
        # worker's pre-first-frame grace must cover the ROOT's formation
        # window, not its own local --connect-timeout)
        ack = [PROTOCOL_VERSION, _HELLO_ACK_OK, self.nnodes,
               int(self.heartbeat_interval * 1e3),
               int(self.worker_timeout * 1e3),
               int(self.connect_timeout * 1e3)]
        if version != PROTOCOL_VERSION:
            ack[1] = _HELLO_ACK_BAD_VERSION
            self._ack_and_close(conn, ack)
            raise ClusterProtocolError(
                f"protocol version mismatch: worker rank {rank} speaks "
                f"v{version}, root speaks v{PROTOCOL_VERSION} — every node "
                "must run the same build")
        if not (1 <= rank < self.nnodes) or rank in self.peers:
            ack[1] = _HELLO_ACK_BAD_RANK
            self._ack_and_close(conn, ack)
            raise ClusterProtocolError(
                f"bad HELLO rank {rank}: expected a unique rank in "
                f"1..{self.nnodes - 1} (already connected: "
                f"{sorted(self.peers)})")
        try:
            _send_frame(conn, MSG_HELLO_ACK, ack, timeout=5.0)
            self.peers[rank] = _Peer(rank, conn, pid)
        except (OSError, ClusterProtocolError):
            # the worker died between its HELLO and our ACK: drop the
            # half-dead connection and keep waiting for that rank's
            # restart inside the formation deadline — a raw BrokenPipe
            # must not crash formation unstructured
            conn.close()

    @staticmethod
    def _ack_and_close(conn: socket.socket, ack: list[int]) -> None:
        try:
            _send_frame(conn, MSG_HELLO_ACK, ack, timeout=5.0)
        except (OSError, ClusterProtocolError):
            pass
        conn.close()

    def _receiver(self, peer: _Peer) -> None:
        """Per-peer read loop: any frame refreshes liveness; silence past
        ``worker_timeout`` (the peer answers PINGs when healthy, so
        silence means dead or wedged), EOF, reset, or a torn frame trips
        ClusterPeerLost with the matching reason."""
        while peer.alive and not self._closing:
            wait = max(0.05,
                       peer.last_seen + self.worker_timeout - _now())
            try:
                frame = _recv_frame(peer.sock, timeout=wait,
                                    acct=peer.acct_recv)
            except socket.timeout:
                self._lost(peer, "timeout")
                return
            except ConnectionResetError:
                self._lost(peer, "reset")
                return
            except ClusterProtocolError as e:
                self._lost(peer, str(e))
                return
            except OSError:
                if self._closing:
                    return
                self._lost(peer, "socket error")
                return
            if frame is None:  # clean EOF: the worker process is gone
                if not self._closing:
                    self._lost(peer, "eof")
                return
            peer.last_seen = _now()
            if self.stats is not None:
                self.stats.frames_received += 1
                if frame[0] == MSG_PONG:
                    self.stats.pongs_received += 1
                    self._note_pong(peer, frame[1])
            if frame[0] == MSG_TRACE:
                self._ingest_trace(peer, frame[2])

    def _note_pong(self, peer: _Peer, ints: list[int]) -> None:
        """One PONG: match it to its PING's send stamps for the RTT
        sample, and — when the worker echoed its wall clock — refresh
        the midpoint clock-offset estimate (offset = worker wall at the
        midpoint of the round trip minus local wall; kept at the best
        i.e. minimum-RTT sample — the NTP pick)."""
        if not ints:
            return
        stamp = peer.ping_sent.pop(int(ints[0]), None)
        if stamp is None:
            return
        mono_send, wall_send = stamp
        rtt_ms = (_now() - mono_send) * 1e3
        offset_s = None
        if len(ints) > 1 and ints[1]:
            wall_mid = (wall_send + time.time()) / 2.0
            offset_s = ints[1] / 1e6 - wall_mid
        self.stats.wire.rtt(peer.rank, rtt_ms, offset_s)

    def _ingest_trace(self, peer: _Peer, payload: bytes) -> None:
        """One MSG_TRACE frame: merge the worker's wall-stamped span
        events onto the local tracer's timeline, shifted by the per-peer
        clock-offset estimate so cross-host events sort to within the
        offset estimate's error (~RTT/2)."""
        from ..runtime.trace import TRACER

        if not TRACER.enabled:
            return
        try:
            import json

            events = json.loads(payload.decode())["events"]
            assert isinstance(events, list)
        except (ValueError, KeyError, AssertionError, UnicodeDecodeError):
            return  # a malformed ship is observability loss, not a fault
        off = (self.stats.wire.clock_offset_s(peer.rank)
               if self.stats is not None else None)
        if off:
            events = [{**e, "ts_wall": e["ts_wall"] - off}
                      for e in events if "ts_wall" in e]
        TRACER.ingest(events, origin=f"node{peer.rank}")

    def _heartbeat(self) -> None:
        # ping FIRST, then sleep: the formation-complete ping reaches
        # every worker immediately, ending the protocol-silent formation
        # window their own liveness clocks must tolerate (WorkerLink
        # _receiver's pre-first-frame grace)
        seq = 0
        while not self._closing:
            seq += 1
            for peer in list(self.peers.values()):
                if not peer.alive:
                    continue
                try:
                    # stamp BEFORE the send: the RTT sample must include
                    # the send syscall (the peer's PONG races the stamp
                    # otherwise); stale seqs (unanswered pings) pruned
                    # so a wedged peer cannot grow the dict unboundedly.
                    # The receiver thread pops matched seqs lock-free
                    # concurrently, so the prune must tolerate losing
                    # the race (default pop; StopIteration/RuntimeError
                    # if the dict empties/mutates under the iterator) —
                    # an uncaught error here would kill the heartbeat
                    # thread and tear the whole cluster down
                    peer.ping_sent[seq] = (_now(), time.time())
                    while len(peer.ping_sent) > 64:
                        try:
                            peer.ping_sent.pop(
                                next(iter(peer.ping_sent)), None)
                        except (StopIteration, RuntimeError):
                            break
                    with peer.send_lock:
                        _send_frame(peer.send_sock, MSG_PING, [seq],
                                    timeout=self.worker_timeout,
                                    acct=peer.acct_send)
                    if self.stats is not None:
                        self.stats.pings_sent += 1
                except (OSError, ClusterProtocolError) as e:
                    self._lost(peer, f"send failed: {e}")
            time.sleep(self.heartbeat_interval)

    def _lost(self, peer: _Peer, reason: str) -> None:
        peer.alive = False
        age = _now() - peer.last_seen
        peer.close()
        self._report_lost(
            ClusterPeerLost(peer.rank, age, self.phase, reason))

    def broadcast(self, kind: int, ints, payload: bytes = b"") -> None:
        """Fan one protocol frame out to every worker (the reference
        root's per-worker socket writes). Raises ClusterPeerLost when a
        peer was, or just turned out to be, lost — except for SHUTDOWN,
        which is best-effort by design (a dying cluster must still be
        tear-down-able)."""
        shutdown = kind == MSG_SHUTDOWN
        if shutdown:
            with self._lock:
                self._closing = True
        else:
            self.check()
        for peer in list(self.peers.values()):
            if not peer.alive:
                continue
            try:
                with peer.send_lock:
                    _send_frame(peer.send_sock, kind, ints, payload,
                                timeout=self.worker_timeout,
                                acct=peer.acct_send)
                if self.stats is not None:
                    self.stats.frames_sent += 1
            except (OSError, ClusterProtocolError) as e:
                if not shutdown:
                    self._lost(peer, f"send failed: {e}")
                    self.check()

    def close(self) -> None:
        with self._lock:
            self._closing = True
        for peer in self.peers.values():
            peer.alive = False
            peer.close()


class WorkerLink(_LinkBase):
    """Worker side: connects with retry + exponential backoff bounded by
    ``connect_timeout``, HELLOs, adopts the root's heartbeat timing from
    the ACK, then runs one receiver thread that answers PINGs with PONGs,
    queues protocol messages for :meth:`recv`, and trips
    :class:`ClusterPeerLost` (node 0) when the root goes silent past
    ``worker_timeout`` or its socket dies."""

    def __init__(self, host: str, port: int, rank: int, nnodes: int, *,
                 heartbeat_interval: float = 2.0,
                 worker_timeout: float = 10.0,
                 connect_timeout: float = 30.0,
                 protocol_version: int = PROTOCOL_VERSION):
        super().__init__(nnodes, rank, heartbeat_interval=heartbeat_interval,
                         worker_timeout=worker_timeout)
        self._addr = (host, int(port))
        self.connect_timeout = float(connect_timeout)
        self._protocol_version = int(protocol_version)
        self.sock: socket.socket | None = None
        self._send_lock = threading.Lock()
        self._acct_send = None
        self._acct_recv = None
        self._queue: list[tuple[int, list[int], bytes]] = []
        self._cond = threading.Condition()
        self._last_seen = _now()
        self._shutdown_seen = False
        self.connect_retries = 0

    def form(self) -> None:
        deadline = _now() + self.connect_timeout
        delay = 0.05
        last_err: Exception | None = None
        while True:
            budget = deadline - _now()
            if budget <= 0:
                raise ClusterProtocolError(
                    f"could not reach root control port "
                    f"{self._addr[0]}:{self._addr[1]} within "
                    f"{self.connect_timeout:.1f}s (--connect-timeout, "
                    f"{self.connect_retries} attempts): {last_err}")
            try:
                FAULTS.fire("conn_refused")
                self.sock = socket.create_connection(
                    self._addr, timeout=min(budget, 5.0))
                break
            except OSError as e:  # refused/unreachable/timeout: back off
                last_err = e
                self.connect_retries += 1
                time.sleep(min(delay, max(deadline - _now(), 0)))
                delay = min(delay * 2, 1.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            _send_frame(self.sock, MSG_HELLO,
                        [self._protocol_version, self.rank, os.getpid()],
                        timeout=5.0)
        except OSError as e:
            raise ClusterProtocolError(
                f"control handshake failed sending HELLO: {e}") from e
        try:
            frame = _recv_frame(self.sock, timeout=self.connect_timeout)
        except socket.timeout as e:
            raise ClusterProtocolError(
                "root accepted the connection but never ACKed the HELLO "
                f"within {self.connect_timeout:.1f}s") from e
        except OSError as e:  # reset/aborted mid-ACK: still a structured
            raise ClusterProtocolError(  # formation error, never a raw
                f"control handshake failed awaiting the HELLO ack: {e}"
            ) from e  # traceback with exit 1
        if frame is None or frame[0] != MSG_HELLO_ACK or len(frame[1]) < 6:
            raise ClusterProtocolError(
                f"malformed HELLO_ACK from root: {frame!r}")
        (root_version, status, nnodes, hb_ms, timeout_ms,
         connect_ms) = frame[1][:6]
        if status == _HELLO_ACK_BAD_VERSION or root_version != self._protocol_version:
            raise ClusterProtocolError(
                f"protocol version mismatch: this worker speaks "
                f"v{self._protocol_version}, root speaks v{root_version} — "
                "every node must run the same build")
        if status == _HELLO_ACK_BAD_RANK:
            raise ClusterProtocolError(
                f"root rejected rank {self.rank}: duplicate or out of "
                f"range for an {nnodes}-node cluster — check --node-rank")
        # adopt the ROOT's timing: detection bounds must agree cluster-wide
        # (a worker with a shorter timeout than the root's ping interval
        # would false-positive on a healthy root), and the ROOT's
        # formation budget governs the protocol-silent window this
        # worker's pre-first-frame grace must tolerate — its own local
        # --connect-timeout may be shorter
        self.nnodes = int(nnodes)
        self.heartbeat_interval = hb_ms / 1e3
        self.worker_timeout = timeout_ms / 1e3
        self.connect_timeout = connect_ms / 1e3
        self._last_seen = _now()
        self._init_stats(connect_retries=self.connect_retries)
        self._acct_send = self._mk_acct(0, "tx")
        self._acct_recv = self._mk_acct(0, "rx")
        t = threading.Thread(target=self._receiver,
                             name="dllama-cluster-recv-root", daemon=True)
        t.start()

    def _receiver(self) -> None:
        saw_frame = False
        while not self._closing:
            # pre-first-frame grace: between this worker's HELLO_ACK and
            # formation completing, the root is silent BY PROTOCOL while
            # later ranks join (bounded by connect_timeout; the root's
            # formation-complete ping ends the window) — a staggered but
            # healthy join must not read as a dead root. A root that
            # actually dies in the window still surfaces EOF-fast.
            budget = self.worker_timeout + (
                0.0 if saw_frame else self.connect_timeout)
            wait = max(0.05, self._last_seen + budget - _now())
            try:
                frame = _recv_frame(self.sock, timeout=wait,
                                    acct=self._acct_recv)
            except socket.timeout:
                self._root_lost("timeout")
                return
            except ConnectionResetError:
                self._root_lost("reset")
                return
            except ClusterProtocolError as e:
                self._root_lost(str(e))
                return
            except OSError:
                if not self._closing:
                    self._root_lost("socket error")
                return
            if frame is None:
                if not (self._closing or self._shutdown_seen):
                    self._root_lost("eof")
                return
            saw_frame = True
            self._last_seen = _now()
            kind = frame[0]
            if self.stats is not None:
                self.stats.frames_received += 1
            if kind == MSG_PING:
                try:
                    # echo the seq + this worker's wall clock (µs): the
                    # root's midpoint estimate of the clock offset is
                    # what MSG_TRACE span rebasing rides
                    pong = [frame[1][0] if frame[1] else 0,
                            int(time.time() * 1e6)]
                    with self._send_lock:
                        _send_frame(self.sock, MSG_PONG, pong,
                                    timeout=self.worker_timeout,
                                    acct=self._acct_send)
                    if self.stats is not None:
                        self.stats.pongs_sent += 1
                except (OSError, ClusterProtocolError) as e:
                    if not self._closing:
                        self._root_lost(f"pong send failed: {e}")
                    return
                continue
            if kind == MSG_SHUTDOWN:
                # the root's LAST frame (broadcast(MSG_SHUTDOWN) closes
                # the root side to new sends): deliver it and stop
                # reading — continuing would race the root's socket
                # teardown (a stray PING in flight, our PONG to a closed
                # peer) into a spurious root-lost diagnostic
                self._shutdown_seen = True
                with self._cond:
                    self._queue.append(frame)
                    self._cond.notify_all()
                return
            with self._cond:
                self._queue.append(frame)
                self._cond.notify_all()

    def _root_lost(self, reason: str) -> None:
        age = _now() - self._last_seen
        exc = ClusterPeerLost(0, age, self.phase, reason)
        first = self._report_lost(exc)
        with self._cond:
            self._cond.notify_all()  # wake any recv() waiter to raise
        if first:
            try:
                self.sock.close()
            except OSError:
                pass

    def recv(self, timeout: float | None = None
             ) -> tuple[int, list[int], bytes]:
        """Block for the next protocol frame. NEVER unbounded: the wait
        wakes on root loss (raising the structured ClusterPeerLost) and,
        when ``timeout`` is given, raises socket.timeout past it."""
        deadline = None if timeout is None else _now() + timeout
        with self._cond:
            while not self._queue:
                self.check()
                if deadline is not None and _now() > deadline:
                    raise socket.timeout(
                        f"no protocol frame within {timeout:.1f}s")
                self._cond.wait(timeout=0.1)
            return self._queue.pop(0)

    def ship_trace(self, events: list[dict]) -> bool:
        """Best-effort worker→root span ship (MSG_TRACE): the events are
        ``Tracer.export_span`` output (wall-stamped — monotonic clocks do
        not transfer between hosts; the root rebases via its clock-offset
        estimate for this peer). Returns False instead of raising on any
        failure: a span that cannot ship is observability loss, never a
        reason to take the worker down — the root's casualty machinery
        covers a worker that dies before shipping."""
        if self.sock is None or self._closing or not events:
            return False
        import json

        try:
            payload = json.dumps({"events": events}).encode()
        except (TypeError, ValueError):
            return False
        try:
            with self._send_lock:
                _send_frame(self.sock, MSG_TRACE, [len(events)], payload,
                            timeout=self.worker_timeout,
                            acct=self._acct_send)
            if self.stats is not None:
                self.stats.frames_sent += 1
            return True
        except (OSError, ClusterProtocolError):
            return False

    def close(self) -> None:
        with self._lock:
            self._closing = True
        with self._cond:
            self._cond.notify_all()
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


# -- module-level link wiring ---------------------------------------------

_LINK: RootLink | WorkerLink | None = None


def get_link() -> RootLink | WorkerLink | None:
    return _LINK


def set_link(link: RootLink | WorkerLink | None) -> None:
    """Install a link explicitly (the chaos harness and in-process tests
    drive links without init_multihost)."""
    global _LINK
    _LINK = link


def set_phase(phase: str) -> None:
    """Label the cluster phase (rides every ClusterPeerLost diagnostic and
    the /stats cluster block). No-op off-cluster."""
    if _LINK is not None:
        _LINK.set_phase(phase)


def cluster_summary() -> dict | None:
    """The /stats ``cluster`` block (None off-cluster)."""
    return None if _LINK is None else _LINK.summary()


def close_link() -> None:
    global _LINK
    if _LINK is not None:
        _LINK.close()
        _LINK = None


def diagnostic_exit(exc: ClusterPeerLost) -> None:
    """The default peer-lost policy for CLI drivers: print the structured
    diagnostic and hard-exit with EXIT_PEER_LOST. os._exit, not
    sys.exit — the detecting thread is a daemon and the main thread may
    be wedged inside a collective until the process group's timeout; a
    soft exit would hang exactly the way this subsystem exists to
    prevent."""
    import json

    # deliberate operator-facing host output, not kernel debug leftovers
    print("🔴 cluster: " + json.dumps(exc.summary()), flush=True)
    os._exit(EXIT_PEER_LOST)


def await_peer_lost(timeout: float) -> ClusterPeerLost | None:
    """The lost peer the link records within `timeout` seconds, or None
    (at once off-cluster). A collective that failed because a peer died
    usually fails as fast as the link sees the EOF, so a driver that
    caught such a failure asks the link for its verdict before treating
    it as a crash of its own."""
    link = _LINK
    if link is None:
        return None
    end = _now() + timeout
    while True:
        with link._lock:
            if link.lost:
                return next(iter(link.lost.values()))
        if _now() >= end:
            return None
        time.sleep(0.05)


def install_peer_lost_exit(handler=None) -> None:
    """Arm the peer-lost callback on the live link (default:
    :func:`diagnostic_exit`)."""
    if _LINK is not None:
        _LINK.on_peer_lost = handler or diagnostic_exit


# the data plane's view of this process: its global rank, the node count,
# its node and the ranks a node runs (set by join_data_plane)
_CLUSTER = {"rank": 0, "nnodes": 1, "node_rank": 0, "local": 1}
# a gloo group over every rank for host arrays (None: the default group
# is gloo and serves), and this node's ranks for the link holder's relay
# (None on a one-rank node)
_HOST_GROUP = None
_NODE_GROUP = None


def node_ranks(node_rank: int, world: int, nnodes: int) -> list[int]:
    """The global ranks node `node_rank` runs: world / nnodes consecutive
    ones, the first of them the node's link holder."""
    local = world // nnodes
    return list(range(node_rank * local, (node_rank + 1) * local))


def init_multihost(coordinator: str, num_processes: int, process_id: int, *,
                   world: int, device_type: str, timeout_s: float,
                   connect_timeout: float = 30.0,
                   heartbeat_interval: float = 2.0,
                   worker_timeout: float = 10.0,
                   before_join=None) -> int:
    """Form the control-plane star, then join the data plane's process
    group; returns this process's global rank.

    `num_processes` is the node count and `process_id` this node's rank
    (0 = the root); `world` is the product of the mesh axes, and this
    process is its node's first rank. Every node passes the same
    coordinator address ("host:port", reachable from every node). The
    control link forms FIRST: version/rank mismatches and unreachable roots
    surface as immediate structured errors with bounded waits, instead of
    a wait inside the process group's rendezvous — and the heartbeat covers
    the (collective-heavy) init/load phases from the moment the handshake
    completes. `before_join` runs between the two: the node's other local
    ranks start there (parallel/launch.py run_node)."""
    global _LINK
    if num_processes > 1:
        host = coordinator.rsplit(":", 1)[0]
        port = control_port(coordinator)
        if process_id == 0:
            link = RootLink(num_processes, "", port,
                            heartbeat_interval=heartbeat_interval,
                            worker_timeout=worker_timeout,
                            connect_timeout=connect_timeout)
        else:
            link = WorkerLink(host, port, process_id, num_processes,
                              heartbeat_interval=heartbeat_interval,
                              worker_timeout=worker_timeout,
                              connect_timeout=connect_timeout)
        link.form()
        # the diagnostic-exit policy arms BEFORE the rendezvous: a peer
        # that dies while everyone waits inside init_process_group must
        # still produce the bounded structured exit. Drivers may
        # re-install a richer handler afterwards (the api server's
        # supervisor mapping).
        link.on_peer_lost = diagnostic_exit
        _LINK = link
        set_phase("init")
    if before_join is not None:
        before_join()
    rank = node_ranks(process_id, world, num_processes)[0]
    join_data_plane(coordinator, rank, world, num_processes, device_type,
                    timeout_s)
    return rank


def join_data_plane(coordinator: str, rank: int, world: int, nnodes: int,
                    device_type: str, timeout_s: float) -> None:
    """Join the cluster's process group as global rank `rank` of `world`
    (its TCP store at the coordinator address, served by rank 0), then
    make, collectively and in one order on every rank, the gloo group for
    host arrays and one group a node. `timeout_s` bounds the rendezvous
    and every collective."""
    import torch.distributed as dist

    from .mesh import init_ranks

    global _HOST_GROUP, _NODE_GROUP
    backend = init_ranks(rank, world, f"tcp://{coordinator}", device_type,
                         timeout_s)
    local = world // nnodes
    _CLUSTER.update(rank=rank, nnodes=nnodes, node_rank=rank // local,
                    local=local)
    _HOST_GROUP = (None if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    _NODE_GROUP = None
    if local > 1:
        for node in range(nnodes):
            g = dist.new_group(node_ranks(node, world, nnodes),
                               backend="gloo")
            if node == _CLUSTER["node_rank"]:
                _NODE_GROUP = g


def cluster_rank() -> int:
    """This process's global rank (0 off-cluster)."""
    return _CLUSTER["rank"]


def is_multihost(mesh) -> bool:
    """Does this mesh span ranks started on more than one node? (If so,
    the logits a host reads must be whole on every rank, and host-side
    drivers must run the control-plane protocol.)"""
    return mesh is not None and _CLUSTER["nnodes"] > 1


def _bcast(arr: np.ndarray) -> np.ndarray:
    """Rank 0's host array on every rank (each rank passes one of the
    same shape and dtype), over gloo."""
    import torch
    import torch.distributed as dist

    arr = np.ascontiguousarray(arr)
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    dist.broadcast(t, 0, group=_HOST_GROUP)
    return t.numpy()


def _note_bcast(what: str, ms: float, nbytes: int = 0) -> None:
    """Record one startup data-plane broadcast into the cluster ledger
    (the bytes ride torch.distributed collectives the socket ledger cannot
    see — the host-side wall and payload size are what this plane CAN
    measure) and onto the trace timeline when the recorder is on."""
    link = _LINK
    if link is not None and link.stats is not None:
        st = link.stats
        if what == "spec":
            st.bcast_spec_ms = round((st.bcast_spec_ms or 0.0) + ms, 3)
        else:
            st.bcast_tensors_ms = round(
                (st.bcast_tensors_ms or 0.0) + ms, 3)
            st.bcast_tensors_bytes += int(nbytes)
    from ..runtime.trace import TRACER

    if TRACER.enabled:
        TRACER.event("bcast", getattr(link, "trace_tid", 0) or 0,
                     what=what, ms=round(ms, 3), bytes=int(nbytes))


class RunMsg:
    """One decoded protocol message."""

    def __init__(self, kind: int, tokens=None, body: bytes | None = None,
                 ints=None, max_tokens: int = 0, seed: int = 0,
                 temperature: float = 0.0, topp: float = 0.0,
                 reset: bool = False, lookup: int = 0,
                 trace_tid: int = 0):
        self.kind = kind
        self.tokens = tokens
        self.body = body
        self.ints = ints
        self.max_tokens = max_tokens
        self.seed = seed
        self.temperature = temperature
        self.topp = topp
        self.lookup = lookup
        self.reset = reset
        self.trace_tid = trace_tid


def _require_link() -> RootLink | WorkerLink:
    if _LINK is None:
        raise RuntimeError(
            "no cluster control link — init_multihost() was never called "
            "in this process (single-process runs have no protocol)")
    return _LINK


def _send(kind: int, *, int_payload=None, bytes_payload: bytes | None = None,
          max_tokens: int = 0, seed: int = 0, temperature: float = 0.0,
          topp: float = 0.0, reset: bool = False, lookup: int = 0,
          trace_tid: int = 0) -> None:
    assert int_payload is None or bytes_payload is None
    n = (len(int_payload) if int_payload is not None
         else len(bytes_payload) if bytes_payload is not None else 0)
    header = [
        kind, n, int(bytes_payload is not None), max_tokens,
        seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
        int(np.float32(temperature).view(np.int32)),
        int(np.float32(topp).view(np.int32)),
        int(reset),
        int(lookup),
        int(trace_tid),
    ]
    if int_payload is not None:
        payload = np.asarray(int_payload, "<i8").tobytes()
    elif bytes_payload is not None:
        payload = bytes(bytes_payload)
    else:
        payload = b""
    link = _require_link()
    assert isinstance(link, RootLink), "only rank 0 sends protocol messages"
    link.broadcast(kind, header, payload)
    _relay((kind, header, payload))


def _relay(frame=None):
    """A node's protocol frame from its link holder (the node's first
    rank) to its other local ranks, over the node's gloo group; returns
    the frame on every rank of the node. A no-op on a one-rank node."""
    if _NODE_GROUP is None:
        return frame
    import torch.distributed as dist

    box = [frame]
    src = _CLUSTER["node_rank"] * _CLUSTER["local"]
    dist.broadcast_object_list(box, src=src, group=_NODE_GROUP)
    return box[0]


def recv_msg(timeout: float | None = None) -> RunMsg:
    """Worker: block for the next protocol message. The wait is supervised
    (root loss raises a structured ClusterPeerLost within the heartbeat
    bound), never an unbounded socket read. A node's other local ranks
    (the root node's too) wait on their link holder's relay instead,
    bounded by the process group's timeout; a link holder exits on a lost
    peer, and its local ranks follow it (parallel/launch.py)."""
    if _LINK is None and _NODE_GROUP is not None:
        # a node's other local rank: its link holder relays the frame
        kind, h, payload = _relay()
    else:
        link = _require_link()
        assert isinstance(link, WorkerLink), "only workers receive messages"
        kind, h, payload = _relay(link.recv(timeout=timeout))
    if len(h) < _HEADER_LEN:
        raise ClusterProtocolError(
            f"short protocol header: {len(h)} ints (kind={kind})")
    n, is_bytes = int(h[1]), int(h[2])
    msg = RunMsg(
        kind,
        max_tokens=int(h[3]),
        seed=int(h[4]) | (int(h[5]) << 32),
        temperature=float(np.int32(h[6]).view(np.float32)),
        topp=float(np.int32(h[7]).view(np.float32)),
        reset=bool(h[8]),
        lookup=int(h[9]),
        trace_tid=int(h[10]),
    )
    if n:
        if is_bytes:
            msg.body = payload
        else:
            msg.ints = [int(v) for v in np.frombuffer(payload, "<i8")]
            if kind == MSG_RUN:
                msg.tokens = msg.ints
    return msg


# -- root-side senders -----------------------------------------------------

def send_run(tokens: list[int], max_tokens: int, seed: int,
             temperature: float, topp: float, reset: bool = False,
             lookup: int = 0, trace_tid: int = 0) -> None:
    """Root: announce one generate() run. seed carries the root sampler's
    CURRENT rng state, so workers reproduce the token stream even when
    their own sampler flags differ. lookup > 0 = the run speculates with
    that draft length: drafts are mined from the (replicated) token
    stream, so every process mines the SAME drafts and the verify-forward
    shapes stay in lock-step across the cluster. trace_tid links the
    workers' span events to the root's timeline (0 = untraced)."""
    _send(MSG_RUN, int_payload=tokens, max_tokens=max_tokens, seed=seed,
          temperature=temperature, topp=topp, reset=reset, lookup=lookup,
          trace_tid=trace_tid)


def send_api(body_json: bytes) -> None:
    """Root: announce one API request; workers replay the identical
    completion loop from the raw request body."""
    _send(MSG_API, bytes_payload=body_json)


def send_xfer_bench(n_prompt: int) -> None:
    """Root: announce the benchmark's collective-microbench sequence.
    ``n_prompt`` rides the header so every worker runs the IDENTICAL
    measure_transfer_ms() + measure_prefill_transfer_ms(n_prompt)
    calls (which run real collectives over the whole mesh, the pp hops
    included) — the root running a measure the workers skip deadlocks the
    whole cluster."""
    _send(MSG_XFER_BENCH, max_tokens=int(n_prompt))


def send_shutdown() -> None:
    _send(MSG_SHUTDOWN)


# -- startup handshake -----------------------------------------------------

def check_config(fingerprint: list[int]) -> None:
    """Verify every process launched with the same mesh/dtype/sampler config
    (the reference ships its spec as a raw struct memcpy and is silently
    ABI-fragile — ref: src/transformer.cpp:633). All-gathered so EVERY rank
    sees every other rank's fingerprint: a mismatch errors symmetrically and
    immediately on all processes, instead of one side exiting while the
    other hangs in its next collective."""
    import torch
    import torch.distributed as dist

    mine = torch.as_tensor(np.asarray(fingerprint, np.int64))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine, group=_HOST_GROUP)
    allfp = torch.stack(parts).numpy()
    bad = [r for r in range(allfp.shape[0]) if list(allfp[r]) != list(allfp[0])]
    if bad:
        raise SystemExit(
            f"cluster config mismatch: rank 0 has {list(allfp[0])}, "
            f"rank(s) {bad} differ (mine: {mine.tolist()}) — every process "
            "must use the same MODEL (.m) and TOKENIZER (.t) files and the "
            "same --tp/--dp/--sp/--ep/--pp, dtype, seq-len and sampler "
            "flags")


def bcast_spec(spec, model_fp: int = 0, push: bool = False):
    """Root-push phase 0: rank 0 broadcasts the model spec, weight-content
    fingerprint, and its --push-weights flag so FILE-LESS workers can
    participate in the config check and build their engine without ever
    reading a `.m`. Non-root callers pass spec=None; returns
    (spec, model_fp, push) on every rank.

    Runs UNCONDITIONALLY on every multihost startup (build_engine), not
    only in push mode: the collective sequence must be identical across
    processes regardless of per-process flags, or a --push-weights
    mismatch would deadlock in mismatched collectives BEFORE check_config
    could report it. With the sequence fixed, the flag rides here and the
    fingerprint check turns a mismatch into a symmetric error. Matches the
    reference root shipping its TransformerSpec struct ahead of the weight
    push (ref: src/transformer.cpp:633-644) — explicit fields, not a raw
    memcpy. Every rank takes part, a node's other local ranks too."""
    from ..models.spec import ArchType, HiddenAct, ModelSpec
    from ..quants.types import FloatType

    if spec is not None:
        fields = [int(spec.arch), spec.dim, spec.hidden_dim, spec.n_layers,
                  spec.n_heads, spec.n_kv_heads, spec.vocab_size,
                  spec.seq_len, int(spec.hidden_act),
                  int(np.float32(spec.rope_theta).view(np.int32)),
                  spec.n_experts, spec.n_active_experts,
                  int(spec.weights_float_type), spec.version,
                  model_fp & 0xFFFFFFFF, int(push)]
    else:
        fields = [0] * 16
    t0 = time.perf_counter()
    f = _bcast(np.asarray(fields, np.int64))
    _note_bcast("spec", (time.perf_counter() - t0) * 1e3)
    out = ModelSpec(
        arch=ArchType(int(f[0])), dim=int(f[1]), hidden_dim=int(f[2]),
        n_layers=int(f[3]), n_heads=int(f[4]), n_kv_heads=int(f[5]),
        vocab_size=int(f[6]), seq_len=int(f[7]),
        hidden_act=HiddenAct(int(f[8])),
        rope_theta=float(np.int32(f[9]).view(np.float32)),
        n_experts=int(f[10]), n_active_experts=int(f[11]),
        weights_float_type=FloatType(int(f[12])), version=int(f[13]))
    return out, int(f[14]), bool(f[15])


def bcast_model_tensors(spec, path: str | None):
    """Root-push phase 1: a HostTensor generator on EVERY rank. Rank 0
    streams its `.m` file tensor-by-tensor and broadcasts each tensor's
    raw file bytes; other ranks receive and decode the identical bytes —
    so a worker needs NO local model file (the reference's root pushes
    every worker its slice over TCP the same way,
    ref: src/transformer.cpp:562-591,685-720). One tensor is resident at a
    time on each host (the streamed-loader memory contract holds); feed
    this to models.loader.load_params_streamed(tensors=...), which keeps
    only this rank's shards and drops the rest."""
    from ..io.model_file import (_tensor_bytes, model_tensor_plan, read_spec,
                                 tensor_from_bytes)

    root = cluster_rank() == 0
    f = None
    if root:
        assert path is not None, "--push-weights root needs the model file"
        header_size = getattr(spec, "_header_size", None)
        if header_size is None:
            header_size = getattr(
                read_spec(path, spec.weights_float_type), "_header_size")
        f = open(path, "rb")
        f.seek(header_size)
    total_ms = 0.0
    total_bytes = 0
    try:
        for name, shape, ftype in model_tensor_plan(spec):
            nbytes = _tensor_bytes(shape, ftype)
            if root:
                raw = np.frombuffer(f.read(nbytes), np.uint8)
                if raw.size != nbytes:
                    raise EOFError(f"model file truncated at {name}")
            else:
                raw = np.zeros(nbytes, np.uint8)
            t0 = time.perf_counter()
            raw = _bcast(raw)
            total_ms += (time.perf_counter() - t0) * 1e3
            total_bytes += nbytes
            yield tensor_from_bytes(name, shape, ftype, raw.tobytes())
    finally:
        if f is not None:
            f.close()
        # one ledger note for the whole stream (per-tensor events would
        # be hundreds of lines for one number an operator wants)
        if total_bytes:
            _note_bcast("tensors", total_ms, total_bytes)


def broadcast_seed(seed: int) -> int:
    """Agree on one base sampler seed cluster-wide (the CLI default is
    time-based, which would diverge per host)."""
    if cluster_rank() == 0:
        _send(MSG_SEED, seed=seed)
        return seed
    msg = recv_msg()
    if msg.kind == MSG_SHUTDOWN:
        raise SystemExit("root shut down during startup")
    if msg.kind != MSG_SEED:
        raise SystemExit(f"protocol error: expected seed, got kind={msg.kind}")
    return msg.seed
