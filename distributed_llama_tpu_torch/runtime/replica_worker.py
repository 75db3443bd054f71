"""Process-isolated serving replicas: the worker entry point, its framed
transport and the parent-side process supervisor — the port of the JAX
package's runtime/replica_worker.py.

Thread replicas (runtime/router.py) share one interpreter, so a crash in
native code or a wedged CUDA call is a whole-service fault. This module
moves the fault boundary to the OS process:

  * ``python -m distributed_llama_tpu_torch.runtime.replica_worker`` runs
    ONE supervised Scheduler + Engine (runtime/resilience.EngineSupervisor,
    watchdog and all) per OS process, on the card unless its config says
    ``"device": "cpu"``, and serves submit, stream and admin verbs over the
    multi-node star's length-prefixed frame codec
    (parallel/multihost._send_frame/_recv_frame), with a deadline on every
    send and recv and keepalive frames while a step runs long. The
    socket-layer fault sites fire inside the codec unchanged.
  * ``WorkerClient`` is the parent's side: one short-lived connection a
    request (a dead worker is an EOF on exactly the requests it served),
    plus a persistent control connection for health, stats and admin.
    Connection loss mid-stream surfaces as a STRUCTURED retryable
    ``RequestError``, which feeds the router's bounded failover, so greedy
    retries of not-yet-streamed requests give the same tokens (the sampler
    spec rides the submit frame; the worker rebuilds it).
  * ``WorkerProc`` starts a local worker with ``subprocess`` (never a fork
    of a process with CUDA up): the port handshake through an atomically
    written port file, logs to a per-replica file, and exit-code
    CLASSIFICATION (``classify_exit``: a SIGKILL reads
    ``signal:SIGKILL``, a config typo ``config_error``). The respawn,
    backoff and breaker policy lives in the router's handle
    (runtime/router.RemoteReplicaHandle).

Each worker owns its CUDA context and its own weights. Its kernels are the
libraries ``ops/cuda_build.py`` builds, shared across processes (a per-pid
temporary file and an atomic rename).

The worker deals in TOKEN IDS only: the tokenizer, HTTP, routing, the
retry budget and the text scanning stay in the parent. The RMSG frames are
the JAX worker's, byte for byte.

Chaos surface: a worker armed with ``DLLAMA_FAULTS=worker_exit:...`` in its
environment ``os._exit``s immediately before a token frame (the
count-deterministic stand-in for SIGKILL); the tests also send a real
``SIGKILL`` to a worker mid-stream.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import queue as _pyqueue

import numpy as np

from ..parallel.multihost import (ClusterProtocolError, _recv_frame,
                                  _send_frame)
from .faults import FAULTS
from .kv_transfer import RMSG_BLOCK_QUERY
from .resilience import EngineUnready
from .scheduler import (PromptTooLong, QueueFull, RequestError,
                        SchedulerClosed)
from .stats import RequestStats, ServeStats
from .trace import TRACER

# the JAX worker's protocol version: v2 added the submit header's trace id
# and RMSG_TRACE, v3 RMSG_PROFILE, v4 the KV block transfer verbs and the
# submit header's fill fields, v5 the tenant and priority. The version
# handshake turns a mismatched parent and worker into a clean HELLO
# failure instead of a misparsed frame.
REPLICA_PROTOCOL_VERSION = 5

# message kinds — a namespace distinct from the cluster control plane's
# MSG_* so a replica socket accidentally pointed at a cluster control
# port (or vice versa) fails the handshake instead of misparsing frames
RMSG_HELLO = 100        # client -> worker: [protocol_version]
RMSG_HELLO_ACK = 101    # worker -> client: [version, ok, batch, seq_len, pid]
RMSG_SUBMIT = 102       # client -> worker: the request header + prompt ints
RMSG_ACCEPT = 103       # worker -> client: [request_id]
RMSG_REFUSE = 104       # worker -> client: JSON {code, message, ...}
RMSG_TOKEN = 105        # worker -> client: [token]
RMSG_DONE = 106         # worker -> client: JSON {finish_reason}
RMSG_ERROR = 107        # worker -> client: JSON structured error frame
RMSG_CANCEL = 108       # client -> worker, on the submit socket
RMSG_KEEPALIVE = 109    # worker -> client while a step runs long
RMSG_PING = 110         # client -> worker (control): health probe
RMSG_PONG = 111         # worker -> client: JSON health payload
RMSG_STATS = 112        # client -> worker (control)
RMSG_STATS_ACK = 113    # worker -> client: JSON supervisor summary
RMSG_RESET = 114        # client -> worker: reset the ENGINE breaker
RMSG_REBUILD = 115      # client -> worker: rebuild the supervisor in place
RMSG_SHUTDOWN = 116     # client -> worker: graceful exit 0
RMSG_OK = 117           # worker -> client: JSON ack for admin verbs
RMSG_TRACE = 118        # worker -> client: JSON span events for this
#                         request's trace id, sent just before the
#                         terminal frame (the parent tracer merges them
#                         onto its own timeline — runtime/trace.py)
RMSG_PROFILE = 119      # client -> worker (control): [ms] — write one
#                         torch.profiler trace of the next ms milliseconds
#                         into THIS worker's capture dir; RMSG_OK carries
#                         {dir} back (the /admin/profile relay,
#                         runtime/profiler.py)
# 120..124: the KV block transfer verbs (RMSG_BLOCK_QUERY/ACK/FETCH/
#           DATA/END) — runtime/kv_transfer.py owns them; the server
#           below dispatches a QUERY-opening connection to BlockDonor

# [max_tokens, temp_bits, topp_bits, rng_lo, rng_hi, vocab, deadline_ms,
#  n_eos, trace_id, fill_port, fill_expected, fill_donor, priority,
#  tenant_len] then n_eos stop ids then the prompt; the payload carries
# the fill donor's host (utf-8, empty when fill_port == 0 — no fill
# requested) followed by tenant_len bytes of utf-8 tenant name
# (tenant_len == 0 — untagged). fill_donor is the donor's replica id:
# the importer's wire ledger and kv_fill trace events attribute per
# donor, not to a constant peer. priority indexes fleet.PRIORITIES
# (negative — untagged, the worker's default band).
_SUBMIT_HEADER = 14

EXIT_WORKER_FAULT = 86   # the worker_exit fault site's os._exit code

_COUNTER_KEYS = ("requests_submitted", "requests_finished",
                 "requests_failed", "requests_expired",
                 "requests_rejected", "tokens_out", "steps")


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _bits_f32(b: int) -> float:
    return float(np.int32(b).view(np.float32))


# -- worker-side server ----------------------------------------------------


def _sup_counters(sup) -> dict:
    """Cross-generation counter totals of one EngineSupervisor WITHOUT the
    percentile sorts of summary() — cheap enough to ride every PONG (the
    parent caches them, so a SIGKILL loses at most one poll interval of
    counts and never double-counts)."""
    with sup._state_lock:
        sched = sup._sched
        carry = dict(sup._carry)
        dead = list(sup._dead_stats)
    return {k: (getattr(sched.stats, k, 0) + carry[k]
                + sum(getattr(d, k, 0) for d in dead))
            for k in _COUNTER_KEYS}


class ReplicaServer:
    """The worker process's serving loop: accept framed connections, run
    one supervised engine, stream tokens. One thread per connection; a
    submit connection carries exactly one request (ACCEPT → TOKEN* →
    DONE/ERROR), a control connection loops PING/STATS/admin verbs.

    ``sup_factory`` builds the EngineSupervisor — kept so RMSG_REBUILD
    can replace the whole supervisor in place (the rolling-restart verb:
    fresh engine + cache + empty prefix tree, params shared via the
    factory's closure) while counters carry across the swap."""

    def __init__(self, sup_factory, *, host: str = "127.0.0.1",
                 port: int = 0, io_timeout: float = 30.0,
                 keepalive: float = 2.0, idle_timeout: float = 600.0,
                 fault_key: str | None = None,
                 profile_dir: str | None = None,
                 kv_transfer: bool = False, tier: str = "mixed"):
        from .kv_transfer import BlockDonor
        from .stats import KVTransferStats

        self._factory = sup_factory
        self._io = float(io_timeout)
        self._keepalive = float(keepalive)
        self._idle = float(idle_timeout)
        self._fault_key = fault_key
        self._profile_dir = profile_dir  # RMSG_PROFILE capture home
        self._sup_lock = threading.RLock()
        self.sup = sup_factory()  # dlrace: guarded-by(self._sup_lock)
        # cross-replica KV block transfer (runtime/kv_transfer.py): this
        # worker serves sibling QUERY/FETCH connections as a donor and
        # runs its own fills when a submit carries donor coordinates.
        # The stats block rides every /stats reply even when disabled
        # (enabled=False — a tier must not lose the family to a flag);
        # `tier` is this worker's disaggregation role, advertised on
        # every PONG so the router places by role.
        self.tier = tier if tier in ("prefill", "decode", "mixed") \
            else "mixed"
        self.kvx_stats = KVTransferStats(enabled=bool(kv_transfer),
                                         tier=self.tier)
        self._kv_transfer = bool(kv_transfer)
        # this worker's replica index (fault_key "rK" -> K): the
        # requester id its fills stamp on BLOCK_QUERY frames so donors
        # account wire bytes per peer
        try:
            self.replica_index = int((fault_key or "r0").lstrip("r"))
        except ValueError:
            self.replica_index = 0
        pc = self.sup.prefix_cache
        if pc is not None:
            from .kv_transfer import block_payload_bytes

            eng = self.sup.engine
            self.kvx_stats.block_len = pc.block_len
            self.kvx_stats.block_bytes = block_payload_bytes(
                eng.spec.n_layers, eng.spec.n_kv_heads, pc.block_len,
                eng.spec.head_size, eng.cache_dtype)
        self._donor = BlockDonor(lambda: self.sup, self.kvx_stats,
                                 fault_key=fault_key,
                                 io_timeout=self._io)
        # rebuild carry: RMSG_REBUILD swaps the supervisor wholesale, so
        # the dying one's cross-generation totals fold in here and every
        # STATS/PONG reply adds them back — counters never reset or
        # double-count across a rolling restart (the same contract the
        # thread replicas keep)
        self._carry = {k: 0 for k in _COUNTER_KEYS}
        self._bind = (host, int(port))
        self._srv: socket.socket | None = None
        self._done = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        self._srv = socket.create_server(self._bind, backlog=16,
                                         reuse_port=False)
        self._srv.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop,
                             name="dllama-replica-accept", daemon=True)
        t.start()
        return self._srv.getsockname()[1]

    def wait(self) -> None:
        self._done.wait()

    def shutdown(self) -> None:
        """Graceful exit: stop accepting, fail in-flight work with
        structured shutdown frames (EngineSupervisor.close's contract),
        release main()."""
        if self._done.is_set():
            return
        self._done.set()
        try:
            with self._sup_lock:
                self.sup.close(timeout=10.0)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._conn_main, args=(conn,),
                             daemon=True).start()

    # -- per-connection protocol -------------------------------------------

    def _conn_main(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            frame = _recv_frame(conn, timeout=self._io)
            if frame is None or frame[0] != RMSG_HELLO or not frame[1]:
                return
            ok = int(frame[1][0] == REPLICA_PROTOCOL_VERSION)
            with self._sup_lock:
                eng = self.sup.engine
            _send_frame(conn, RMSG_HELLO_ACK,
                        [REPLICA_PROTOCOL_VERSION, ok, eng.batch,
                         eng.seq_len, os.getpid()], timeout=self._io)
            if not ok:
                return
            frame = _recv_frame(conn, timeout=self._idle)
            if frame is None:
                return
            if frame[0] == RMSG_SUBMIT:
                self._handle_submit(conn, frame[1], frame[2])
            elif frame[0] == RMSG_BLOCK_QUERY:  # donor serving
                # (runtime/kv_transfer.BlockDonor). A worker with the
                # transfer plane OFF answers a clean miss instead of
                # serving (mixed --replica-hosts fleets, where each
                # worker's own config decides kv_transfer)
                if self._kv_transfer:
                    self._donor.serve(conn, frame)
                else:
                    from .kv_transfer import RMSG_BLOCK_ACK

                    _send_frame(conn, RMSG_BLOCK_ACK,
                                [0, 0, 0, 0, 0, 0, 0],
                                timeout=self._io)
            else:
                self._control_loop(conn, frame)
        except (OSError, ClusterProtocolError):
            pass  # a dead/garbled client costs this connection only
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_submit(self, conn: socket.socket, ints: list[int],
                       payload: bytes = b"") -> None:
        from ..sampler import Sampler

        if len(ints) < _SUBMIT_HEADER:
            raise ClusterProtocolError(f"short submit header: {len(ints)}")
        (max_tokens, temp_b, topp_b, rng_lo, rng_hi, vocab,
         deadline_ms, n_eos, trace_id, fill_port,
         fill_expected, fill_donor, prio_idx,
         tenant_len) = ints[:_SUBMIT_HEADER]
        # fairness tags (v5): the fill host is the payload's head, the
        # tenant name its tail — split by the header's declared length
        fill_payload, tenant = payload, None
        if tenant_len > 0:
            fill_payload = payload[:-tenant_len]
            tenant = payload[-tenant_len:].decode("utf-8",
                                                  errors="replace")
        from .fleet import PRIORITIES

        priority = (PRIORITIES[prio_idx]
                    if 0 <= prio_idx < len(PRIORITIES) else "normal")
        eos = [int(t) for t in ints[_SUBMIT_HEADER:_SUBMIT_HEADER + n_eos]]
        prompt = [int(t) for t in ints[_SUBMIT_HEADER + n_eos:]]
        sampler = Sampler(int(vocab), temperature=_bits_f32(temp_b),
                          topp=_bits_f32(topp_b),
                          seed=(rng_lo & 0xFFFFFFFF) | (rng_hi << 32))
        # the wire carries the REMAINING budget (absolute perf_counter
        # clocks do not transfer between processes); rebased here so the
        # scheduler's in-step reaper enforces the same end-to-end bound
        deadline = (None if deadline_ms < 0
                    else time.perf_counter() + deadline_ms / 1e3)
        with self._sup_lock:
            sup = self.sup
        # cache FILL on miss (runtime/kv_transfer.py): the router knows a
        # sibling holds a longer prefix than this replica — fetch its
        # blocks into the local radix tree BEFORE admission, so the
        # ordinary _admit seeds them and only the uncached suffix
        # prefills. Degrades to a plain re-prefill on ANY failure; the
        # donor's answer rides the ACCEPT frame back so the router can
        # clear stale shadow entries (a QUERY miss == donor eviction).
        fill_answer = -1
        # the transfer's budget is bounded by the REQUEST's remaining
        # budget, not just the io timeout: a wedged donor must degrade
        # to a re-prefill with time left to actually serve — a fill
        # that eats the whole deadline would convert a transfer failure
        # into the client-visible request failure the degrade contract
        # forbids (half the budget for the fill, floor 0.25 s to skip
        # hopeless attempts)
        fill_budget = min(self._io, 15.0)
        if deadline_ms >= 0:
            fill_budget = min(fill_budget, deadline_ms / 1e3 * 0.5)
        if fill_port > 0 and self._kv_transfer and fill_budget >= 0.25:
            from .kv_transfer import fill_from_wire

            host = (fill_payload.decode("utf-8", errors="replace")
                    if fill_payload else "127.0.0.1")
            try:
                sched = sup._sched
            except AttributeError:
                sched = None
            if sched is not None:
                fill_answer = fill_from_wire(
                    sched, prompt, host, int(fill_port),
                    int(fill_expected), stats=self.kvx_stats,
                    protocol_version=REPLICA_PROTOCOL_VERSION,
                    trace_id=int(trace_id),
                    requester=self.replica_index,
                    donor_peer=int(fill_donor),
                    io_timeout=min(self._io, 10.0),
                    deadline_s=fill_budget)
        try:
            # the PARENT minted the trace id: worker-side scheduler events
            # carry it so the shipped span merges onto the parent's
            # timeline (trace_id=0 -> None lets an untraced parent leave
            # the worker's own minting behavior unchanged)
            req = sup.submit(prompt, int(max_tokens), sampler,
                             eos_id=set(eos) or None, deadline=deadline,
                             trace_id=int(trace_id) or None,
                             tenant=tenant, priority=priority)
        except QueueFull as e:
            self._refuse(conn, {"code": "queue_full", "message": str(e),
                                "retry_after": e.retry_after})
            return
        except EngineUnready as e:
            self._refuse(conn, {"code": "unready", "message": str(e),
                                "state": e.state,
                                "retry_after": e.retry_after})
            return
        except PromptTooLong as e:
            self._refuse(conn, {"code": "prompt_too_long",
                                "message": str(e)})
            return
        except SchedulerClosed as e:
            self._refuse(conn, {"code": "closed", "message": str(e)})
            return
        # two Python socket objects over one fd (the multihost._Peer
        # discipline): the cancel watcher re-arms read deadlines on
        # `conn` while this thread sends tokens on the dup — shared
        # settimeout() state would race the two directions' budgets
        wsock = conn.dup()
        done = threading.Event()
        try:
            # the ACCEPT echoes the fill verdict (donor's answered match
            # in tokens; -1 = no verdict) + what the router expected —
            # the shadow-staleness feedback channel, no extra RPC
            _send_frame(wsock, RMSG_ACCEPT,
                        [req.id, fill_answer, int(fill_expected)],
                        timeout=self._io)
            threading.Thread(target=self._cancel_watcher,
                             args=(conn, req, done), daemon=True).start()
            self._pump(wsock, req)
        except (OSError, ClusterProtocolError):
            req.cancel()  # client gone: free the slot now
        finally:
            done.set()
            try:
                wsock.close()
            except OSError:
                pass

    def _cancel_watcher(self, conn: socket.socket, req, done) -> None:
        """Read the submit socket for RMSG_CANCEL / EOF while the stream
        runs — a disconnected client's request must stop burning forwards
        (the scheduler reaps the cancel at its next iteration)."""
        while not done.is_set():
            try:
                frame = _recv_frame(conn, timeout=0.25)
            except socket.timeout:
                continue
            except (OSError, ClusterProtocolError):
                req.cancel()
                return
            if frame is None:          # client closed its end
                req.cancel()
                return
            if frame[0] == RMSG_CANCEL:
                req.cancel()           # keep reading to the EOF

    def _pump(self, wsock: socket.socket, req) -> None:
        """Drain one ServeRequest's event queue onto the socket. Reads
        the queue directly (not tokens()) so idle gaps turn into
        keepalive frames instead of a client-side deadline: the client's
        per-frame recv deadline then only ever fires on a genuinely
        frozen worker process, while slow steps and the worker's OWN
        stall/crash recovery stay inside the protocol."""
        while True:
            try:
                kind, val = req.events.get(timeout=self._keepalive)
            except _pyqueue.Empty:
                _send_frame(wsock, RMSG_KEEPALIVE, [], timeout=self._io)
                continue
            if kind == "token":
                if FAULTS.triggered("worker_exit", key=self._fault_key):
                    # the SIGKILL/OOM shape, count-deterministic: no
                    # flush, no teardown, no DONE frame — the client
                    # sees a mid-frame EOF exactly like a real -9
                    os._exit(EXIT_WORKER_FAULT)
                _send_frame(wsock, RMSG_TOKEN, [val], timeout=self._io)
            elif kind == "done":
                self._ship_trace(wsock, req)
                _send_frame(wsock, RMSG_DONE, [], json.dumps(
                    {"finish_reason": req.finish_reason or val}).encode(),
                    timeout=self._io)
                return
            else:  # structured error frame (dict) or legacy string
                frame = (dict(val) if isinstance(val, dict)
                         else {"code": "error", "message": str(val),
                               "retryable": True})
                self._ship_trace(wsock, req)
                _send_frame(wsock, RMSG_ERROR, [],
                            json.dumps(frame).encode(), timeout=self._io)
                return

    def _ship_trace(self, wsock: socket.socket, req) -> None:
        """Ship this request's worker-side span ahead of the terminal
        frame (RMSG_TRACE): events carry wall-clock timestamps so the
        parent tracer rebases them onto ITS monotonic timeline — a
        surviving request's cross-process story merges; a SIGKILLed
        worker simply never ships (the parent's own casualty events and
        the monitor's classified worker_exit tell that half)."""
        tid = getattr(req, "trace_id", 0)
        if not tid or not TRACER.enabled:
            return
        events = TRACER.export_span(tid)
        if events:
            _send_frame(wsock, RMSG_TRACE, [tid],
                        json.dumps({"events": events}).encode(),
                        timeout=self._io)

    def _refuse(self, conn: socket.socket, payload: dict) -> None:
        _send_frame(conn, RMSG_REFUSE, [], json.dumps(payload).encode(),
                    timeout=self._io)

    # -- control connection ------------------------------------------------

    def _control_loop(self, conn: socket.socket, frame) -> None:
        while frame is not None and not self._done.is_set():
            kind = frame[0]
            if kind == RMSG_PING:
                _send_frame(conn, RMSG_PONG, frame[1],
                            json.dumps(self._health()).encode(),
                            timeout=self._io)
            elif kind == RMSG_STATS:
                _send_frame(conn, RMSG_STATS_ACK, [],
                            json.dumps(self._summary()).encode(),
                            timeout=self._io)
            elif kind == RMSG_RESET:
                with self._sup_lock:
                    self.sup.reset_breaker()
                self._ok(conn)
            elif kind == RMSG_REBUILD:
                self._rebuild()
                self._ok(conn)
            elif kind == RMSG_PROFILE:
                # on-demand capture relay (POST /admin/profile on the
                # parent): synchronous — the OK frame means the trace is
                # on disk in THIS worker's capture dir. The client sizes
                # its recv deadline to ms + slack.
                ms = float(frame[1][0]) if frame[1] else 100.0
                _send_frame(conn, RMSG_OK, [],
                            json.dumps(self._profile(ms)).encode(),
                            timeout=self._io)
            elif kind == RMSG_SHUTDOWN:
                self._ok(conn)
                self.shutdown()
                return
            else:
                return  # unknown verb: drop the connection
            frame = _recv_frame(conn, timeout=self._idle)

    def _ok(self, conn: socket.socket) -> None:
        _send_frame(conn, RMSG_OK, [], json.dumps({"ok": True}).encode(),
                    timeout=self._io)

    def _profile(self, ms: float) -> dict:
        """One torch.profiler capture into this worker's own directory
        (two processes must never share one trace dir, same rule as the
        trace sink's per-worker subdirs)."""
        import tempfile

        from .profiler import PROFILER

        base = self._profile_dir or tempfile.mkdtemp(
            prefix=f"dlprof-worker-{os.getpid()}-")
        d = os.path.join(base, f"profile-{int(time.time() * 1e3):x}")
        try:
            return {"ok": True, **PROFILER.capture(d, ms)}
        except RuntimeError as e:  # capture busy
            return {"ok": False, "error": str(e)}

    def _health(self) -> dict:
        """The PONG payload: routability signals + counter snapshot. The
        parent's monitor caches it, so placement (load), drain (busy) and
        the shadow-index invalidation (recoveries — a supervisor rebuild
        emptied the radix tree) never RPC on the submit hot path."""
        with self._sup_lock:
            sup = self.sup
            carry = dict(self._carry)
        sched = sup._sched
        load = (len(sched._queue)
                + sum(1 for s in sched.slots if s.req is not None))
        counters = _sup_counters(sup)
        for k in _COUNTER_KEYS:
            counters[k] += carry[k]
        return {"state": sup.state, "ready": sup.ready, "load": load,
                "busy": load > 0,
                "recoveries": sup.sup_stats.recoveries,
                # the disaggregation role — connect-mode routers learn it
                # from here (spawn mode ships it in the worker config)
                "tier": self.tier,
                "counters": counters}

    def _summary(self) -> dict:
        with self._sup_lock:
            sup = self.sup
            carry = dict(self._carry)
        out = sup.summary()
        for k in _COUNTER_KEYS:
            out[k] = out.get(k, 0) + carry[k]
        out["pid"] = os.getpid()
        # this worker's transfer-plane record (donor serving + its own
        # fills) — present even when transfer is off (enabled=False)
        out["kv_transfer"] = self.kvx_stats.summary()
        out["tier"] = self.tier
        if TRACER.enabled:
            # the step timeline is WORKER-local (the parent never sees
            # our iterations) — ride it on the stats reply so the bench
            # procs row and a curious operator get it across the
            # boundary without a new verb
            out["step_timeline"] = TRACER.steps.summary_json()
            out["trace"] = TRACER.summary()
        return out

    def _rebuild(self) -> None:
        """The rolling-restart verb: tear down the current supervisor
        (in-flight work gets structured shutdown frames — the router
        drains the replica first, so normally there is none), fold its
        lifetime counters into the carry, build a fresh one (params
        shared through the factory closure; warmup runs inside the
        supervisor constructor so the replica answers ready=True only
        once it can actually serve)."""
        with self._sup_lock:
            old = self.sup
            old.close(timeout=30.0)
            for k, v in _sup_counters(old).items():
                self._carry[k] += v
            self.sup = self._factory()


# -- worker construction from a config dict --------------------------------


def build_supervisor_factory(cfg: dict):
    """(engine config dict) -> zero-argument EngineSupervisor factory.

    Two engine sources:
      * ``test_spec`` — a ModelSpec field dict and an RNG ``seed``/
        ``scale``: seeded synthetic weights (models/params.random_tensors,
        the JAX package's draws), so a parent building the same spec and
        seed holds the same params — the greedy-parity oracle of the
        process chaos tests;
      * ``model`` — a ``.m`` path, streamed as the CLI loads it (each
        worker owns its weights: process isolation trades the thread
        tier's shared weights for a real fault boundary).

    ``device`` is ``cuda`` unless the config says ``cpu``; with no card a
    cuda worker exits with its error (it never serves from the CPU).
    Params load ONCE here; the factory closes over them, so crash-recovery
    rebuilds and RMSG_REBUILD swaps mint fresh engines and caches without
    reading weights again."""
    import torch

    from ..models.spec import ArchType, HiddenAct, ModelSpec
    from ..quants.types import FloatType
    from ..utils.device import resolve_device
    from .engine import Engine
    from .resilience import EngineSupervisor

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
              "f8": torch.float8_e4m3fn}
    device = resolve_device(cfg.get("device", "cuda"))
    compute = dtypes[cfg.get("compute_dtype", "f32")]
    cache = dtypes[cfg.get("cache_dtype", cfg.get("compute_dtype", "f32"))]
    q80 = cfg.get("buffer_float_type", "f32") == "q80"

    if "test_spec" in cfg:
        from ..models.params import load_params, random_tensors

        ts = dict(cfg["test_spec"])
        ts["arch"] = ArchType[ts.get("arch", "LLAMA")]
        ts["hidden_act"] = HiddenAct[ts.get("hidden_act", "SILU")]
        spec = ModelSpec(**ts)
        host = random_tensors(spec, seed=int(cfg.get("seed", 0)),
                              scale=float(cfg.get("scale", 0.02)))
        params = load_params(spec, host, mode=cfg.get("mode", "dense"),
                             dtype=compute, device=device)
        model_fp = 0
    else:
        from ..io.model_file import content_fingerprint, read_spec
        from ..models.loader import load_params_streamed

        wft = cfg.get("weights_float_type")
        spec = read_spec(cfg["model"],
                         weights_float_type=(FloatType[wft.upper()]
                                             if wft else None))
        model_fp = content_fingerprint(cfg["model"])
        params, _ = load_params_streamed(spec, cfg["model"], device,
                                         dtype=compute)

    batch = int(cfg.get("batch", 1))
    serve = dict(cfg.get("serve", {}))
    # the first generation's engine; a rebuild spawns the next over the
    # same weights (Engine.spawn: a fresh cache and graphs)
    template = Engine(spec, params, device=device, batch=batch,
                      max_seq_len=cfg.get("max_seq_len"),
                      compute_dtype=compute, cache_dtype=cache,
                      prefill_chunk=int(cfg.get("prefill_chunk") or 256),
                      # the CLI's rule: Q80 activations for Q40 weights
                      activation_q80=(q80 and spec.weights_float_type
                                      == FloatType.Q40),
                      model_fingerprint=model_fp)

    built = []

    def engine_factory():
        eng = template.spawn(batch) if built else template
        built.append(1)
        return eng

    n_blocks = 0
    if cfg.get("prefix_cache"):
        bl = int(cfg.get("prefix_block_len", 32))
        n_blocks = int(cfg.get("prefix_blocks", 0)) or max(
            2 * batch * template.seq_len // bl, 1)
    sup_kwargs = dict(
        chunk=serve.get("chunk") or None,
        max_queue=int(serve.get("max_queue", 0)) or 4 * batch,
        request_deadline=serve.get("request_deadline") or None,
        stall_timeout=serve.get("stall_timeout") or 10.0,
        prefix_blocks=n_blocks,
        prefix_block_len=int(cfg.get("prefix_block_len", 32)),
        # the block-transfer plane (runtime/kv_transfer.py)
        kv_transfer=bool(cfg.get("kv_transfer")),
        fault_key=cfg.get("fault_key"),
        # the SLO admission policy runs INSIDE each worker (it reads the
        # worker's own step timeline)
        slo_ttft_ms=serve.get("slo_ttft_ms"),
        slo_itl_ms=serve.get("slo_itl_ms"),
        # per-slot speculation (runtime/draft.py): each worker builds its
        # own DraftModel over its own engine a generation; the spec
        # string ships, never weights
        draft=cfg.get("draft"), draft_len=int(cfg.get("draft_len", 0)),
        draft_vocab=cfg.get("draft_vocab"))

    # weighted-fair admission (runtime/fleet.py): the budget SPEC ships in
    # the config; the ledger lives here, outside the supervisor's
    # generations, so budgets survive rebuilds and fairness holds in this
    # worker's queue, where the waiting happens
    tb = serve.get("tenant_budgets")
    if tb:
        from .fleet import TenantLedger, WFQueue, parse_tenant_budgets

        ledger = TenantLedger(parse_tenant_budgets(tb))
        sup_kwargs["fair_queue_factory"] = lambda: WFQueue(ledger)

    return lambda: EngineSupervisor(engine_factory, **sup_kwargs)


def config_from_cli_args(args, serve_batch: int) -> dict:
    """The worker config the api server ships to locally-spawned replicas
    (``--replica-procs``): exactly the engine+serving knobs `dllama api`
    itself was launched with, minus everything that stays in the parent
    (tokenizer, routing, HTTP)."""
    return {
        "model": args.model,
        "weights_float_type": getattr(args, "weights_float_type", None),
        "batch": serve_batch,
        "max_seq_len": getattr(args, "max_seq_len", None),
        "compute_dtype": getattr(args, "compute_dtype", "bf16"),
        "cache_dtype": getattr(args, "cache_dtype", "bf16"),
        "buffer_float_type": getattr(args, "buffer_float_type", "q80"),
        # the parent's device: a cuda parent's workers run on the card
        "device": getattr(args, "device", None) or "cuda",
        "prefix_cache": bool(getattr(args, "prefix_cache", False)),
        "prefix_blocks": int(getattr(args, "prefix_blocks", 0) or 0),
        "prefix_block_len": int(getattr(args, "prefix_block_len", None)
                                or 32),
        # KV block transfer (runtime/kv_transfer.py): the enable flag
        # ships; the per-replica `tier` role is stamped per index by
        # build_front_door, like fault_key
        "kv_transfer": bool(getattr(args, "kv_transfer", False)),
        # speculative decoding (runtime/draft.py): the draft SPEC ships
        # (the worker builds the DraftModel over its own engine);
        # draft_vocab is filled in by the api server once the tokenizer
        # is loaded (the verify argmax truncates at the tokenizer vocab).
        # The draft-len DEFAULT (7) applies here as on the local tiers:
        # argparse's sentinel is None, and shipping 0 with a draft armed
        # would fail the scheduler's draft_len >= 1 check in every worker
        "draft": getattr(args, "draft", None),
        "draft_len": int(getattr(args, "draft_len", None)
                         or (7 if getattr(args, "draft", None) else 0)),
        "serve": {
            "chunk": getattr(args, "serve_chunk", 0),
            "max_queue": getattr(args, "queue_depth", 0),
            "request_deadline": getattr(args, "request_deadline", 0.0),
            "stall_timeout": getattr(args, "stall_timeout", 0.0),
            "slo_ttft_ms": getattr(args, "slo_ttft_ms", None),
            "slo_itl_ms": getattr(args, "slo_itl_ms", None),
            # weighted-fair admission (runtime/fleet.py): the raw
            # --tenant-budgets spec ships so each worker's own WFQ
            # orders its queue by the same weights/budgets
            "tenant_budgets": getattr(args, "tenant_budgets", None),
        },
        # device-tier observability: the recompile sentinel freezes and
        # the attribution sampler sample INSIDE each worker; /admin/
        # profile captures land under per-worker subdirs of profile_dir
        "freeze_compiles": bool(getattr(args, "freeze_compiles", False)),
        "profile_sample": int(getattr(args, "profile_sample", 0) or 0),
        "profile_dir": getattr(args, "profile_dir", None),
        # flight recorder: workers trace whenever the parent does, so
        # span events exist on both sides of the process boundary
        **({"trace": {
            "capacity": getattr(args, "trace_buffer", None) or 8192,
            "sample": (1.0 if getattr(args, "trace_sample", None) is None
                       else args.trace_sample),
            "decode_every": getattr(args, "trace_decode_every", None) or 8,
            "dir": getattr(args, "trace_dir", None),
        }} if getattr(args, "trace", False) else {}),
    }


# -- worker CLI ------------------------------------------------------------


def _emit(event: str, **fields) -> None:
    print(json.dumps({"event": event, "t_wall": time.time(), **fields}),
          flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse_parser()
    args = p.parse_args(argv)
    # config problems exit FAST (code 2), before any engine work: the
    # parent's spawn breaker must see a crash-loop in milliseconds an
    # attempt, not a weight load each
    try:
        with open(args.config) as f:
            cfg = json.load(f)
        if "test_spec" not in cfg and "model" not in cfg:
            raise ValueError("config needs 'test_spec' or 'model'")
    except (OSError, ValueError) as e:
        _emit("config_error", error=f"{type(e).__name__}: {e}")
        return 2

    tr = cfg.get("trace")
    if tr:
        # per-worker flight recorder (runtime/trace.py): spans ship back
        # to the parent in RMSG_TRACE frames; a sink directory gets a
        # per-worker subdir so two processes never fight over one file
        # rotation sequence
        sink = tr.get("dir")
        if sink:
            sink = os.path.join(
                sink, f"worker-{cfg.get('fault_key') or os.getpid()}")
        TRACER.configure(capacity=int(tr.get("capacity", 8192)),
                         sample=float(tr.get("sample", 1.0)),
                         decode_every=int(tr.get("decode_every", 8)),
                         sink_dir=sink)

    # device-tier observability (runtime/profiler.py): the worker runs its
    # own graph ledger (with its freeze) and sampled device-time
    # attribution; their blocks ride the stats reply like every other
    # per-replica block
    from .profiler import COMPILES, PROFILER

    if cfg.get("freeze_compiles"):
        COMPILES.freeze = True
    PROFILER.sample_every = int(cfg.get("profile_sample", 0) or 0)
    profile_dir = cfg.get("profile_dir")
    if profile_dir:
        profile_dir = os.path.join(
            profile_dir, f"worker-{cfg.get('fault_key') or os.getpid()}")

    sup_factory = build_supervisor_factory(cfg)
    server = ReplicaServer(sup_factory, host=args.host, port=args.port,
                           io_timeout=args.io_timeout,
                           keepalive=args.keepalive,
                           fault_key=cfg.get("fault_key"),
                           profile_dir=profile_dir,
                           kv_transfer=bool(cfg.get("kv_transfer")),
                           tier=cfg.get("tier") or "mixed")
    port = server.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"port": port, "pid": os.getpid()}, f)
        os.replace(tmp, args.port_file)  # atomic: the parent never reads
        # a half-written handshake
    _emit("listening", port=port, pid=os.getpid(),
          fault_key=cfg.get("fault_key"))

    def _term(*_):
        server.shutdown()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    server.wait()
    _emit("exiting")
    return 0


def argparse_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="replica_worker",
        description="One supervised serving replica (Scheduler + Engine) "
                    "behind the framed replica protocol. Spawned by "
                    "`dllama api --replica-procs N`, or started by hand "
                    "on another host for --replica-hosts.")
    p.add_argument("--config", required=True,
                   help="JSON engine+serving config (see "
                        "build_supervisor_factory)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 for --replica-hosts "
                        "workers; the protocol has no auth — firewall "
                        "accordingly)")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = OS-assigned; see --port-file)")
    p.add_argument("--port-file", default=None,
                   help="write {port, pid} JSON here once listening — "
                        "the parent's spawn handshake")
    p.add_argument("--io-timeout", type=float, default=30.0,
                   help="per-socket deadline on every framed send/recv")
    p.add_argument("--keepalive", type=float, default=2.0,
                   help="keepalive frame cadence while a step runs long")
    return p


# -- parent-side client ----------------------------------------------------


class _RemoteStream:
    """One in-flight request on a worker process, as the parent sees it:
    duck-types the ``ServeRequest`` consumer surface (``tokens()``,
    ``cancel()``, ``finished``, ``finish_reason``, ``stats``) so
    ``RouterRequest`` wraps remote and in-process replicas identically.
    Connection loss before the terminal frame raises a RETRYABLE
    structured ``RequestError`` (code ``replica_lost``) — the router's
    existing failover machinery takes it from there."""

    def __init__(self, sock: socket.socket, io_timeout: float,
                 n_prompt: int, rid: int, trace_id: int = 0,
                 origin: str = "worker"):
        self.id = rid
        self.trace_id = trace_id
        self._origin = origin
        self._sock = sock
        self._wsock = sock.dup()   # cancel() sends here; reads stay on
        # _sock so the two directions' deadlines never share settimeout
        self._io = io_timeout
        self._iterating = False
        self.finished = threading.Event()
        self.finish_reason: str | None = None
        self.stats = RequestStats(n_prompt=n_prompt)
        self.stats.t_submit = time.perf_counter()
        # the ACCEPT frame's fill verdict (runtime/kv_transfer.py): the
        # donor's answered match in tokens (-1 = no fill / no verdict)
        # and what the router expected off its shadow index — the
        # router reads these right after submit to clear stale shadow
        # entries (a miss answer == donor-side eviction)
        self.fill_answer = -1
        self.fill_expected = 0

    def cancel(self) -> None:
        try:
            _send_frame(self._wsock, RMSG_CANCEL, [], timeout=2.0)
        except (OSError, ClusterProtocolError):
            pass  # worker gone: nothing left to cancel
        if not self._iterating:
            # no consumer will ever run tokens()'s finally: close now so
            # an abandoned pre-stream request cannot leak the socket
            self._close()

    def tokens(self, timeout: float = 600.0):
        self._iterating = True
        try:
            while True:
                try:
                    frame = _recv_frame(self._sock,
                                        timeout=min(self._io, timeout))
                except (OSError, ClusterProtocolError) as e:
                    self._trace_lost(f"{type(e).__name__}")
                    raise RequestError(
                        "replica_lost",
                        f"replica connection lost mid-request: "
                        f"{type(e).__name__}: {e}", retryable=True) from e
                if frame is None:
                    # mid-stream EOF: the worker process died (SIGKILL,
                    # OOM, segfault) — the kernel closed its sockets
                    self._trace_lost("eof")
                    raise RequestError(
                        "replica_lost",
                        "replica closed the connection before the "
                        "terminal frame (process died?)", retryable=True)
                kind = frame[0]
                if kind == RMSG_TOKEN:
                    now = time.perf_counter()
                    if self.stats.t_first is None:
                        self.stats.t_first = now
                        if TRACER.enabled and self.trace_id:
                            # the CLIENT-side TTFT edge: a SIGKILLed
                            # worker can never ship its span, so the
                            # casualty's "it was streaming" fact must be
                            # recorded on this side of the boundary.
                            # side="client" tells it apart from the
                            # worker's OWN first_token (which arrives
                            # later via RMSG_TRACE with the same origin
                            # but a smaller, worker-internal ttft_ms)
                            TRACER.event("first_token", self.trace_id,
                                         side="client",
                                         origin=self._origin,
                                         ttft_ms=round(
                                             (now - self.stats.t_submit)
                                             * 1e3, 3))
                    self.stats.n_out += 1
                    yield int(frame[1][0])
                elif kind == RMSG_KEEPALIVE:
                    continue
                elif kind == RMSG_TRACE:
                    # the worker's span events, wall-stamped; merge them
                    # onto the parent timeline (no-op when untraced)
                    if TRACER.enabled:
                        payload = json.loads(frame[2] or b"{}")
                        TRACER.ingest(payload.get("events", []),
                                      origin=self._origin)
                    continue
                elif kind == RMSG_DONE:
                    payload = json.loads(frame[2] or b"{}")
                    self.finish_reason = payload.get("finish_reason")
                    self.stats.t_done = time.perf_counter()
                    return
                elif kind == RMSG_ERROR:
                    fr = json.loads(frame[2] or b"{}")
                    self.finish_reason = "error"
                    raise RequestError(fr.get("code", "error"),
                                       fr.get("message", "replica error"),
                                       fr.get("retryable", True))
                else:
                    self._trace_lost(f"frame_kind_{kind}")
                    raise RequestError(
                        "replica_lost",
                        f"unexpected frame kind {kind} in a token stream",
                        retryable=True)
        finally:
            self.finished.set()
            self._close()

    def _trace_lost(self, how: str) -> None:
        """Parent-side casualty record: the worker died (or tore the
        connection) mid-request, so ITS tracer can never ship this span
        — the error event the timeline needs lives on this side."""
        if TRACER.enabled and self.trace_id:
            TRACER.event("error", self.trace_id, code="replica_lost",
                         retryable=True, n_out=self.stats.n_out,
                         how=how, side="client", origin=self._origin)

    def _close(self) -> None:
        for s in (self._sock, self._wsock):
            try:
                s.close()
            except OSError:
                pass


class WorkerClient:
    """Framed-codec speaker for one worker process. Submits open a fresh
    connection per request (failure isolation: a dying worker EOFs
    exactly the streams it owned); health/stats/admin verbs share one
    persistent control connection under a lock, reconnecting on error.
    Duck-types the slice of the EngineSupervisor surface the router's
    remote handle delegates here."""

    def __init__(self, host: str, port: int, *, io_timeout: float = 30.0,
                 connect_timeout: float = 5.0):
        self.addr = (host, int(port))
        self._io = float(io_timeout)
        self._connect_timeout = float(connect_timeout)
        self._ctrl: socket.socket | None = None
        self._ctrl_lock = threading.Lock()
        # shape template from the worker's HELLO ack (the slice of the
        # Engine surface the HTTP handlers read) — cached on the first
        # successful connect, kept across respawns (same config)
        self.batch: int | None = None
        self.seq_len: int | None = None
        # client-side latency window: the RequestStats the router's
        # summary() merges into tier percentiles (counters come from the
        # worker's own RSTATS — this window is timings only, so nothing
        # double-counts)
        self.stats = ServeStats()

    def set_addr(self, host: str, port: int) -> None:
        """Point at a respawned worker's new port (under the control
        lock so an in-flight admin verb never splits across processes)."""
        with self._ctrl_lock:
            self.addr = (host, int(port))
            self._drop_ctrl_locked()

    # -- submit path -------------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr,
                                        timeout=self._connect_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_frame(sock, RMSG_HELLO, [REPLICA_PROTOCOL_VERSION],
                        timeout=self._io)
            frame = _recv_frame(sock, timeout=self._io)
            if (frame is None or frame[0] != RMSG_HELLO_ACK
                    or len(frame[1]) < 2 or not frame[1][1]):
                raise ClusterProtocolError(
                    f"replica handshake rejected: {frame!r}")
            if len(frame[1]) >= 4:
                self.batch = int(frame[1][2])
                self.seq_len = int(frame[1][3])
            return sock
        except BaseException:
            sock.close()
            raise

    def submit(self, prompt, max_tokens, sampler, eos_id=None,
               deadline=None, trace_id: int = 0,
               fill: tuple | None = None, tenant: str | None = None,
               priority: str = "normal") -> _RemoteStream:
        """Place one request on the worker. Door refusals re-raise the
        SAME exception types the in-process supervisor uses (QueueFull /
        EngineUnready / PromptTooLong / SchedulerClosed), so the router's
        walk-past-refusals placement loop needs no remote special case; a
        worker that cannot even be reached is an EngineUnready door
        refusal too (the process is dead or respawning — its monitor
        will say so shortly).

        ``fill`` = (donor_host, donor_port, expected_tokens, donor_id)
        instructs the worker to fetch the donor's published KV blocks
        before admission (runtime/kv_transfer.py); the ACCEPT's fill
        verdict lands on the returned stream."""
        prompt = [int(t) for t in prompt]
        eos = ([eos_id] if isinstance(eos_id, int)
               else sorted(int(t) for t in (eos_id or ())))
        deadline_ms = (-1 if deadline is None else
                       max(int((deadline - time.perf_counter()) * 1e3), 0))
        fill_host, fill_port, fill_expected, fill_donor = (
            fill or ("", 0, 0, 0))
        # v5: priority rides as an index into fleet.PRIORITIES (-1 =
        # untagged), the tenant as payload-tail bytes sized by tenant_len
        from .fleet import PRIORITIES
        prio_idx = (PRIORITIES.index(priority)
                    if priority in PRIORITIES else -1)
        tenant_bytes = (tenant or "").encode("utf-8")
        rng = sampler.rng_state
        ints = [int(max_tokens), _f32_bits(sampler.temperature),
                _f32_bits(sampler.topp), rng & 0xFFFFFFFF,
                (rng >> 32) & 0xFFFFFFFF, sampler.vocab_size,
                deadline_ms, len(eos), int(trace_id), int(fill_port),
                int(fill_expected), int(fill_donor), prio_idx,
                len(tenant_bytes), *eos, *prompt]
        try:
            sock = self._connect()
        except (OSError, ClusterProtocolError) as e:
            raise EngineUnready(f"unreachable ({type(e).__name__})",
                                1.0) from e
        try:
            _send_frame(sock, RMSG_SUBMIT, ints,
                        payload=fill_host.encode("utf-8") + tenant_bytes,
                        timeout=self._io)
            frame = _recv_frame(sock, timeout=self._io)
        except (OSError, ClusterProtocolError) as e:
            sock.close()
            # the worker died between connect and accept: nothing can
            # have streamed, so this is a door refusal, not a failure
            raise EngineUnready(f"lost during submit "
                                f"({type(e).__name__})", 1.0) from e
        if frame is not None and frame[0] == RMSG_REFUSE:
            payload = json.loads(frame[2] or b"{}")
            sock.close()
            code = payload.get("code")
            msg = payload.get("message", code or "refused")
            if code == "queue_full":
                raise QueueFull(0, 0,
                                retry_after=payload.get("retry_after", 1.0))
            if code == "prompt_too_long":
                raise PromptTooLong(msg)
            if code == "closed":
                raise SchedulerClosed(msg)
            raise EngineUnready(payload.get("state", code or "unready"),
                                payload.get("retry_after", 1.0))
        if frame is None or frame[0] != RMSG_ACCEPT:
            sock.close()
            raise EngineUnready("bad accept frame", 1.0)
        rs = _RemoteStream(sock, self._io, len(prompt),
                           int(frame[1][0]) if frame[1] else 0,
                           trace_id=int(trace_id),
                           origin=f"worker@{self.addr[0]}:{self.addr[1]}")
        if len(frame[1]) >= 3:
            # the fill verdict the ACCEPT echoed (see _handle_submit)
            rs.fill_answer = int(frame[1][1])
            rs.fill_expected = int(frame[1][2])
        self.stats.requests.append(rs.stats)
        return rs

    # -- control path ------------------------------------------------------

    def _drop_ctrl_locked(self) -> None:
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except OSError:
                pass
            self._ctrl = None

    def _request(self, kind: int, ints=(), timeout: float | None = None):
        t = timeout or self._io
        with self._ctrl_lock:
            for attempt in (0, 1):
                try:
                    if self._ctrl is None:
                        self._ctrl = self._connect()
                    _send_frame(self._ctrl, kind, ints, timeout=t)
                    frame = _recv_frame(self._ctrl, timeout=t)
                    if frame is None:
                        raise ClusterProtocolError("control EOF")
                    return frame
                except (OSError, ClusterProtocolError):
                    self._drop_ctrl_locked()
                    if attempt:
                        raise
        raise AssertionError("unreachable")

    def ping(self, timeout: float = 3.0) -> dict | None:
        """Health probe; None when the worker is unreachable (the monitor
        turns that into ready=False, never an exception)."""
        try:
            frame = self._request(RMSG_PING, [0], timeout=timeout)
            if frame[0] != RMSG_PONG:
                return None
            return json.loads(frame[2] or b"{}")
        except (OSError, ClusterProtocolError):
            return None

    def stats_summary(self, timeout: float = 10.0) -> dict | None:
        try:
            frame = self._request(RMSG_STATS, timeout=timeout)
            if frame[0] != RMSG_STATS_ACK:
                return None
            return json.loads(frame[2] or b"{}")
        except (OSError, ClusterProtocolError):
            return None

    def reset_breaker(self, timeout: float = 10.0) -> bool:
        try:
            return self._request(RMSG_RESET, timeout=timeout)[0] == RMSG_OK
        except (OSError, ClusterProtocolError):
            return False

    def profile(self, ms: float, timeout: float | None = None
                ) -> dict | None:
        """RMSG_PROFILE: capture `ms` milliseconds of torch.profiler trace
        in the worker, into ITS capture dir. Synchronous — the deadline
        covers the capture window plus slack; None when the worker is
        unreachable or the verb failed."""
        try:
            frame = self._request(RMSG_PROFILE, [int(ms)],
                                  timeout=(timeout
                                           or float(ms) / 1e3 + 30.0))
            if frame[0] != RMSG_OK:
                return None
            out = json.loads(frame[2] or b"{}")
            return out if out.get("ok") else None
        except (OSError, ClusterProtocolError):
            return None

    def rebuild(self, timeout: float = 120.0) -> bool:
        """RMSG_REBUILD blocks until the worker's fresh supervisor is
        warmed — the rolling-restart step completes only once the replica
        can actually serve again."""
        try:
            return self._request(RMSG_REBUILD,
                                 timeout=timeout)[0] == RMSG_OK
        except (OSError, ClusterProtocolError):
            return False

    def shutdown(self, timeout: float = 10.0) -> bool:
        try:
            return self._request(RMSG_SHUTDOWN,
                                 timeout=timeout)[0] == RMSG_OK
        except (OSError, ClusterProtocolError):
            return False

    def close(self) -> None:
        with self._ctrl_lock:
            self._drop_ctrl_locked()


# -- parent-side process spawn/monitor -------------------------------------


def classify_exit(rc: int | None) -> str:
    """Human- and machine-readable exit classification for the supervisor
    log and the per-replica /stats proc block. Negative returncodes are
    deaths by signal (``signal:SIGKILL`` is the -9 the chaos tests
    deliver); 2 is a config error (a crash-loop the spawn breaker must
    catch); EXIT_WORKER_FAULT is the injected hard-exit site."""
    if rc is None:
        return "running"
    if rc == 0:
        return "clean"
    if rc < 0:
        try:
            return "signal:" + signal.Signals(-rc).name
        except ValueError:
            return f"signal:{-rc}"
    return {2: "config_error",
            EXIT_WORKER_FAULT: "fault_exit"}.get(rc, f"error:{rc}")


class WorkerProc:
    """Spawn record for one local replica worker process: config file,
    per-attempt port file (the ready handshake), a log file the worker's
    stdout/stderr append to, and bounded waits everywhere. Respawn
    policy (backoff, breaker, carry) lives in the router-side handle —
    this class only knows how to start, watch, and stop ONE attempt."""

    def __init__(self, rid: int, config: dict, *, workdir: str,
                 host: str = "127.0.0.1", io_timeout: float = 30.0,
                 keepalive: float = 2.0, faults: str | None = None,
                 env: dict | None = None):
        self.rid = rid
        self.host = host
        self._io = io_timeout
        self._keepalive = keepalive
        self._faults = faults
        self._env = dict(env or {})
        self._workdir = workdir
        self._attempt = 0
        os.makedirs(workdir, exist_ok=True)
        self.config_path = os.path.join(workdir, f"r{rid}.config.json")
        with open(self.config_path, "w") as f:
            json.dump(config, f)
        self.log_path = os.path.join(workdir, f"r{rid}.log")
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.pid: int | None = None

    def spawn(self) -> None:
        self._attempt += 1
        self.port = None
        self._port_file = os.path.join(
            self._workdir, f"r{self.rid}.port.{self._attempt}")
        env = dict(os.environ)
        # never inherit the parent's armed faults: a chaos test arming
        # replica_raise for the PARENT's schedulers must not also crash
        # every worker (workers get their own arming via `faults`)
        env.pop("DLLAMA_FAULTS", None)
        if self._faults:
            env["DLLAMA_FAULTS"] = self._faults
        # the package must be importable regardless of the parent's cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update(self._env)
        log = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m",
                 "distributed_llama_tpu_torch.runtime.replica_worker",
                 "--config", self.config_path,
                 "--port-file", self._port_file,
                 "--host", self.host, "--port", "0",
                 "--io-timeout", str(self._io),
                 "--keepalive", str(self._keepalive)],
                env=env, stdout=log, stderr=log)
        finally:
            log.close()  # the child holds its own copies of the fds

    def wait_ready(self, timeout: float = 120.0) -> int:
        """Block until the worker wrote its port file (it binds only
        after params load + supervisor warmup, so a readable port means
        a servable replica). Raises with the log tail when the process
        died first or the deadline passed."""
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            rc = self.proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"replica worker r{self.rid} exited during startup "
                    f"({classify_exit(rc)})\n{self.log_tail()}")
            if os.path.exists(self._port_file):
                with open(self._port_file) as f:
                    info = json.load(f)
                self.port = int(info["port"])
                self.pid = int(info["pid"])
                return self.port
            time.sleep(0.05)
        raise RuntimeError(
            f"replica worker r{self.rid} did not come up within "
            f"{timeout:.0f}s\n{self.log_tail()}")

    def poll(self) -> int | None:
        return self.proc.poll() if self.proc is not None else None

    def kill(self, sig: int = signal.SIGKILL) -> None:
        if self.proc is not None and self.proc.poll() is None:
            os.kill(self.proc.pid, sig)

    def stop(self, timeout: float = 10.0) -> int | None:
        """SIGTERM (graceful worker drain) escalating to SIGKILL at the
        deadline; reaps and returns the exit code."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)
        return self.proc.returncode

    def log_tail(self, nbytes: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(f.tell() - nbytes, 0))
                return f.read().decode("utf-8", errors="replace")
        except OSError:
            return "<no log>"


if __name__ == "__main__":
    sys.exit(main())
