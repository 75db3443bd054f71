"""Two-process control-plane chaos harness — the port's copy of the JAX
package's parallel/cluster_harness.py.

Drives the multi-node control star (parallel/multihost.py RootLink /
WorkerLink) WITHOUT a model, a mesh or a process group — host-side
protocol only — so chaos tests can kill, stall, or corrupt either side of
a real two-OS-process cluster and assert bounded detection quickly (no
fixture, no torch: at module level this imports neither torch nor jax,
so a harness process starts in a fraction of a second).

Every observable is one JSON line on stdout:

  {"event": "formed", ...}            link up (worker reports its backoff
                                      retry count)
  {"event": "tick", "phase": ...}     worker received a phase-tick frame
  {"event": "dying", "t_wall": ...}   worker about to os._exit(9)
                                      (--die-after; the SIGKILL shape)
  {"event": "cluster_peer_lost", ...} bounded detection fired
                                      (ClusterPeerLost.summary() +
                                      "t_wall") — process exits
                                      EXIT_PEER_LOST (43)
  {"event": "formation_failed", ...}  handshake/connect failure — exits
                                      EXIT_FORMATION (44); its "t_wall"
                                      against "t_start" bounds formation
  {"event": "complete" | "shutdown"}  clean end (root | worker), exit 0

Every line carries "t_start", the process's own start on the wall clock
(taken at import, after the interpreter is up), so a bound on a detection
or on formation can leave out the interpreter's start.

Faults are armed via DLLAMA_FAULTS in the child's environment (the
registry loads it at import — runtime/faults.py): e.g.
``recv_stall:after=2;times=0`` wedges a worker's receiver so it stops
answering heartbeats, ``conn_refused:times=2`` fails the first two connect
attempts to exercise the formation backoff.

``--trace`` arms the flight recorder on either side: the root mints ONE
trace id for the session and rides it in every phase frame's header; the
worker records a ``cluster_tick`` span event per frame and ships the new
events root-ward in ``MSG_TRACE`` frames, which the root rebases
(clock-offset estimate) onto its own timeline. The root then emits a
``trace_dump`` JSON line — its merged ring, wall-stamped — on completion
AND on a peer loss (the casualty path: the dump carries the root-side
``cluster_lost`` event linked under the same id). The ``complete`` /
``shutdown`` stats carry the measured wire ledger (bytes + frames per
peer/kind/direction, heartbeat RTT, clock offset).

Usage:
  python -m distributed_llama_tpu_torch.parallel.cluster_harness root \
      --port 19000 --nnodes 2 --heartbeat-interval 0.2 --worker-timeout 1.5 \
      --phases formation:0.2,prefill:8
  python -m distributed_llama_tpu_torch.parallel.cluster_harness worker \
      --host 127.0.0.1 --port 19000 --rank 1 --nnodes 2 [--die-after 0.8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

# this process's start on the wall clock, after the interpreter is up
T_START = time.time()

from . import multihost as mh  # noqa: E402


def _emit(event: str, **fields) -> None:
    # the harness's whole output is these JSON lines
    print(json.dumps({"event": event, "t_wall": time.time(),
                      "t_start": T_START, **fields}), flush=True)


def _emit_trace_dump(tid: int) -> None:
    """Dump the tracer's ring, wall-stamped, as one JSON line — the
    harness's stand-in for GET /admin/trace (same event shape, same
    anchor): cross-node linkage asserts read this from stdout, which
    survives the os._exit a peer loss takes."""
    from ..runtime.trace import TRACER

    if not TRACER.enabled:
        return
    events = [{**e, "ts_wall": TRACER.to_wall(e["ts"])}
              for e in TRACER.recent(0)]
    _emit("trace_dump", tid=tid, anchor_wall=TRACER.anchor_wall,
          events=events)


_TRACE_TID = [0]  # the session's minted id, readable from the lost path


def _exit_on_peer_lost(exc: mh.ClusterPeerLost) -> None:
    _emit(**exc.summary())
    # the casualty event (multihost._report_lost) is already in the ring
    _emit_trace_dump(_TRACE_TID[0])
    os._exit(mh.EXIT_PEER_LOST)


def _parse_phases(spec: str) -> list[tuple[str, float]]:
    out = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, secs = part.partition(":")
        out.append((name, float(secs or 1.0)))
    return out


def run_root(args) -> int:
    from ..runtime.trace import TRACER

    link = mh.RootLink(args.nnodes, "", args.port,
                       heartbeat_interval=args.heartbeat_interval,
                       worker_timeout=args.worker_timeout,
                       connect_timeout=args.connect_timeout)
    tid = 0
    if args.trace:
        # arm BEFORE form() so the casualty path can always link, then
        # mint ONE id for the whole session — every phase frame carries
        # it, so root ticks, worker ticks (shipped back via MSG_TRACE),
        # and a peer-loss casualty all land under one span
        TRACER.configure(enabled=True)
        tid = TRACER.new_id()
        _TRACE_TID[0] = tid
        link.trace_tid = tid
    try:
        link.form()
    except mh.ClusterProtocolError as e:
        _emit("formation_failed", error=str(e))
        return mh.EXIT_FORMATION
    mh.set_link(link)
    link.on_peer_lost = _exit_on_peer_lost
    if tid:
        TRACER.event("handshake", tid, role="root",
                     peers=sorted(link.peers))
    _emit("formed", role="root", peers=sorted(link.peers))
    for name, secs in _parse_phases(args.phases):
        link.set_phase(name)
        # a real protocol frame per phase so the broadcast path (and its
        # lost-peer raise) is exercised, not just the heartbeat — the
        # payload carries the phase name so the worker's diagnostics
        # agree with the root's, and the header carries the trace id
        mh._send(mh.MSG_RUN, bytes_payload=name.encode(), trace_tid=tid)
        if tid:
            TRACER.event("cluster_tick", tid, phase=name, role="root",
                         rank=0)
        time.sleep(secs)
    mh.send_shutdown()
    _emit("complete", stats=link.summary(), tid=tid)
    _emit_trace_dump(tid)
    link.close()
    return 0


def run_worker(args) -> int:
    from ..runtime.trace import TRACER

    link = mh.WorkerLink(args.host, args.port, args.rank, args.nnodes,
                         heartbeat_interval=args.heartbeat_interval,
                         worker_timeout=args.worker_timeout,
                         connect_timeout=args.connect_timeout,
                         protocol_version=args.protocol_version)
    if args.trace:
        TRACER.configure(enabled=True)
    try:
        link.form()
    except mh.ClusterProtocolError as e:
        _emit("formation_failed", error=str(e))
        return mh.EXIT_FORMATION
    mh.set_link(link)
    link.on_peer_lost = _exit_on_peer_lost
    _emit("formed", role="worker", rank=args.rank,
          retries=link.connect_retries,
          heartbeat_interval=link.heartbeat_interval,
          worker_timeout=link.worker_timeout)
    if args.die_after is not None:
        def die():
            time.sleep(args.die_after)
            _emit("dying")
            os._exit(9)  # abrupt, like a SIGKILL/OOM — no FIN handshake code
        threading.Thread(target=die, daemon=True).start()
    shipped = 0  # span events already shipped root-ward (delta ships —
    #              re-sending the whole span would duplicate on ingest)
    while True:
        msg = mh.recv_msg()
        if msg.kind == mh.MSG_SHUTDOWN:
            _emit("shutdown", stats=link.summary())
            link.close()
            return 0
        if msg.kind == mh.MSG_RUN:
            phase = (msg.body or b"?").decode()
            link.set_phase(phase)
            tid = msg.trace_tid
            if TRACER.enabled and tid:
                TRACER.reserve(tid)  # root-minted id: keep local mints
                #                      disjoint (Tracer.reserve)
                link.trace_tid = tid
                _TRACE_TID[0] = tid
                TRACER.event("cluster_tick", tid, phase=phase,
                             role="worker", rank=args.rank)
                # ship per tick, not at shutdown: the root stops reading
                # after its SHUTDOWN broadcast, and a worker that DIES
                # mid-session has at least its earlier ticks on the
                # root's timeline (the casualty span covers the rest)
                span = TRACER.export_span(tid)
                if len(span) > shipped and link.ship_trace(span[shipped:]):
                    shipped = len(span)
            _emit("tick", phase=phase)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cluster_harness")
    p.add_argument("role", choices=["root", "worker"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--nnodes", type=int, default=2)
    p.add_argument("--rank", type=int, default=1)
    p.add_argument("--heartbeat-interval", type=float, default=0.25)
    p.add_argument("--worker-timeout", type=float, default=2.0)
    p.add_argument("--connect-timeout", type=float, default=10.0)
    p.add_argument("--protocol-version", type=int,
                   default=mh.PROTOCOL_VERSION,
                   help="override to exercise the version-mismatch path")
    p.add_argument("--phases", default="formation:0.2,idle:2.0",
                   help="root: comma list of name:seconds cluster phases")
    p.add_argument("--die-after", type=float, default=None,
                   help="worker: os._exit(9) after this many seconds")
    p.add_argument("--trace", action="store_true",
                   help="arm the flight recorder: root mints one trace "
                        "id, workers ship cluster_tick spans back via "
                        "MSG_TRACE, both dump the merged ring as a "
                        "trace_dump JSON line")
    args = p.parse_args(argv)
    try:
        return run_root(args) if args.role == "root" else run_worker(args)
    except mh.ClusterPeerLost as exc:  # surfaced on the driving thread
        _emit(**exc.summary())
        return mh.EXIT_PEER_LOST


if __name__ == "__main__":
    sys.exit(main())
