"""Cross-replica KV block transfer: published arena blocks as a currency
between replicas — the port of the JAX package's runtime/kv_transfer.py.

  * an RMSG frame family (``RMSG_BLOCK_QUERY``/``RMSG_BLOCK_FETCH``/
    ``RMSG_BLOCK_DATA``/``RMSG_BLOCK_END``) rides the framed codec of the
    multi-node control star (parallel/multihost._send_frame/_recv_frame,
    whose socket fault sites fire inside it unchanged) between replica
    workers, shipping published arena blocks: fixed-shape, refcounted and
    token-addressed by the radix prefix cache, so a block describes
    itself;
  * CACHE FILL ON MISS — when the router places a request on a replica
    whose cache trails a sibling's, the placed replica FETCHES the missing
    whole blocks (pinned on the donor for the transfer's lifetime),
    publishes them into its own radix tree, and the ordinary admission
    seeds them. The shipped K/V is the donor's prefill writes, so greedy
    tokens equal a cold prefill's in the same chunk shapes. Any failure
    (donor death mid-``RMSG_BLOCK_DATA``, a torn frame, a stalled socket
    past the per-transfer deadline) degrades to a plain local re-prefill,
    never a request failure;
  * PREFILL/DECODE DISAGGREGATION — ``--tier prefill|decode|mixed`` gives
    replicas roles: a prefill-tier replica runs prompt passes only and
    its blocks reach decode-tier replicas through the same fill path
    (runtime/router.py owns the placement and falls back to the mixed
    path when no prefill replica is routable).

Every block frame is accounted in a wire ledger (stats.WireStats, per
(peer, kind, dir)), and ``netstats.estimate_block_transfer`` models when a
transfer pays against the re-prefill it replaces; ``dlprof --wire``
renders the "KV transfer" section from these blocks.

A block is a pair of host tensors (layers, kv_heads, block_len,
head_size) in the cache dtype (``Engine.block_export``: device-to-host
copies into pinned buffers, synchronized before the frame is sent;
``Engine.slot_import_block``: host-to-device into the arena, in place).
The wire carries their raw bytes, the same bytes the JAX package ships
for the same values.

Thread model: the donor's export loop holds the donor scheduler's step
mutex only per block copy (pin first, copy block by block, unpin in a
finally); the importer publishes under its own step mutex.

Chaos surface: ``kvx_stall``/``kvx_exit`` (runtime/faults.py) land a wedge
or a hard ``os._exit`` between two BLOCK_DATA frames of the donor; the
codec's ``frame_truncate``/``recv_stall`` sites fire at the transfer
sites unchanged.
"""

from __future__ import annotations

import os
import socket
import time

import torch

from ..parallel.multihost import ClusterProtocolError, _recv_frame, \
    _send_frame
from .faults import FAULTS
from .trace import TRACER

# the block-transfer verbs of the replica RMSG namespace
# (runtime/replica_worker.py owns 100..119; a version-checked HELLO
# precedes every connection, so a mixed build fails the handshake)
RMSG_BLOCK_QUERY = 120  # client -> worker: [requester, n_have, *tokens]
RMSG_BLOCK_ACK = 121    # worker -> client: [n_match, block_len, layers,
#                         kv_heads, head_size, dtype_code, payload_bytes]
RMSG_BLOCK_FETCH = 122  # client -> worker: [start_block, end_block]
RMSG_BLOCK_DATA = 123   # worker -> client: [block_index] + K||V payload
RMSG_BLOCK_END = 124    # worker -> client: [n_blocks_sent]

# ledger labels (the `kind` of dllama_kv_wire_bytes_total)
KVX_KIND_NAMES = {
    RMSG_BLOCK_QUERY: "BLOCK_QUERY", RMSG_BLOCK_ACK: "BLOCK_ACK",
    RMSG_BLOCK_FETCH: "BLOCK_FETCH", RMSG_BLOCK_DATA: "BLOCK_DATA",
    RMSG_BLOCK_END: "BLOCK_END",
    100: "HELLO", 101: "HELLO_ACK",  # the handshake frames share the conn
}

# arena dtypes a block may ship as (the ACK carries the code; an
# unknown/mismatched code is a refusal on the importer side — a fill
# must degrade, never write foreign-typed bytes into an arena)
DTYPE_CODES = {"float32": 1, "bfloat16": 2, "float8_e4m3fn": 3,
               "float16": 4}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}

# the donor's kvx_exit hard-death code: EXIT_WORKER_FAULT's value
# (runtime/replica_worker.py), repeated here because replica_worker
# imports this module
EXIT_KVX_FAULT = 86

TIERS = ("prefill", "decode", "mixed")


class KVTransferError(RuntimeError):
    """A transfer could not complete (protocol/shape/deadline). Always
    caught by the fill path: the request degrades to a local re-prefill
    — a transfer failure must never become a request failure.
    ``answered`` carries the donor's BLOCK_ACK match (tokens) when the
    failure happened AFTER the query was answered: the answer is a
    valid shadow-staleness verdict even when the data never arrived."""

    def __init__(self, msg: str, answered: int = -1):
        super().__init__(msg)
        self.answered = int(answered)


def _kind_name(kind) -> str:
    return KVX_KIND_NAMES.get(kind, str(kind))


def _mk_acct(wire, peer: int, direction: str):
    """Wire-ledger hook for the codec (same shape as the cluster
    plane's): None when no ledger is attached."""
    if wire is None:
        return None

    def acct(kind, nbytes):
        wire.account(peer, _kind_name(kind), direction, nbytes)
    return acct


def dtype_name(dtype) -> str:
    """The dtype's name as the wire codes spell it ("bfloat16", ...), for
    a torch dtype or its name."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str):
    return getattr(torch, name)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype_name(dtype))
                       ).element_size()


def block_bytes(t: torch.Tensor) -> bytes:
    """A host block tensor's raw bytes (any dtype, bf16 and e4m3
    included)."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def block_from_bytes(buf: bytes, shape: tuple, dtype) -> torch.Tensor:
    """The inverse of block_bytes: a host tensor of `shape` over a copy
    of `buf`."""
    raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    return raw.view(_torch_dtype(dtype_name(dtype))).reshape(shape)


def block_payload_bytes(n_layers: int, kv_heads: int, block_len: int,
                        head_size: int, dtype) -> int:
    """One block's on-the-wire K+V payload bytes: the exact arithmetic the
    ledger is held against."""
    one = n_layers * kv_heads * block_len * head_size
    return 2 * one * _itemsize(dtype)


# -- donor side -------------------------------------------------------------


class BlockDonor:
    """Serves one QUERY(/FETCH) connection against the CURRENT
    generation's prefix cache. Owned by the worker's ReplicaServer (and
    by in-process tests); ``sup_getter`` returns the live supervisor so
    a rolling rebuild mid-serve degrades instead of touching a dead
    generation."""

    def __init__(self, sup_getter, stats, *, fault_key: str | None = None,
                 io_timeout: float = 30.0):
        self._sup = sup_getter
        self.stats = stats
        self._fault_key = fault_key
        self._io = float(io_timeout)

    def serve(self, conn: socket.socket, frame) -> None:
        """Handle one RMSG_BLOCK_QUERY connection to completion. The
        matched path is pinned for exactly this connection's lifetime:
        a client that dies (or never fetches) unpins in the finally —
        a dead peer can never leak a pin."""
        ints = frame[1]
        if len(ints) < 2:
            raise ClusterProtocolError(f"short block query: {len(ints)}")
        requester, n_have = int(ints[0]), int(ints[1])
        tokens = [int(t) for t in ints[2:]]
        st = self.stats
        with st.lock:
            st.queries_served += 1
        acct_tx = _mk_acct(st.wire, requester, "tx")
        try:
            sched = self._sup()._sched
            pc = sched.prefix_cache
        except Exception:  # noqa: BLE001 — supervisor mid-swap
            sched = pc = None
        if pc is None:
            with st.lock:
                st.query_misses += 1
            _send_frame(conn, RMSG_BLOCK_ACK, [0, 0, 0, 0, 0, 0, 0],
                        timeout=self._io, acct=acct_tx)
            return
        bl = pc.block_len
        n_match, ids, pins = sched.kv_export_pin(tokens)
        try:
            eng = sched.engine
            dtype_code = DTYPE_CODES.get(dtype_name(eng.cache_dtype), 0)
            payload = block_payload_bytes(
                eng.spec.n_layers, eng.spec.n_kv_heads, bl,
                eng.spec.head_size, eng.cache_dtype)
            if n_match <= max(n_have, 0):
                # nothing the requester lacks — the MISS answer. The
                # router clears its stale shadow entry off this (the
                # donor evicted what the shadow still promised).
                with st.lock:
                    st.query_misses += 1
            _send_frame(conn, RMSG_BLOCK_ACK,
                        [n_match, bl, eng.spec.n_layers,
                         eng.spec.n_kv_heads, eng.spec.head_size,
                         dtype_code, payload],
                        timeout=self._io, acct=acct_tx)
            req = _recv_frame(conn, timeout=self._io,
                              acct=_mk_acct(st.wire, requester, "rx"))
            if req is None or req[0] != RMSG_BLOCK_FETCH:
                return  # client declined (miss) or died: unpin below
            start, end = int(req[1][0]), int(req[1][1])
            if not 0 <= start <= end <= n_match // bl:
                raise ClusterProtocolError(
                    f"block fetch range {start}..{end} outside "
                    f"0..{n_match // bl}")
            sent = 0
            for i in range(start, end):
                # chaos surface: a wedge or a hard exit lands exactly
                # between two BLOCK_DATA frames (key = the donor's
                # replica identity, like every replica-level site)
                FAULTS.fire("kvx_stall", key=self._fault_key)
                if FAULTS.triggered("kvx_exit", key=self._fault_key):
                    os._exit(EXIT_KVX_FAULT)
                k_blk, v_blk = sched.kv_export_block(ids[i])
                _send_frame(conn, RMSG_BLOCK_DATA, [i],
                            block_bytes(k_blk) + block_bytes(v_blk),
                            timeout=self._io, acct=acct_tx)
                sent += 1
                with st.lock:
                    st.blocks_exported += 1
                    st.bytes_tx += payload
            _send_frame(conn, RMSG_BLOCK_END, [sent], timeout=self._io,
                        acct=acct_tx)
        except (OSError, ClusterProtocolError, socket.timeout):
            with st.lock:
                st.donor_aborts += 1
            raise
        finally:
            try:
                sched.kv_unpin(pins)
            except Exception:  # noqa: BLE001 — a dying generation's
                pass           # detached pins are already moot


# -- importer side ----------------------------------------------------------


def fetch_prefix(host: str, port: int, tokens: list[int], n_have: int, *,
                 block_len: int, block_shape: tuple, dtype,
                 protocol_version: int, requester: int = 0,
                 io_timeout: float = 10.0, deadline_s: float = 15.0,
                 wire=None, peer: int = 0):
    """Fetch the whole blocks of ``tokens`` beyond ``n_have`` from the
    donor at (host, port). Returns (n_match, start_block, blocks) —
    n_match is the donor's whole-block answer in tokens (the shadow
    verdict even when nothing is fetched), blocks a list of host
    (L, KVH, bl, hs) K/V tensor pairs. Raises KVTransferError/OSError on any
    failure; ``deadline_s`` bounds the WHOLE transfer (each frame's recv
    runs under the remaining budget), so a stalled donor degrades within
    the bound instead of holding the request hostage."""
    t_end = time.monotonic() + float(deadline_s)

    def budget() -> float:
        left = t_end - time.monotonic()
        if left <= 0:
            raise KVTransferError("transfer deadline exceeded")
        return min(float(io_timeout), left)

    acct_tx = _mk_acct(wire, peer, "tx")
    acct_rx = _mk_acct(wire, peer, "rx")
    sock = socket.create_connection((host, int(port)), timeout=budget())
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_frame(sock, 100, [protocol_version], timeout=budget(),
                    acct=acct_tx)  # RMSG_HELLO
        ack = _recv_frame(sock, timeout=budget(), acct=acct_rx)
        if (ack is None or ack[0] != 101 or len(ack[1]) < 2
                or not ack[1][1]):  # RMSG_HELLO_ACK [version, ok, ...]
            raise KVTransferError(f"donor handshake rejected: {ack!r}")
        _send_frame(sock, RMSG_BLOCK_QUERY,
                    [int(requester), int(n_have), *tokens],
                    timeout=budget(), acct=acct_tx)
        ans = _recv_frame(sock, timeout=budget(), acct=acct_rx)
        if ans is None or ans[0] != RMSG_BLOCK_ACK or len(ans[1]) < 7:
            raise KVTransferError(f"bad block ack: {ans!r}")
        (n_match, bl, n_l, kvh, hs, dtype_code, payload) = [
            int(v) for v in ans[1][:7]]
        if n_match <= max(n_have, 0):
            return n_match, 0, []  # donor can't help: the MISS verdict
        try:
            want_shape = tuple(block_shape)
            if (bl != block_len or (n_l, kvh, bl, hs) != want_shape
                    or CODE_DTYPES.get(dtype_code)
                    != dtype_name(dtype)):
                raise KVTransferError(
                    f"donor block geometry ({n_l},{kvh},{bl},{hs})/"
                    f"{CODE_DTYPES.get(dtype_code)} != local "
                    f"{want_shape}/{dtype_name(dtype)}")
            one = n_l * kvh * bl * hs * _itemsize(dtype)
            if payload != 2 * one:
                raise KVTransferError(
                    f"donor payload {payload} != modeled {2 * one}")
            start = max(n_have, 0) // bl
            end = n_match // bl
            _send_frame(sock, RMSG_BLOCK_FETCH, [start, end],
                        timeout=budget(), acct=acct_tx)
            blocks: list = []
            expect = start
            while True:
                fr = _recv_frame(sock, timeout=budget(), acct=acct_rx)
                if fr is None:
                    raise KVTransferError(
                        f"donor closed mid-transfer after "
                        f"{len(blocks)}/{end - start} blocks")
                if fr[0] == RMSG_BLOCK_END:
                    break
                if fr[0] != RMSG_BLOCK_DATA or len(fr[2]) != payload:
                    raise KVTransferError(
                        f"bad block frame kind={fr[0]} "
                        f"payload={len(fr[2])}")
                if int(fr[1][0]) != expect:
                    raise KVTransferError(
                        f"out-of-order block {fr[1][0]} "
                        f"(expected {expect})")
                expect += 1
                buf = fr[2]
                shape = (n_l, kvh, bl, hs)
                blocks.append((block_from_bytes(buf[:one], shape, dtype),
                               block_from_bytes(buf[one:], shape, dtype)))
            if len(blocks) != end - start:
                raise KVTransferError(
                    f"short transfer: {len(blocks)}/{end - start} "
                    "blocks")
            return n_match, start, blocks
        except KVTransferError as e:
            e.answered = n_match  # the query WAS answered: a failure
            raise                 # past it still carries the verdict
        except (OSError, ClusterProtocolError, socket.timeout) as e:
            raise KVTransferError(f"transfer failed after the query "
                                  f"answered: {type(e).__name__}: {e}",
                                  answered=n_match) from e
    finally:
        try:
            sock.close()
        except OSError:
            pass


def fill_from_wire(sched, tokens: list[int], host: str, port: int,
                   expected: int, *, stats, protocol_version: int,
                   trace_id: int = 0, requester: int = 0,
                   donor_peer: int = 0, io_timeout: float = 10.0,
                   deadline_s: float = 15.0) -> int:
    """One cache FILL over the wire into ``sched``'s radix tree, before
    the request is admitted. Returns the donor's whole-block answer in
    tokens (the shadow-staleness verdict: < expected means the donor
    evicted what the router's shadow still promised), or -1 when there
    is NO verdict (donor unreachable/deadline/a torn transfer — the
    donor may be mid-respawn, so the shadow must not be cleared off it).
    NEVER raises: every failure degrades to a plain local re-prefill."""
    st = stats
    with st.lock:
        st.fills_requested += 1
    t0 = time.perf_counter()
    verdict, got, fell_back = -1, 0, False
    try:
        pc = sched.prefix_cache
        if pc is None:
            fell_back = True
            return -1
        n_have = sched.kv_match_len(tokens)
        if n_have >= expected:
            return -1  # already warm locally: nothing to fetch, no verdict
        eng = sched.engine
        n_match, start, blocks = fetch_prefix(
            host, port, tokens, n_have, block_len=pc.block_len,
            block_shape=(eng.spec.n_layers, eng.spec.n_kv_heads,
                         pc.block_len, eng.spec.head_size),
            dtype=eng.cache_dtype, protocol_version=protocol_version,
            requester=requester, io_timeout=io_timeout,
            deadline_s=deadline_s, wire=st.wire, peer=donor_peer)
        verdict = n_match
        if n_match < expected:
            with st.lock:
                st.fill_misses += 1
        if not blocks:
            return verdict
        payload = block_payload_bytes(
            eng.spec.n_layers, eng.spec.n_kv_heads, pc.block_len,
            eng.spec.head_size, eng.cache_dtype)
        with st.lock:
            st.bytes_rx += payload * len(blocks)
        got = sched.kv_import_prefix(tokens, start, blocks)
        if got > 0:
            with st.lock:
                st.fills_ok += 1
                st.tokens_filled += got
                st.blocks_filled += got // pc.block_len
        else:
            fell_back = True
        return verdict
    except Exception as e:  # noqa: BLE001 — degrade, NEVER fail the
        # request: besides the socket/protocol shapes, a supervisor
        # rebuild mid-import can raise out of the engine (a released
        # arena) — all of them must end in a plain local re-prefill
        fell_back = True
        # a failure AFTER the donor answered the query still carries
        # the answer — the shadow-staleness verdict survives the loss
        verdict = max(verdict, getattr(e, "answered", -1))
        return verdict
    finally:
        if fell_back:
            with st.lock:
                st.fill_fallbacks += 1
        ms = (time.perf_counter() - t0) * 1e3
        st.note_transfer_ms(ms)
        if TRACER.enabled and trace_id:
            TRACER.event("kv_fill", trace_id, donor=donor_peer,
                         transport="wire", expected=expected,
                         answered=verdict, filled=got,
                         ms=round(ms, 3), ok=got > 0)


def local_fill(donor_sup, target_sup, tokens: list[int], *, stats,
               trace_id: int = 0, donor_id: int = 0) -> int:
    """The thread-tier fill: donor and target schedulers share one
    process, so blocks hop arena -> host -> arena with no socket (the
    same export and import copies as the wire path, so parity holds
    whatever the transport). Same degrade-never-fail contract and return
    semantics as :func:`fill_from_wire`."""
    st = stats
    with st.lock:
        st.fills_requested += 1
    t0 = time.perf_counter()
    verdict, got, fell_back = -1, 0, False
    try:
        sched_d = donor_sup._sched
        sched_t = target_sup._sched
        pc_t = sched_t.prefix_cache
        pc_d = sched_d.prefix_cache
        if pc_t is None or pc_d is None \
                or pc_t.block_len != pc_d.block_len:
            fell_back = True
            return -1
        bl = pc_t.block_len
        n_have = sched_t.kv_match_len(tokens)
        n_match, ids, pins = sched_d.kv_export_pin(tokens)
        try:
            verdict = n_match
            if n_match <= n_have:
                with st.lock:
                    st.fill_misses += 1
                    st.queries_served += 1
                    st.query_misses += 1
                return verdict
            with st.lock:
                st.queries_served += 1
            start = n_have // bl
            payload = block_payload_bytes(
                sched_d.engine.spec.n_layers,
                sched_d.engine.spec.n_kv_heads, bl,
                sched_d.engine.spec.head_size,
                sched_d.engine.cache_dtype)
            blocks = []
            for i in range(start, n_match // bl):
                blocks.append(sched_d.kv_export_block(ids[i]))
                with st.lock:
                    st.blocks_exported += 1
                    st.bytes_tx += payload
        finally:
            sched_d.kv_unpin(pins)
        with st.lock:
            st.bytes_rx += payload * len(blocks)
        got = sched_t.kv_import_prefix(tokens, start, blocks)
        if got > 0:
            with st.lock:
                st.fills_ok += 1
                st.tokens_filled += got
                st.blocks_filled += got // bl
        else:
            fell_back = True
        return verdict
    except Exception:  # noqa: BLE001 — degrade, never fail the request
        fell_back = True
        return verdict
    finally:
        if fell_back:
            with st.lock:
                st.fill_fallbacks += 1
        ms = (time.perf_counter() - t0) * 1e3
        st.note_transfer_ms(ms)
        if TRACER.enabled and trace_id:
            TRACER.event("kv_fill", trace_id, donor=donor_id,
                         transport="local", answered=verdict,
                         filled=got, ms=round(ms, 3), ok=got > 0)
