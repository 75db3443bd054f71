"""Wire and collective observability, the decode-wire part — the port of
the JAX package's runtime/netstats.py.

The reference surfaces per-token transfer time and sent kB from its socket
byte counters (ref: src/socket.cpp:266-271, printed as the T/S columns in
benchmark mode — src/apps/dllama/dllama.cpp:74-91). Here:

  * `estimate_decode_wire` — modeled bytes each rank sends a decoded token,
    from the mesh and the sharding design (the JAX model, value for value:
    the S column);
  * `measure_allreduce_ms` / `measure_ppermute_ms` — timed collectives on
    the real mesh (torch.distributed over the ranks' process groups), the
    per-token transfer estimate behind the T column
    (runtime/engine.py measure_transfer_ms);
  * `reconcile_wire` — a measured byte count against the model, drift
    flagged at 25%.

Ring-algorithm cost model: an all-reduce moves 2*(n-1)/n * payload per
device, an all-gather / all-to-all (n-1)/n * payload.

The fleet's part (the JAX names): `estimate_serve_wire` (per emitted token
under the slot scheduler's occupancy), `estimate_prefix_reuse` and
`estimate_block_transfer` (a KV block transfer against the re-prefill it
replaces, frame-exact), and the trace readers `per_step_op_ms`,
`per_trace_attribution` and `per_module_ms`, which read a torch.profiler
Chrome trace (`--profile DIR`, `/admin/profile`) where the JAX ones read an
xplane: a step is one replayed CUDA graph, a module one kernel name. The T
column stays the microbench estimate.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from ..models.spec import ModelSpec


class WireEstimate(NamedTuple):
    sent_kb_per_token: float          # per device, per decoded token
    breakdown: dict                   # component -> kB


def _ar(n: int, payload: float) -> float:
    """Ring all-reduce bytes sent per device."""
    return 2 * (n - 1) / n * payload


def _ag(n: int, payload: float) -> float:
    """Ring all-gather (or all-to-all) bytes sent per device; `payload` is
    the full gathered size."""
    return (n - 1) / n * payload


def estimate_decode_wire(
    spec: ModelSpec,
    mesh,
    *,
    q80: bool = False,
    act_bytes: int = 4,
    batch: int = 1,
    shard_vocab: bool = False,
    vocab_topk: int = 32,
) -> WireEstimate:
    """Modeled bytes each device sends per decoded token.

    tp: 2 partial-sum all-reduces per dense layer (wo, w2 — the reference's
    2 broadcast + 2 gather pairs collapse to these, SURVEY.md §3.4), one per
    active expert + one for wo on MoE layers, plus the vocab-sharded logits
    all-gather. q80 mode swaps the f32 all-reduce for the two-shot quantized
    exchange (int8 + f16 block scales = 1.0625 B/value).
    sp: the decode-attention stat merge (acc + m + l per layer).
    dp: no inter-device traffic at inference.
    shard_vocab (ops/sharded_vocab.py): the embedding gather costs one
    extra dim-sized all-reduce per forward, and the full-logits gather is
    REPLACED by the candidate-summary gather (S·k probs+ids + guards per
    row — hundreds of bytes where the logits were vocab·4).
    """
    if mesh is None:
        return WireEstimate(0.0, {})
    tp = mesh.shape.get("tp", 1)
    sp = mesh.shape.get("sp", 1)
    dp = mesh.shape.get("dp", 1)
    ep = mesh.shape.get("ep", 1)
    b_local = max(1, batch // dp)
    bd: dict[str, float] = {}

    val_bytes = 1.0625 if q80 else act_bytes  # int8 + f16/32-block scale
    if tp > 1:
        # with ep the MoE expert-sum reduce moves out of the tp column (see
        # ep_moe_reduce below); only the attention wo reduce stays per-layer
        if spec.is_moe:
            reduces_per_layer = 1 if ep > 1 else 1 + spec.n_active_experts
        else:
            reduces_per_layer = 2
        per_reduce = spec.dim * b_local * val_bytes
        layer_fn = _ar  # both the f32 all-reduce and the 2-shot q80
        # exchange move 2*(n-1)/n * payload per device
        bd["tp_partial_sums"] = (spec.n_layers * reduces_per_layer
                                 * layer_fn(tp, per_reduce))
        if shard_vocab:
            bd["vocab_embed_psum"] = _ar(tp, spec.dim * b_local
                                         * act_bytes)
            k = min(vocab_topk, max(spec.vocab_size // tp, 1))
            bd["vocab_sample_gather"] = _ag(
                tp, b_local * (tp * k * 8 + tp * 4 + 4))
        else:
            bd["tp_logits_gather"] = _ag(tp,
                                         spec.vocab_size * b_local * 4)
    if ep > 1:
        # one MoE output reduce per layer (parallel/ep_moe.py): exact mode is
        # a single all-reduce over the ep*tp group; q80 mode is a quantized
        # 2-shot over tp followed by an exact f32 psum over ep
        per = spec.dim * b_local
        if q80 and tp > 1:
            moe = _ar(tp, per * val_bytes) + _ar(ep, per * act_bytes)
        else:
            moe = _ar(ep * tp, per * act_bytes)
        bd["ep_moe_reduce"] = spec.n_layers * moe
    if sp > 1:
        stat = spec.n_heads * spec.head_size + 2 * spec.n_heads  # acc + m + l
        bd["sp_attn_merge"] = spec.n_layers * _ar(sp, stat * b_local * 4)
    pp = mesh.shape.get("pp", 1)
    if pp > 1:
        # one masked-psum live-stage broadcast of the activations per stage
        # (parallel/pp.py)
        bd["pp_stage_handoff"] = pp * _ar(pp, spec.dim * b_local * act_bytes)

    total = sum(bd.values())
    return WireEstimate(total / 1024.0,
                        {k: v / 1024.0 for k, v in bd.items()})


def estimate_serve_wire(
    spec: ModelSpec,
    mesh,
    *,
    batch: int = 1,
    occupancy: float | None = None,
    q80: bool = False,
    act_bytes: int = 4,
) -> WireEstimate:
    """Per-EMITTED-token wire under the continuous-batching scheduler
    (runtime/scheduler.py): a slot-scheduler decode step moves the full
    batch-B collective payload no matter how many slots are live (gated
    rows ride through every collective with the rest of the batch), so
    the per-emitted-token cost is the batch-B step estimate divided by
    the mean slot occupancy. occupancy == batch reproduces the static
    batched estimate; occupancy -> 1 degrades to B× the per-token wire —
    the quantitative reason queue pressure, not slot count, sets serving
    efficiency."""
    step = estimate_decode_wire(spec, mesh, q80=q80, act_bytes=act_bytes,
                                batch=batch)
    # `is not None`, not truthiness: a measured occupancy of 0.0 (idle
    # window) must clamp to the degenerate worst case below, not silently
    # take the full-batch best case
    occ = float(occupancy) if occupancy is not None else float(batch)
    occ = max(min(occ, float(batch)), 1e-6)
    return WireEstimate(step.sent_kb_per_token / occ,
                        {k: v / occ for k, v in step.breakdown.items()})


def estimate_prefix_reuse(
    spec: ModelSpec,
    mesh,
    *,
    tokens_saved: int,
    tokens_copied: int | None = None,
    cache_bytes: float = 2.0,
    q80: bool = False,
    act_bytes: int = 4,
    batch: int = 1,
) -> dict:
    """Modeled cost/benefit of serving `tokens_saved` prompt tokens from
    the radix prefix cache (runtime/prefix_cache.py) instead of
    prefilling them.

    A seeded token SKIPS its prefill forward entirely, so it saves the
    full per-token collective payload of a forward — the same per-layer
    reduces estimate_decode_wire models (prefill segments move the same
    per-token bytes as decode; only the segment width batches them).
    What it pays instead is a pure-HBM block copy that rides NO
    collective: 2 (K and V) * layers * kv_heads * head_size *
    cache_bytes per token COPIED. `tokens_copied` is the caller's figure
    of what the seeds really copied (the JAX engine's seed gathers a
    fixed width, the port's the matched blocks); it defaults to
    tokens_saved, the lower bound.

    The wire side is why prefix reuse is a near-strict win over ranks:
    the copy rides no collective, and on one card it replaces whole
    forwards' weight reads and FLOPs.

    Returns {"wire_saved_kb", "hbm_copy_kb", "kb_saved_per_token"}."""
    per_tok_kb = estimate_decode_wire(spec, mesh, q80=q80,
                                      act_bytes=act_bytes,
                                      batch=batch).sent_kb_per_token
    copy_b = (2 * spec.n_layers * spec.n_kv_heads * spec.head_size
              * cache_bytes)
    copied = tokens_saved if tokens_copied is None else tokens_copied
    return {
        "wire_saved_kb": round(per_tok_kb * tokens_saved, 3),
        "hbm_copy_kb": round(copy_b * copied / 1024.0, 3),
        "kb_saved_per_token": round(per_tok_kb, 4),
    }


def estimate_block_transfer(
    spec: ModelSpec,
    *,
    tokens: int,
    block_len: int,
    cache_bytes: float = 2.0,
    link_gbps: float | None = None,
    prefill_tok_per_s: float | None = None,
    mesh=None,
    q80: bool = False,
    batch: int = 1,
) -> dict:
    """Model one cross-replica KV block transfer (runtime/kv_transfer.py)
    against the re-prefill it replaces — the "when does a fill pay"
    arithmetic.

    The WIRE side is exact: ``tokens`` rounds down to whole blocks, each
    block ships one RMSG_BLOCK_DATA frame of 2 (K and V) * layers *
    kv_heads * block_len * head_size * cache_bytes payload plus the
    framed-codec overhead (parallel/multihost.frame_bytes — the same
    arithmetic the wire ledger is held against), bracketed by the HELLO/QUERY/ACK/FETCH/END frames. The
    REPLACED side is the prefill forward those tokens would have run:
    per-token collective bytes (estimate_decode_wire — prefill moves the
    same per-token reduces as decode, batched by segment width) and, when
    a measured ``prefill_tok_per_s`` is given, the wall time. With a
    ``link_gbps`` both sides resolve to milliseconds and ``pays`` says
    whether the transfer wins; without them the byte model stands alone
    (``pays`` = None — never fabricated).

    ``modeled_data_bytes`` is the exact figure ``reconcile_wire`` closes
    against the measured BLOCK_DATA ledger entry at the 25% bar."""
    from ..parallel.multihost import frame_bytes

    bl = int(block_len)
    n_blocks = max(int(tokens), 0) // bl
    per_block = int(2 * spec.n_layers * spec.n_kv_heads * bl
                    * spec.head_size * cache_bytes)
    data_bytes = n_blocks * frame_bytes(1, per_block)
    # HELLO [v] + QUERY [requester, n_have, *tokens] + FETCH [s, e] tx;
    # HELLO_ACK [5] + ACK [7] + END [1] rx — tiny next to the payload,
    # counted so the model reconciles frame-exactly
    overhead = (frame_bytes(1, 0) + frame_bytes(2 + int(tokens), 0)
                + frame_bytes(2, 0) + frame_bytes(5, 0)
                + frame_bytes(7, 0) + frame_bytes(1, 0))
    out = {
        "tokens": n_blocks * bl,
        "n_blocks": n_blocks,
        "block_payload_bytes": per_block,
        "modeled_data_bytes": data_bytes,
        "overhead_bytes": overhead,
        "transfer_bytes": data_bytes + overhead,
        "reprefill_wire_kb": round(
            estimate_decode_wire(spec, mesh, q80=q80,
                                 batch=batch).sent_kb_per_token
            * n_blocks * bl, 3),
        "transfer_ms": None, "reprefill_ms": None, "pays": None,
    }
    if link_gbps:
        out["transfer_ms"] = round(
            (data_bytes + overhead) * 8 / (link_gbps * 1e9) * 1e3, 3)
    if prefill_tok_per_s:
        out["reprefill_ms"] = round(
            n_blocks * bl / prefill_tok_per_s * 1e3, 3)
    if out["transfer_ms"] is not None and out["reprefill_ms"] is not None:
        out["pays"] = out["transfer_ms"] < out["reprefill_ms"]
    return out


# measured-vs-modeled movement worth flagging, the same 25% bar the
# autotune knee-drift check uses (tools/dlprof.py mirrors both — it must
# run with no repo on the path; tests pin the mirrors against each other)
WIRE_DRIFT_FRAC = 0.25


def reconcile_wire(measured: float, modeled: float, *,
                   threshold: float = WIRE_DRIFT_FRAC,
                   unit: str = "bytes") -> dict:
    """Measured wire traffic (the wire ledger) vs the model — the
    closed loop the reference's printed T/S columns never had. Units are
    the caller's (control-plane bytes against frame-size arithmetic;
    per-token kB against :func:`estimate_decode_wire`) — only the RATIO
    matters here. ``drift`` trips at ``threshold`` relative movement:
    past it either the model is wrong (a collective the estimate does
    not know about) or the measurement is (bytes leaking outside the
    ledger) — both are findings. Modeled == 0 cannot reconcile: the
    result says so instead of dividing."""
    measured = float(measured)
    modeled = float(modeled)
    out = {"measured": round(measured, 4), "modeled": round(modeled, 4),
           "unit": unit, "threshold": threshold,
           "drift_frac": None, "drift": False, "note": None}
    if modeled > 0:
        frac = abs(measured - modeled) / modeled
        out["drift_frac"] = round(frac, 4)
        out["drift"] = frac >= threshold
        if out["drift"]:
            out["note"] = (f"measured {unit} moved {frac:.0%} from the "
                           f"model (>= {threshold:.0%}): the byte model "
                           "or the ledger is wrong — investigate before "
                           "trusting either")
    elif measured > 0:
        out["note"] = ("no model to reconcile against (modeled == 0) — "
                       "measured traffic stands alone")
    return out


# the collective kernels of a torch.profiler trace: NCCL names its device
# kernels ncclDevKernel_<Op>_... / ncclKernel_<Op>_...
COLLECTIVE_MARKERS = ("AllReduce", "AllGather", "ReduceScatter", "AllToAll",
                      "SendRecv", "Broadcast")
# the device-side event categories of a torch.profiler Chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_events(trace_dir: str) -> list:
    """The newest Chrome trace under trace_dir (torch.profiler's
    export_chrome_trace: `--profile DIR`, `/admin/profile`), its
    traceEvents; [] when there is none."""
    import glob
    import json
    import os

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    for path in reversed(files):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        events = data.get("traceEvents") if isinstance(data, dict) else data
        if isinstance(events, list):
            return events
    return []


def _stem(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list: "void q40_gemv1_kernel<...>(...)" -> "q40_gemv1_kernel"."""
    name = name.split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].strip()


def _device_events(events: list) -> list:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


def per_step_op_ms(trace_dir: str, markers: tuple = COLLECTIVE_MARKERS,
                   module_hint: str | None = None) -> list:
    """PER-STEP summed device time (ms) of the kernels whose name holds
    any marker, from a torch.profiler trace — the port's reading of the
    JAX function (there, one step is one executed XLA module). Here one
    step is one replayed CUDA graph: each ``cudaGraphLaunch`` runtime
    event, with the device kernels that carry its correlation id, in
    timeline order (``module_hint``, when given, keeps the steps that
    launched a kernel whose name holds it). Returns [] when the trace
    has no graph replay on a device (CPU runs, eager steps): the caller
    falls back to the microbench."""
    events = _trace_events(trace_dir)
    launches = sorted((e.get("ts", 0.0), e.get("args", {}).get("correlation"))
                      for e in events
                      if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch")
    if not launches:
        return []
    index = {corr: i for i, (_, corr) in enumerate(launches)}
    total = [0.0] * len(launches)
    hinted = [module_hint is None] * len(launches)
    for e in _device_events(events):
        i = index.get(e.get("args", {}).get("correlation"))
        if i is None:
            continue
        name = e.get("name", "")
        if module_hint is not None and module_hint in name:
            hinted[i] = True
        if any(m in name for m in markers):
            total[i] += float(e.get("dur", 0.0)) / 1e3
    return [t for t, h in zip(total, hinted) if h]


def per_trace_attribution(trace_dir: str) -> tuple[dict, float]:
    """ONE walk of a trace giving both halves of a sampled step's
    attribution: ({kernel name: total device ms}, total collective device
    ms). ({}, 0.0) when the trace has no device events (CPU runs)."""
    mods: dict[str, float] = {}
    sync_ms = 0.0
    for e in _device_events(_trace_events(trace_dir)):
        ms = float(e.get("dur", 0.0)) / 1e3
        name = e.get("name", "")
        stem = _stem(name)
        mods[stem] = mods.get(stem, 0.0) + ms
        if any(m in name for m in COLLECTIVE_MARKERS):
            sync_ms += ms
    return ({k: round(v, 4) for k, v in mods.items()}, round(sync_ms, 4))


def per_module_ms(trace_dir: str) -> dict:
    """PER-KERNEL summed device time from a torch.profiler trace: {kernel
    name: total ms over its launches} (the JAX function keys by executed
    XLA module; a replayed CUDA graph has no such name, so the port keys
    by the kernels it replays: q40_gemv1_kernel, flash_attention's, the
    copies). {} when the trace has no device events."""
    return per_trace_attribution(trace_dir)[0]



def _axis_name(axes: tuple):
    """The port mesh's axis (or joint axis) name for JAX axis names."""
    from ..parallel.mesh import JOINT

    axes = tuple(axes)
    if len(axes) == 1:
        return axes[0]
    for name, parts in JOINT.items():
        if parts == axes:
            return name
    raise ValueError(f"no process group spans axes {axes}")


def _sync(mesh) -> None:
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def measure_allreduce_ms(mesh, payload_elems: int, iters: int = 16,
                         axes: tuple = ("tp",)) -> float:
    """Time one f32 all-reduce of `payload_elems` over the given mesh axes
    (jointly — ("ep", "tp") is the MoE group reduce) with the port's
    collective (parallel/collectives.py, staged through host memory where
    gloo carries CUDA tensors, as the forward's are). Returns ms per
    all-reduce, amortized over iters after one warm call; 0.0 when the
    axes are one rank wide. Every rank of the mesh calls it, in one order."""
    import torch

    from ..parallel.collectives import all_reduce

    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return 0.0
    axis = _axis_name(axes)
    x = torch.ones(payload_elems, dtype=torch.float32, device=mesh.device)
    all_reduce(x, mesh, axis)       # warm
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce(x, mesh, axis)
    _sync(mesh)
    return (time.perf_counter() - t0) / iters * 1e3


def measure_ppermute_ms(mesh, payload_elems: int, iters: int = 16,
                        axis: str = "pp") -> float:
    """Time one f32 hop of `payload_elems` to the next rank along `axis`
    (the pp stage hop, the sp ring's step): every rank sends to the next
    and receives from the previous, point to point. Returns ms per hop,
    0.0 when the axis is one rank wide."""
    import torch

    from ..parallel.collectives import ring_shift

    if mesh.shape.get(axis, 1) <= 1:
        return 0.0
    x = torch.ones(payload_elems, dtype=torch.float32, device=mesh.device)
    ring_shift([x], mesh, axis).wait()     # warm
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        (x,) = ring_shift([x], mesh, axis).wait()
    _sync(mesh)
    return (time.perf_counter() - t0) / iters * 1e3


def measure_broadcast_ms(mesh, payload_elems: int, iters: int = 16,
                         axis: str = "pp") -> float:
    """Time one f32 broadcast of `payload_elems` from the last rank along
    `axis` (the last pp stage's activations). Returns ms per broadcast,
    0.0 when the axis is one rank wide."""
    import torch

    from ..parallel.collectives import broadcast

    n = mesh.shape.get(axis, 1)
    if n <= 1:
        return 0.0
    x = torch.ones(payload_elems, dtype=torch.float32, device=mesh.device)
    broadcast(x, mesh, axis, n - 1)      # warm
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        broadcast(x, mesh, axis, n - 1)
    _sync(mesh)
    return (time.perf_counter() - t0) / iters * 1e3
