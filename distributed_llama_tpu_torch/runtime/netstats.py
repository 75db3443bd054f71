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

The serving, prefix-reuse and block-transfer estimates and the trace
readers come with the fleet (ROADMAP item 16). The T column is the
microbench estimate: the port's `--profile DIR` trace does not tell one
decode step's collectives from another's, so the JAX CLI's per-step trace
reading (its fallback is this estimate, apps/dllama.py:1011-1013) has no
counterpart here.
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
