"""Streamed `.m` loader for one device — counterpart of the single-device
part of the JAX package's models/loader.py:load_params_streamed.

Tensors stream from the file one at a time (only the tensors of an open
fusion group are resident on the host). wq|wk|wv and w1|w3 are fused on the
host before upload (`_fuse_group`/`_concat_host`, JAX loader.py:348-368),
so the device holds only the fused wqkv / w13. Q40 tensors go to the
device still packed, never through f32.

MoE experts: each layer's (E, ...) stacks `moe_up`/`moe_gate`/`moe_down`
are allocated on the device once, when their first expert streams past,
and each expert's file tensor is copied into its slot as it arrives. No
host stack of all E experts is ever built (the JAX loader stacks them on
the host), so the host high-water mark stays near one expert's bytes.

With `tp > 1` (JAX loader.py:371 with a mesh) each rank streams the whole
file and keeps only its shard of each tensor, cut on the host before the
upload (parallel/sharding.py's splits: row shards of wq/wk/wv/w1/w3 and
the experts' up/gate, column shards of wo/w2 and the experts' down, wcls's
vocab rows when tp divides the vocab, tok_emb's with `shard_vocab`; kv
heads replicated when tp exceeds them). The rank fuses its own row shards
and marks every split leaf (parallel/wrappers.py), so Engine(mesh=) takes
the dict as it is.

With `pp > 1` or `ep > 1` (JAX loader.py:150-180, 230-345) a rank keeps
only the layers of its stage and, of every MoE stack, its E/ep experts
(each still cut to its tp rows or columns, and marked EpRowWeight /
EpColWeight): the others stream past and are dropped on the host, so the
rank's device never holds the whole model. sp replicates the weights.
kv heads are replicated per tensor before anything is kept, as in JAX.
`vocab_split` (n, i) cuts the vocab rows of wcls (and of tok_emb with
`shard_vocab`) into n parts, over (pp, tp) when the engine widens the
split over the stages (parallel/sharding.vocab_axis).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.model_file import HostTensor, iter_model_tensors
from ..parallel.sharding import _SPLIT, check_axis_constraints
from ..parallel.wrappers import (EpColWeight, EpRowWeight, TpColWeight,
                                 TpRowWeight, WeightWrapper)
from ..quants.torch_codec import QuantizedTensor
from ..quants.types import FloatType
from .params import NORMS, as_q40_host, host_dense, host_weight
from .spec import ModelSpec


@dataclasses.dataclass
class LoadStats:
    peak_host_bytes: int = 0
    total_bytes: int = 0
    device_bytes: int = 0      # this rank's params on its device


def _leaf_key(name: str) -> str:
    """'layers.3.wq' -> 'wq'; 'layers.0.experts.2.up' -> 'moe_up'."""
    parts = name.split(".")
    if len(parts) > 2 and parts[2] == "experts":
        return "moe_" + parts[4]
    return parts[-1]


def _fuse_group(key: str) -> str | None:
    """Which fusion group a leaf belongs to (params.fuse_layer_weights)."""
    if key in ("wq", "wk", "wv"):
        return "wqkv"
    if key in ("w1", "w3"):
        return "w13"
    return None


def _host_bytes(t: HostTensor) -> int:
    return sum(a.nbytes for a in (t.data, t.scales, t.packed) if a is not None)


def _concat_host(ts: list[HostTensor], mode: str) -> HostTensor:
    """Concatenate a fusion group along the output dim on the host."""
    if mode == "q40":
        qs = [as_q40_host(t) for t in ts]
        return HostTensor("", FloatType.Q40,
                          (sum(t.shape[0] for t in ts), ts[0].shape[1]),
                          scales=np.concatenate([q.scales for q in qs]),
                          packed=np.concatenate([q.packed for q in qs]))
    x = np.concatenate([t.to_f32() for t in ts], axis=0)
    return HostTensor("", FloatType.F32, x.shape, data=x)


def _expert_into_stack(dest: dict, key: str, e: int, t: HostTensor,
                       n_experts: int, mode: str, dtype, device) -> None:
    """Copy expert e's file tensor into slot e of the layer's (E, ...)
    stack, allocating the stack on the device at its first expert."""
    d, n = t.shape
    if mode == "q40":
        q = as_q40_host(t)
        if key not in dest:
            dest[key] = QuantizedTensor(
                torch.empty((n_experts, d, n // 2), dtype=torch.uint8,
                            device=device),
                torch.empty((n_experts, d, n // 32), dtype=torch.float16,
                            device=device))
        w = QuantizedTensor.from_host(q.scales, q.packed, "cpu")
        dest[key].packed[e].copy_(w.packed)
        dest[key].scales[e].copy_(w.scales)
        return
    if key not in dest:
        dest[key] = torch.empty((n_experts, d, n), dtype=dtype, device=device)
    dest[key][e].copy_(torch.from_numpy(t.to_f32()))


def _host_shard(t: HostTensor, key: str, mode: str, spec: ModelSpec,
                tp: int, k: int, shard_vocab: bool,
                vocab_split: tuple[int, int]) -> HostTensor:
    """Rank k's shard of one file tensor, cut on the host (a Q40 tensor in
    q40 mode stays packed: whole blocks of its rows or columns); the vocab
    rows of tok_emb and wcls are shard vocab_split[1] of vocab_split[0]."""
    split = "row" if key == "tok_emb" and shard_vocab else _SPLIT.get(key)
    if key in ("tok_emb", "wcls"):
        tp, k = vocab_split
    if split is None or tp == 1 or (key == "wcls" and t.shape[0] % tp):
        return t
    d, n = t.shape
    if split == "row":
        if key in ("wk", "wv") and tp > spec.n_kv_heads:
            # one virtual kv head a rank: real head k // r
            hs = spec.head_size
            h = k // (tp // spec.n_kv_heads)
            rows = slice(h * hs, (h + 1) * hs)
        else:
            rows = slice(k * d // tp, (k + 1) * d // tp)
        cols = slice(None)
    else:
        rows, cols = slice(None), slice(k * n // tp, (k + 1) * n // tp)
    nr = len(range(d)[rows])
    if mode == "q40" and key != "tok_emb":
        q = as_q40_host(t)
        bcols = slice(None) if cols == slice(None) else \
            slice(cols.start // 32, cols.stop // 32)
        packed = np.ascontiguousarray(q.packed[rows, bcols])
        return HostTensor(t.name, FloatType.Q40, (nr, packed.shape[1] * 32),
                          scales=np.ascontiguousarray(q.scales[rows, bcols]),
                          packed=packed)
    x = np.ascontiguousarray(t.to_f32()[rows, cols])
    return HostTensor(t.name, FloatType.F32, x.shape, data=x)


def _mark(key: str, w, spec: ModelSpec, tp: int, ep: int):
    """A placed leaf in its marker (parallel/wrappers.py): a MoE stack
    over ep > 1 in its Ep marker, a tp-split leaf (tp > 1; for wcls, tp is
    the vocab split's count) in its Tp marker; a wcls that the split does
    not divide stays whole and plain."""
    split = _SPLIT.get(key)
    if ep > 1 and key in ("moe_up", "moe_gate", "moe_down"):
        return EpColWeight(w) if split == "col" else EpRowWeight(w)
    if split is None or tp == 1 or (key == "wcls" and spec.vocab_size % tp):
        return w
    return TpRowWeight(w) if split == "row" else TpColWeight(w)


def _nbytes(w) -> int:
    if isinstance(w, WeightWrapper):
        w = w.w
    if isinstance(w, QuantizedTensor):
        return _nbytes(w.packed) + _nbytes(w.scales)
    return w.numel() * w.element_size()


def load_params_streamed(spec: ModelSpec, path: str, device, *,
                         mode: str | None = None, dtype=torch.bfloat16,
                         tp: int = 1, rank: int = 0,
                         shard_vocab: bool = False, ep: int = 1,
                         ep_rank: int = 0, pp: int = 1, pp_rank: int = 0,
                         vocab_split: tuple[int, int] | None = None,
                         ) -> tuple[dict, LoadStats]:
    """Stream the `.m` file into a fused params dict on `device`: all of it,
    or with tp > 1 tp rank `rank`'s marked shard; with pp > 1 only stage
    pp_rank's layers (the dict's "layers" are those L/pp), with ep > 1 only
    ep rank ep_rank's experts of every MoE stack.

    mode defaults to q40 for Q40 files and dense otherwise (as the JAX
    CLI's build_engine picks it). Returns (params, LoadStats) with the
    loader's measured high-water mark of resident file-tensor bytes and
    the device bytes of the params it built."""
    if mode is None:
        mode = "q40" if spec.weights_float_type == FloatType.Q40 else "dense"
    shard = tp > 1
    vocab_split = vocab_split or (tp, rank)
    check_axis_constraints(spec, ep=ep, pp=pp)
    n_local, e_local = spec.n_layers // pp, spec.n_experts // ep
    l0, e0 = pp_rank * n_local, ep_rank * e_local
    p: dict = {"layers": [dict() for _ in range(n_local)]}
    pending: dict[str, list[HostTensor]] = {}
    experts_in = 0
    stats = LoadStats()
    live = 0
    for t in iter_model_tensors(path, spec):
        key = _leaf_key(t.name)
        b = _host_bytes(t)
        stats.total_bytes += b
        live += b
        stats.peak_host_bytes = max(stats.peak_host_bytes, live)
        parts = t.name.split(".")
        if parts[0] == "layers" and not (
                l0 <= int(parts[1]) < l0 + n_local and (
                    parts[2] != "experts"
                    or e0 <= int(parts[3]) < e0 + e_local)):
            live -= b       # another stage's layer or another rank's expert
            continue
        if shard or key in ("tok_emb", "wcls"):
            t = _host_shard(t, key, mode, spec, tp, rank, shard_vocab,
                            vocab_split)
        dest = p["layers"][int(parts[1]) - l0] \
            if parts[0] == "layers" else p
        group = _fuse_group(key)
        if group is not None:
            gk = f"{t.name.rsplit('.', 1)[0]}.{group}"
            pending.setdefault(gk, []).append(t)
            if len(pending[gk]) == (3 if group == "wqkv" else 2):
                ts = pending.pop(gk)
                dest[group] = host_weight(_concat_host(ts, mode), mode,
                                          dtype, device)
                live -= sum(_host_bytes(x) for x in ts)
            continue
        if key in ("moe_up", "moe_gate", "moe_down"):
            _expert_into_stack(dest, key, int(parts[3]) - e0, t, e_local,
                               mode, dtype, device)
            experts_in += 1
        elif key in NORMS:
            dest[key] = host_dense(t, torch.float32, device)  # norms stay f32
        elif key in ("tok_emb", "moe_router"):
            dest[key] = host_dense(t, dtype, device)
        else:
            dest[key] = host_weight(t, mode, dtype, device)
        live -= b
    if pending:
        raise ValueError(f"incomplete fusion groups: {list(pending)}")
    if experts_in != 3 * e_local * n_local:
        raise ValueError(f"{experts_in} expert tensors kept from the file, "
                         f"the spec wants {3 * e_local * n_local}")
    p["wcls"] = _mark("wcls", p["wcls"], spec, vocab_split[0], 1)
    if shard or ep > 1:
        p["layers"] = [{k: _mark(k, w, spec, tp, ep) for k, w in lw.items()}
                       for lw in p["layers"]]
    stats.device_bytes = param_bytes(p)
    return p, stats


def param_bytes(p: dict) -> int:
    """The bytes a params dict holds on its device (every leaf, marked
    shards unwrapped)."""
    return sum(_nbytes(w) for lw in p["layers"] for w in lw.values()) + sum(
        _nbytes(p[k]) for k in ("tok_emb", "rms_final", "wcls"))
