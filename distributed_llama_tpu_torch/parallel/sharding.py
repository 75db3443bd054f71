"""One rank's shard of the params — counterpart of the JAX package's
parallel/sharding.py (its _SPLIT table, check_tp_constraints,
COL_SPLIT_NAMES, cache_pspec) and of param_pspecs + shard_params, which
place every leaf's shard on its device: here each rank cuts its own shard
from the full params (`shard_params`), or the streamed loader keeps only
its shard of each tensor as it passes (models/loader.py).

Beyond tp, a rank keeps (JAX sharding.py:138-150, pp.stack_stages,
ep_moe.repack_moe_ep):

  pp   the layers of its stage, [p*L/pp, (p+1)*L/pp), and their cache;
  ep   its E/ep experts of every MoE stack (`place_moe`);
  sp   every weight (sp replicates them) and S/sp positions of the cache,
       [i*S/sp, (i+1)*S/sp);
  vocab  with the vocab split and pp > 1, the embedding's and the head's
       vocab rows over (pp, tp) when pp*tp divides the vocab (JAX
       ops/sharded_vocab.vocab_shard_axes), over tp otherwise.

The split of each leaf is the reference's (ref: src/transformer.cpp:14-76):

  row  output rows [k*d/tp, (k+1)*d/tp): wq, wk, wv, w1, w3, moe_up,
       moe_gate, and wcls (the vocab rows, when tp divides the vocab);
  col  input columns [k*n/tp, (k+1)*n/tp): wo, w2, moe_down;
  None replicated: norms, the MoE router, and tok_emb unless the vocab
       is split (ops/sharded_vocab.py), when it takes its vocab rows.

A Q40 column shard is simpler here than in the JAX package: the port's
packed layout is block-major (quants/torch_codec.py), block b's 16 bytes
at [16b, 16b + 16) of its row, so columns [k*n/tp, (k+1)*n/tp) are the
per-row byte slice [k*n/(2 tp), (k+1)*n/(2 tp)) and the scales' slice
[k*nb/tp, (k+1)*nb/tp), whole blocks because n/tp % 32 == 0
(check_tp_constraints). JAX's lane-order relayout (tp_q80.repack_col_tp)
has no counterpart. Every shard is copied into storage of its own,
contiguous and 16-byte aligned, as K1 and K2 take it
(ops/cuda_q40.py:_checked_x), and so that the full tensor can be freed.

A rank fuses its own row shards, wq|wk|wv -> wqkv and w1|w3 -> w13
(models/params.fuse_layer_weights on the shard): the same product as the
JAX package's unfused calls at tp > 1, in the launches of one device.
"""

from __future__ import annotations

import torch

from ..models.params import (fuse_layer_weights, replicate_kv_heads,
                             unfuse_layer_weights)
from ..models.spec import ModelSpec
from ..quants.torch_codec import QuantizedTensor
from .mesh import PP_TP, TP_AXIS
from .wrappers import (EpColWeight, EpRowWeight, TpColWeight, TpRowWeight,
                       WeightWrapper)

_SPLIT = {
    "tok_emb": None,
    "rms_att": None,
    "rms_ffn": None,
    "rms_moe": None,
    "rms_ffn2": None,
    "rms_final": None,
    "moe_router": None,
    "wq": "row",
    "wk": "row",
    "wv": "row",
    "wqkv": "row",
    "w1": "row",
    "w3": "row",
    "w13": "row",
    "moe_up": "row",
    "moe_gate": "row",
    "moe_down": "col",
    "wo": "col",
    "w2": "col",
    "wcls": "row",
}
COL_SPLIT_NAMES = tuple(k for k, v in _SPLIT.items() if v == "col")


def check_tp_constraints(spec: ModelSpec, tp: int, q40: bool = False) -> None:
    """The divisibility rules (JAX sharding.py:153; ref:
    src/transformer.cpp:15,49,254-257), on the spec the engine computes
    with (kv heads already replicated when tp exceeds them)."""
    if tp == 1:
        return
    if spec.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={spec.n_kv_heads} (reference "
            "constraint nSlices <= nKvHeads, transformer.cpp:254-257; for "
            "tp > n_kv_heads the engine replicates kv heads first)")
    if spec.n_heads % tp or spec.hidden_dim % tp or spec.dim % tp:
        raise ValueError(f"tp={tp} must divide n_heads={spec.n_heads}, "
                         f"hidden_dim={spec.hidden_dim} and dim={spec.dim}")
    if q40 and (spec.hidden_dim % (32 * tp) or spec.dim % (32 * tp)):
        raise ValueError(f"tp={tp}: Q40 column shards must keep whole "
                         f"32-value blocks (dim={spec.dim}, hidden_dim="
                         f"{spec.hidden_dim} must divide by {32 * tp})")


def check_axis_constraints(spec: ModelSpec, *, sp: int = 1, ep: int = 1,
                           pp: int = 1, seq_len: int | None = None,
                           q80_collectives: bool = False) -> None:
    """The placement rules of the other axes, in the JAX engine's words
    (JAX runtime/engine.py:186-189, 215-221, 234-245)."""
    if sp > 1 and (seq_len or spec.seq_len) % sp:
        raise ValueError(f"sp={sp} must divide max_seq_len="
                         f"{seq_len or spec.seq_len} (sp-sharded KV cache)")
    if ep > 1:
        if not spec.is_moe:
            raise ValueError("--ep requires a MoE model (experts to place)")
        if spec.n_experts % ep:
            raise ValueError(f"ep={ep} must divide n_experts="
                             f"{spec.n_experts}")
    if pp > 1:
        if spec.n_layers % pp:
            raise ValueError(f"pp={pp} must divide n_layers={spec.n_layers}")
        if q80_collectives:
            raise ValueError("pp uses exact tp reduces; --buffer-float-type "
                             "q80 is not supported with --pp")


def vocab_splits(spec: ModelSpec, tp: int) -> bool:
    """Whether tp can row-split the vocab dim evenly (JAX
    sharded_vocab.vocab_shard_axes: the vocab splits only with tp)."""
    return tp > 1 and spec.vocab_size % tp == 0


def vocab_axis(spec: ModelSpec, tp: int, pp: int) -> str:
    """The axis a split vocab lies over (JAX vocab_shard_axes): (pp, tp)
    when there are stages and pp*tp divides the vocab, tp otherwise."""
    if tp > 1 and pp > 1 and spec.vocab_size % (pp * tp) == 0:
        return PP_TP
    return TP_AXIS


def loader_placement(mesh, spec: ModelSpec, shard_vocab: bool) -> dict:
    """The streamed loader's keyword arguments for this rank of `mesh`
    (models/loader.load_params_streamed): its tp shard, ep experts, pp
    stage and vocab rows, as Engine(mesh=) expects them."""
    ax = vocab_axis(spec, mesh.tp, mesh.pp) if shard_vocab else TP_AXIS
    return dict(tp=mesh.tp, rank=mesh.tp_rank, ep=mesh.ep,
                ep_rank=mesh.ep_rank, pp=mesh.pp, pp_rank=mesh.pp_rank,
                shard_vocab=shard_vocab and mesh.tp > 1,
                vocab_split=(mesh.shape[ax], mesh.index(ax)))


def stage_layers(layers: list, pp: int, k: int) -> list:
    """Stage k's layers, [k*L/pp, (k+1)*L/pp)."""
    n = len(layers) // pp
    return list(layers[k * n:(k + 1) * n])


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in storage of its own (16-byte aligned, like every
    fresh allocation)."""
    return t.clone(memory_format=torch.contiguous_format)


def row_shard(w, tp: int, k: int):
    """Rank k's output rows (axis -2 of a (..., d, n) weight; axis 0 of
    an embedding table) of a dense or Q40 weight."""
    if tp == 1:
        return w
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(row_shard(w.packed, tp, k),
                               row_shard(w.scales, tp, k))
    d = w.shape[-2]
    if d % tp:
        raise ValueError(f"{d} rows do not split over tp={tp}")
    return _own(w.narrow(-2, k * (d // tp), d // tp))


def col_shard(w, tp: int, k: int):
    """Rank k's input columns of a dense or Q40 (..., d, n) weight: a Q40
    weight's block-major bytes and scales sliced per row."""
    if tp == 1:
        return w
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(col_shard(w.packed, tp, k),
                               col_shard(w.scales, tp, k))
    n = w.shape[-1]
    if n % tp:
        raise ValueError(f"{n} columns do not split over tp={tp}")
    return _own(w.narrow(-1, k * (n // tp), n // tp))


def expert_slice(w, ep: int, k: int):
    """Rank k's E/ep consecutive experts of an (E, d, n) stack, dense or
    Q40, in storage of their own (whole: the full stack can be freed)."""
    if ep == 1:
        return w
    n = w.shape[0] // ep
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(_own(w.packed.narrow(0, k * n, n)),
                               _own(w.scales.narrow(0, k * n, n)))
    return _own(w.narrow(0, k * n, n))


def place_moe(lw: dict, ep: int, ep_k: int, tp: int, tp_k: int) -> dict:
    """One layer's three MoE stacks for the ep path, marked (JAX
    repack_moe_ep): the rank's local experts of moe_up / moe_gate cut to
    its tp rows (EpRowWeight) and of moe_down cut to its tp columns
    (EpColWeight; the column shard is a per-row byte slice of the
    block-major Q40 layout, so no tp relayout comes first)."""
    out = {name: EpRowWeight(row_shard(expert_slice(lw[name], ep, ep_k),
                                       tp, tp_k))
           for name in ("moe_up", "moe_gate")}
    out["moe_down"] = EpColWeight(col_shard(
        expert_slice(lw["moe_down"], ep, ep_k), tp, tp_k))
    return out


def leaf_shard(name: str, w, tp: int, k: int):
    """Rank k's shard of one layer leaf, wrapped in its marker when it is
    a split matmul weight (plain when replicated)."""
    split = _SPLIT[name]
    if split is None:
        return w
    if split == "row":
        return TpRowWeight(row_shard(w, tp, k))
    return TpColWeight(col_shard(w, tp, k))


def is_sharded(params: dict) -> bool:
    """Whether params already are a rank's shard (marked leaves)."""
    return any(isinstance(v, WeightWrapper)
               for lw in params["layers"] for v in lw.values())


def shard_params(params: dict, spec: ModelSpec, tp: int, k: int,
                 vocab: bool = False, *, ep: int = 1, ep_k: int = 0,
                 pp: int = 1, pp_k: int = 0,
                 vocab_split: tuple[int, int] | None = None) -> dict:
    """Rank k's shard of the full params, for an engine over tp ranks:
    fused leaves split back first (unfuse_layer_weights), kv heads
    replicated when tp exceeds them (before the stage is picked, as in
    JAX), stage pp_k's layers kept, ep rank ep_k's experts of each MoE
    stack (`place_moe`), every split leaf cut and marked,
    the rank's row shards fused. `vocab_split` (n, i): shard i of n of the
    vocab rows (default (tp, k)); wcls is row-split whenever n divides the
    vocab, and `vocab` splits tok_emb's rows too. Leaves that stay whole
    are shared with `params`, not copied; nothing of `params` is
    changed."""
    params = unfuse_layer_weights(params, spec)
    if tp > spec.n_kv_heads:
        params = replicate_kv_heads(params, spec, tp)
    vn, vk = vocab_split or (tp, k)
    wcls = params["wcls"]
    out = {"tok_emb": row_shard(params["tok_emb"], vn, vk) if vocab
           else params["tok_emb"],
           "rms_final": params["rms_final"],
           "wcls": (TpRowWeight(row_shard(wcls, vn, vk))
                    if wcls.shape[0] % vn == 0 else wcls)}
    out["layers"] = []
    for lw in stage_layers(params["layers"], pp, pp_k):
        moe = ep > 1 and "moe_up" in lw
        local = {name: leaf_shard(name, w, tp, k) for name, w in lw.items()
                 if not (moe and name in ("moe_up", "moe_gate", "moe_down"))}
        if moe:
            local.update(place_moe(lw, ep, ep_k, tp, k))
        out["layers"].append(fuse_local_rows(local))
    return out


def fuse_local_rows(lw: dict) -> dict:
    """A layer's row shards fused as fuse_layer_weights fuses a whole
    layer: wq|wk|wv -> wqkv, w1|w3 -> w13, marked as row shards."""
    inner = {k: (v.w if isinstance(v, TpRowWeight) else v)
             for k, v in lw.items()}
    fused = fuse_layer_weights({"layers": [inner]})["layers"][0]
    return {k: (TpRowWeight(v) if k in ("wqkv", "w13") else lw[k])
            for k, v in fused.items()}
