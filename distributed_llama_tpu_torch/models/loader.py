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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.model_file import HostTensor, iter_model_tensors
from ..quants.torch_codec import QuantizedTensor
from ..quants.types import FloatType
from .params import NORMS, as_q40_host, host_dense, host_weight
from .spec import ModelSpec


@dataclasses.dataclass
class LoadStats:
    peak_host_bytes: int = 0
    total_bytes: int = 0


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


def load_params_streamed(spec: ModelSpec, path: str, device, *,
                         mode: str | None = None,
                         dtype=torch.bfloat16) -> tuple[dict, LoadStats]:
    """Stream the `.m` file into a fused params dict on `device`.

    mode defaults to q40 for Q40 files and dense otherwise (as the JAX
    CLI's build_engine picks it). Returns (params, LoadStats) with the
    loader's measured high-water mark of resident file-tensor bytes."""
    if mode is None:
        mode = "q40" if spec.weights_float_type == FloatType.Q40 else "dense"
    p: dict = {"layers": [dict() for _ in range(spec.n_layers)]}
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
        dest = p["layers"][int(t.name.split(".")[1])] \
            if t.name.startswith("layers.") else p
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
            _expert_into_stack(dest, key, int(t.name.split(".")[3]), t,
                               spec.n_experts, mode, dtype, device)
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
    if experts_in != 3 * spec.n_experts * spec.n_layers:
        raise ValueError(f"{experts_in} expert tensors in the file, the spec "
                         f"wants {3 * spec.n_experts * spec.n_layers}")
    return p, stats
