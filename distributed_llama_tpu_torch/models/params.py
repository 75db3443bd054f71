"""Model parameters as a dict of device tensors — counterpart of the JAX
package's models/params.py.

Structure: {"tok_emb", "rms_final", "wcls", "layers": [<per-layer dict>, ...]}
with each layer's weights standalone tensors (no stacked (L, ...) axis), the
same tree the JAX package builds, so models/convert.py maps one onto the
other leaf by leaf.

Two storage modes:
  * dense — weights dequantized to `dtype` at load
  * q40   — weights kept packed as QuantizedTensor on the device
            (4.5 bits/weight), consumed by the Q40 kernels

MoE layers (MIXTRAL, GROK1) hold a dense router `moe_router` (E, dim) in
`dtype` and their experts stacked: `moe_up`/`moe_gate` (E, hidden, dim),
`moe_down` (E, dim, hidden), as the JAX package's moe_weight stacks them;
GROK1 adds the norms `rms_moe` and `rms_ffn2`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.model_file import HostTensor, model_tensor_plan
from ..quants.numpy_codec import quantize_q40
from ..quants.torch_codec import QuantizedTensor
from ..quants.types import FloatType
from ..utils.device import resolve_device
from .spec import ArchType, ModelSpec

NORMS = ("rms_att", "rms_ffn", "rms_moe", "rms_ffn2", "rms_final")


def _to_q40_host(x: np.ndarray) -> HostTensor:
    scales, packed = quantize_q40(x.reshape(-1, x.shape[-1]))
    return HostTensor("", FloatType.Q40, x.shape, scales=scales, packed=packed)


def as_q40_host(t: HostTensor) -> HostTensor:
    """A file tensor in Q40: as it is if the file holds Q40, else quantized
    on the host."""
    return t if t.ftype == FloatType.Q40 else _to_q40_host(t.to_f32())


def host_weight(t: HostTensor, mode: str, dtype, device):
    """One matmul weight from its file tensor in the requested mode. Q40
    file tensors go to the device still packed, never through f32."""
    if mode == "q40":
        t = as_q40_host(t)
        return QuantizedTensor.from_host(t.scales, t.packed, device)
    return torch.from_numpy(t.to_f32()).to(device=device, dtype=dtype)


def host_dense(t: HostTensor, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t.to_f32())).to(
        device=device, dtype=dtype)


def host_stack(ts: list[HostTensor], mode: str, dtype, device):
    """An (E, ...) expert stack from the experts' file tensors. Q40 file
    tensors stay packed (JAX params.py:moe_weight)."""
    if mode == "q40":
        qs = [as_q40_host(t) for t in ts]
        return QuantizedTensor.from_host(np.stack([q.scales for q in qs]),
                                         np.stack([q.packed for q in qs]),
                                         device)
    return torch.from_numpy(np.stack([t.to_f32() for t in ts])).to(
        device=device, dtype=dtype)


def load_params(spec: ModelSpec, tensors: dict[str, HostTensor],
                mode: str = "q40", dtype=torch.float32,
                device=None) -> dict:
    """Build the params dict from file tensors on `device` (`cuda` unless
    told otherwise). Norms stay f32; the embedding table and the MoE
    router are stored in `dtype`."""
    if mode not in ("dense", "q40"):
        raise ValueError(f"mode must be dense or q40, got {mode!r}")
    device = resolve_device(device)
    p: dict = {"tok_emb": host_dense(tensors["tok_emb"], dtype, device)}
    norms = NORMS[:4] if spec.arch == ArchType.GROK1 else NORMS[:2]
    layers = []
    for l in range(spec.n_layers):
        pre = f"layers.{l}."
        lw = {k: host_dense(tensors[pre + k], torch.float32, device)
              for k in norms}
        for w in ("wq", "wk", "wv", "wo"):
            lw[w] = host_weight(tensors[pre + w], mode, dtype, device)
        if spec.is_moe:
            lw["moe_router"] = host_dense(tensors[pre + "moe_router"], dtype,
                                          device)
            for w in ("up", "gate", "down"):
                lw[f"moe_{w}"] = host_stack(
                    [tensors[f"{pre}experts.{e}.{w}"]
                     for e in range(spec.n_experts)], mode, dtype, device)
        else:
            for w in ("w1", "w2", "w3"):
                lw[w] = host_weight(tensors[pre + w], mode, dtype, device)
        layers.append(lw)
    p["layers"] = layers
    p["rms_final"] = host_dense(tensors["rms_final"], torch.float32, device)
    p["wcls"] = host_weight(tensors["wcls"], mode, dtype, device)
    return p


def _concat_weights(ws: list):
    """Concatenate matmul weights along the output dim."""
    if isinstance(ws[0], QuantizedTensor):
        return QuantizedTensor(torch.cat([w.packed for w in ws]),
                               torch.cat([w.scales for w in ws]))
    return torch.cat(ws)


def fuse_layer_weights(params: dict) -> dict:
    """Fuse wq|wk|wv -> wqkv and w1|w3 -> w13 along the output dim, IN
    PLACE (JAX params.py:117-133): one kernel launch per group instead of
    three or two. Mutating the layer dicts frees the superseded tensors
    even while the caller still holds the params dict. MoE experts' gate
    and up stay apart, as in the JAX package. A rank's shard
    (parallel/sharding.py) fuses its own row shards the same way."""
    for lw in params["layers"]:
        if "wq" in lw:
            lw["wqkv"] = _concat_weights([lw.pop("wq"), lw.pop("wk"), lw.pop("wv")])
        if "w1" in lw:
            lw["w13"] = _concat_weights([lw.pop("w1"), lw.pop("w3")])
    return params


def _split_rows(w, cuts: list[int]) -> list:
    """Split a matmul weight back along the output dim at `cuts` (views)."""
    edges = list(zip([0] + cuts, cuts + [w.shape[0]]))
    if isinstance(w, QuantizedTensor):
        return [QuantizedTensor(w.packed[a:b], w.scales[a:b]) for a, b in edges]
    return [w[a:b] for a, b in edges]


def unfuse_layer_weights(params: dict, spec: ModelSpec) -> dict:
    """Inverse of fuse_layer_weights (exact row slices; JAX params.py:144),
    for a params dict that a one-device engine fused in place and a rank's
    shard is cut from: a row split of the fused [q|k|v] output dim would
    cross the projections' boundaries. Non-mutating; no-op when nothing is
    fused."""
    if not any("wqkv" in lw or "w13" in lw for lw in params["layers"]):
        return params
    d, kv, h = spec.dim, spec.kv_dim, spec.hidden_dim
    params = dict(params)
    params["layers"] = [dict(lw) for lw in params["layers"]]
    for lw in params["layers"]:
        if "wqkv" in lw:
            lw["wq"], lw["wk"], lw["wv"] = _split_rows(lw.pop("wqkv"),
                                                       [d, d + kv])
        if "w13" in lw:
            lw["w1"], lw["w3"] = _split_rows(lw.pop("w13"), [h])
    return params


def kv_replication(spec: ModelSpec, tp: int) -> int:
    """The replication factor r of the KV heads when tp exceeds them (JAX
    params.py:165): each kv head's projections and cache are repeated r =
    tp / n_kv_heads times as tp "virtual" heads (virtual head j holds real
    head j // r), so every rank holds one. Raises on a tp it cannot serve."""
    kvh = spec.n_kv_heads
    if tp % kvh:
        raise ValueError(f"tp={tp} must be a multiple of n_kv_heads={kvh} "
                         "to replicate")
    if spec.n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={spec.n_heads}")
    return tp // kvh


def _repeat_head_rows(a: torch.Tensor, kvh: int, r: int) -> torch.Tensor:
    per = a.shape[0] // kvh
    return a.reshape(kvh, per, *a.shape[1:]).repeat_interleave(r, dim=0) \
        .reshape(kvh * r * per, *a.shape[1:])


def replicate_kv_heads(params: dict, spec: ModelSpec, tp: int) -> dict:
    """wk/wv expanded to tp virtual heads (kv_replication; JAX
    params.py:197). Non-mutating; a leaf already expanded (tp x kv rows)
    passes through. Takes unfused params."""
    r = kv_replication(spec, tp)
    if r == 1:
        return params
    kvh = spec.n_kv_heads
    params = dict(params)
    params["layers"] = [dict(lw) for lw in params["layers"]]
    for lw in params["layers"]:
        for key in ("wk", "wv"):
            w = lw[key]
            if w.shape[0] == spec.kv_dim * r:
                continue
            if w.shape[0] != spec.kv_dim:
                raise ValueError(f"{key} has {w.shape[0]} rows, kv_dim is "
                                 f"{spec.kv_dim}")
            lw[key] = (QuantizedTensor(_repeat_head_rows(w.packed, kvh, r),
                                       _repeat_head_rows(w.scales, kvh, r))
                       if isinstance(w, QuantizedTensor)
                       else _repeat_head_rows(w, kvh, r))
    return params


def random_tensors(spec: ModelSpec, seed: int = 0,
                   scale: float = 0.02) -> dict[str, HostTensor]:
    """Synthetic host tensors for tests (numpy RNG) — the same draws as the
    JAX package's random_tensors for the same seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, ftype in model_tensor_plan(spec):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        if ftype == FloatType.Q40:
            out[name] = _to_q40_host(x)
            out[name].name = name
            out[name].shape = shape
        else:
            out[name] = HostTensor(name, FloatType.F32, shape, data=x)
    return out


def synthetic_q40_params(spec: ModelSpec, seed: int, device,
                         dtype=torch.bfloat16) -> dict:
    """Random full-width Q40 params built at the packed-byte level ON the
    device, from a seeded torch.Generator (the JAX package's
    bench.synth_q40_params does the same on the host): uniform nibbles,
    scales in [0.001, 0.005), so dequantized weights land near N(0, 0.01).
    Unit norms; embedding and MoE router N(0, 0.02) in `dtype`. Returned
    already fused (wqkv, and w13 for a dense FFN); MoE experts stacked."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def q40(*shape: int) -> QuantizedTensor:
        *lead, n = shape
        packed = torch.randint(0, 256, (*lead, n // 2), generator=gen,
                               device=device, dtype=torch.uint8)
        scales = torch.rand((*lead, n // 32), generator=gen, device=device,
                            dtype=torch.float32) * 0.004 + 0.001
        return QuantizedTensor(packed, scales.to(torch.float16))

    def normal(*shape: int) -> torch.Tensor:
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02
        return x.to(dtype)

    d, hd, ne = spec.dim, spec.hidden_dim, spec.n_experts
    norms = NORMS[:4] if spec.arch == ArchType.GROK1 else NORMS[:2]
    layers = []
    for _ in range(spec.n_layers):
        lw = {k: torch.ones(d, dtype=torch.float32, device=device)
              for k in norms}
        lw["wqkv"] = q40(d + 2 * spec.kv_dim, d)
        lw["wo"] = q40(d, d)
        if spec.is_moe:
            lw["moe_router"] = normal(ne, d)
            lw["moe_up"] = q40(ne, hd, d)
            lw["moe_gate"] = q40(ne, hd, d)
            lw["moe_down"] = q40(ne, d, hd)
        else:
            lw["w13"] = q40(2 * hd, d)
            lw["w2"] = q40(d, hd)
        layers.append(lw)
    return {"tok_emb": normal(spec.vocab_size, d), "layers": layers,
            "rms_final": torch.ones(d, dtype=torch.float32, device=device),
            "wcls": q40(spec.vocab_size, d)}
