"""Model parameters as a dict of device tensors — counterpart of the JAX
package's models/params.py.

Structure: {"tok_emb", "rms_final", "wcls", "layers": [<per-layer dict>, ...]}
with each layer's weights standalone tensors (no stacked (L, ...) axis), the
same tree the JAX package builds, so models/convert.py maps one onto the
other leaf by leaf.

Two storage modes:
  * dense — weights dequantized to `dtype` at load
  * q40   — weights kept packed as QuantizedTensor on the device
            (4.5 bits/weight), consumed by the Q40 kernel
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.model_file import HostTensor, model_tensor_plan
from ..quants.numpy_codec import quantize_q40
from ..quants.torch_codec import QuantizedTensor
from ..quants.types import FloatType
from .spec import ArchType, ModelSpec


def _to_q40_host(x: np.ndarray) -> HostTensor:
    scales, packed = quantize_q40(x.reshape(-1, x.shape[-1]))
    return HostTensor("", FloatType.Q40, x.shape, scales=scales, packed=packed)


def host_weight(t: HostTensor, mode: str, dtype, device):
    """One matmul weight from its file tensor in the requested mode. Q40
    file tensors go to the device still packed, never through f32."""
    if mode == "q40":
        if t.ftype != FloatType.Q40:
            t = _to_q40_host(t.to_f32())
        return QuantizedTensor.from_host(t.scales, t.packed, device)
    return torch.from_numpy(t.to_f32()).to(device=device, dtype=dtype)


def host_dense(t: HostTensor, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t.to_f32())).to(
        device=device, dtype=dtype)


def load_params(spec: ModelSpec, tensors: dict[str, HostTensor],
                mode: str = "q40", dtype=torch.float32,
                device="cpu") -> dict:
    """Build the params dict from file tensors (LLAMA arch). Norms stay
    f32; the embedding table is stored in `dtype`."""
    if mode not in ("dense", "q40"):
        raise ValueError(f"mode must be dense or q40, got {mode!r}")
    if spec.is_moe:
        raise NotImplementedError(
            f"{spec.arch.name}: MoE weights are ROADMAP slice 2 of the port")
    p: dict = {"tok_emb": host_dense(tensors["tok_emb"], dtype, device)}
    layers = []
    for l in range(spec.n_layers):
        pre = f"layers.{l}."
        lw = {"rms_att": host_dense(tensors[pre + "rms_att"], torch.float32, device),
              "rms_ffn": host_dense(tensors[pre + "rms_ffn"], torch.float32, device)}
        for w in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
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
    even while the caller still holds the params dict."""
    for lw in params["layers"]:
        if "wq" in lw:
            lw["wqkv"] = _concat_weights([lw.pop("wq"), lw.pop("wk"), lw.pop("wv")])
        if "w1" in lw:
            lw["w13"] = _concat_weights([lw.pop("w1"), lw.pop("w3")])
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
    Unit norms; embedding N(0, 0.02) in `dtype`. LLAMA arch only; returned
    already fused (wqkv, w13)."""
    if spec.arch != ArchType.LLAMA:
        raise NotImplementedError(f"{spec.arch.name}: ROADMAP slice 2")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def q40(d: int, n: int) -> QuantizedTensor:
        packed = torch.randint(0, 256, (d, n // 2), generator=gen,
                               device=device, dtype=torch.uint8)
        scales = torch.rand((d, n // 32), generator=gen, device=device,
                            dtype=torch.float32) * 0.004 + 0.001
        return QuantizedTensor(packed, scales.to(torch.float16))

    d, hd = spec.dim, spec.hidden_dim
    ones = lambda: torch.ones(d, dtype=torch.float32, device=device)  # noqa: E731
    layers = [{"rms_att": ones(), "rms_ffn": ones(),
               "wqkv": q40(d + 2 * spec.kv_dim, d), "wo": q40(d, d),
               "w13": q40(2 * hd, d), "w2": q40(d, hd)}
              for _ in range(spec.n_layers)]
    emb = torch.randn((spec.vocab_size, d), generator=gen, device=device,
                      dtype=torch.float32) * 0.02
    return {"tok_emb": emb.to(dtype), "layers": layers, "rms_final": ones(),
            "wcls": q40(spec.vocab_size, d)}
