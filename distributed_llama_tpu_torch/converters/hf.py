"""HF safetensors checkpoint -> reference-format `.m`.

Equivalent of the reference HF converter (ref: converter/convert-hf.py):
llama / mistral / mixtral from config.json + *.safetensors, streamed
tensor-by-tensor so peak memory is one tensor.

Layout decisions mirror the reference:
  * llama/mistral q/k projections are permuted from HF's half-split rotary
    layout to the interleaved layout our rope_llama expects
    (ref: converter/convert-hf.py:12-15,46-50): within each head,
    new_row[2j] = old_row[j], new_row[2j+1] = old_row[j + hs/2].
  * mixtral keeps HF's native layout — the MIXTRAL arch applies half-rotation
    RoPE (rope_falcon), matching HF semantics without permutation.
  * MoE expert tensor order is up(w3), gate(w1), down(w2)
    (ref: converter/convert-hf.py:67-74).

Usage:
  python -m distributed_llama_tpu_torch.converters.hf <hf_dir> out.m --weights-float-type q40
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..io.model_file import model_tensor_plan, write_header, write_tensor
from ..models.spec import ArchType, HiddenAct, ModelSpec
from ..quants.types import FloatType


def permute_rotary(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF half-split -> interleaved rotary row order, per head."""
    d, n = w.shape
    hs = d // n_heads
    return (w.reshape(n_heads, 2, hs // 2, n)
             .swapaxes(1, 2)
             .reshape(d, n))


def spec_from_config(config: dict, weights_float_type: FloatType,
                     max_seq_len: int | None = None) -> ModelSpec:
    model_type = config.get("model_type", "llama")
    if model_type not in ("llama", "mistral", "mixtral"):
        raise ValueError(
            f"unsupported model_type '{model_type}' — this converter handles "
            "llama/mistral/mixtral (ref: converter/convert-hf.py:146-181)")
    scaling = config.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) not in (None, "default"):
        raise ValueError(
            f"rope_scaling {scaling!r} cannot be represented in the .m spec; "
            "converting would silently produce wrong rotary frequencies")
    n_experts = config.get("num_local_experts", 0) or 0
    arch = ArchType.MIXTRAL if n_experts > 0 else ArchType.LLAMA
    seq_len = config.get("max_position_embeddings", 2048)
    if max_seq_len:
        seq_len = min(seq_len, max_seq_len)
    act = config.get("hidden_act", "silu")
    return ModelSpec(
        arch=arch,
        dim=config["hidden_size"],
        hidden_dim=config["intermediate_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config.get("num_key_value_heads", config["num_attention_heads"]),
        vocab_size=config["vocab_size"],
        seq_len=seq_len,
        hidden_act=HiddenAct.GELU if act.startswith("gelu") else HiddenAct.SILU,
        rope_theta=float(config.get("rope_theta", 10000.0)),
        n_experts=n_experts,
        n_active_experts=config.get("num_experts_per_tok", 0) or 0,
        weights_float_type=weights_float_type,
        version=0,
    )


class SafetensorsIndex:
    """Lazy multi-file safetensors reader: name -> f32 numpy array."""

    def __init__(self, folder: str):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.folder = folder
        self.file_for: dict[str, str] = {}
        index_path = os.path.join(folder, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self.file_for[name] = os.path.join(folder, fname)
        else:
            for fname in sorted(os.listdir(folder)):
                if fname.endswith(".safetensors"):
                    path = os.path.join(folder, fname)
                    with safe_open(path, framework="np") as f:
                        for name in f.keys():
                            self.file_for[name] = path
        if not self.file_for:
            raise FileNotFoundError(f"no .safetensors files under {folder}")

    def __contains__(self, name: str) -> bool:
        return name in self.file_for

    def get(self, name: str) -> np.ndarray:
        import torch

        path = self.file_for[name]
        with self._safe_open(path, framework="pt") as f:
            t = f.get_tensor(name)  # torch handles bf16, np does not
        return t.to(torch.float32).numpy()


def _hf_name(plan_name: str, spec: ModelSpec) -> tuple[str, bool]:
    """Map our plan tensor name -> (HF tensor name, needs_rotary_permute)."""
    if plan_name == "tok_emb":
        return "model.embed_tokens.weight", False
    if plan_name == "rms_final":
        return "model.norm.weight", False
    if plan_name == "wcls":
        return "lm_head.weight", False
    assert plan_name.startswith("layers.")
    _, l, rest = plan_name.split(".", 2)
    p = f"model.layers.{l}."
    permute = spec.arch == ArchType.LLAMA
    table = {
        "wq": (p + "self_attn.q_proj.weight", permute),
        "wk": (p + "self_attn.k_proj.weight", permute),
        "wv": (p + "self_attn.v_proj.weight", False),
        "wo": (p + "self_attn.o_proj.weight", False),
        "w1": (p + "mlp.gate_proj.weight", False),
        "w2": (p + "mlp.down_proj.weight", False),
        "w3": (p + "mlp.up_proj.weight", False),
        "moe_router": (p + "block_sparse_moe.gate.weight", False),
        "rms_att": (p + "input_layernorm.weight", False),
        "rms_ffn": (p + "post_attention_layernorm.weight", False),
    }
    if rest in table:
        return table[rest]
    # experts.{e}.{up|gate|down} -> HF w3/w1/w2 (ref: convert-hf.py:67-74)
    _, e, role = rest.split(".")
    hf_w = {"up": "w3", "gate": "w1", "down": "w2"}[role]
    return p + f"block_sparse_moe.experts.{e}.{hf_w}.weight", False


def convert_hf(folder: str, out_path: str, weights_float_type: FloatType,
               max_seq_len: int | None = None, progress: bool = True) -> ModelSpec:
    with open(os.path.join(folder, "config.json")) as f:
        config = json.load(f)
    spec = spec_from_config(config, weights_float_type, max_seq_len)
    idx = SafetensorsIndex(folder)

    def fetch(plan_name: str, shape) -> np.ndarray:
        hf, permute = _hf_name(plan_name, spec)
        if hf == "lm_head.weight" and hf not in idx:
            hf = "model.embed_tokens.weight"  # tied embeddings
        x = idx.get(hf)
        if permute:
            n_heads = spec.n_heads if plan_name.endswith("wq") else spec.n_kv_heads
            x = permute_rotary(x, n_heads)
        assert x.shape == tuple(shape), (plan_name, x.shape, shape)
        return x

    t0 = time.time()
    with open(out_path, "wb") as f:
        write_header(f, spec)
        for name, shape, ftype in model_tensor_plan(spec):
            write_tensor(f, fetch(name, shape), ftype)
            if progress:
                print(f"🔶 {name} {tuple(shape)} -> {ftype.name} "
                      f"({time.time()-t0:.0f}s)", flush=True)
    return spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a HF llama/mistral/mixtral "
                                             "checkpoint folder to .m")
    ap.add_argument("folder")
    ap.add_argument("output")
    ap.add_argument("--weights-float-type", default="q40",
                    choices=["f32", "f16", "q40", "q80"])
    ap.add_argument("--max-seq-len", type=int, default=None)
    args = ap.parse_args(argv)
    spec = convert_hf(args.folder, args.output,
                      FloatType[args.weights_float_type.upper()],
                      args.max_seq_len)
    print(f"✅ wrote {args.output}: {spec.arch.name} dim={spec.dim} "
          f"layers={spec.n_layers}")


if __name__ == "__main__":
    main()
