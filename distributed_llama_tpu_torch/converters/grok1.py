"""Grok-1 (keyfan/grok-1-hf torch dump) -> reference-format `.m`.

Equivalent of the reference Grok converter (ref: converter/convert-grok-1.py):
hardcoded 64-layer / 8-expert / top-2 spec (ref: convert-grok-1.py:59-70), the
19-file `pytorch_model-000NN-of-00019.bin` walk with one file resident at a
time, and the tensor-name mapping:

  transformer.in_out_embed.weight                      -> tok_emb
  ...decoder_layer.{l}.multi_head_attention.query/key/value/linear -> wq/wk/wv/wo
  ...decoder_layer.{l}.router.weight                   -> moe_router
  ...decoder_layer.{l}.moe.{e}.linear_v/linear/linear_1 -> expert up/gate/down
  ...decoder_layer.{l}.rms_norm{,_1,_2,_3}             -> rms_att/rms_ffn/rms_moe/rms_ffn2
  transformer.rms_norm.weight                          -> rms_final
  lm_head.weight                                       -> wcls

Usage:
  python -m distributed_llama_tpu_torch.converters.grok1 <dir> out.m --weights-float-type q40
"""

from __future__ import annotations

import argparse
import gc
import os

import numpy as np

from ..io.model_file import model_tensor_plan, write_header, write_tensor
from ..models.spec import ArchType, HiddenAct, ModelSpec
from ..quants.types import FloatType

GROK1_SPEC = dict(
    arch=ArchType.GROK1, dim=6144, hidden_dim=32768, n_layers=64, n_heads=48,
    n_kv_heads=8, n_experts=8, n_active_experts=2, vocab_size=131072,
    seq_len=8192, hidden_act=HiddenAct.GELU, rope_theta=10000.0,
)
N_FILES = 19


def _grok_name(plan_name: str) -> str:
    if plan_name == "tok_emb":
        return "transformer.in_out_embed.weight"
    if plan_name == "rms_final":
        return "transformer.rms_norm.weight"
    if plan_name == "wcls":
        return "lm_head.weight"
    _, l, rest = plan_name.split(".", 2)
    p = f"transformer.decoder_layer.{l}."
    table = {
        "wq": p + "multi_head_attention.query.weight",
        "wk": p + "multi_head_attention.key.weight",
        "wv": p + "multi_head_attention.value.weight",
        "wo": p + "multi_head_attention.linear.weight",
        "moe_router": p + "router.weight",
        "rms_att": p + "rms_norm.weight",
        "rms_ffn": p + "rms_norm_1.weight",
        "rms_moe": p + "rms_norm_2.weight",
        "rms_ffn2": p + "rms_norm_3.weight",
    }
    if rest in table:
        return table[rest]
    _, e, role = rest.split(".")
    suffix = {"up": "linear_v", "gate": "linear", "down": "linear_1"}[role]
    return p + f"moe.{e}.{suffix}.weight"


class _ShardWalker:
    """One torch shard resident at a time, with a name->file index built
    lazily (ref: convert-grok-1.py:20-52)."""

    def __init__(self, folder: str, n_files: int = N_FILES):
        self.folder = folder
        self.n_files = n_files
        self.index: dict[str, int] = {}
        self.current: dict | None = None
        self.current_idx = 0

    def _load(self, idx: int) -> None:
        import torch

        if self.current_idx == idx and self.current is not None:
            return
        self.current = None
        # memory relief between checkpoint shards — but respect a process
        # that disabled cyclic GC (refcounting already frees the dropped
        # shard's tensors)
        if gc.isenabled():
            gc.collect()
        path = os.path.join(
            self.folder, f"pytorch_model-{idx:05d}-of-{self.n_files:05d}.bin")
        print(f"💿 loading {os.path.basename(path)}", flush=True)
        self.current = torch.load(path, map_location="cpu")
        for k in self.current:
            self.index[k] = idx
        self.current_idx = idx

    def get(self, name: str) -> np.ndarray:
        import torch

        if self.current is None:
            self._load(1)
        while name not in self.current:
            if name in self.index:
                self._load(self.index[name])
            elif self.current_idx < self.n_files:
                self._load(self.current_idx + 1)
            else:
                raise KeyError(name)
        return self.current[name].to(torch.float32).numpy()


def convert_grok1(folder: str, out_path: str, weights_float_type: FloatType,
                  progress: bool = True, spec: ModelSpec | None = None,
                  n_files: int = N_FILES) -> ModelSpec:
    """spec/n_files default to the production Grok-1 dump (ref:
    convert-grok-1.py:59-70); overridable for shrunken test checkpoints."""
    if spec is None:
        spec = ModelSpec(weights_float_type=weights_float_type, **GROK1_SPEC)
    walker = _ShardWalker(folder, n_files)
    with open(out_path, "wb") as f:
        write_header(f, spec)
        for name, shape, ftype in model_tensor_plan(spec):
            x = walker.get(_grok_name(name))
            assert x.shape == tuple(shape), (name, x.shape, shape)
            write_tensor(f, x, ftype)
            if progress:
                print(f"🔶 {name} {tuple(shape)} -> {ftype.name}", flush=True)
    return spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a Grok-1 torch dump to .m")
    ap.add_argument("folder")
    ap.add_argument("output")
    ap.add_argument("--weights-float-type", default="q40",
                    choices=["f32", "f16", "q40", "q80"])
    args = ap.parse_args(argv)
    spec = convert_grok1(args.folder, args.output,
                         FloatType[args.weights_float_type.upper()])
    print(f"✅ wrote {args.output}: {spec.arch.name} dim={spec.dim} "
          f"layers={spec.n_layers}")


if __name__ == "__main__":
    main()
