"""Meta Llama checkpoint (consolidated.*.pth) -> reference-format `.m`.

Equivalent of the reference Meta converter (ref: converter/convert-llama.py):
the N checkpoint shards are Meta's column/row-parallel splits, re-concatenated
per tensor role — axis 1 for tok_embeddings / wo / w2, axis 0 otherwise
(ref: convert-llama.py:73-90). hidden_dim is derived from w1's shard shape x
n_shards (ref: convert-llama.py:64-66). No rotary permutation: Meta's layout
is already the interleaved form rope_llama expects.

Tensors are streamed chunk-by-chunk so peak host memory stays bounded
(ref: convert-llama.py:49-67 chunks for the same reason).

Usage:
  python -m distributed_llama_tpu_torch.converters.meta_llama <dir> out.m \
      --weights-float-type q40 [--seq-len 4096]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from ..io.model_file import model_tensor_plan, write_header, write_tensor
from ..models.spec import ArchType, HiddenAct, ModelSpec
from ..quants.types import FloatType

# our plan name -> (meta name pattern, concat axis)
_AXIS1 = {"tok_emb", "wo", "w2"}
_META = {
    "tok_emb": "tok_embeddings.weight",
    "wq": "layers.{l}.attention.wq.weight",
    "wk": "layers.{l}.attention.wk.weight",
    "wv": "layers.{l}.attention.wv.weight",
    "wo": "layers.{l}.attention.wo.weight",
    "w1": "layers.{l}.feed_forward.w1.weight",
    "w2": "layers.{l}.feed_forward.w2.weight",
    "w3": "layers.{l}.feed_forward.w3.weight",
    "rms_att": "layers.{l}.attention_norm.weight",
    "rms_ffn": "layers.{l}.ffn_norm.weight",
    "rms_final": "norm.weight",
    "wcls": "output.weight",
}


def _meta_name(plan_name: str) -> str:
    if plan_name.startswith("layers."):
        _, l, rest = plan_name.split(".", 2)
        return _META[rest].format(l=l)
    return _META[plan_name]


def convert_meta(folder: str, out_path: str, weights_float_type: FloatType,
                 seq_len: int | None = None, progress: bool = True) -> ModelSpec:
    """seq_len=None reads max_seq_len from params.json (the reference
    converter requires and uses it — ref: convert-llama.py:59-62), falling
    back to 2048 for checkpoints that omit it; pass a value to override."""
    import torch

    with open(os.path.join(folder, "params.json")) as f:
        params = json.load(f)
    if seq_len is None:
        seq_len = int(params.get("max_seq_len", 2048))

    shard_paths = sorted(Path(folder).glob("consolidated.*.pth"))
    if not shard_paths:
        raise FileNotFoundError(f"no consolidated.*.pth under {folder}")
    shards = [torch.load(p, map_location="cpu", mmap=True) for p in shard_paths]

    def fetch(plan_name: str) -> np.ndarray:
        meta = _meta_name(plan_name)
        parts = [s[meta] for s in shards]
        if len(parts) == 1 or parts[0].dim() == 1:
            t = parts[0]
        else:
            base = plan_name.split(".")[-1]
            t = torch.cat(parts, dim=1 if base in _AXIS1 else 0)
        return t.to(torch.float32).numpy()

    n_heads = params["n_heads"]
    hidden_dim = shards[0]["layers.0.feed_forward.w1.weight"].shape[0] * len(shards)
    vocab_size = params.get("vocab_size", -1)
    if vocab_size <= 0:
        # tok_embeddings shards are column-split (axis 1 = dim), so the vocab
        # dimension is shape[0] regardless of shard count
        vocab_size = shards[0]["tok_embeddings.weight"].shape[0]

    spec = ModelSpec(
        arch=ArchType.LLAMA,
        dim=params["dim"],
        hidden_dim=hidden_dim,
        n_layers=params["n_layers"],
        n_heads=n_heads,
        n_kv_heads=params.get("n_kv_heads", n_heads),
        vocab_size=vocab_size,
        seq_len=seq_len,
        hidden_act=HiddenAct.SILU,
        rope_theta=float(params.get("rope_theta", 10000.0)),
        weights_float_type=weights_float_type,
    )

    with open(out_path, "wb") as f:
        write_header(f, spec)
        for name, shape, ftype in model_tensor_plan(spec):
            x = fetch(name)
            assert x.shape == tuple(shape), (name, x.shape, shape)
            write_tensor(f, x, ftype)
            if progress:
                print(f"🔶 {name} {tuple(shape)} -> {ftype.name}", flush=True)
    return spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a Meta llama checkpoint "
                                             "folder to .m")
    ap.add_argument("folder")
    ap.add_argument("output")
    ap.add_argument("--weights-float-type", default="q40",
                    choices=["f32", "f16", "q40", "q80"])
    ap.add_argument("--seq-len", type=int, default=None,
                    help="context length written to the header (default: "
                         "params.json max_seq_len, else 2048)")
    args = ap.parse_args(argv)
    spec = convert_meta(args.folder, args.output,
                        FloatType[args.weights_float_type.upper()], args.seq_len)
    print(f"✅ wrote {args.output}: {spec.arch.name} dim={spec.dim} "
          f"layers={spec.n_layers}")


if __name__ == "__main__":
    main()
