"""Tiny fixture model/tokenizer writers shared by tests and examples.

One place for the end-to-end fixture the suite uses everywhere: a small
random-weight Llama spec written to a real `.m` file plus a llama2.c-style
byte-fallback tokenizer `.t` (vocab 288 = 3 specials + 256 byte tokens +
fillers; byte b maps to token b+3), so CLI/API/cluster paths exercise the
same file formats the reference consumes. A copy of the JAX package's
testing module: the same seed writes the same bytes in both packages.
"""

from __future__ import annotations

import struct

import numpy as np

from .io import (TokenizerData, model_tensor_plan, write_model,
                 write_tokenizer_file)
from .io.model_file import read_spec
from .models import ArchType, HiddenAct, ModelSpec
from .quants import FloatType


def tiny_spec(weights_float_type: FloatType = FloatType.Q40,
              **overrides) -> ModelSpec:
    base = dict(
        arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
        n_kv_heads=2, vocab_size=288, seq_len=160, hidden_act=HiddenAct.SILU,
        weights_float_type=weights_float_type)
    base.update(overrides)
    return ModelSpec(**base)


def byte_fallback_vocab(vocab_size: int) -> list[bytes]:
    vocab = [b"<unk>", b"<s>", b"</s>"]
    vocab += [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [f"<fill{i}>".encode() for i in range(len(vocab), vocab_size)]
    return vocab


def write_fixture(dirpath, seed: int = 77, rng=None,
                  spec: ModelSpec | None = None,
                  **spec_overrides) -> tuple[str, str]:
    """Write model.m + tok.t under dirpath; returns their paths.

    Weights are `rng.standard_normal * 0.05` from `rng` (or a fresh
    default_rng(seed)) in plan order — tests that pin golden outputs must
    keep their seed/spec stable.
    """
    if spec is None:
        spec = tiny_spec(**spec_overrides)
    if rng is None:
        rng = np.random.default_rng(seed)
    tensors = {name: rng.standard_normal(shape).astype(np.float32) * 0.05
               for name, shape, _ in model_tensor_plan(spec)}
    mpath = f"{dirpath}/model.m"
    write_model(mpath, spec, tensors)
    tpath = f"{dirpath}/tok.t"
    write_tokenizer_file(tpath, TokenizerData(
        vocab=byte_fallback_vocab(spec.vocab_size),
        scores=[0.0] * spec.vocab_size, bos_id=1, eos_id=2))
    return mpath, tpath


def write_legacy_copy(mpath: str, out: str) -> str:
    """Copy a KV-header `.m` (a LLAMA or GROK1 file) to `out` with its
    header replaced by the reference's legacy 9-int header (magic = the
    arch type, ref: src/transformer.cpp:198). A legacy header stores no
    weight type and no rope theta (10000 is read back), so a Q40 copy
    loads only with --weights-float-type q40. Returns `out`."""
    spec = read_spec(mpath)
    with open(mpath, "rb") as f:
        f.seek(4)
        header_size = struct.unpack("<i", f.read(4))[0]
        f.seek(header_size)
        body = f.read()
    with open(out, "wb") as f:
        f.write(struct.pack("<10i", int(spec.arch), spec.dim, spec.hidden_dim,
                            spec.n_layers, spec.n_heads, spec.n_kv_heads,
                            spec.n_experts, spec.n_active_experts,
                            spec.vocab_size, spec.seq_len))
        f.write(body)
    return out
