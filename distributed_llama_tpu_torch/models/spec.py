"""Model hyperparameter spec.

Analogue of TransformerSpec (ref: src/transformer.hpp:82-104); a copy of the
JAX package's models/spec.py.
Values and enum encodings are file-compatible with the reference `.m` header
(ref: src/transformer.hpp:42-80).
"""

from __future__ import annotations

import dataclasses
import enum

from ..quants.types import FloatType


class ArchType(enum.IntEnum):
    """ref: src/transformer.hpp:71-75 (values double as legacy file magics)."""

    LLAMA = 0xABCD00
    GROK1 = 0xABCD01
    MIXTRAL = 0xABCD02


class HiddenAct(enum.IntEnum):
    """ref: src/transformer.hpp:77-80."""

    GELU = 0
    SILU = 1


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    arch: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    n_experts: int = 0
    n_active_experts: int = 0
    weights_float_type: FloatType = FloatType.F32
    version: int = 0

    @property
    def head_size(self) -> int:
        # ref: src/transformer.cpp:248
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        # ref: src/transformer.cpp:249
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def validate(self) -> None:
        assert self.dim % self.n_heads == 0
        assert (self.dim * self.n_kv_heads) % self.n_heads == 0
        if self.arch in (ArchType.GROK1, ArchType.MIXTRAL):
            # MoE archs without experts would fail deep inside the forward
            # (missing moe_router); reject at spec level instead
            assert self.is_moe, f"{self.arch.name} requires n_experts > 0"
        if self.is_moe:
            assert 0 < self.n_active_experts <= self.n_experts
