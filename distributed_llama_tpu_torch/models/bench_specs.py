"""The bench's model table: the JAX package's bench.py:101-145 specs, field
for field, as the port's tools, chip_smoke.py and (later) the port's bench
use them. Weights for each come from models/params.synthetic_q40_params.

  LLAMA2_7B         Llama-2-7B, full width and depth
  LLAMA2_13B        Llama-2-13B, full width and depth
  LLAMA3_8B         Llama-3-8B (GQA 32/8, 128k vocab), full width and depth
  MIXTRAL_MOE       Mixtral 8x7B widths, 4 of its 32 layers
  LLAMA2_70B_TRUNC  Llama-2-70B widths (GQA 64/8), 4 of its 80 layers
  GROK1_TRUNC       Grok-1 widths (8 experts, GELU, 131k vocab), 2 of 64 layers
  TINY              a small Llama for the CPU tests
"""

from __future__ import annotations

from .spec import ArchType, HiddenAct, ModelSpec

LLAMA2_7B = ModelSpec(
    arch=ArchType.LLAMA, dim=4096, hidden_dim=11008, n_layers=32,
    n_heads=32, n_kv_heads=32, vocab_size=32000, seq_len=2048,
    hidden_act=HiddenAct.SILU)

LLAMA2_13B = ModelSpec(
    arch=ArchType.LLAMA, dim=5120, hidden_dim=13824, n_layers=40,
    n_heads=40, n_kv_heads=40, vocab_size=32000, seq_len=2048,
    hidden_act=HiddenAct.SILU)

LLAMA3_8B = ModelSpec(
    arch=ArchType.LLAMA, dim=4096, hidden_dim=14336, n_layers=32,
    n_heads=32, n_kv_heads=8, vocab_size=128256, seq_len=2048,
    hidden_act=HiddenAct.SILU, rope_theta=500000.0)

TINY = ModelSpec(
    arch=ArchType.LLAMA, dim=256, hidden_dim=704, n_layers=4,
    n_heads=8, n_kv_heads=8, vocab_size=512, seq_len=256,
    hidden_act=HiddenAct.SILU)

MIXTRAL_MOE = ModelSpec(
    arch=ArchType.MIXTRAL, dim=4096, hidden_dim=14336, n_layers=4,
    n_heads=32, n_kv_heads=8, vocab_size=32000, seq_len=2048,
    hidden_act=HiddenAct.SILU, rope_theta=1000000.0,
    n_experts=8, n_active_experts=2)

LLAMA2_70B_TRUNC = ModelSpec(
    arch=ArchType.LLAMA, dim=8192, hidden_dim=28672, n_layers=4,
    n_heads=64, n_kv_heads=8, vocab_size=32000, seq_len=2048,
    hidden_act=HiddenAct.SILU)

GROK1_TRUNC = ModelSpec(
    arch=ArchType.GROK1, dim=6144, hidden_dim=32768, n_layers=2,
    n_heads=48, n_kv_heads=8, vocab_size=131072, seq_len=2048,
    hidden_act=HiddenAct.GELU, rope_theta=10000.0,
    n_experts=8, n_active_experts=2)

BENCH_SPECS = {
    "LLAMA2_7B": LLAMA2_7B, "LLAMA2_13B": LLAMA2_13B, "LLAMA3_8B": LLAMA3_8B,
    "MIXTRAL_MOE": MIXTRAL_MOE, "GROK1_TRUNC": GROK1_TRUNC,
    "LLAMA2_70B_TRUNC": LLAMA2_70B_TRUNC, "TINY": TINY,
}
