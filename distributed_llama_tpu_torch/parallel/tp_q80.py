"""The matmuls of a rank's shard — counterpart of the JAX package's
parallel/tp_q80.py (tp_row_matmul :99, tp_col_matmul :228, and
tp_flash_attention :135).

In the JAX package these run the Pallas kernels per shard inside
shard_map. Here each rank holds its shard already (parallel/sharding.py),
so each is the local kernel call on it:

  row shard      K1 (or K2 for an expert stack) on the rank's output rows,
                 the output left split, no collective (JAX tp_row_matmul):
                 ops/matmul.py unwraps a TpRowWeight and calls
                 local_matmul on it;
  tp_col_matmul  K1 (or K2) on the rank's input columns: a partial sum,
                 then the exact all-reduce or the Q80 two-shot reduce over
                 tp (parallel/collectives.py).

Attention needs no function of its own: a rank's q, k and v come out of
its row shards with its own H/tp and KVH/tp heads, its cache holds those
kv heads, and K3 runs on them with no collective (models/transformer.py).

The Q80 activation round trip commutes with a block-aligned slice: a
column shard's input is the rank's slice of the whole input, whose round
trip is the slice of the whole round trip. So the fused t = 1 path inside
K1 (cuda_q40.fuses_q80) stays on at the shard shapes.
"""

from __future__ import annotations

import torch

from ..ops.matmul import fused_expert_matmul, local_matmul
from .collectives import reduce_partials
from .mesh import Mesh
from .wrappers import TpColWeight


def tp_col_matmul(x: torch.Tensor, w: TpColWeight, mesh: Mesh, *,
                  compute_dtype, activation_q80: bool = False,
                  reduce: str = "exact") -> torch.Tensor:
    """y[..., d] = sum over ranks of x_local @ W_cols^T: x is the rank's
    slice of the input (the row-split producer's output), the partial
    sums reduced over tp, "exact" or "q80"."""
    partial = local_matmul(x, w.w, compute_dtype=compute_dtype,
                           activation_q80=activation_q80)
    return reduce_partials(partial, mesh, reduce)


def tp_expert_matmul(x: torch.Tensor, w, idx: torch.Tensor, mesh: Mesh | None,
                     *, compute_dtype, activation_q80: bool = False,
                     reduce: str = "exact") -> torch.Tensor:
    """The MoE decode step's product against the active experts of a
    sharded (E, d, n) stack: K2 on the rank's row shard (moe_up/moe_gate,
    output split) or column shard (moe_down, every expert's partial sums
    reduced over tp at once, as the JAX package reduces each)."""
    out = fused_expert_matmul(x, w.w, idx, compute_dtype=compute_dtype,
                              activation_q80=activation_q80)
    if isinstance(w, TpColWeight):
        return reduce_partials(out, mesh, reduce)
    return out
