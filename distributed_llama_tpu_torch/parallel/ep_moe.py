"""Expert parallelism: the MoE experts placed over the mesh's ep axis —
counterpart of the JAX package's parallel/ep_moe.py (repack_moe_ep :59,
ep_moe_ffn :113 and its body _ep_body :154).

The JAX package runs the body inside shard_map; here each rank is a
process holding its E/ep local experts already (parallel/sharding.py
place_moe), each cut to its tp rows (moe_up, moe_gate) or columns
(moe_down), and the body is the rank's own computation:

    for each local expert le (E/ep of them, ascending):
        w_e  = routing_weights[..., ep_index * E/ep + le]   # 0 if inactive
        hb   = act(x @ gate_le^T) * (x @ up_le^T)           # hidden/tp
        acc += w_e * (hb @ down_le^T)                       # partial sums
    out = sum of acc over (ep, tp)

Every local expert is computed densely for every token, decode included,
and masked by the scattered routing weights (JAX transformer.py:293-331):
a rank's cost is E/ep experts whatever the top-k. Each expert product is
K1 (ops/cuda_q40.py) on the local expert's slice, WITHOUT the Q80
activation round trip: the JAX body calls local_matmul with no
activation_q80, so the port does too (on the card, K1's t = 1 GEMV
without its fused q80_store). `acc` is kept in the compute dtype, as the
JAX body's is. The one reduce: the exact sum over the joint (ep, tp)
group, or with `reduce == "q80"` the Q80 two-shot over tp and then the
exact sum over ep (JAX :185-190).
"""

from __future__ import annotations

import torch

from ..ops.matmul import local_matmul
from ..quants.torch_codec import take_expert
from .collectives import all_reduce, q80_psum_2shot
from .mesh import EP_AXIS, EP_TP, TP_AXIS, Mesh


def ep_moe_ffn(xb: torch.Tensor, e_weights: torch.Tensor, lw: dict,
               mesh: Mesh, *, act_fn, compute_dtype,
               reduce: str = "exact") -> torch.Tensor:
    """The expert-parallel MoE FFN of this rank: xb (B, T, dim) post-norm
    activations, e_weights (B, T, E) the normalized routing weights (0 for
    an inactive expert); returns (B, T, dim) in compute_dtype, the same on
    every rank of the (ep, tp) group."""
    up, gate, down = lw["moe_up"].w, lw["moe_gate"].w, lw["moe_down"].w
    e_local = up.shape[0]
    g0 = mesh.ep_rank * e_local
    acc = torch.zeros((*xb.shape[:-1], down.shape[-2]), dtype=compute_dtype,
                      device=xb.device)
    for le in range(e_local):
        w_e = e_weights[..., g0 + le, None]
        g = local_matmul(xb, take_expert(gate, le), compute_dtype=compute_dtype)
        u = local_matmul(xb, take_expert(up, le), compute_dtype=compute_dtype)
        out = local_matmul(act_fn(g) * u, take_expert(down, le),
                           compute_dtype=compute_dtype)
        acc = acc + w_e.to(out.dtype) * out
    if reduce == "q80" and mesh.tp > 1:
        return all_reduce(q80_psum_2shot(acc, mesh, TP_AXIS), mesh, EP_AXIS)
    if reduce not in ("exact", "q80"):
        raise ValueError(f"reduce must be exact or q80, got {reduce!r}")
    return all_reduce(acc, mesh, EP_TP)
