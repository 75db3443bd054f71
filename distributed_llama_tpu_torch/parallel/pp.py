"""Pipeline parallelism: the layers placed in stages over the mesh's pp
axis — counterpart of the JAX package's parallel/pp.py (pp_layers :256,
gpipe_microbatches :292, pp_layers_gpipe :308).

Stage p holds layers [p*L/pp, (p+1)*L/pp) and their cache only
(parallel/sharding.py picks them: the JAX stack_stages has no counterpart
here). A forward's layers run over the stages in M sequence microbatches
(`pp_layers_gpipe`), M chosen per segment as the JAX forward chooses it
(`forward`):

  M = 1   decode and segments shorter than 32*pp tokens (or GPipe off):
          stage p receives x from stage p-1 (stage 0 starts from the
          embedding), runs its layers and sends the result on. It is the
          one-process-a-rank form of the JAX all-stages scheme (pp_layers),
          where every device computes every stage and a write gate keeps
          the live stage's cache writes: the same layers in the same
          order, one stage busy at a time.
  M > 1   longer segments (JAX gpipe_microbatches, copied), the JAX GPipe
          schedule: at step t stage p runs microbatch t - p, which in one
          process a stage is stage p taking microbatches 0..M-1 in order
          as they arrive from p-1 and sending each on. A stage finishes
          microbatch m's cache writes before it runs microbatch m + 1,
          whose attention reads them.

Either way the last stage's x is broadcast over pp at the end, because
every stage then computes the head (the vocab can be split over (pp, tp):
ops/sharded_vocab.py). The output is exact: the JAX psum adds zeros to the
one live value, the broadcast copies it.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import broadcast, recv, send
from .mesh import PP_AXIS, Mesh


def gpipe_microbatches(t: int, pp: int) -> int:
    """Microbatch count for a T-token segment: 1 means "use the all-stages
    scheme". GPipe engages only for flop-bound segments (>= 32 tokens per
    stage — decode and speculative verify stay all-stages, they are
    weight-read-bound and rotation would re-read weights); M is the
    largest divisor of T in [pp, 4*pp] capped at T/32, trading bubble
    fraction (M+pp-1)/M against per-microbatch weight re-reads."""
    if pp <= 1 or t < 32 * pp:
        return 1
    for m in range(min(4 * pp, t // 32), pp - 1, -1):
        if t % m == 0:
            return m
    return 1


# stage(x, q_pos): this rank's layers over x (B, T, dim) at positions
# q_pos (B, T), writing their cache; returns the layers' output
Stage = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def forward(x: torch.Tensor, q_pos: torch.Tensor, stage: Stage, mesh: Mesh,
            gpipe: bool = True) -> torch.Tensor:
    """Every layer of the model over the stages: GPipe for a long segment
    (with `gpipe`), one microbatch otherwise. x: the embedded segment (on
    every rank); returns the last layer's output on every rank."""
    m = gpipe_microbatches(x.shape[1], mesh.pp) if gpipe else 1
    return pp_layers_gpipe(x, q_pos, stage, mesh, m)


def _ends(mesh: Mesh) -> tuple[int | None, int | None]:
    """The global ranks of the previous and the next stage (None at the
    ends of the pipeline)."""
    p, n = mesh.pp_rank, mesh.pp
    return (mesh.neighbour(PP_AXIS, -1) if p > 0 else None,
            mesh.neighbour(PP_AXIS, 1) if p < n - 1 else None)


def pp_layers_gpipe(x: torch.Tensor, q_pos: torch.Tensor, stage: Stage,
                    mesh: Mesh, n_mb: int) -> torch.Tensor:
    """GPipe over n_mb sequence microbatches (n_mb divides T): each stage
    runs microbatch m once m has arrived from the previous stage and sends
    its output on while it runs m + 1; the last stage's output, the whole
    (B, T, dim), is broadcast over pp."""
    t = x.shape[1]
    if n_mb < 1 or t % n_mb:
        raise ValueError(f"{n_mb} microbatches do not split {t} tokens")
    t_mb = t // n_mb
    prv, nxt = _ends(mesh)
    ys = []
    sent = None
    for mb in range(n_mb):
        cols = slice(mb * t_mb, (mb + 1) * t_mb)
        inp = x[:, cols].contiguous()
        if prv is not None:
            inp = recv(inp, mesh, prv)
        y = stage(inp, q_pos[:, cols])
        if nxt is None:
            ys.append(y)
            continue
        if sent is not None:
            sent.wait()
        sent = send(y, mesh, nxt)
    # the other stages pass x, whose values the broadcast never reads
    out = x if nxt is not None else ys[0] if n_mb == 1 else torch.cat(ys, 1)
    out = broadcast(out, mesh, PP_AXIS, mesh.pp - 1)
    if sent is not None:
        sent.wait()
    return out
