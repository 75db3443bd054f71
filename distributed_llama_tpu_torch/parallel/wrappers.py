"""The weight markers of a rank's shard — counterpart of the JAX package's
parallel/wrappers.py, the TpRowWeight / TpColWeight classes of
parallel/tp_q80.py and the EpRowWeight / EpColWeight classes of
parallel/ep_moe.py.

A marker holds this rank's shard of one matmul weight (a dense tensor or
a QuantizedTensor), and its type says how the product over the ranks is
made, so ops/matmul.py dispatches on it as the JAX matmul does
(ops/matmul.py:99-124):

  TpRowWeight  output rows [k*d/tp, (k+1)*d/tp) (the reference's
               RowMatmulSlice): the local product is the rank's slice of
               the output, no collective;
  TpColWeight  input columns [k*n/tp, (k+1)*n/tp) (ColMatmulSlice): the
               local product is a partial sum, reduced over tp;
  EpRowWeight  a MoE row stack (moe_up, moe_gate) placed over ep: this
               rank's E/ep experts, each cut to its tp output rows;
  EpColWeight  the MoE column stack (moe_down) placed over ep: this rank's
               E/ep experts, each cut to its tp input columns (the JAX
               repack_moe_ep's tp restack, which the port's block-major
               Q40 layout needs no relayout for: parallel/sharding.py).
               parallel/ep_moe.py reduces the experts' partial sums over
               (ep, tp) at once.

No pytree registration: the port's params are plain dicts.
"""

from __future__ import annotations

import dataclasses

from ..quants.torch_codec import QuantizedTensor


class WeightWrapper:
    """Base of the one-field weight markers."""

    w: object

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.w.shape)


@dataclasses.dataclass
class TpRowWeight(WeightWrapper):
    """This rank's output rows of a row-split weight."""

    w: QuantizedTensor | object


@dataclasses.dataclass
class TpColWeight(WeightWrapper):
    """This rank's input columns of a column-split weight."""

    w: QuantizedTensor | object


@dataclasses.dataclass
class EpRowWeight(WeightWrapper):
    """This rank's local experts of a MoE row stack, tp rows each."""

    w: QuantizedTensor | object


@dataclasses.dataclass
class EpColWeight(WeightWrapper):
    """This rank's local experts of a MoE column stack, tp columns each."""

    w: QuantizedTensor | object
