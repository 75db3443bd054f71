"""The weight markers of a rank's shard — counterpart of the JAX package's
parallel/wrappers.py and the TpRowWeight / TpColWeight classes of
parallel/tp_q80.py.

A marker holds this rank's shard of one matmul weight (a dense tensor or
a QuantizedTensor), and its type says how the product over the ranks is
made, so ops/matmul.py dispatches on it as the JAX matmul does
(ops/matmul.py:99-124):

  TpRowWeight  output rows [k*d/tp, (k+1)*d/tp) (the reference's
               RowMatmulSlice): the local product is the rank's slice of
               the output, no collective;
  TpColWeight  input columns [k*n/tp, (k+1)*n/tp) (ColMatmulSlice): the
               local product is a partial sum, reduced over tp.

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
