"""Convert the JAX package's params tree into the port's params.

`params_from_jax(np_params, spec, device)` takes the tree that the JAX
package's models/params.load_params (or its streamed loader) builds, with
every leaf already brought to the host as numpy (for example by
`jax.tree_util.tree_map(np.asarray, params)`), and returns the port's
params dict on `device`. This is what lets the tests feed the same weights
to both packages. The port never imports the JAX package, so Q40 leaves are
recognised by shape, not by class: any object with `packed` and `scales`.

  * packed bytes go from the TPU lane order m = j*nb + b
    (distributed_llama_tpu/quants/jax_codec.py) to the port's block-major
    order b*16 + j (quants/torch_codec.py);
  * uint16 scales are f16 bit patterns and are read as float16; float32
    scales (hand-built tensors) are narrowed to float16;
  * bf16 leaves arrive as numpy's bfloat16 extension type and are moved
    bit for bit;
  * fused (wqkv, w13) and unfused layer dicts are both accepted, and kept
    as they are;
  * MoE leaves: the dense router as it is, each (E, d, m) expert stack
    converted row by row like a 2D weight (the lane order is per row), so
    it stays one stack.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .spec import ModelSpec


def _is_q40(leaf) -> bool:
    return hasattr(leaf, "packed") and hasattr(leaf, "scales")


def q40_from_lane_order(packed: np.ndarray, scales: np.ndarray,
                        device) -> QuantizedTensor:
    """(..., 16*nb) bytes in lane order m = j*nb + b -> the port's
    block-major (..., nb*16); scales to float16."""
    packed = np.asarray(packed, dtype=np.uint8)
    scales = np.asarray(scales)
    nb = scales.shape[-1]
    lead = packed.shape[:-1]
    blocks = packed.reshape(*lead, 16, nb).swapaxes(-1, -2)   # (..., nb, 16)
    pk = np.ascontiguousarray(blocks).reshape(*lead, nb * 16)
    if scales.dtype == np.uint16:
        sc = scales.view(np.float16).copy()
    else:
        sc = scales.astype(np.float16)
    return QuantizedTensor(torch.from_numpy(pk).to(device),
                           torch.from_numpy(sc).to(device))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy leaf as a torch tensor; bfloat16 (ml_dtypes) moves as bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf(x, device):
    if _is_q40(x):
        return q40_from_lane_order(x.packed, x.scales, device)
    return tensor_from_numpy(x, device)


def params_from_jax(np_params: dict, spec: ModelSpec, device=None) -> dict:
    """The JAX package's params tree (numpy leaves) -> the port's params on
    `device` (`cuda` unless told otherwise)."""
    device = resolve_device(device)
    if len(np_params["layers"]) != spec.n_layers:
        raise ValueError(f"params hold {len(np_params['layers'])} layers, "
                         f"spec says {spec.n_layers}")
    out = {k: _leaf(np_params[k], device)
           for k in ("tok_emb", "rms_final", "wcls")}
    out["layers"] = [{k: _leaf(v, device) for k, v in lw.items()}
                     for lw in np_params["layers"]]
    return out
