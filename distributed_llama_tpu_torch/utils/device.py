"""Device choice shared by every entry point of the port.

The port runs on `cuda` unless the caller asks for the CPU: with no card
present, asking for the default raises instead of running elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless told otherwise; a CUDA device without a card raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "device='cpu' is asked for explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
