"""Device resolution for the port's entry points.

The port runs on the card. ``resolve_device(None)`` is ``cuda`` and
raises when no CUDA device is present; the CPU is used only when the
caller names it (the tests do), never as a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the CUDA device (raises without one); anything else is
    taken as given, and a CUDA request still needs a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
