"""Device resolution for the port's entry points.

The port runs on the card. The CPU is used only when a caller names it
(the CPU tests do, ``--device cpu`` on the CLI); a missing CUDA device
is an error, never a silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or a CUDA name -> that CUDA device, raising when
    ``torch.cuda.is_available()`` is false; ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU explicitly")
    return dev
