"""Device policy: every entry point runs on the card unless told otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a visible card raises:
    there is no silent fallback to the CPU, which callers must ask for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev
