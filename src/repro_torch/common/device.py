"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller names the CPU;
there is no automatic fallback, so a run that asked for the card and
found none fails loudly instead of carrying on on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a usable card
    raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "to run on the host")
    return dev
