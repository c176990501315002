"""Device selection for the port's entry points.

The card is the default: ``device=None`` means ``cuda``.  Without a card
the entry points raise instead of carrying on on the CPU unasked; the
caller passes ``device="cpu"`` to run the plain PyTorch versions there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; any CUDA device needs a visible card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fmda_tpu_torch runs on a CUDA card by default and none is "
            "visible; pass device='cpu' to run the plain PyTorch path on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
