"""Device resolution shared by every entry point of the package.

``device=None`` means the CUDA card.  A caller that wants the CPU says
so with ``device="cpu"``: without a CUDA device, an entry point called
without it raises instead of carrying on quietly on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point places its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
