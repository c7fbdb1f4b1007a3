"""Device resolution shared by every entry point of the package.

``device=None`` means the CUDA card.  A caller that wants the CPU says
so with ``device="cpu"``: without a CUDA device, an entry point called
without it raises instead of carrying on quietly on the host.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "check_f32_matmul", "card_line"]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point places its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def check_f32_matmul(device: torch.device) -> None:
    """Refuse to score on a CUDA device while TF32 matmuls are allowed:
    the scoring products and the fold-in solves need full float32 (the
    two-phase certificate's 1e-4 margin does not cover TF32 rounding)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: ALS scoring needs "
            "full float32 products (the two-phase certificate's 1e-4 margin "
            "does not cover TF32 rounding)")


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (None without
    one): the label every bench artifact records beside its numbers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None
