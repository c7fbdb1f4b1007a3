"""Device resolution shared by every entry point of the package.

``device=None`` means the CUDA card.  A caller that wants the CPU says
so with ``device="cpu"``: without a CUDA device, an entry point called
without it raises instead of carrying on quietly on the host.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch

__all__ = ["resolve_device", "check_f32_matmul", "card_line", "thread_card",
           "bind_thread", "bound", "device_context"]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point places its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def thread_card(device=None) -> torch.device | None:
    """The card, with its index, that worker threads of an entry point on
    ``device`` (None means ``cuda``) make current: the index is read on
    the calling thread when ``device`` names none.  None when the entry
    point runs on the CPU, or no card exists: such threads launch
    nothing on a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def bind_thread(card: torch.device | None) -> None:
    """Make ``card`` current on the calling thread (a thread's first CUDA
    call otherwise runs with no current context, and on a host with
    several cards lands on card 0).  A no-op for None."""
    if card is not None:
        torch.cuda.set_device(card)


def bound(target, card: torch.device | None):
    """``target`` as a thread's entry point that first makes ``card``
    current (``bind_thread``)."""
    def run(*args, **kwargs):
        bind_thread(card)
        return target(*args, **kwargs)
    return run


def device_context(device: torch.device | None):
    """The context that work for ``device`` runs in: its card made
    current, so that the work queues on it; nothing for the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
