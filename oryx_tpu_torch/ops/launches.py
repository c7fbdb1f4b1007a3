"""The launch counts of the hand-written kernels, by wrapper.

Each wrapper (``ops/phase_a*.py``) adds one to its ``LAUNCHES`` where it
launches its kernel, and nowhere else.  ``counts`` reads them all; the
kernel router and the operator CLI log them, so that a layer run in a
process of its own shows which kernels served it.
"""

from __future__ import annotations

__all__ = ["counts"]


def counts() -> dict[str, int]:
    """Every wrapper's launches since its process started."""
    from . import phase_a, phase_a_fold, phase_a_i8, phase_a_i8_fold
    from . import phase_a_qm
    return {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
            for mod in (phase_a, phase_a_fold, phase_a_i8, phase_a_i8_fold,
                        phase_a_qm)}
