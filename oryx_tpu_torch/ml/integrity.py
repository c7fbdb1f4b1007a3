"""Model-integrity primitives: the numerical trust boundary of the
update path.

Counterpart of ``oryx_tpu/ml/integrity.py``.  A model that arrives
intact but carries NaN or Inf factors (a diverged candidate, a
truncated artifact, a poison UP message) is refused at every hand-off
— the batch layer's pre-publish gate (``ml/mlupdate.py``) and the
speed and serving managers — with one meaning of "finite".
"""

from __future__ import annotations

import numpy as np

__all__ = ["ModelIntegrityError", "NumericalDivergenceError",
           "is_finite_array", "check_finite_array"]


class ModelIntegrityError(Exception):
    """A model artifact or update payload failed an integrity check
    (non-finite factors, a truncated or corrupt document, missing
    fields).  Consumers treat it like a lost message: log, count, keep
    serving the previous model."""


class NumericalDivergenceError(ModelIntegrityError):
    """Training diverged to non-finite factors and every rung of the
    rescue ladder (float32 -> float64 -> escalated regularization)
    failed."""


def is_finite_array(a) -> bool:
    """True when every element is finite (an empty array is)."""
    a = np.asarray(a)
    return a.size == 0 or bool(np.all(np.isfinite(a)))


def check_finite_array(name: str, a) -> None:
    """Raise ModelIntegrityError when ``a`` holds NaN or Inf."""
    a = np.asarray(a)
    if not is_finite_array(a):
        bad = int(a.size - np.count_nonzero(np.isfinite(a)))
        raise ModelIntegrityError(
            f"{name} has {bad} non-finite entries (shape {a.shape})")
