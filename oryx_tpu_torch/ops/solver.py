"""Linear system solving with singularity detection.

Counterpart of ``oryx_tpu/ops/solver.py`` (reference:
LinearSystemSolver.java:39 — singularity threshold = inf-norm * 1e-5,
SingularMatrixSolverException carrying the apparent rank; Solver.java:25).

The matrices are k x k Gramians (X^T X, Y^T Y), k the feature count.
Singularity is checked once on the host by SVD, as the reference does;
the factor kept for solving is a float32 Cholesky factor on the model's
device, so a batch of right-hand sides is one triangular solve there.

Numerical rescue (``docs/NUMERICS.md``): a Gramian that is positive
definite in float64 can fail the float32 factorization.  ``get_solver``
then factors it in float64 on the host and returns a solver that solves
in float64; only a matrix the float64 Cholesky also rejects raises
``SingularMatrixSolverException``.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..common.device import resolve_device
from ..resilience.faults import fire as _fault

_log = logging.getLogger(__name__)

__all__ = ["Solver", "SingularMatrixSolverException", "get_solver",
           "linalg_call"]

_SINGULARITY_THRESHOLD_RATIO = 1.0e-5

# torch loads its CUDA linear-algebra library on the first such call, and
# two threads making that first call at once fail ("lazy wrapper should
# be called at most once"): both solver caches recompute on threads of
# their own, and the batch layer may train candidates on several, so the
# first linear-algebra call of the process on a card is serialized
_cuda_linalg_lock = threading.Lock()
_cuda_linalg_loaded = False


def linalg_call(fn, a: torch.Tensor, *args):
    """``fn(a, *args)`` for a ``torch.linalg`` function; the first call
    on a CUDA tensor holds a lock until the library is loaded."""
    global _cuda_linalg_loaded
    if a.device.type != "cuda" or _cuda_linalg_loaded:
        return fn(a, *args)
    with _cuda_linalg_lock:
        out = fn(a, *args)
        _cuda_linalg_loaded = True
    return out


def _cholesky_ex(a: torch.Tensor):
    return linalg_call(torch.linalg.cholesky_ex, a)


class SingularMatrixSolverException(Exception):
    """Raised when the system matrix is near-singular
    (reference: SingularMatrixSolverException.java:22)."""

    def __init__(self, apparent_rank: int, message: str):
        super().__init__(message)
        self.apparent_rank = apparent_rank


class Solver:
    """Solves A x = b for a fixed symmetric positive-definite A.

    ``solve`` takes one right-hand side (k,) or a batch (n, k) and
    returns the same shape.  ``precision`` is "float32" (the device
    factor) or "float64" (the host rescue factor)."""

    def __init__(self, chol: torch.Tensor, chol64: np.ndarray | None = None):
        self._chol = chol
        self._chol64 = chol64

    @property
    def precision(self) -> str:
        return "float32" if self._chol64 is None else "float64"

    def _solve64(self, b) -> np.ndarray:
        b64 = torch.from_numpy(np.array(b, dtype=np.float64, ndmin=2))
        x = torch.cholesky_solve(b64.T, torch.from_numpy(self._chol64)).T
        out = x.numpy()
        return out[0] if np.ndim(b) == 1 else out

    def solve(self, b) -> np.ndarray:
        if self._chol64 is not None:
            return self._solve64(b).astype(np.float32)
        bt = torch.from_numpy(np.array(b, dtype=np.float32, ndmin=2)).to(
            self._chol.device)
        out = torch.cholesky_solve(bt.T, self._chol).T.cpu().numpy()
        return out[0] if np.ndim(b) == 1 else out

    def solve_d_to_d(self, b) -> np.ndarray:
        if self._chol64 is not None:
            return self._solve64(b)
        return self.solve(np.asarray(b, dtype=np.float64)).astype(np.float64)

    def solve_f_to_f(self, b) -> np.ndarray:
        return self.solve(np.asarray(b, dtype=np.float32)).astype(np.float32)

    @property
    def cholesky(self) -> torch.Tensor:
        """Lower Cholesky factor (float32, on the device).  In float64
        rescue mode it is the float64 factor cast to float32: the
        fold-in solves against it, as the reference's does."""
        return self._chol

    def __repr__(self):  # pragma: no cover
        return f"Solver(k={self._chol.shape[0]}, {self.precision})"


def get_solver(a, device=None) -> Solver:
    """A Solver for the symmetric (k, k) matrix ``a``, factored on
    ``device`` (None means ``cuda``); raises
    SingularMatrixSolverException when ``a`` is near-singular (smallest
    singular value at or below inf-norm * 1e-5, as the reference's RRQR
    test)."""
    dev = resolve_device(device)
    a = np.asarray(a, dtype=np.float64)
    if a.size and not np.all(np.isfinite(a)):
        raise SingularMatrixSolverException(
            0, f"{a.shape[0]} x {a.shape[1]} matrix has non-finite entries")
    inf_norm = float(np.max(np.sum(np.abs(a), axis=1))) if a.size else 0.0
    threshold = inf_norm * _SINGULARITY_THRESHOLD_RATIO
    svals = np.linalg.svd(a, compute_uv=False)
    apparent_rank = int(np.sum(svals > 0.01 * (svals[0] if svals.size
                                               else 0.0)))
    if svals.size == 0 or svals[-1] <= threshold:
        raise SingularMatrixSolverException(
            apparent_rank,
            f"{a.shape[0]} x {a.shape[1]} matrix is near-singular "
            f"(threshold {threshold}). Apparent rank: {apparent_rank}")
    chol, info = _cholesky_ex(
        torch.from_numpy(a.astype(np.float32)).to(dev))
    # chaos seam: discard the float32 factor to drive the float64 rescue
    f32_ok = (_fault("solver-f32-discard") != "drop" and int(info) == 0
              and not bool(torch.isnan(chol).any()))
    if f32_ok:
        return Solver(chol)
    try:
        chol64 = np.linalg.cholesky(a)
    except np.linalg.LinAlgError:
        raise SingularMatrixSolverException(
            apparent_rank,
            f"matrix is not positive definite; apparent rank: "
            f"{apparent_rank}") from None
    _log.warning("f32 Cholesky degenerated for %dx%d Gramian; rescued "
                 "with float64 host factorization", a.shape[0], a.shape[1])
    return Solver(torch.from_numpy(chol64.astype(np.float32)).to(dev),
                  chol64=chol64)
