"""In-tree float64 NumPy ALS oracle: the slow, trusted quality
reference.

Counterpart of ``oryx_tpu/ml/oracle.py``, as is: NumPy only, so the
same inputs give the same bits in both packages.

The north-star quality gate (SURVEY §7) asks for RMSE/AUC parity with
the reference's MLlib ALS at equal hyperparameters.  MLlib cannot run
in this environment, so this module is the strongest available
substitute: a deliberately simple, loop-per-row, float64 NumPy
implementation of the same objective the card's trainer optimizes —

  implicit:  min Σ_ui c_ui (p_ui - x_u·y_i)^2 + λ Σ_u n_u|x_u|^2 + ...
             c = 1 + α|r|,  p = 1 if r > 0 else 0
             (Hu, Koren & Volinsky 2008, the paper cited at reference
             ALSUpdate.java:60-68)
  explicit:  min Σ_observed (r_ui - x_u·y_i)^2 + λ n_u |x_u|^2 + ...
             (ALS-WR per-row-count λ scaling, as MLlib does)

Design constraints that make it an oracle rather than a second trainer:

- float64 everywhere (MLlib's working precision, ALSUpdate.java:88-152);
- no batching, no padding, no device code, no shared helpers with
  `app/als/trainer.py` — an error there cannot be mirrored here;
- one plain least-squares solve per row per half-sweep, readable
  against the paper's equations in a few minutes.

`tests/test_torch_oracle.py` asserts the port's trainer reaches the
oracle's RMSE and AUC within tolerance at equal hyperparameters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["OracleModel", "train_als_oracle"]


class OracleModel(NamedTuple):
    X: np.ndarray  # (n_users, k) float64
    Y: np.ndarray  # (n_items, k) float64


def _solve_side(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                n_rows: int, opposite: np.ndarray, lam: float,
                alpha: float, implicit: bool) -> np.ndarray:
    """Solve every row's factor given the opposite side's factors: the
    normal equations of the (implicit or explicit) objective, one row
    at a time in float64."""
    k = opposite.shape[1]
    out = np.zeros((n_rows, k), dtype=np.float64)
    gramian = opposite.T @ opposite if implicit else None
    eye = np.eye(k, dtype=np.float64)
    order = np.argsort(rows, kind="stable")
    srows, scols, svals = rows[order], cols[order], vals[order]
    bounds = np.searchsorted(srows, np.arange(n_rows + 1))
    for r in range(n_rows):
        lo, hi = bounds[r], bounds[r + 1]
        if lo == hi:
            continue  # no interactions: zero factor (trainer parity)
        Yr = opposite[scols[lo:hi]]       # (n_r, k)
        v = svals[lo:hi]
        n_r = hi - lo
        if implicit:
            # A = Y^T Y + Y_r^T diag(c-1) Y_r + λ n_r I,  b = Y_r^T (c p)
            c_minus_1 = alpha * np.abs(v)
            a = gramian + Yr.T @ (Yr * c_minus_1[:, None])
            b = Yr.T @ ((1.0 + c_minus_1) * (v > 0.0))
        else:
            a = Yr.T @ Yr
            b = Yr.T @ v
        a += lam * n_r * eye
        out[r] = np.linalg.solve(a, b)
    return out


def train_als_oracle(users: np.ndarray, items: np.ndarray,
                     values: np.ndarray, n_users: int, n_items: int,
                     features: int, lam: float, alpha: float,
                     implicit: bool, iterations: int,
                     seed: int = 0) -> OracleModel:
    """Factor the interaction COO in float64.

    Same init scheme as the trainer (normalized gaussian / sqrt(k)
    item factors, user side solved first), so a run at equal
    hyperparameters is comparable apples-to-apples.
    """
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_items, features)) / np.sqrt(features)
    X = np.zeros((n_users, features), dtype=np.float64)
    for _ in range(iterations):
        X = _solve_side(users, items, values, n_users, Y, lam, alpha,
                        implicit)
        Y = _solve_side(items, users, values, n_items, X, lam, alpha,
                        implicit)
    return OracleModel(X, Y)
