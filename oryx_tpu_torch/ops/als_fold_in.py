"""ALS incremental fold-in on the solver's device.

Counterpart of ``oryx_tpu/ops/als_fold_in.py`` (reference: ALSUtils.java
— computeTargetQui :36-60, the implicit target interpolation with NaN
meaning "no change", and computeUpdatedXu :74-, which solves
``(Y^T Y) dXu = dQui * Yi`` and adds).  A batch of events is one
triangular solve against the solver's float32 Cholesky factor, on the
device that factor lives on; an ordered context is folded one event at
a time, each step depending on the last, with no host round trip
between the steps.

The factor is ``Solver.cholesky`` even when the solver is in float64
rescue mode (the rescue factor cast to float32), as in the reference,
so rescue-mode answers match it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import check_f32_matmul

__all__ = ["compute_target_qui", "fold_in_batch", "fold_in_sequential",
           "compute_updated_xu"]


def compute_target_qui(implicit: bool, value, current_value) -> torch.Tensor:
    """Elementwise target strength; NaN means "no change" (the semantics
    of ALSUtils.computeTargetQui)."""
    value = torch.as_tensor(value, dtype=torch.float32)
    current = torch.as_tensor(current_value, dtype=torch.float32,
                              device=value.device)
    if not implicit:
        return value
    pos = (value > 0.0) & (current < 1.0)
    neg = (value < 0.0) & (current > 0.0)
    pos_target = current + (value / (1.0 + value)) * (
        1.0 - torch.clamp(current, min=0.0))
    neg_target = current + (value / (value - 1.0)) * (
        -torch.clamp(current, max=1.0))
    nan = torch.full_like(pos_target, float("nan"))
    return torch.where(pos, pos_target, torch.where(neg, neg_target, nan))


def _solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Rows of ``rhs`` solved against ``L L^T`` (one triangular solve
    pair for the whole batch)."""
    return torch.cholesky_solve(rhs.T, chol).T


def fold_in_batch(solver, values, xu, yi, implicit: bool):
    """Fold a batch of interaction events into user vectors.

    ``values`` (n,) strengths; ``xu`` (n, k) current user vectors, a
    NaN row meaning "no vector yet"; ``yi`` (n, k) item vectors, a NaN
    row meaning "no item vector" (no update).  Returns ``(new_xu,
    valid)`` as NumPy arrays: the (n, k) updated vectors and the (n,)
    mask of events that produced an update (False where the reference
    returns null: no Yi, or a NaN target).  The reference pads the
    batch to a power of two for XLA's compile cache; with no such
    cache, this batch is solved at its own size.  The inputs go up in
    one copy from one host buffer (pinned on a card), and the vectors
    and the mask come back in one fetch."""
    chol = solver.cholesky
    dev = chol.device
    check_f32_matmul(dev)
    values = np.asarray(values, dtype=np.float32)
    xu = np.asarray(xu, dtype=np.float32)
    yi = np.asarray(yi, dtype=np.float32)
    n, k = xu.shape
    nk = n * k
    # one upload: [values | xu | yi | has_xu | has_yi], NaN rows as zeros
    host = torch.empty(2 * nk + 3 * n, dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    buf[:n] = values
    buf[n:n + nk] = np.nan_to_num(xu).reshape(-1)
    buf[n + nk:n + 2 * nk] = np.nan_to_num(yi).reshape(-1)
    buf[n + 2 * nk:2 * n + 2 * nk] = ~np.any(np.isnan(xu), axis=1)
    buf[2 * n + 2 * nk:] = ~np.any(np.isnan(yi), axis=1)
    packed = host.to(dev, non_blocking=True)
    v_t = packed[:n]
    xu_t = packed[n:n + nk].view(n, k)
    yi_t = packed[n + nk:n + 2 * nk].view(n, k)
    has_xu = packed[n + 2 * nk:2 * n + 2 * nk] > 0.5
    has_yi = packed[2 * n + 2 * nk:] > 0.5
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # Qui: the current estimated strength, 0 for a new user, whose
    # "don't know" state is 0.5
    qui = torch.where(has_xu, (xu_t * yi_t).sum(dim=1), zero)
    current = torch.where(has_xu, qui, torch.full_like(qui, 0.5))
    target = compute_target_qui(implicit, v_t, current)
    valid = has_yi & ~torch.isnan(target)
    d_qui = torch.where(valid, target - qui, zero)
    d_xu = _solve(chol, yi_t * d_qui[:, None])
    new_xu = torch.where(has_xu[:, None], xu_t, zero) + d_xu
    # one fetch: the vectors and the mask
    out = torch.cat([new_xu.reshape(-1), valid.to(new_xu.dtype)])
    out = out.cpu().numpy()
    return out[:nk].reshape(n, k), out[nk:] > 0.5


def fold_in_sequential(solver, item_values, get_item_vector,
                       xu: np.ndarray | None, implicit: bool,
                       features: int):
    """Fold an ordered list of ``(item_id, strength)`` context events
    into a (possibly absent) user vector, one event after another (the
    reference's per-item loop, EstimateForAnonymous.
    buildTemporaryUserVector :74-96).  ``get_item_vector(item_id)``
    gives the item's row or None; items without one are skipped.
    Returns the new vector, or ``xu`` when nothing folded in and no
    vector existed.  The inputs go up in one copy, the steps run on the
    factor's device with no host round trip between them, and the
    result comes back in one fetch at the end."""
    rows = []
    for item_id, value in item_values:
        v = get_item_vector(item_id)
        if v is not None:
            rows.append((float(value), v))
    if not rows:
        return xu
    chol = solver.cholesky
    dev = chol.device
    check_f32_matmul(dev)
    # one upload: strengths, item rows and start vector packed into one
    # host buffer (pinned on a card), so the copy makes the host wait
    # for nothing
    m = len(rows)
    host = torch.empty(m * (features + 1) + features, dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    buf[:m] = [v for v, _ in rows]
    buf[m:m * (features + 1)] = np.asarray(
        [y for _, y in rows], np.float32).reshape(-1)
    buf[m * (features + 1):] = 0.0 if xu is None else np.asarray(
        xu, dtype=np.float32)
    packed = host.to(dev, non_blocking=True)
    values = packed[:m]
    ys = packed[m:m * (features + 1)].view(m, features)
    cur = packed[m * (features + 1):]
    has_xu = torch.full((), xu is not None, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    half = torch.full((), 0.5, dtype=torch.float32, device=dev)
    for j in range(m):
        y = ys[j]
        qui = torch.where(has_xu, torch.dot(cur, y), zero)
        current = torch.where(has_xu, qui, half)
        target = compute_target_qui(implicit, values[j], current)
        valid = ~torch.isnan(target)
        d_qui = torch.where(valid, target - qui, zero)
        d_xu = _solve(chol, (y * d_qui)[None, :])[0]
        base = torch.where(has_xu, cur, zero)
        cur = torch.where(valid, base + d_xu, cur)
        has_xu = has_xu | valid
    # one fetch: the vector and whether anything folded in
    out = torch.cat([cur, has_xu.to(cur.dtype)[None]]).cpu().numpy()
    return out[:features] if out[features] else xu


def compute_updated_xu(solver, value: float, xu, yi, implicit: bool):
    """Single-event fold-in with the reference's signature
    (ALSUtils.computeUpdatedXu); the new Xu, or None."""
    if yi is None:
        return None
    k = len(yi)
    xu_arr = np.full((1, k), np.nan, dtype=np.float32) if xu is None \
        else np.asarray(xu, dtype=np.float32)[None, :]
    new_xu, valid = fold_in_batch(solver, np.array([value]), xu_arr,
                                  np.asarray(yi, dtype=np.float32)[None, :],
                                  implicit)
    return new_xu[0] if bool(valid[0]) else None
