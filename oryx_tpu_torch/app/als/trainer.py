"""Alternating least squares on the card — implicit (Hu, Koren and
Volinsky, the paper cited at reference ALSUpdate.java:60-68) and
explicit.

Counterpart of ``oryx_tpu/app/als/trainer.py``: the same objective,
packing, initial factors, rescue ladder and results, in torch.

  implicit:  min sum_ui c_ui (p_ui - x_u . y_i)^2 + lambda sum_u n_u |x_u|^2 + ...
             c = 1 + alpha |r|,  p = 1 if r > 0 else 0
  explicit:  min sum_observed (r_ui - x_u . y_i)^2 + lambda n_u |x_u|^2 + ...
  (ALS-WR: lambda scaled by each row's interaction count, as MLlib does)

Design, as in the reference:
 - the interactions are grouped by the side being solved and packed
   into degree-bucketed batches padded to powers of two (the
   reference's plan, kept so both packages solve the same systems; the
   padding is zeros and changes no sum).  Each side's plan goes up to
   the card once per factorization, in one non-blocking copy from
   pinned memory;
 - one batch builds all B normal-equation systems at once,
   A_u = [G +] Yg_u^T diag(w_u) Yg_u + lambda n_u I,  b_u = Yg_u^T t_u,
   Yg the (B, P, k) gathered opposite rows, with two batched products,
   then solves them with one batched LU (``torch.linalg.solve_ex``,
   like ``jnp.linalg.solve``; a singular system shows up as non-finite
   factors, and nothing waits for the card);
 - G = Y^T Y (the implicit base term) is one product per half-sweep;
 - the host waits for the card once per sweep, for the finite check
   that drives the rescue ladder (float32 -> float64 on the host ->
   escalated lambda, ``docs/NUMERICS.md``).

Every product is full float32: the trainer refuses to run on a card
while TF32 matmuls are allowed.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...common.device import check_f32_matmul, resolve_device
from ...common.rand import RandomManager
from ...ml.integrity import NumericalDivergenceError
from ...ops.solver import linalg_call
from ...resilience.faults import fire as _fault
from .common import ParsedRatings

_log = logging.getLogger(__name__)

__all__ = ["train_als", "rescue_retrain_f64", "ALSModel", "predict_pairs",
           "score_all_items"]

# max padded interaction slots (B*P) per solve batch; bounds the (B, P, k)
# gather at slots * k * 4 bytes (210 MB at k = 100), a buffer the caching
# allocator hands to the next batch once the stream has passed it
_BATCH_SLOT_BUDGET = 1 << 19
_MAX_B = 4096

# floor for the escalated-regularization rescue rung: an effectively
# unregularized candidate (lambda ~ 0) whose float64 systems are still
# singular gets at least this much
_RESCUE_MIN_LAMBDA = 1e-3


class ALSModel(NamedTuple):
    user_ids: list[str]
    item_ids: list[str]
    X: np.ndarray  # (n_users, k) float32
    Y: np.ndarray  # (n_items, k) float32
    # non-None when the float32 factorization diverged and a rescue rung
    # produced these factors: {"precision", "trigger_iteration",
    # "escalated_lambda"}, carried into the candidate's PMML
    rescue: dict | None = None


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _csr_by(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int):
    """Group COO by row: returns (order-sorted cols, vals, row_ptr, counts)."""
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    counts = np.bincount(sorted_rows, minlength=n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    return cols[order], vals[order], row_ptr, counts


def _plan_batches(counts: np.ndarray) -> list[tuple[np.ndarray, int]]:
    """Pack row indices into degree-bucketed batches: rows sorted by
    degree, descending; a batch's width P is its largest degree rounded
    up to a power of two, and its size B is capped so that B*P stays
    within the slot budget.  Every batch has its width's full B: the
    tail of a degree class is padded with the dummy row index
    ``len(counts)``, which scatters to a sacrificial extra row.  Returns
    (row indices, P) pairs."""
    n = len(counts)
    order = np.argsort(-counts, kind="stable")
    batches = []
    i = 0
    while i < n:
        p = _next_pow2(max(1, int(counts[order[i]])))
        b = max(1, min(_MAX_B, _BATCH_SLOT_BUDGET // p))
        batch = order[i:i + b]
        if len(batch) < b:
            batch = np.concatenate(
                [batch, np.full(b - len(batch), n, dtype=batch.dtype)])
        batches.append((batch, p))
        i += b
    return batches


class _SidePlan(NamedTuple):
    """The packed batches of one half-sweep.  The sparsity pattern is
    fixed for the whole factorization, so the packing and its upload
    happen once and every sweep reuses them.  ``host`` holds, per batch,
    (row indices (B,), cols (B, P), vals (B, P), mask (B, P)) as NumPy
    arrays; ``device`` the same as tensors on the card (or None before
    the upload)."""

    n_rows: int
    host: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    device: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]] | None = None


def _pack_side(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int, device: torch.device | None = None) -> _SidePlan:
    """Group by row, then pack into padded batches with vectorized
    scatters (no per-row Python loop).  Dummy row indices (== n_rows)
    carry no interactions.  With a ``device``, every batch is packed
    into two host buffers (the indices, the values and masks), pinned
    for a card, and each goes up in one non-blocking copy; the host
    arrays are views of those buffers."""
    s_cols, s_vals, row_ptr, counts = _csr_by(rows, cols, vals, n_rows)
    counts_ext = np.concatenate([counts, [0]])     # dummy row: degree 0
    row_ptr_ext = np.concatenate([row_ptr, [row_ptr[-1]]])
    plan = _plan_batches(counts)
    n_idx = sum(len(r) + len(r) * p for r, p in plan)
    n_val = sum(2 * len(r) * p for r, p in plan)
    pin = device is not None and device.type == "cuda"
    idx_buf = torch.empty(n_idx, dtype=torch.int64, pin_memory=pin)
    val_buf = torch.empty(n_val, dtype=torch.float32, pin_memory=pin)
    idx_np, val_np = idx_buf.numpy(), val_buf.numpy()
    host, spans = [], []
    i = v = 0
    for batch_rows, p in plan:
        bsz = len(batch_rows)
        c = counts_ext[batch_rows].astype(np.int64)
        total = int(c.sum())
        # flat source/destination indices of every real slot at once
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(c) - c, c)
        src = np.repeat(row_ptr_ext[batch_rows], c) + within
        dst = np.repeat(np.arange(bsz, dtype=np.int64) * p, c) + within
        brows = idx_np[i:i + bsz]
        bcols = idx_np[i + bsz:i + bsz + bsz * p]
        bvals = val_np[v:v + bsz * p]
        bmask = val_np[v + bsz * p:v + 2 * bsz * p]
        brows[:] = batch_rows
        bcols[:] = 0
        bvals[:] = 0.0
        bmask[:] = 0.0
        bcols[dst] = s_cols[src]
        bvals[dst] = s_vals[src]
        bmask[dst] = 1.0
        host.append((brows, bcols.reshape(bsz, p), bvals.reshape(bsz, p),
                     bmask.reshape(bsz, p)))
        spans.append((i, v, bsz, p))
        i += bsz + bsz * p
        v += 2 * bsz * p
    if device is None:
        return _SidePlan(n_rows, host)
    idx_dev = idx_buf.to(device, non_blocking=True)
    val_dev = val_buf.to(device, non_blocking=True)
    batches = []
    for i, v, bsz, p in spans:
        batches.append((idx_dev[i:i + bsz],
                        idx_dev[i + bsz:i + bsz + bsz * p].view(bsz, p),
                        val_dev[v:v + bsz * p].view(bsz, p),
                        val_dev[v + bsz * p:v + 2 * bsz * p].view(bsz, p)))
    return _SidePlan(n_rows, host, batches)


def _normal_equations(Yg: torch.Tensor, vals: torch.Tensor,
                      mask: torch.Tensor, G: torch.Tensor | None,
                      lam: float, alpha: float, implicit: bool):
    """The batch's systems: (A (B, k, k), b (B, k), n_u (B,)).

    Yg:   (B, P, k) gathered opposite-side factor rows (zeros at padding)
    vals: (B, P)    interaction strengths (zeros at padding)
    mask: (B, P)    1.0 at real interactions
    G:    (k, k)    Y^T Y, the implicit base term (None if explicit)
    """
    k = Yg.shape[-1]
    n_u = mask.sum(dim=1)  # per-row interaction count (ALS-WR)
    if implicit:
        w = alpha * vals.abs() * mask              # c - 1
        t = (1.0 + w) * (vals > 0.0)               # c * p
    else:
        w = mask
        t = vals * mask
    # A_u = [G +] Yg^T diag(w) Yg + lam * n_u * I — one batched product
    A = torch.bmm((Yg * w[:, :, None]).transpose(1, 2), Yg)
    if implicit:
        A = A + G[None, :, :]
    # rows with no interactions would make A singular in explicit mode
    # (A = 0): regularize them with a unit count and zero the solution
    A = A + (lam * torch.clamp(n_u, min=1.0))[:, None, None] * \
        torch.eye(k, dtype=A.dtype, device=A.device)[None]
    b = torch.bmm(Yg.transpose(1, 2), t[:, :, None])[..., 0]
    return A, b, n_u


def _solve_systems(A: torch.Tensor, b: torch.Tensor,
                   n_u: torch.Tensor) -> torch.Tensor:
    # LU without the info check: a singular system leaves non-finite
    # factors for the per-sweep check, and the host never waits here
    x = linalg_call(torch.linalg.solve_ex, A, b[..., None])[0][..., 0]
    return torch.where((n_u > 0)[:, None], x, 0.0)


class _Stopwatch:
    """Marks on the card's stream (CUDA events) or the host clock,
    read after the stream has passed them."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"

    def mark(self):
        if self._cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self._cuda:
            return a.elapsed_time(b) / 1000.0
        return b - a


def _solve_side(opposite: torch.Tensor, plan: _SidePlan, k: int,
                lam: float, alpha: float, implicit: bool,
                clock: _Stopwatch | None = None, marks: list | None = None
                ) -> torch.Tensor:
    """One half-sweep: every row's factor given the opposite side, all
    on the card, the batches queued back to back.  With a ``clock``,
    ``marks`` gets each batch's (start, products done, solved) marks."""
    G = opposite.T @ opposite if implicit else None
    # one sacrificial extra row absorbs the dummy (tail padding) rows
    out = torch.zeros((plan.n_rows + 1, k), dtype=torch.float32,
                      device=opposite.device)
    for batch_rows, bcols, bvals, bmask in plan.device:
        m0 = clock.mark() if clock else None
        bsz, p = bcols.shape
        Yg = opposite.index_select(0, bcols.reshape(-1)).view(bsz, p, k)
        A, b, n_u = _normal_equations(Yg, bvals, bmask, G, lam, alpha,
                                      implicit)
        m1 = clock.mark() if clock else None
        x = _solve_systems(A, b, n_u)
        out.index_copy_(0, batch_rows, x)
        if clock:
            marks.append((m0, m1, clock.mark()))
    return out[:plan.n_rows]


def _solve_side_f64_host(opposite: np.ndarray, plan: _SidePlan,
                         k: int, lam: float, alpha: float,
                         implicit: bool) -> np.ndarray:
    """Host float64 half-sweep over the same packed batches: the same
    masking, ALS-WR scaling and empty-row semantics, only the precision
    differs.  The rescue precision: MLlib factors in float64
    (ALSUpdate.java:88-152)."""
    G = opposite.T @ opposite if implicit else None
    out = np.zeros((plan.n_rows + 1, k), dtype=np.float64)
    eye = np.eye(k, dtype=np.float64)
    for rows, bcols, bvals, bmask in plan.host:
        Yg = opposite[bcols]                       # (B, P, k) float64
        vals = bvals.astype(np.float64)
        mask = bmask.astype(np.float64)
        n_u = mask.sum(axis=1)
        if implicit:
            w = alpha * np.abs(vals) * mask
            t = (1.0 + w) * (vals > 0.0)
        else:
            w = mask
            t = vals * mask
        A = np.einsum("bpk,bpl->bkl", Yg * w[:, :, None], Yg)
        if implicit:
            A = A + G[None, :, :]
        A += (lam * np.maximum(n_u, 1.0))[:, None, None] * eye[None]
        b = np.einsum("bpk,bp->bk", Yg, t)
        x = np.linalg.solve(A, b[..., None])[..., 0]
        x[n_u == 0] = 0.0
        out[rows] = x
    return out[:plan.n_rows]


def _initial_y(n_items: int, k: int, seed_val: int) -> np.ndarray:
    """The reference's initial item factors (float64): a normalized
    Gaussian / sqrt(k), as MLlib scales them."""
    rng = np.random.default_rng(seed_val)
    return rng.standard_normal((n_items, k)) / math.sqrt(k)


def _train_f64_host(user_plan: _SidePlan, item_plan: _SidePlan,
                    n_items: int, k: int, lam: float, alpha: float,
                    implicit: bool, iterations: int, seed_val: int
                    ) -> tuple[np.ndarray, np.ndarray] | None:
    """A whole float64 host retrain from the same seed and init; (X, Y)
    as float32, or None when even float64 diverges or meets an exactly
    singular system."""
    Y = _initial_y(n_items, k, seed_val)
    try:
        for _ in range(iterations):
            X = _solve_side_f64_host(Y, user_plan, k, lam, alpha, implicit)
            Y = _solve_side_f64_host(X, item_plan, k, lam, alpha, implicit)
    except np.linalg.LinAlgError:
        return None
    if not (np.all(np.isfinite(X)) and np.all(np.isfinite(Y))):
        return None
    return X.astype(np.float32), Y.astype(np.float32)


def _factors_finite(X: torch.Tensor, Y: torch.Tensor) -> bool:
    # NaN-propagating sums: the host reads two scalars, not the factors
    return bool(torch.isfinite(X.sum()) & torch.isfinite(Y.sum()))


def _f64_ladder(user_plan: _SidePlan, item_plan: _SidePlan, n_items: int,
                k: int, lam: float, alpha: float, implicit: bool,
                iterations: int, seed_val: int,
                trigger_iteration: int | None
                ) -> tuple[np.ndarray, np.ndarray, dict]:
    """The float64 and escalated-lambda rungs; returns (X, Y, rescue
    record) or raises NumericalDivergenceError when both fail."""
    rescue = {"precision": "float64", "trigger_iteration": trigger_iteration,
              "escalated_lambda": None}
    factors = _train_f64_host(user_plan, item_plan, n_items, k, lam, alpha,
                              implicit, iterations, seed_val)
    if factors is None:
        lam_esc = max(lam * 10.0, _RESCUE_MIN_LAMBDA)
        _log.warning("float64 retrain also diverged; escalating "
                     "regularization lambda %g -> %g", lam, lam_esc)
        rescue["escalated_lambda"] = lam_esc
        factors = _train_f64_host(user_plan, item_plan, n_items, k, lam_esc,
                                  alpha, implicit, iterations, seed_val)
        if factors is None:
            raise NumericalDivergenceError(
                f"ALS diverged at every rescue rung (features={k} "
                f"lambda={lam}, escalated {lam_esc})")
    X_r, Y_r = factors
    _log.info("ALS float64 rescue succeeded (%s)", rescue)
    return X_r, Y_r, rescue


def rescue_retrain_f64(ratings: ParsedRatings, features: int, lam: float,
                       alpha: float, implicit: bool, iterations: int,
                       seed: int | None = None) -> ALSModel:
    """The float64 and escalated-lambda rungs alone, for a caller whose
    factorization has no ladder of its own; a rescue-annotated model,
    or NumericalDivergenceError."""
    n_users = len(ratings.user_ids)
    n_items = len(ratings.item_ids)
    user_plan = _pack_side(ratings.users, ratings.items, ratings.values,
                           n_users)
    item_plan = _pack_side(ratings.items, ratings.users, ratings.values,
                           n_items)
    seed_val = RandomManager.random_seed() if seed is None else seed
    X_r, Y_r, rescue = _f64_ladder(user_plan, item_plan, n_items, features,
                                   lam, alpha, implicit, iterations,
                                   seed_val, trigger_iteration=None)
    return ALSModel(ratings.user_ids, ratings.item_ids, X_r, Y_r,
                    rescue=rescue)


def train_als(ratings: ParsedRatings,
              features: int,
              lam: float,
              alpha: float,
              implicit: bool,
              iterations: int,
              seed: int | None = None,
              on_iteration: Callable[[int, np.ndarray, np.ndarray], None]
              | None = None,
              device=None,
              timings: dict | None = None) -> ALSModel:
    """Factor the interaction matrix into X (users) and Y (items) on
    ``device`` (None means ``cuda``).

    ``on_iteration(i, X, Y)`` fires after each full sweep with host
    copies of the factors.  A ``timings`` dict is filled with the host
    packing seconds (``pack_s``), each sweep's wall seconds up to its
    finite check (``sweep_s``), each half-sweep's seconds on the card
    (``half_sweep_s``, [users, items] per sweep) and, inside each
    half-sweep, the seconds of the gathers and products
    (``products_s``) and of the solves and scatters (``solve_s``), from
    CUDA events on a card.

    Rescue ladder: the float32 factors are checked for NaN/Inf after
    every sweep (one wait for the card per sweep); on divergence the
    candidate retrains in float64 on the host (same seed and init), and
    if even that fails, once more with escalated regularization.  The
    model's ``rescue`` records the rung taken; only a candidate that
    exhausts the ladder raises NumericalDivergenceError.
    """
    dev = resolve_device(device)
    n_users = len(ratings.user_ids)
    n_items = len(ratings.item_ids)
    k = features
    if n_users == 0 or n_items == 0:
        return ALSModel(ratings.user_ids, ratings.item_ids,
                        np.zeros((0, k), np.float32),
                        np.zeros((0, k), np.float32))
    check_f32_matmul(dev)

    t_pack = time.perf_counter()
    user_plan = _pack_side(ratings.users, ratings.items, ratings.values,
                           n_users, dev)
    item_plan = _pack_side(ratings.items, ratings.users, ratings.values,
                           n_items, dev)
    seed_val = RandomManager.random_seed() if seed is None else seed
    # small random init, scaled like MLlib's; drawn on the host so it is
    # the reference's, bit for bit
    Y = torch.from_numpy(_initial_y(n_items, k, seed_val).astype(
        np.float32)).to(dev)
    X = torch.zeros((n_users, k), dtype=torch.float32, device=dev)
    clock = None
    if timings is not None:
        timings.update(pack_s=time.perf_counter() - t_pack, sweep_s=[],
                       half_sweep_s=[], products_s=[], solve_s=[])
        clock = _Stopwatch(dev)

    diverged_at = None
    for it in range(iterations):
        t_sweep = time.perf_counter()
        marks = ([], []) if clock else (None, None)
        h0 = clock.mark() if clock else None
        # the factors stay on the card between half-sweeps
        X = _solve_side(Y, user_plan, k, lam, alpha, implicit, clock,
                        marks[0])
        h1 = clock.mark() if clock else None
        Y = _solve_side(X, item_plan, k, lam, alpha, implicit, clock,
                        marks[1])
        h2 = clock.mark() if clock else None
        # chaos seam: poison this sweep's factors so tests drive the
        # rescue ladder on healthy data
        if _fault("trainer-f32-poison") == "drop":
            X[0, 0] = float("nan")
        # the one wait for the card per sweep: divergence shows within
        # the first sweeps, and stopping early pins trigger_iteration
        if not _factors_finite(X, Y):
            diverged_at = it
            break
        if clock:
            timings["sweep_s"].append(time.perf_counter() - t_sweep)
            timings["half_sweep_s"].append(
                [clock.seconds(h0, h1), clock.seconds(h1, h2)])
            timings["products_s"].append(
                [sum(clock.seconds(a, b) for a, b, _ in m) for m in marks])
            timings["solve_s"].append(
                [sum(clock.seconds(b, c) for _, b, c in m) for m in marks])
        _log.info("ALS iteration %d/%d done", it + 1, iterations)
        if on_iteration is not None:
            on_iteration(it, X.cpu().numpy(), Y.cpu().numpy())

    if diverged_at is None:
        return ALSModel(ratings.user_ids, ratings.item_ids,
                        X.cpu().numpy(), Y.cpu().numpy())

    _log.warning("ALS float32 factorization diverged at iteration %d/%d "
                 "(features=%d lambda=%g); rescuing in float64",
                 diverged_at + 1, iterations, k, lam)
    X_r, Y_r, rescue = _f64_ladder(user_plan, item_plan, n_items, k, lam,
                                   alpha, implicit, iterations, seed_val,
                                   trigger_iteration=diverged_at)
    return ALSModel(ratings.user_ids, ratings.item_ids, X_r, Y_r,
                    rescue=rescue)


def predict_pairs(model_x: np.ndarray, model_y: np.ndarray,
                  users: np.ndarray, items: np.ndarray,
                  device=None) -> np.ndarray:
    """Predicted strengths of (user, item) index pairs: one gather and
    row-wise dot on ``device`` (None means ``cuda``)."""
    dev = resolve_device(device)
    X = torch.from_numpy(np.asarray(model_x, np.float32)).to(dev)
    Y = torch.from_numpy(np.asarray(model_y, np.float32)).to(dev)
    u = torch.from_numpy(np.asarray(users, np.int64)).to(dev)
    i = torch.from_numpy(np.asarray(items, np.int64)).to(dev)
    return (X[u] * Y[i]).sum(dim=1).cpu().numpy()


def score_all_items(x_u, Y, device=None) -> np.ndarray:
    """Scores of every item for one or more users (the serving-side
    product), in full float32 on ``device`` (None means ``cuda``)."""
    dev = resolve_device(device)
    check_f32_matmul(dev)
    x = torch.from_numpy(np.asarray(x_u, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(Y, np.float32)).to(dev)
    return (x @ y.T).cpu().numpy()
