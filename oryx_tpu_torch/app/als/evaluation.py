"""ALS model evaluation: RMSE (explicit) and mean per-user AUC (implicit).

Counterpart of ``oryx_tpu/app/als/evaluation.py``: the same sampling,
drawn from this package's ``RandomManager`` (the reference's NumPy
streams), with the predictions on ``device`` (None means ``cuda``).

Reference: app/oryx-app-mllib/src/main/java/com/cloudera/oryx/app/batch/
mllib/als/Evaluation.java — rmse :49-63 (predict test pairs, root mean
squared diff) and areaUnderCurve :70-136 (per-user AUC: sample about as
many random negative items as the user has positives, count how often a
positive outranks a negative, average over users).

The predictions of all test pairs and of all sampled negatives are two
batched gather-and-dot calls on the card; only the light per-user
pairwise counting runs on the host.
"""

from __future__ import annotations

import numpy as np

from ...common.rand import RandomManager
from .trainer import predict_pairs

__all__ = ["rmse", "area_under_curve"]


def rmse(X: np.ndarray, Y: np.ndarray,
         users: np.ndarray, items: np.ndarray, values: np.ndarray,
         device=None) -> float:
    preds = predict_pairs(X, Y, users, items, device)
    return float(np.sqrt(np.mean((preds - values) ** 2)))


def area_under_curve(X: np.ndarray, Y: np.ndarray,
                     users: np.ndarray, items: np.ndarray,
                     device=None) -> float:
    """Mean per-user AUC over (user, positive-item) test pairs.

    All positive and all sampled-negative predictions are computed in
    two batched device calls; only the light pairwise counting runs on
    the host, per user.
    """
    if len(users) == 0:
        return 0.0
    rng = RandomManager.random()
    all_items = np.unique(items)

    # group positives per user
    order = np.argsort(users, kind="stable")
    su, si = users[order], items[order]
    uniq_users, starts = np.unique(su, return_index=True)
    ends = np.append(starts[1:], len(su))

    # sample about as many negatives as positives per user (reference:
    # with replacement from the distinct item universe, skipping the
    # user's positives, bounded by the universe size)
    neg_users: list[int] = []
    neg_items: list[int] = []
    neg_bounds = [0]
    for u, lo, hi in zip(uniq_users, starts, ends):
        pos_items = set(si[lo:hi].tolist())
        num_pos = hi - lo
        negatives: list[int] = []
        for _ in range(len(all_items)):
            if len(negatives) >= num_pos:
                break
            cand = int(all_items[rng.integers(len(all_items))])
            if cand not in pos_items:
                negatives.append(cand)
        neg_users.extend([int(u)] * len(negatives))
        neg_items.extend(negatives)
        neg_bounds.append(len(neg_items))

    pos_scores_all = predict_pairs(X, Y, su, si, device)
    neg_scores_all = (predict_pairs(
        X, Y, np.asarray(neg_users, dtype=np.int32),
        np.asarray(neg_items, dtype=np.int32), device)
        if neg_items else np.zeros(0, dtype=np.float32))

    aucs = []
    for idx, (lo, hi) in enumerate(zip(starts, ends)):
        neg = neg_scores_all[neg_bounds[idx]:neg_bounds[idx + 1]]
        if len(neg) == 0:
            aucs.append(0.0)
            continue
        pos = pos_scores_all[lo:hi]
        correct = np.sum(pos[:, None] > neg[None, :])
        aucs.append(float(correct) / (len(pos) * len(neg)))
    return float(np.mean(aucs))
