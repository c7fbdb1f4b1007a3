"""Real-dataset adapter: consume MovieLens-format ratings files when
present, fall back to the planted-structure synthesizer otherwise.

Counterpart of ``oryx_tpu/bench/datasets.py`` (NumPy, whole).

Nothing is downloaded: the benches synthesize at MovieLens-20M shape
by default (bench/train.py), and a user with the real files points the
benches at them.  Set
``ORYX_ML_DATA=/path/to/ml-20m`` (or pass ``--data``): the adapter
reads ``ratings.csv`` (ml-20m/25m header format
``userId,movieId,rating,timestamp``) or ``ratings.dat``
(ml-1m/ml-10m ``::``-separated) and returns the same COO index-space
arrays the synthesizer produces.

Reference anchor: the reference's docs benchmark ALS on MovieLens-
shaped CSV through the same input-line codec the batch layer ingests
(docs/docs/performance.html; MLFunctions.PARSE_FN).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_movielens", "movielens_or_synthetic"]


def load_movielens(path: str):
    """(users, items, values, user_ids, item_ids) from a MovieLens
    directory or ratings file.  Users/items are re-indexed densely;
    ``values`` are the raw star ratings (float32)."""
    if os.path.isdir(path):
        for name in ("ratings.csv", "ratings.dat"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no ratings.csv/ratings.dat under {path}")
    # loadtxt's C tokenizer: ml-20m's 20M rows parse in seconds where
    # genfromtxt's Python line loop takes minutes and GBs
    if path.endswith(".dat"):
        with open(path) as f:
            raw = np.loadtxt((ln.replace("::", ",") for ln in f),
                             delimiter=",", dtype=np.float64,
                             usecols=(0, 1, 2), ndmin=2)
    else:
        raw = np.loadtxt(path, delimiter=",", skiprows=1,
                         dtype=np.float64, usecols=(0, 1, 2), ndmin=2)
    user_raw = raw[:, 0].astype(np.int64)
    item_raw = raw[:, 1].astype(np.int64)
    values = raw[:, 2].astype(np.float32)
    uniq_u, users = np.unique(user_raw, return_inverse=True)
    uniq_i, items = np.unique(item_raw, return_inverse=True)
    return (users.astype(np.int32), items.astype(np.int32), values,
            [str(u) for u in uniq_u.tolist()],
            [str(i) for i in uniq_i.tolist()])


def movielens_or_synthetic(data_path: str | None, n_ratings: int,
                           seed: int = 7, n_users: int | None = None,
                           n_items: int | None = None):
    """(users, items, explicit_values, user_ids, item_ids, source).

    ``data_path`` (or $ORYX_ML_DATA) selects the real files; otherwise
    the planted-structure synthesizer at MovieLens-20M shape (or a
    smaller ``n_users`` x ``n_items`` space for sub-scale runs — a
    tiny rating count over the full 138k-user space leaves the
    time-split's test users unseen in training)."""
    data_path = data_path or os.environ.get("ORYX_ML_DATA")
    if data_path:
        users, items, values, user_ids, item_ids = load_movielens(data_path)
        return users, items, values, user_ids, item_ids, data_path
    from .train import ML20M_ITEMS, ML20M_USERS, synthesize_movielens

    users, items, _, exp_vals, _ = synthesize_movielens(
        n_users=n_users or ML20M_USERS, n_items=n_items or ML20M_ITEMS,
        n_ratings=n_ratings, seed=seed)
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1
    return (users, items, exp_vals,
            [str(u) for u in range(n_users)],
            [str(i) for i in range(n_items)],
            f"synthetic-ml20m-shape({n_ratings} ratings)")
