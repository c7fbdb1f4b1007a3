"""The MovieLens-20M-shaped synthetic interactions of the training
benchmark.

Counterpart of ``oryx_tpu/bench/train.py``, cut down to the synthesizer
(``synthesize_movielens``, ``_sample_from_cdf``) and the hold-out split
(``_split``): NumPy, the same draws from the same seed.  With no
network, the data is synthesized at MovieLens-20M's shape (138,493
users x 26,744 items x 20M interactions, power-law popularity and user
activity) with planted latent structure, so held-out AUC is a real
gate: a user's items come mostly from their preference cluster's item
distribution, which implicit ALS must recover.  The benchmark harness
itself comes with the benches (``ROADMAP.md`` queue 1, item 11).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["synthesize_movielens", "ML20M_USERS", "ML20M_ITEMS",
           "ML20M_RATINGS"]

ML20M_USERS = 138_493
ML20M_ITEMS = 26_744
ML20M_RATINGS = 20_000_000


def _sample_from_cdf(rng: np.random.Generator, cdf: np.ndarray,
                     n: int) -> np.ndarray:
    # float cumsum can leave cdf[-1] slightly below 1.0; clamp so a draw
    # above it cannot index one past the end
    idx = np.searchsorted(cdf, rng.random(n), side="right")
    return np.minimum(idx, len(cdf) - 1).astype(np.int32)


def synthesize_movielens(n_users: int = ML20M_USERS,
                         n_items: int = ML20M_ITEMS,
                         n_ratings: int = ML20M_RATINGS,
                         n_clusters: int = 96,
                         latent_rank: int = 12,
                         noise_sigma: float = 0.5,
                         seed: int = 7):
    """MovieLens-shaped interactions with planted latent structure.

    Returns (users, items, implicit_values, explicit_values, noise_sigma)
    as deduplicated COO arrays in index space.  Item popularity and user
    activity are power-law; each user belongs to a preference cluster and
    85% of their interactions come from that cluster's item distribution
    (that is the structure implicit ALS must recover).  Explicit values
    are true-factor dots + gaussian noise on the 0.5..5 star scale.
    """
    rng = np.random.default_rng(seed)

    # power-law global item popularity and user activity
    item_pop = 1.0 / np.power(np.arange(1, n_items + 1), 0.8)
    rng.shuffle(item_pop)
    item_cdf = np.cumsum(item_pop / item_pop.sum())
    user_act = np.exp(rng.normal(0.0, 1.0, n_users))
    user_cdf = np.cumsum(user_act / user_act.sum())

    users = _sample_from_cdf(rng, user_cdf, n_ratings)

    # per-cluster item distributions: popularity reshaped by lognormal
    # affinity noise -> clusters concentrate on different item subsets
    user_cluster = rng.integers(0, n_clusters, n_users).astype(np.int32)
    items = np.empty(n_ratings, dtype=np.int32)
    from_cluster = rng.random(n_ratings) < 0.85
    n_global = int(np.count_nonzero(~from_cluster))
    items[~from_cluster] = _sample_from_cdf(rng, item_cdf, n_global)
    rating_cluster = user_cluster[users]
    for c in range(n_clusters):
        mask = from_cluster & (rating_cluster == c)
        m = int(np.count_nonzero(mask))
        if m == 0:
            continue
        affinity = item_pop * np.exp(
            np.random.default_rng(seed * 1000 + c).normal(0.0, 2.0, n_items))
        cdf = np.cumsum(affinity / affinity.sum())
        items[mask] = _sample_from_cdf(rng, cdf, m)

    # dedupe (user,item) pairs; implicit strength = interaction count
    key = users.astype(np.int64) * n_items + items
    uniq, inverse = np.unique(key, return_inverse=True)
    implicit_vals = np.bincount(inverse, minlength=len(uniq)).astype(
        np.float32)
    users = (uniq // n_items).astype(np.int32)
    items = (uniq % n_items).astype(np.int32)

    # explicit stars: true-factor dot + noise, 0.5..5 in half-star steps
    scale = 1.0 / math.sqrt(latent_rank)
    Zu = rng.normal(0.0, scale, (n_users, latent_rank)).astype(np.float32)
    Zi = rng.normal(0.0, scale, (n_items, latent_rank)).astype(np.float32)
    dots = np.einsum("nk,nk->n", Zu[users], Zi[items])
    stars = 3.25 + 1.5 * dots + rng.normal(0.0, noise_sigma, len(users))
    explicit_vals = np.clip(np.round(stars * 2.0) / 2.0, 0.5, 5.0).astype(
        np.float32)

    return users, items, implicit_vals, explicit_vals, noise_sigma


def _split(rng: np.random.Generator, n: int, test_fraction: float):
    test_mask = rng.random(n) < test_fraction
    return ~test_mask, test_mask
