"""k-means training on the card: Lloyd's iterations, k-means|| or random
initialization, and the best of several runs.

Counterpart of ``oryx_tpu/app/kmeans/trainer.py`` (reference:
KMeansUpdate.java:107-120 hands Spark MLlib's KMeans.train k,
maxIterations, runs and "k-means||" or "random").  Each Lloyd iteration
is the assignment, an argmin over a (points, clusters) squared-distance
product in row chunks, and the update, per-cluster sums and counts as
one-hot products (deterministic, where an atomic scatter is not).  An
empty cluster keeps its previous center, as MLlib's does.  The points
stay on the card for the whole train; the host fetches the centers, the
counts and one cost per run.

Random initialization draws its rows from the NumPy generator as the
reference does, so it starts from the same rows.  k-means|| draws its
Bernoulli oversampling from a ``torch.Generator`` seeded from the same
NumPy stream (the reference draws from ``jax.random``, which torch cannot
reproduce): it is held to the clustering's quality, not to the
reference's bits.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from ...common.device import resolve_device
from ...common.rand import RandomManager
from ...ops.ann import one_hot_sums
from .common import ClusterInfo, nearest

_log = logging.getLogger(__name__)

__all__ = ["train_kmeans", "K_MEANS_PARALLEL", "RANDOM"]

K_MEANS_PARALLEL = "k-means||"
RANDOM = "random"

_INIT_ROUNDS = 5  # k-means|| oversampling rounds


def _lloyd(points: torch.Tensor, centers0: torch.Tensor, iterations: int):
    """``iterations`` Lloyd steps from ``centers0``: (centers, cost,
    counts), the cost that of the last step's assignment (to the centers
    before its update) and the counts those of the assignment to the
    final centers."""
    k = int(centers0.shape[0])
    pp = torch.sum(points * points, dim=1)
    centers = centers0
    cost = torch.zeros((), device=points.device)
    for _ in range(iterations):
        idx, dmin = nearest(points, centers, pp)
        sums, counts = one_hot_sums(points, idx, k)
        cost = torch.sum(dmin)
        # an empty cluster keeps its previous center
        centers = torch.where((counts > 0)[:, None],
                              sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    idx, _ = nearest(points, centers, pp)
    counts = torch.bincount(idx, minlength=k)
    return centers, cost, counts


def _kmeans_pp_weighted(cands: np.ndarray, weights: np.ndarray, k: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Weighted k-means++ over a small candidate set (host; the last step
    of k-means|| initialization)."""
    n = len(cands)
    centers = [cands[rng.choice(n, p=weights / weights.sum())]]
    d2 = np.sum((cands - centers[0]) ** 2, axis=1)
    while len(centers) < k:
        p = weights * d2
        total = p.sum()
        if total <= 0:
            centers.append(cands[rng.integers(n)])
        else:
            centers.append(cands[rng.choice(n, p=p / total)])
        d2 = np.minimum(d2, np.sum((cands - centers[-1]) ** 2, axis=1))
    return np.stack(centers).astype(np.float32)


def _kmeans_parallel_rounds(points: torch.Tensor, gen: torch.Generator,
                            first_idx: int, cap: int, per_round: int,
                            rounds: int, ell: float):
    """Every k-means|| oversampling round on the card: each round draws
    each point with probability min(1, ell * d2 / phi) and appends the
    first ``per_round`` winners to a (cap, d) candidate buffer.  Returns
    (cands, valid, weights), a candidate's weight the number of points
    nearest to it."""
    n, d = points.shape
    dev = points.device
    pp = torch.sum(points * points, dim=1)
    cands = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    cands[0] = points[first_idx]
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[0] = True
    count = 1
    for _ in range(rounds):
        _, d2 = nearest(points, cands, pp, valid=valid)
        phi = torch.sum(d2)
        probs = torch.clamp(ell * d2 / torch.clamp(phi, min=1e-30),
                            max=1.0)
        sel = torch.rand(n, generator=gen, device=dev) < probs
        idx = torch.nonzero(sel).squeeze(1)[:per_round]
        take = min(int(idx.shape[0]), cap - count)
        if take > 0 and float(phi) > 0:
            cands[count:count + take] = points[idx[:take]]
            valid[count:count + take] = True
            count += take
    near, _ = nearest(points, cands, pp, valid=valid)
    weights = torch.bincount(near, minlength=cap).to(torch.float32)
    return cands, valid, weights


def _init_parallel(points: torch.Tensor, k: int,
                   rng: np.random.Generator) -> np.ndarray:
    """k-means|| (Bahmani et al.): oversample about 2k candidates per
    round in proportion to the current cost, then reduce them to k by
    weighted k-means++ on the host."""
    n = int(points.shape[0])
    ell = 2.0 * k
    per_round = int(2 * ell)
    cap = 1 << max(4, (_INIT_ROUNDS * per_round).bit_length())
    gen = torch.Generator(device=points.device)
    gen.manual_seed(int(rng.integers(2**31)))
    cands_d, valid_d, weights_d = _kmeans_parallel_rounds(
        points, gen, int(rng.integers(n)), cap, per_round, _INIT_ROUNDS,
        ell)
    valid = valid_d.cpu().numpy()
    cands = cands_d.cpu().numpy()[valid].astype(np.float64)
    weights = weights_d.cpu().numpy()[valid].astype(np.float64)
    if len(cands) <= k:
        # a degenerate draw (tiny data, zero potential): random points
        # give the k-means++ reduction enough material
        extra = rng.choice(n, size=k - len(cands) + 1, replace=n < k)
        rows = torch.from_numpy(np.sort(extra)).to(points.device)
        extra_rows = points[rows].cpu().numpy().astype(np.float64)
        cands = np.concatenate([cands, extra_rows])
        weights = np.concatenate([weights, np.ones(len(extra_rows))])
    weights = np.maximum(weights, 1e-12)
    return _kmeans_pp_weighted(cands, weights, k, rng)


def train_kmeans(points, k: int, iterations: int, runs: int = 1,
                 initialization: str = K_MEANS_PARALLEL,
                 seed: int | None = None, timings: dict | None = None,
                 device=None) -> list[ClusterInfo]:
    """Cluster the (n, d) ``points`` (a host array, uploaded once to
    ``device`` — None means ``cuda`` — or a tensor, used where it is) into
    k ``ClusterInfo`` with the counts of the final assignment.  The run
    of lowest cost wins.  ``timings``, if given, receives ``init_s`` and
    ``lloyd_s`` totals (the card synchronised at each boundary)."""
    if isinstance(points, torch.Tensor):
        dev_points = points.to(torch.float32)
    else:
        dev_points = torch.from_numpy(
            np.asarray(points, dtype=np.float32)).to(resolve_device(device))
    n = int(dev_points.shape[0])
    if k < 2:
        raise ValueError("k must be > 1")
    if n < k:
        raise ValueError(f"fewer points ({n}) than clusters ({k})")
    rng = np.random.default_rng(
        RandomManager.random_seed() if seed is None else seed)

    def sync():
        if dev_points.device.type == "cuda":
            torch.cuda.synchronize(dev_points.device)

    best = None
    best_cost = math.inf
    init_s = lloyd_s = 0.0
    for run in range(max(1, runs)):
        t0 = time.perf_counter()
        if initialization == RANDOM:
            rows = rng.choice(n, size=k, replace=False)
            centers0 = dev_points[torch.from_numpy(rows).to(
                dev_points.device)]
        elif initialization == K_MEANS_PARALLEL:
            centers0 = torch.from_numpy(_init_parallel(
                dev_points, k, rng)).to(dev_points.device)
        else:
            raise ValueError(
                f"unknown initialization strategy: {initialization}")
        sync()
        t1 = time.perf_counter()
        init_s += t1 - t0
        centers, cost, counts = _lloyd(dev_points, centers0, iterations)
        centers = centers.cpu().numpy()
        counts = counts.cpu().numpy()
        cost = float(cost)
        lloyd_s += time.perf_counter() - t1
        _log.info("k-means run %d/%d cost %.4f", run + 1, runs, cost)
        if cost < best_cost:
            best, best_cost = (centers, counts), cost

    if timings is not None:
        timings["init_s"] = init_s
        timings["lloyd_s"] = lloyd_s
    centers, counts = best
    return [ClusterInfo(i, centers[i], max(1, int(counts[i])))
            for i in range(k)]
