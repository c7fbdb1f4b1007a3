"""Clustering quality metrics: silhouette, Davies-Bouldin, Dunn, SSE.

Counterpart of ``oryx_tpu/app/kmeans/evaluation.py`` (reference:
SilhouetteCoefficient.java:31-40 — a sample of at most 100,000 points,
size-1 clusters contribute 0; DaviesBouldinIndex.java — mean-distance
scatter, the non-symmetric max ratio; DunnIndex.java — the smallest
inter-center distance over the largest mean intra-cluster distance;
SumSquaredError.java; AbstractKMeansEvaluation.java:76 — count, mean
distance and sum of squared distances per cluster).  The per-cluster
metrics are one assignment on the device and bincounts; the silhouette's
pairwise distances run as chunked (chunk, sample) distance products on
the device, reduced per cluster by a one-hot product, and the per-point
terms are taken on the host in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...common.device import check_f32_matmul, resolve_device
from ...common.rand import RandomManager
from .common import ClusterInfo, assign_points

__all__ = ["sum_squared_error", "davies_bouldin_index", "dunn_index",
           "silhouette_coefficient", "cluster_metrics", "EVAL_STRATEGIES",
           "evaluate"]

MAX_SILHOUETTE_SAMPLE = 100_000
_CHUNK = 4096


def _centers_matrix(clusters: list[ClusterInfo]) -> np.ndarray:
    return np.stack([c.center for c in
                     sorted(clusters, key=lambda c: c.id)]).astype(np.float32)


def cluster_metrics(clusters: list[ClusterInfo], points, device=None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(counts, mean distance, sum of squared distances) per cluster id,
    the points assigned on ``device`` (None means ``cuda``)."""
    centers = _centers_matrix(clusters)
    idx, dist = assign_points(points, centers, device=device)
    k = len(centers)
    counts = np.bincount(idx, minlength=k).astype(np.float64)
    sum_dist = np.bincount(idx, weights=dist, minlength=k)
    sum_sq = np.bincount(idx, weights=dist * dist, minlength=k)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_dist = np.where(counts > 0, sum_dist / counts, 0.0)
    return counts, mean_dist, sum_sq


def sum_squared_error(clusters: list[ClusterInfo], points,
                      device=None) -> float:
    """Total squared distance to the assigned centers; lower is better."""
    _, _, sum_sq = cluster_metrics(clusters, points, device)
    return float(sum_sq.sum())


def davies_bouldin_index(clusters: list[ClusterInfo], points,
                         device=None) -> float:
    """Mean over clusters of the largest (scatter_i + scatter_j) /
    d(c_i, c_j); lower is better.  The reference's non-symmetric max."""
    centers = _centers_matrix(clusters)
    _, mean_dist, _ = cluster_metrics(clusters, points, device)
    k = len(centers)
    diff = centers[:, None, :] - centers[None, :, :]
    center_d = np.sqrt(np.sum(diff * diff, axis=2))
    total = 0.0
    for i in range(k):
        worst = 0.0
        for j in range(k):
            if i != j and center_d[i, j] > 0:
                worst = max(worst,
                            (mean_dist[i] + mean_dist[j]) / center_d[i, j])
        total += worst
    return total / k if k else 0.0


def dunn_index(clusters: list[ClusterInfo], points, device=None) -> float:
    """Smallest inter-center distance over the largest mean intra-cluster
    distance; higher is better."""
    centers = _centers_matrix(clusters)
    _, mean_dist, _ = cluster_metrics(clusters, points, device)
    max_intra = mean_dist.max()
    k = len(centers)
    min_inter = math.inf
    for i in range(k):
        for j in range(i + 1, k):
            min_inter = min(min_inter,
                            float(np.linalg.norm(centers[i] - centers[j])))
    return min_inter / max_intra if max_intra > 0 else 0.0


def _pairwise_dist_chunk(chunk, pts, pp):
    d2 = (torch.sum(chunk * chunk, dim=1)[:, None]
          - 2.0 * (chunk @ pts.T) + pp[None, :])
    return torch.sqrt(torch.clamp(d2, min=0.0))


def silhouette_coefficient(clusters: list[ClusterInfo], points,
                           max_sample: int = MAX_SILHOUETTE_SAMPLE,
                           device=None) -> float:
    """Mean silhouette over (a sample of) the points, in [-1, 1]; higher
    is better.  Size-1 clusters contribute 0, as in the reference."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if n == 0:
        return 0.0
    if n > max_sample:
        rng = np.random.default_rng(RandomManager.random_seed())
        points = points[rng.choice(n, size=max_sample, replace=False)]
        n = max_sample
    centers = _centers_matrix(clusters)
    k = len(centers)
    dev = resolve_device(device)
    check_f32_matmul(dev)
    idx, _ = assign_points(points, centers, device=dev)
    counts = np.bincount(idx, minlength=k).astype(np.float64)

    dev_pts = torch.from_numpy(points).to(dev)
    pp = torch.sum(dev_pts * dev_pts, dim=1)
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(idx.astype(np.int64)).to(dev), k).to(torch.float32)
    total = 0.0
    for lo in range(0, n, _CHUNK):
        D = _pairwise_dist_chunk(dev_pts[lo:lo + _CHUNK], dev_pts, pp)
        # (chunk, k) sums of distances to each cluster's points
        sums = (D @ onehot).cpu().numpy().astype(np.float64)
        rows = np.arange(len(sums))
        own = idx[lo:lo + len(sums)]
        with np.errstate(divide="ignore", invalid="ignore"):
            # a: mean distance to the own cluster's other points (the
            # point's own distance is 0); b: the nearest other cluster's
            a = sums[rows, own] / (counts[own] - 1)
            other = np.where(counts[None, :] > 0,
                             sums / counts[None, :], math.inf)
            other[rows, own] = math.inf
            b = other.min(axis=1)
            m = np.maximum(a, b)
            term = np.where(m == 0, 0.0, (b - a) / m)
        ok = (counts[own] > 1) & np.isfinite(b)
        total += float(np.sum(np.where(ok, term, 0.0)))
    return total / n


def evaluate(strategy: str, clusters: list[ClusterInfo], points,
             device=None) -> float:
    """Higher-is-better evaluation by the configured strategy
    (KMeansUpdate.evaluate: Davies-Bouldin and SSE are negated)."""
    s = strategy.upper()
    if s == "DAVIES_BOULDIN":
        return -davies_bouldin_index(clusters, points, device)
    if s == "DUNN":
        return dunn_index(clusters, points, device)
    if s == "SILHOUETTE":
        return silhouette_coefficient(clusters, points, device=device)
    if s == "SSE":
        return -sum_squared_error(clusters, points, device)
    raise ValueError(f"Unknown evaluation strategy {strategy}")


EVAL_STRATEGIES = ("DAVIES_BOULDIN", "DUNN", "SILHOUETTE", "SSE")
