"""Distributed k-means: Lloyd iterations over a device mesh.

Counterpart of ``oryx_tpu/parallel/kmeans_dist.py`` (reference: Spark
MLlib KMeans.train at KMeansUpdate.java:107-120, each iteration a map
and a reduceByKey over executors).  The points are row-sharded over the
mesh entries and never move; the centers are replicated.  Each Lloyd
iteration is, per entry, the single trainer's chunked distance products
and argmin (``app/kmeans/common.nearest``) and one-hot sums in row
chunks, weighted so that padding rows count for nothing, then one ``psum`` of the (k, d) sums, the (k,) counts and the
cost: the collective that replaces the shuffle.

Initialization (k-means|| or random) runs as in the single trainer, on
the first entry's device over all points, and its centers go to every
entry.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..app.kmeans.common import ClusterInfo, assign_points, nearest
from ..app.kmeans.trainer import K_MEANS_PARALLEL, RANDOM, _init_parallel
from ..common.rand import RandomManager
from ..common.device import device_context
from .mesh import Mesh, pad_rows, psum, shard_rows

_log = logging.getLogger(__name__)

__all__ = ["make_lloyd_step", "train_kmeans_distributed"]


# elements of one chunk's (rows, k) one-hot matrix
_ONE_HOT_ELEMS = 1 << 26


def _weighted_sums(points: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   k: int):
    """(sums, counts) of the weighted points per center, as one-hot
    products in row chunks."""
    sums = torch.zeros((k, int(points.shape[1])), dtype=torch.float32,
                       device=points.device)
    counts = torch.zeros(k, dtype=torch.float32, device=points.device)
    step = max(1024, _ONE_HOT_ELEMS // k)
    for s in range(0, int(points.shape[0]), step):
        oh = torch.nn.functional.one_hot(idx[s:s + step], k).to(
            torch.float32) * w[s:s + step, None]
        counts += oh.sum(dim=0)
        sums += oh.T @ points[s:s + step]
    return sums, counts


def make_lloyd_step(mesh: Mesh, k: int, iterations: int):
    """The distributed Lloyd program: ``run(points, weights, centers0) ->
    (centers, cost)``, ``points`` and ``weights`` one row block per local
    entry, ``centers0`` a (k, d) tensor; the cost is that of the last
    step's assignment.  Padding rows carry weight 0."""
    devs = mesh.devices

    def run(points, weights, centers0):
        pps = []
        for d, p in zip(devs, points):
            with device_context(d):
                pps.append(torch.sum(p * p, dim=1))
        centers = [centers0.to(d) for d in devs]
        cost = None
        for _ in range(iterations):
            sums, counts, costs = [], [], []
            for e, d in enumerate(devs):
                with device_context(d):
                    idx, dmin = nearest(points[e], centers[e], pps[e])
                    s, c = _weighted_sums(points[e], weights[e], idx, k)
                    sums.append(s)
                    counts.append(c)
                    costs.append(torch.sum(weights[e] * dmin))
            counts, sums = psum(mesh, counts), psum(mesh, sums)
            cost = psum(mesh, costs)[0]
            new = []
            for e, d in enumerate(devs):
                with device_context(d):
                    new.append(torch.where(
                        (counts[e] > 0)[:, None],
                        sums[e] / torch.clamp(counts[e], min=1.0)[:, None],
                        centers[e]))
            centers = new
        return centers[0], cost

    return run


def train_kmeans_distributed(points: np.ndarray, k: int, iterations: int,
                             mesh: Mesh, runs: int = 1,
                             initialization: str = K_MEANS_PARALLEL,
                             seed: int | None = None) -> list[ClusterInfo]:
    """The mesh's drop-in for ``train_kmeans`` (same model semantics)."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if k < 2:
        raise ValueError("k must be > 1")
    if n < k:
        raise ValueError(f"fewer points ({n}) than clusters ({k})")
    rng = np.random.default_rng(
        RandomManager.random_seed() if seed is None else seed)
    n_pad = pad_rows(n, mesh.size)
    padded = np.zeros((n_pad, points.shape[1]), dtype=np.float32)
    padded[:n] = points
    weights = np.zeros(n_pad, dtype=np.float32)
    weights[:n] = 1.0
    dev_points = shard_rows(mesh, padded)
    dev_w = shard_rows(mesh, weights)
    step = make_lloyd_step(mesh, k, iterations)
    d0 = mesh.devices[0]
    all_points = None

    best_centers, best_cost = None, math.inf
    for run in range(max(1, runs)):
        if initialization == RANDOM:
            centers0 = torch.from_numpy(
                points[rng.choice(n, size=k, replace=False)]).to(d0)
        elif initialization == K_MEANS_PARALLEL:
            if all_points is None:
                all_points = torch.from_numpy(points).to(d0)
            with device_context(d0):
                centers0 = torch.from_numpy(
                    _init_parallel(all_points, k, rng)).to(d0)
        else:
            raise ValueError(
                f"unknown initialization strategy: {initialization}")
        centers, cost = step(dev_points, dev_w, centers0)
        centers, cost = centers.cpu().numpy(), float(cost)
        _log.info("dist k-means run %d/%d cost %.4f", run + 1, runs, cost)
        if cost < best_cost:
            best_centers, best_cost = centers, cost

    with device_context(d0):
        idx, _ = assign_points(points, best_centers, device=d0)
    counts = np.bincount(idx, minlength=k)
    return [ClusterInfo(i, best_centers[i], max(1, int(counts[i])))
            for i in range(k)]
