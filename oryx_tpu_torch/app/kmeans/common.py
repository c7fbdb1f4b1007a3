"""Shared k-means domain logic.

Counterpart of ``oryx_tpu/app/kmeans/common.py`` (reference:
ClusterInfo.java:26 — center and count with the moving-average update;
KMeansUtils.java:29 — closestCluster and featuresFromTokens).  A batch
of points is assigned in one (points, clusters) distance product with
an argmin on the device (``assign_points``); ``ClusterInfo`` stays a
host value, and one datum is assigned by a host loop over the clusters
(``closest_cluster``), as in the reference.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ...common.device import check_f32_matmul, resolve_device
from ..schema import InputSchema

__all__ = ["ClusterInfo", "closest_cluster", "assign_points",
           "features_from_tokens", "parse_to_matrix"]

# elements of one (points, clusters) distance block
_ASSIGN_CHUNK_ELEMS = 1 << 26


class ClusterInfo:
    """One cluster's center and observed count, with the reference's
    moving-average update: c' = c + (n_new/(n+n_new)) * (p - c)."""

    def __init__(self, id_: int, center, count: int):
        center = np.asarray(center, dtype=np.float64)
        if center.size == 0:
            raise ValueError("empty center")
        if count < 1:
            raise ValueError("count must be >= 1")
        self.id = id_
        self.center = center
        self.count = int(count)
        self._lock = threading.Lock()

    def update(self, new_point, new_count: int) -> None:
        new_point = np.asarray(new_point, dtype=np.float64)
        with self._lock:
            total = self.count + new_count
            self.center = self.center + (new_count / total) * (new_point
                                                               - self.center)
            self.count = total

    def __repr__(self):
        return f"{self.id} {self.center.tolist()} {self.count}"


def nearest(points: torch.Tensor, centers: torch.Tensor,
            pp: torch.Tensor | None = None, clamp_first: bool = False,
            valid: torch.Tensor | None = None):
    """(index, squared distance clamped at 0) of the nearest center of
    every point, by ``||p||^2 - 2 p.c + ||c||^2``, in row chunks.  Ties
    go to the lowest center, as ``jnp.argmin`` breaks them.  With
    ``clamp_first`` the distances are clamped at 0 before the argmin, as
    the reference's assignment kernel does; its Lloyd steps clamp
    after.  Centers where ``valid`` is False are at +inf."""
    check_f32_matmul(points.device)
    if pp is None:
        pp = torch.sum(points * points, dim=1)
    cc = torch.sum(centers * centers, dim=1)[None, :]
    ct = centers.T
    step = max(1024, _ASSIGN_CHUNK_ELEMS // max(1, int(centers.shape[0])))
    idx, dmin = [], []
    for s in range(0, int(points.shape[0]), step):
        d = pp[s:s + step, None] - 2.0 * (points[s:s + step] @ ct) + cc
        if valid is not None:
            d = torch.where(valid[None, :], d, float("inf"))
        if clamp_first:
            d = torch.clamp(d, min=0.0)
        i = torch.argmin(d, dim=1)
        idx.append(i)
        dmin.append(torch.clamp(d.gather(1, i[:, None])[:, 0], min=0.0))
    if not idx:
        empty = torch.zeros(0, device=points.device)
        return empty.to(torch.int64), empty
    return torch.cat(idx), torch.cat(dmin)


def assign_points(points, centers, device=None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(cluster index, euclidean distance) of every point, on ``device``
    (None means ``cuda``; a tensor's own device when ``points`` is one):
    the batch form of the reference's per-point closestCluster scan."""
    if isinstance(points, torch.Tensor):
        pts = points.to(torch.float32)
    else:
        pts = torch.from_numpy(np.asarray(points, dtype=np.float32)).to(
            resolve_device(device))
    c = torch.from_numpy(np.array(centers, dtype=np.float32)).to(
        pts.device)
    idx, d2 = nearest(pts, c, clamp_first=True)
    return (idx.to(torch.int32).cpu().numpy(),
            torch.sqrt(d2).cpu().numpy())


def closest_cluster(clusters: list[ClusterInfo],
                    vector) -> tuple[ClusterInfo, float]:
    """KMeansUtils.closestCluster: the nearest cluster by euclidean
    distance, by a host loop (few clusters, one datum)."""
    if not clusters:
        raise ValueError("no clusters")
    vec = np.asarray(vector, dtype=np.float64)
    best, best_d = None, float("inf")
    for c in clusters:
        d = float(np.linalg.norm(c.center - vec))
        if d < best_d:
            best, best_d = c, d
    if not np.isfinite(best_d):
        raise ValueError("non-finite distance")
    return best, best_d


def features_from_tokens(tokens: list[str],
                         schema: InputSchema) -> np.ndarray:
    """The numeric predictor vector of a tokenized input line
    (KMeansUtils.featuresFromTokens)."""
    out = np.zeros(schema.num_predictors, dtype=np.float64)
    for f in range(len(tokens)):
        if schema.is_active(f):
            out[schema.feature_to_predictor_index(f)] = float(tokens[f])
    return out


def parse_to_matrix(lines: list[list[str]],
                    schema: InputSchema) -> np.ndarray:
    """(n, num_predictors) float32 matrix of tokenized lines."""
    out = np.zeros((len(lines), schema.num_predictors), dtype=np.float32)
    for i, tokens in enumerate(lines):
        out[i] = features_from_tokens(tokens, schema)
    return out
