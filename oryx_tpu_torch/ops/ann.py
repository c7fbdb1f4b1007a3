"""Nearest-centroid assignment and Lloyd's update, shared by the IVF
index and the k-means app.

Counterpart of ``oryx_tpu/ops/ann.py``.  The IVF serving index
(``app/als/ivf.py``) partitions the item matrix by nearest centroid;
this module trains and applies that partition:

- ``lloyd_step``: one Lloyd iteration, assignment by matmul-argmin and
  the one-hot update as a matmul;
- ``train_centroids``: k-means over a seeded row sample, reproducible
  for fixed inputs;
- ``assign_cells``: the nearest centroid of every row of the catalog,
  in row chunks, so the (rows, cells) distance matrix never exists
  whole (10M x 1024 float32 would be 43 GB).

Centroids train in float32 whatever the store's dtype: the partition
routes, it does not score (phase B rescores from the exact factors
under the two-phase certificate), so their precision moves recall,
never correctness.  ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does.  The k-means trainer (``app/kmeans/trainer.py``)
runs the same two products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import check_f32_matmul, resolve_device

__all__ = ["lloyd_step", "train_centroids", "assign_cells",
           "sq_dist_argmin", "one_hot_sums"]

# rows per distance product: bounds the (rows, centers) float32 block
_ASSIGN_CHUNK_ELEMS = 1 << 26


def _chunk_rows(n_centers: int) -> int:
    return max(1024, _ASSIGN_CHUNK_ELEMS // max(1, n_centers))


def sq_dist_argmin(points: torch.Tensor, centers: torch.Tensor,
                   chunk: int | None = None) -> torch.Tensor:
    """Nearest center per point by squared euclidean distance, int64.
    ``||p||^2`` is the same for every center and is dropped, so the
    distance is one matmul plus a norm per center.  Rows go in chunks
    of ``chunk`` (each row's argmin is independent of the others)."""
    check_f32_matmul(points.device)
    cc = torch.sum(centers * centers, dim=1)[None, :]
    ct = centers.T
    step = chunk or _chunk_rows(int(centers.shape[0]))
    out = [torch.argmin(cc - 2.0 * (points[s:s + step] @ ct), dim=1)
           for s in range(0, int(points.shape[0]), step)]
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=points.device)
    return torch.cat(out)


def one_hot_sums(points: torch.Tensor, idx: torch.Tensor, n_centers: int,
                 chunk: int | None = None):
    """(sums, counts) of the points per center as one-hot matmuls in
    row chunks: deterministic for fixed shapes, where an atomic
    scatter-add is not."""
    sums = torch.zeros((n_centers, int(points.shape[1])),
                       dtype=torch.float32, device=points.device)
    counts = torch.zeros(n_centers, dtype=torch.float32,
                         device=points.device)
    step = chunk or _chunk_rows(n_centers)
    for s in range(0, int(points.shape[0]), step):
        oh = torch.nn.functional.one_hot(
            idx[s:s + step], n_centers).to(torch.float32)
        counts += oh.sum(dim=0)
        sums += oh.T @ points[s:s + step]
    return sums, counts


def lloyd_step(points: torch.Tensor, centers: torch.Tensor,
               ncells: int) -> torch.Tensor:
    """One Lloyd iteration: assign every point to its nearest center,
    move each center to the mean of its points.  An empty cell keeps its
    previous center (a dead centroid owns no rows; re-seeding would make
    the build depend on iteration order)."""
    idx = sq_dist_argmin(points, centers)
    sums, counts = one_hot_sums(points, idx, ncells)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts > 0.0)[:, None], new, centers)


def train_centroids(rows, ncells: int, iterations: int, seed: int,
                    device=None) -> np.ndarray:
    """K-means centroids over ``rows`` (a host array or a tensor), from a
    seeded row-sample initialisation, for ``iterations`` Lloyd steps on
    ``device`` (None means ``cuda``; a tensor's own device when ``rows``
    is one).  The same inputs give the same centroids: the initial rows
    come from a seeded NumPy generator and every step is deterministic."""
    if isinstance(rows, torch.Tensor):
        pts = rows.to(torch.float32)
        n = int(pts.shape[0])
    else:
        host = np.asarray(rows, dtype=np.float32)
        n = host.shape[0]
        pts = None
    if n == 0 or ncells < 1:
        raise ValueError("cannot train centroids over an empty matrix")
    ncells = min(ncells, n)
    rng = np.random.default_rng(seed)
    pick = rng.permutation(n)[:ncells]
    if pts is None:
        init = host[pick]
        if ncells < 2:
            return init
        pts = torch.from_numpy(host).to(resolve_device(device))
    else:
        init = pts[torch.from_numpy(pick).to(pts.device)].cpu().numpy()
        if ncells < 2:
            return init
    centers = torch.from_numpy(init).to(pts.device)
    for _ in range(max(1, iterations)):
        centers = lloyd_step(pts, centers, ncells)
    return centers.cpu().numpy().astype(np.float32)


def assign_cells(vecs, centroids, device=None) -> np.ndarray:
    """Nearest-centroid cell of every row of ``vecs``, int32 on the host.
    ``vecs`` may be the store's column-padded device snapshot: the
    centroids are zero-padded to its width, which leaves every distance
    unchanged (padding columns are exact zeros on both sides).  A host
    ``vecs`` goes to ``device`` (None means ``cuda``)."""
    if not isinstance(vecs, torch.Tensor):
        vecs = torch.from_numpy(np.asarray(vecs, dtype=np.float32)).to(
            resolve_device(device))
    c = torch.from_numpy(np.array(centroids, dtype=np.float32)).to(
        vecs.device)
    w = int(vecs.shape[1])
    if int(c.shape[1]) != w:
        c = torch.nn.functional.pad(c, (0, w - int(c.shape[1])))
    if vecs.dtype == torch.float32:
        return sq_dist_argmin(vecs, c).to(torch.int32).cpu().numpy()
    # a bf16 store widens exactly, one chunk at a time
    step = _chunk_rows(int(c.shape[0]))
    out = [sq_dist_argmin(vecs[s:s + step].to(torch.float32), c)
           for s in range(0, int(vecs.shape[0]), step)]
    return torch.cat(out).to(torch.int32).cpu().numpy()
