"""Sharded serving scan: the item matrix row-sharded over the mesh
entries, a top-k per shard, one gather and a merge.

Counterpart of ``oryx_tpu/parallel/serving_dist.py`` (reference: the
partitioned scan of PartitionedFeatureVectors.java:84-148 under
ALSServingModel.java:265-280).  Rows of Y live in one block per entry;
each query batch is scored on every entry against its block, the
``k_shard`` best leave each entry with their global rows (local row +
entry x rows per entry), the candidates of all entries are gathered
entry-major onto the first entry, and the ``k_final`` best of them are
the answer.  A request may ask for more than one shard holds: ``k_shard``
is clamped to the rows of a shard, ``k_final`` to all candidates.

Every top-k is the serving model's ``_top_k`` (``lax.top_k``'s order:
descending, ties lowest index first).  The candidates are gathered
entry-major, so a tie between shards goes to the lower global row, as on
the reference.  Scores are float32: a bf16 store's rows are widened
before the product (``serving_model._scores``), so bf16 x bf16 products
accumulate in float32 as on the reference's MXU; TF32 is refused.  Each
shard scans its rows in chunks with a running top-k, so no (B, rows)
score matrix larger than about 1 GB exists.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..app.als.feature_vectors import device_width, resolve_dtype
from ..app.als.serving_model import (_FLAT_SCORES_LIMIT, _pad_k, _q_cast,
                                     _scores, _top_k)
from ..common.device import check_f32_matmul, device_context
from .mesh import Mesh, all_gather, pad_rows, shard_rows

__all__ = ["ShardKernelCache", "ShardedItemScorer", "shard_top_k"]

_NEG_INF = float("-inf")


def shard_top_k(Y: torch.Tensor, active: torch.Tensor, Q: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores, local rows) of the ``k`` best active rows of one shard for
    every query, scanned in row chunks with a running top-k: the carry
    comes before each chunk, so ties keep the lowest row first."""
    check_f32_matmul(Y.device)
    Qc = _q_cast(Q, Y)
    n = int(Y.shape[0])
    step = max(k, _FLAT_SCORES_LIMIT // (4 * max(1, int(Q.shape[0]))))
    best_s = best_i = None
    for s in range(0, n, step):
        sc = _scores(Qc, Y[s:s + step])
        sc = torch.where(active[None, s:s + step], sc, _NEG_INF)
        idx = torch.arange(s, s + sc.shape[1], device=Y.device).expand(
            sc.shape[0], -1)
        if best_s is not None:
            sc = torch.cat([best_s, sc], dim=1)
            idx = torch.cat([best_i, idx], dim=1)
        vals, pos = _top_k(sc, min(k, int(sc.shape[1])))
        best_s, best_i = vals, idx.gather(1, pos)
    return best_s, best_i


class ShardKernelCache:
    """The shard plan of one mesh, shared by :class:`ShardedItemScorer`
    and the serving model's sharded mode
    (``oryx.serving.api.item-shards``): per-shard top-k, gather, merge.
    Nothing is compiled per shape here, as it is under XLA; the name is
    the reference's."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def top_k(self, Y: Sequence[torch.Tensor],
              active: Sequence[torch.Tensor], Q: Sequence[torch.Tensor],
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores, global rows), (B, k_final) on the first entry, of the
        merged per-shard top-k of a replicated query batch (``Q`` one
        copy per entry, from :meth:`replicate`); ``k`` is clamped to the
        global row count and each shard's share to its own rows."""
        mesh = self.mesh
        n_local = int(Y[0].shape[0])
        k_shard = min(k, n_local)
        k_final = min(k, k_shard * mesh.size)
        parts_s, parts_i = [], []
        for e, d in enumerate(mesh.devices):
            with device_context(d):
                s, i = shard_top_k(Y[e], active[e], Q[e], k_shard)
                parts_s.append(s[None])
                parts_i.append(
                    (i + (mesh.first_entry + e) * n_local)[None])
        # (n_dev, B, ks) -> (B, n_dev * ks): candidates entry-major
        gs = all_gather(mesh, parts_s)[0]
        gidx = all_gather(mesh, parts_i)[0]
        b = gs.shape[1]
        gs = gs.permute(1, 0, 2).reshape(b, -1)
        gidx = gidx.permute(1, 0, 2).reshape(b, -1)
        with device_context(mesh.devices[0]):
            ms, sel = _top_k(gs, k_final)
            return ms, gidx.gather(1, sel)

    def replicate(self, Q: np.ndarray) -> list[torch.Tensor]:
        """One copy of the host query batch per local entry."""
        q = torch.from_numpy(np.ascontiguousarray(Q, dtype=np.float32))
        return [q.to(d, non_blocking=True) for d in self.mesh.devices]


class ShardedItemScorer:
    """Row-sharded item matrix and batched exact top-N over a mesh.

    Built from an id list and a factor matrix (a MODEL publish, say);
    rows pad to a multiple of the mesh size with inactive entries, so
    every shard has the same shape."""

    def __init__(self, mesh: Mesh, ids: Sequence[str], Y: np.ndarray,
                 dtype="bfloat16"):
        if len(ids) != len(Y):
            raise ValueError("one id per row required")
        self.mesh = mesh
        self._ids = list(ids)
        n = len(self._ids)
        n_pad = pad_rows(n, mesh.size)
        self.features = int(Y.shape[1])
        dt = resolve_dtype(dtype)
        padded = torch.zeros((n_pad, device_width(self.features)),
                             dtype=dt)
        padded[:n, :self.features] = torch.from_numpy(
            np.asarray(Y, dtype=np.float32))
        active = torch.zeros(n_pad, dtype=torch.bool)
        active[:n] = True
        self._Y = shard_rows(mesh, padded)
        self._active = shard_rows(mesh, active)
        self._n_pad = n_pad
        self._kernels = ShardKernelCache(mesh)

    def __len__(self) -> int:
        return len(self._ids)

    def memory_bytes_per_device(self) -> int:
        y, a = self._Y[0], self._active[0]
        return y.numel() * y.element_size() + a.numel() * a.element_size()

    def top_n_batch(self, how_many: int,
                    queries: np.ndarray) -> list[list[tuple[str, float]]]:
        Q = np.asarray(queries, dtype=np.float32)
        if Q.ndim != 2 or Q.shape[1] != self.features:
            raise ValueError("queries must be (B, features)")
        n_req = Q.shape[0]
        if n_req == 0:
            return []
        b_pad = _pad_k(n_req)
        if b_pad != n_req:
            Q = np.concatenate(
                [Q, np.zeros((b_pad - n_req, Q.shape[1]), np.float32)])
        scores, idx = self._kernels.top_k(
            self._Y, self._active, self._kernels.replicate(Q),
            min(_pad_k(how_many), self._n_pad))
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        out: list[list[tuple[str, float]]] = []
        for b in range(n_req):
            row: list[tuple[str, float]] = []
            for s, i in zip(scores[b].tolist(), idx[b].tolist()):
                if s == _NEG_INF or len(row) == how_many:
                    break
                row.append((self._ids[i], s))
            out.append(row)
        return out
