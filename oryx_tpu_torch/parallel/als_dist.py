"""Distributed ALS: the training step over a device mesh.

Counterpart of ``oryx_tpu/parallel/als_dist.py`` (reference: Spark
MLlib's block-partitioned ALS, ALSUpdate.java:141-152).  The design is
the reference's:

 - both factor matrices are row-sharded over the mesh entries (X:
   users, Y: items), padded to a multiple of the mesh size;
 - the interactions are blocked on the host into a dense padded per-row
   layout (cols/vals/mask of shape (rows, P)), row-sharded the same way,
   so each entry solves the normal equations of its own rows with
   batched products and one batched LU (the single trainer's
   ``_normal_equations`` and ``_solve_systems``);
 - ``mode="gather"``: per half-sweep the opposite factor is gathered
   (``mesh.all_gather``) and its Gramian is the sum of the entries'
   partial Gramians (``mesh.psum``);
 - ``mode="ring"``: the opposite factor's row blocks rotate around the
   mesh (``mesh.ppermute``) while each entry accumulates the normal
   equations of the interactions whose columns live in the resident
   block, and the Gramian term by term; the full opposite factor never
   exists on any entry.

Each entry's work runs under its card
(``common/device.device_context``).  The initial item factors are the
reference's draws from ``np.random.default_rng(seed)``, so a run at the
same seed starts where the reference's does.
"""

from __future__ import annotations

import math
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..app.als.common import ParsedRatings
from ..app.als.trainer import ALSModel, _normal_equations, _solve_systems
from ..common.device import check_f32_matmul, device_context
from ..common.rand import RandomManager
from .mesh import Mesh, all_gather, pad_rows, ppermute, psum, shard_rows

__all__ = ["BlockedRatings", "block_ratings", "block_ratings_ring",
           "make_train_step", "train_als_distributed"]

# the (rows, P, k) gather of one solve chunk stays under this many
# float32 elements (256 MB)
_CHUNK_ELEMS = 1 << 26


class BlockedRatings(NamedTuple):
    """Dense padded per-row interaction blocks for both half-sweeps.

    Row counts are padded to a multiple of the mesh size; padding rows
    have all-zero masks and solve to zero vectors that are sliced away
    at the end.
    """

    n_users: int          # true (unpadded) user count
    n_items: int          # true (unpadded) item count
    u_cols: np.ndarray    # (n_users_pad, Pu) int32 item index per slot
    u_vals: np.ndarray    # (n_users_pad, Pu) float32
    u_mask: np.ndarray    # (n_users_pad, Pu) float32 1.0 at real entries
    i_cols: np.ndarray    # (n_items_pad, Pi) int32 user index per slot
    i_vals: np.ndarray    # (n_items_pad, Pi) float32
    i_mask: np.ndarray    # (n_items_pad, Pi) float32


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _dense_block(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows_pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows_pad)
    p = 1 << max(0, int(counts.max(initial=1) - 1).bit_length())
    bcols = np.zeros((n_rows_pad, p), dtype=np.int32)
    bvals = np.zeros((n_rows_pad, p), dtype=np.float32)
    bmask = np.zeros((n_rows_pad, p), dtype=np.float32)
    slot = np.concatenate([np.arange(c) for c in counts if c > 0]) \
        if len(rows) else np.zeros(0, np.int64)
    bcols[rows, slot] = cols
    bvals[rows, slot] = vals
    bmask[rows, slot] = 1.0
    return bcols, bvals, bmask


def block_ratings(ratings: ParsedRatings, n_devices: int) -> BlockedRatings:
    """The device-blocked layout of aggregated COO interactions."""
    n_users = len(ratings.user_ids)
    n_items = len(ratings.item_ids)
    nu_pad = pad_rows(n_users, n_devices)
    ni_pad = pad_rows(n_items, n_devices)
    u_cols, u_vals, u_mask = _dense_block(
        ratings.users, ratings.items, ratings.values, nu_pad)
    i_cols, i_vals, i_mask = _dense_block(
        ratings.items, ratings.users, ratings.values, ni_pad)
    return BlockedRatings(n_users, n_items,
                          u_cols, u_vals, u_mask, i_cols, i_vals, i_mask)


def _owner_block(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows_pad: int, block_rows: int, n_dev: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(row, owner-block) padded layout for the ring half-sweep:
    slot (r, b, :) holds row r's interactions whose opposite index lives
    in block b, as indices within the block.  The real slots are the
    dense layout's, so the ring touches each interaction once."""
    owner = cols // block_rows
    key = rows.astype(np.int64) * n_dev + owner
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    counts = np.bincount(key_s, minlength=n_rows_pad * n_dev)
    p = _next_pow2(max(1, int(counts.max(initial=1))))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(key_s), dtype=np.int64) - starts[key_s]
    bcols = np.zeros((n_rows_pad * n_dev, p), dtype=np.int32)
    bvals = np.zeros((n_rows_pad * n_dev, p), dtype=np.float32)
    bmask = np.zeros((n_rows_pad * n_dev, p), dtype=np.float32)
    bcols[key_s, slot] = (cols[order] - owner[order] * block_rows
                          ).astype(np.int32)
    bvals[key_s, slot] = vals[order]
    bmask[key_s, slot] = 1.0
    shape = (n_rows_pad, n_dev, p)
    return bcols.reshape(shape), bvals.reshape(shape), bmask.reshape(shape)


def block_ratings_ring(ratings: ParsedRatings,
                       n_devices: int) -> BlockedRatings:
    """The ring half-sweep's layout: the six arrays of
    :func:`block_ratings` shaped ``(rows_pad, n_dev, P_block)``; slab
    ``[:, b, :]`` holds the interactions resolved while block ``b`` of
    the opposite factor is resident."""
    n_users = len(ratings.user_ids)
    n_items = len(ratings.item_ids)
    nu_pad = pad_rows(n_users, n_devices)
    ni_pad = pad_rows(n_items, n_devices)
    u = _owner_block(ratings.users, ratings.items, ratings.values,
                     nu_pad, ni_pad // n_devices, n_devices)
    i = _owner_block(ratings.items, ratings.users, ratings.values,
                     ni_pad, nu_pad // n_devices, n_devices)
    return BlockedRatings(n_users, n_items, *u, *i)


def _chunk_rows(p: int, k: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, p * k))


def _solve_rows(opposite: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor, mask: torch.Tensor,
                G: torch.Tensor | None, lam: float, alpha: float,
                implicit: bool) -> torch.Tensor:
    """Every row's factor from the dense blocks, in row chunks that
    bound the (rows, P, k) gather."""
    k = opposite.shape[1]
    rows, p = cols.shape
    step = _chunk_rows(p, k)
    out = []
    for s in range(0, rows, step):
        c = cols[s:s + step]
        Yg = opposite.index_select(0, c.reshape(-1)).view(c.shape[0], p, k)
        A, b, n_u = _normal_equations(Yg, vals[s:s + step],
                                      mask[s:s + step], G, lam, alpha,
                                      implicit)
        out.append(_solve_systems(A, b, n_u))
    return torch.cat(out)


def make_train_step(mesh: Mesh, lam: float, alpha: float, implicit: bool,
                    mode: str = "gather"):
    """The distributed step: ``step(X, Y, u_cols, u_vals, u_mask, i_cols,
    i_vals, i_mask) -> (X', Y')``, each argument one tensor per local
    entry (``mesh.shard_rows``): blocks from :func:`block_ratings` for
    ``mode="gather"``, from :func:`block_ratings_ring` for
    ``mode="ring"``."""
    n_dev = mesh.size
    devs = mesh.devices

    def _half_gather(opposite, cols, vals, mask):
        full = all_gather(mesh, opposite)
        g_parts = []
        for d, o in zip(devs, opposite):
            with device_context(d):
                g_parts.append(o.T @ o)
        G = psum(mesh, g_parts)
        out = []
        for e, d in enumerate(devs):
            with device_context(d):
                out.append(_solve_rows(full[e], cols[e], vals[e], mask[e],
                                       G[e] if implicit else None, lam,
                                       alpha, implicit))
        return out

    def _half_ring(opposite, cols_b, vals_b, mask_b):
        k = opposite[0].shape[1]
        A, b, G = [], [], []
        for e, d in enumerate(devs):
            rows = cols_b[e].shape[0]
            A.append(torch.zeros((rows, k, k), dtype=torch.float32,
                                 device=d))
            b.append(torch.zeros((rows, k), dtype=torch.float32, device=d))
            G.append(torch.zeros((k, k), dtype=torch.float32, device=d))
        block = list(opposite)
        for t in range(n_dev):
            for e, d in enumerate(devs):
                # global entry g holds block (g - t) mod n at hop t
                j = (mesh.first_entry + e - t) % n_dev
                with device_context(d):
                    c, v, m = cols_b[e][:, j], vals_b[e][:, j], \
                        mask_b[e][:, j]
                    step = _chunk_rows(c.shape[1], k)
                    for s in range(0, c.shape[0], step):
                        cc = c[s:s + step]
                        Yg = block[e].index_select(0, cc.reshape(-1)).view(
                            cc.shape[0], cc.shape[1], k)
                        mm, vv = m[s:s + step], v[s:s + step]
                        if implicit:
                            w = alpha * vv.abs() * mm
                            tt = (1.0 + w) * (vv > 0.0)
                        else:
                            w, tt = mm, vv * mm
                        A[e][s:s + step] += torch.bmm(
                            (Yg * w[:, :, None]).transpose(1, 2), Yg)
                        b[e][s:s + step] += torch.bmm(
                            Yg.transpose(1, 2), tt[:, :, None])[..., 0]
                    if implicit:
                        # block j's Gramian term, while block j is here
                        G[e] += block[e].T @ block[e]
            if t < n_dev - 1:
                block = ppermute(mesh, block)
        out = []
        for e, d in enumerate(devs):
            with device_context(d):
                n_u = mask_b[e].sum(dim=(1, 2))
                AA = A[e] + G[e][None] if implicit else A[e]
                AA = AA + (lam * torch.clamp(n_u, min=1.0))[:, None, None] \
                    * torch.eye(k, dtype=AA.dtype, device=d)[None]
                out.append(_solve_systems(AA, b[e], n_u))
        return out

    half = {"gather": _half_gather, "ring": _half_ring}[mode]

    def step(X, Y, u_cols, u_vals, u_mask, i_cols, i_vals, i_mask):
        X = half(Y, u_cols, u_vals, u_mask)
        Y = half(X, i_cols, i_vals, i_mask)
        return X, Y

    return step


def _host_rows(mesh: Mesh, blocks) -> np.ndarray:
    """The global array of the entries' row blocks, on the host."""
    return all_gather(mesh, blocks)[0].cpu().numpy()


def train_als_distributed(ratings: ParsedRatings, features: int, lam: float,
                          alpha: float, implicit: bool, iterations: int,
                          mesh: Mesh, seed: int | None = None,
                          mode: str = "auto") -> ALSModel:
    """The whole distributed ALS loop; returns host factors.

    ``mode``: "gather" (all-gather and psum), "ring" (the ppermute ring
    with the Gramian folded into the hops), or "auto" = ring exactly
    when the mesh spans processes (reference ``als_dist.py:284-286``)."""
    for d in mesh.devices:
        check_f32_matmul(d)
    n_dev = mesh.size
    k = features
    if mode == "auto":
        mode = "ring" if mesh.process_count > 1 else "gather"
    if len(ratings.user_ids) == 0 or len(ratings.item_ids) == 0:
        return ALSModel(ratings.user_ids, ratings.item_ids,
                        np.zeros((0, k), np.float32),
                        np.zeros((0, k), np.float32))
    blocks = (block_ratings_ring(ratings, n_dev) if mode == "ring"
              else block_ratings(ratings, n_dev))
    if seed is None:
        if mesh.process_count > 1:
            # every process must start from the same factors: derive
            # the seed from the (identical by contract) input
            seed = zlib.crc32(np.ascontiguousarray(
                ratings.values).tobytes()) & 0x7FFFFFFF
        else:
            seed = RandomManager.random_seed()
    rng = np.random.default_rng(seed)
    Y0 = (rng.standard_normal((blocks.i_cols.shape[0], k))
          / math.sqrt(k)).astype(np.float32)
    Y0[blocks.n_items:] = 0.0  # padding rows must not leak into the Gramian
    X0 = np.zeros((blocks.u_cols.shape[0], k), dtype=np.float32)

    X, Y = shard_rows(mesh, X0), shard_rows(mesh, Y0)
    args = [shard_rows(mesh, a, torch.int64 if a.dtype == np.int32 else None)
            for a in (blocks.u_cols, blocks.u_vals, blocks.u_mask,
                      blocks.i_cols, blocks.i_vals, blocks.i_mask)]
    step = make_train_step(mesh, lam, alpha, implicit, mode=mode)
    for _ in range(iterations):
        X, Y = step(X, Y, *args)
    Xh = _host_rows(mesh, X)[:blocks.n_users]
    Yh = _host_rows(mesh, Y)[:blocks.n_items]
    return ALSModel(ratings.user_ids, ratings.item_ids, Xh, Yh)
