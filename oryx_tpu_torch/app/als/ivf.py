"""IVF serving index: a coarse centroid partition of the item matrix and
int8 bounds over the ``nprobe`` nearest cells only.

Counterpart of ``oryx_tpu/app/als/ivf.py``.  A k-means coarse quantizer
(``ops/ann.py``) partitions the catalog into cells; the items are laid
out cell-contiguously in an int8 mirror, quantized per 128-row block by
the same quantizer as the "i8" kind; a query scores only the blocks of
its ``nprobe`` cells of highest inner product with it, so it reads about
``nprobe / cells`` of the catalog.  The integer block maxima become
sound upper bounds by the int8 kind's algebra, selection runs on the
bounds, and phase B rescores the selected rows from the exact store
under the ``kth >= max(unselected bound)`` certificate.  What the
certificate cannot see is the cells left unprobed: that approximation
is measured instead (``measure_recall``, recall@N against the exact
kernel on sampled queries) at every generation load, and the router
refuses the "ivf" kind below ``oryx.als.ann.min-recall``.

The probe computes the integer maxima of the probed (query, block)
pairs only: the reference pads every cell's block list to ``bpc`` (the
power of two at or above the largest cell's block count) with an
always-empty sentinel block and scores those too; here the sentinel's
pairs take the penalty value directly, which is what scoring its empty
rows gives.  The int8 products are taken in float32 (PyTorch has no
int8 batched product on CUDA): every sum is an integer below 2^24 in
magnitude, so exact, and the maxima equal the reference's int32 ones.

Determinism: centroid training is seeded, ties in the assignment go to
the lowest cell, and the layout uses a stable sort, so a generation
always builds the same index.  With ``nprobe == cells`` every block is
probed and the answers are the exact kernel's.

The trainer may publish the index with the sliced artifacts
(``slices.publish_sliced(..., ann=)``): the centroids once per
generation and each slice's cell assignments beside its factors.  A
corrupt or missing index artifact (chaos point ``ann-index-corrupt``)
fails closed to the exact kinds with the ``ann_index_fallbacks``
counter.
"""

from __future__ import annotations

import gzip
import io
import json
import logging
import math
import zlib

import numpy as np
import torch

from ...common import store
from ...ops import ann as ops_ann
from ...resilience.faults import fire as _fault

_log = logging.getLogger(__name__)

__all__ = [
    "AnnConfig", "AnnState", "AnnIndexError", "IVFMirror",
    "build_mirror", "batch_top_n_ivf", "ivf_probe", "ivf_phase_b",
    "measure_recall", "mirror_shapes",
    "publish_centroids", "read_centroids", "read_slice_cells",
    "train_generation_centroids", "CENTROIDS_FILE",
]

CENTROIDS_FILE = "ann-centroids.json.gz"
# elements of the float32 copy of the gathered int8 blocks per probe
# step: bounds the probe's temporary
_PROBE_CHUNK_ELEMS = 1 << 26
# seeds: an index build is a function of the generation only
_TRAIN_SEED = 13
_RECALL_SEED = 29


class AnnIndexError(Exception):
    """A per-slice ANN index artifact is missing or corrupt, or the index
    build failed: the caller fails closed to the exact kinds and counts
    ``ann_index_fallbacks``."""


class AnnConfig:
    """The parsed ``oryx.als.ann.*`` block, validated at boot."""

    def __init__(self, enabled: bool, cells: int, nprobe: int,
                 min_recall: float, recall_at: int, recall_queries: int,
                 train_sample: int, train_iterations: int):
        if cells < 2:
            raise ValueError("oryx.als.ann.cells must be >= 2")
        if not 1 <= nprobe <= cells:
            raise ValueError("oryx.als.ann.nprobe must be in [1, cells]")
        if not 0.0 <= min_recall <= 1.0:
            raise ValueError("oryx.als.ann.min-recall must be in [0, 1]")
        if recall_at < 1 or recall_queries < 1:
            raise ValueError("oryx.als.ann recall-at and recall-queries "
                             "must be >= 1")
        if train_sample < cells or train_iterations < 1:
            raise ValueError("oryx.als.ann train-sample must be >= cells "
                             "and train-iterations >= 1")
        self.enabled = enabled
        self.cells = int(cells)
        self.nprobe = int(nprobe)
        self.min_recall = float(min_recall)
        self.recall_at = int(recall_at)
        self.recall_queries = int(recall_queries)
        self.train_sample = int(train_sample)
        self.train_iterations = int(train_iterations)

    @classmethod
    def from_config(cls, config) -> "AnnConfig":
        return cls(
            enabled=config.get_bool("oryx.als.ann.enabled"),
            cells=config.get_int("oryx.als.ann.cells"),
            nprobe=config.get_int("oryx.als.ann.nprobe"),
            min_recall=config.get_double("oryx.als.ann.min-recall"),
            recall_at=config.get_int("oryx.als.ann.recall-at"),
            recall_queries=config.get_int("oryx.als.ann.recall-queries"),
            train_sample=config.get_int("oryx.als.ann.train-sample"),
            train_iterations=config.get_int(
                "oryx.als.ann.train-iterations"))

    def route_key(self) -> tuple:
        """The ANN half of the route's re-measure key: a route measured
        under one ANN shape is stale under another."""
        return (self.enabled, self.cells, self.nprobe, self.min_recall)


class AnnState:
    """A generation's ANN state on the serving model: the centroids
    (small; they survive mirror eviction), an optional published
    assignment, and the recall certificate.  The device mirror lives in
    the model's version-keyed cache."""

    def __init__(self, cfg: AnnConfig, centroids: np.ndarray,
                 cells: np.ndarray | None = None):
        self.cfg = cfg
        self.centroids = np.asarray(centroids, dtype=np.float32)
        # the published assignment in the store's row order, consumed by
        # the first mirror build only; later builds assign on the device
        # (same centroids, same tie-break: same cells)
        self.cells = cells
        self.recall: float | None = None
        self.index_bytes: int = 0


# -- index layout -------------------------------------------------------------

def mirror_shapes(n_rows: int, ncells: int, bs: int) -> dict:
    """Padded layout for an ``n_rows``-capacity store and ``ncells``
    cells: every cell's rows pad to whole ``bs`` blocks (at most one
    part-empty block per cell), plus one always-empty sentinel block
    that the probe table's padding points at."""
    n_blocks = n_rows // bs + ncells + 1
    return {"blocks": n_blocks, "rows": n_blocks * bs}


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class IVFMirror:
    """The device-resident IVF mirror of one Y snapshot version."""

    def __init__(self, y8p, sy_b, l1y_b, pen_i, activep, perm, cents,
                 cell_blocks, index_bytes: int):
        self.y8p = y8p                  # (Npad, W) int8, cell-contiguous
        self.sy_b = sy_b                # (nb,) f32 per-block scale
        self.l1y_b = l1y_b              # (nb,) f32 per-block max row L1
        self.pen_i = pen_i              # (nb, bs) int32 retired-row mask
        self.activep = activep          # (Npad,) bool
        self.perm = perm                # (Npad,) int32 -> original row
        self.cents = cents              # (C, W) f32 column-padded centroids
        self.cell_blocks = cell_blocks  # (C, bpc) int32 block table
        self.index_bytes = index_bytes


def _permute_kernel(vecs, active, perm, valid):
    """Cell-contiguous permutation of the store snapshot: empty slots
    (``valid`` False) become exact-zero rows, so the per-block scales and
    L1 norms see no garbage, and are not active."""
    idx = perm.to(torch.int64)
    yp = vecs[idx].masked_fill(~valid[:, None], 0)
    ap = active[idx] & valid
    return yp, ap


def build_mirror(vecs, active, state: AnnState, bs: int,
                 cells: np.ndarray | None = None) -> IVFMirror:
    """The device mirror of the live snapshot: assign every row to its
    nearest centroid (or take a published assignment), lay the rows out
    cell-contiguously in whole ``bs`` blocks, and quantize the permuted
    matrix with the quantizer of the "i8" kind, so the bound algebra is
    the same."""
    from . import serving_model as sm

    n_rows, width = int(vecs.shape[0]), int(vecs.shape[1])
    ncells = int(state.centroids.shape[0])
    if n_rows % bs:
        raise AnnIndexError(f"store capacity {n_rows} not divisible by "
                            f"the {bs}-row block size")
    if cells is None:
        cells = ops_ann.assign_cells(vecs, state.centroids)
    cells = np.asarray(cells, dtype=np.int64)
    if cells.shape != (n_rows,) or cells.min(initial=0) < 0 \
            or cells.max(initial=0) >= ncells:
        raise AnnIndexError("cell assignment does not match the store")
    shapes = mirror_shapes(n_rows, ncells, bs)
    n_blocks, n_pad = shapes["blocks"], shapes["rows"]
    counts = np.bincount(cells, minlength=ncells)
    nblocks_c = -(-counts // bs)  # ceil; an empty cell owns no block
    if int(nblocks_c.sum()) > n_blocks - 1:
        raise AnnIndexError("cell layout overflow")  # cannot happen
    order = np.argsort(cells, kind="stable")
    # cell c's rows occupy blocks [starts[c], starts[c] + nblocks_c[c])
    starts = np.zeros(ncells, dtype=np.int64)
    np.cumsum(nblocks_c[:-1], out=starts[1:])
    perm = np.zeros(n_pad, dtype=np.int32)
    valid = np.zeros(n_pad, dtype=bool)
    offsets = np.arange(n_rows) - np.repeat(
        np.cumsum(np.concatenate(([0], counts[:-1]))), counts)
    slots = np.repeat(starts * bs, counts) + offsets
    perm[slots] = order
    valid[slots] = True
    bpc = _pow2_ceil(max(1, int(nblocks_c.max(initial=1))))
    cell_blocks = np.full((ncells, bpc), n_blocks - 1, dtype=np.int32)
    for c in range(ncells):
        nb = int(nblocks_c[c])
        if nb:
            cell_blocks[c, :nb] = np.arange(starts[c], starts[c] + nb)
    # column-pad the centroids once, so query-cell products and row
    # assignment see the same zero-padded geometry
    cents = np.zeros((ncells, width), dtype=np.float32)
    cents[:, :state.centroids.shape[1]] = state.centroids
    dev = vecs.device
    permd = torch.from_numpy(perm).to(dev)
    yp, ap = _permute_kernel(vecs, active, permd,
                             torch.from_numpy(valid).to(dev))
    y8p, sy_b, l1y_b = sm._quantize_items_kernel(yp, bs)
    pen_i = sm._penalty_kernel_i32(ap, bs)
    del yp  # the permuted float copy is an intermediate only
    arrays = (y8p, sy_b, l1y_b, pen_i, ap, permd)
    index_bytes = sum(a.numel() * a.element_size() for a in arrays) \
        + cents.nbytes + cell_blocks.nbytes
    return IVFMirror(y8p, sy_b, l1y_b, pen_i, ap, permd,
                     torch.from_numpy(cents).to(dev),
                     torch.from_numpy(cell_blocks).to(dev),
                     int(index_bytes))


# -- the probe ----------------------------------------------------------------

def _probe_maxima(q8, y8p, pen_i, bi, bs: int, sentinel: int):
    """(B, P) int32 maxima of ``q8 . y8 + penalty`` over the rows of each
    probed block ``bi`` (B, P).  Only real blocks are scored, in chunks
    of (query, block) pairs; a sentinel slot takes the penalty, the
    maximum of its empty rows."""
    from .serving_model import _I8_PENALTY

    b, p = bi.shape
    width = int(y8p.shape[1])
    y8r = y8p.view(-1, bs, width)
    flat = bi.reshape(-1)
    m = torch.full((b * p,), _I8_PENALTY, dtype=torch.int32,
                   device=bi.device)
    real = torch.nonzero(flat != sentinel).squeeze(1)
    q8f = q8.to(torch.float32)
    step = max(1, _PROBE_CHUNK_ELEMS // (bs * width))
    for s in range(0, int(real.shape[0]), step):
        pos = real[s:s + step]
        blk = flat[pos]
        y = y8r[blk].to(torch.float32)                      # (c, bs, W)
        prod = torch.bmm(y, q8f[pos // p][:, :, None])[:, :, 0]
        m[pos] = (prod.to(torch.int32) + pen_i[blk]).amax(1)
    return m.view(b, p)


def ivf_probe(Y, Q, mirror: IVFMirror, bs: int, nprobe: int):
    """The IVF phase A: the ``nprobe`` cells of highest inner product with
    each query and sound upper bounds on the maxima of their blocks.
    Returns (Qc, bi, bound): the query cast to the store, the probed
    block ids (B, nprobe * bpc) and their bounds (-inf for the sentinel
    and retired blocks)."""
    from .serving_model import (_I8_PENALTY, _INV_127, _NEG_INF, _l1_rows,
                                _q_cast, _top_k)

    b = Q.shape[0]
    width = int(mirror.y8p.shape[1])
    n_blocks = int(mirror.y8p.shape[0]) // bs
    Qc = _q_cast(Q, Y)
    Qf = Qc.to(torch.float32)
    mag = Qf.abs()
    # the reference writes "/ 127.0"; its compiler forms the product with
    # f32(1/127), and so does this
    sq = mag.amax(1).clamp_min(1e-30) * _INV_127
    q8 = torch.clamp(torch.round(Qf / sq[:, None]), -127, 127).to(
        torch.int8)
    l1q = _l1_rows(mag)
    # probe by INNER PRODUCT with the query, the score's own metric, not
    # by the euclidean distance the rows were assigned with: the
    # euclidean order's -||c||^2 term ranks down the high-norm cells
    # whose items lead a dot-product top-k
    _, probe_cells = _top_k(Qf @ mirror.cents.T, nprobe)      # (B, nprobe)
    bi = mirror.cell_blocks[probe_cells].reshape(b, -1).to(torch.int64)
    m_int = _probe_maxima(q8, mirror.y8p, mirror.pen_i, bi, bs,
                          n_blocks - 1)
    # the int8 kind's sound upper bound on each probed block's maximum
    syg = mirror.sy_b[bi]
    l1g = mirror.l1y_b[bi]
    s = sq[:, None]
    bound = (m_int.to(torch.float32) * syg * s
             + 0.5 * s * l1g
             + 0.5 * syg * l1q[:, None]
             + 0.25 * width * syg * s)
    masked = m_int <= _I8_PENALTY // 2
    bound = torch.where(masked | (l1q[:, None] == 0.0), _NEG_INF, bound)
    return Qc, bi, bound


def ivf_phase_b(Y, Qc, mirror: IVFMirror, bi, bound, k: int, bs: int,
                ksel: int):
    """The IVF phase B: select the ``ksel`` probed blocks of highest
    bound, rescore their rows exactly from the original store and emit
    top-k with the ``kth >= max(unselected bound)`` certificate.
    Returned indices are original rows."""
    from .serving_model import _NEG_INF, _top_k

    b = Qc.shape[0]
    _, pi = _top_k(bound, ksel)
    m_rest = bound.scatter(1, pi, _NEG_INF).amax(-1)
    m_guard = torch.where(torch.isfinite(m_rest),
                          m_rest + m_rest.abs() * 1e-4, m_rest)
    bi_sel = bi.gather(1, pi)                                 # (B, ksel)
    rows_p = (bi_sel[:, :, None] * bs
              + torch.arange(bs, device=bi.device)[None, None, :]
              ).reshape(b, ksel * bs)
    orig = mirror.perm[rows_p].to(torch.int64)                # (B, R)
    ok = mirror.activep[rows_p]
    scores = torch.bmm(Y[orig].to(torch.float32),
                       Qc.to(torch.float32)[:, :, None])[:, :, 0]
    scores = torch.where(ok, scores, _NEG_INF)
    ts, ti = _top_k(scores, k)
    idx = orig.gather(1, ti)
    cert = ts[:, k - 1] >= m_guard
    return ts, idx, cert


def batch_top_n_ivf(mirror: IVFMirror, Y, Q, k: int, bs: int, ksel: int,
                    nprobe: int):
    """One window through the IVF index (the reference's
    ``_ivf_top_n_kernel``): ``ivf_probe``, then ``ivf_phase_b``; rows
    outside the probed cells are no candidates (the recall certificate
    measured that pruning at the generation load).  ``ksel`` widens as the int8
    kind's does (selection runs on inflated bounds) and is clamped to the
    probe set; a probe set too small to hold ``k`` rows raises."""
    bpc = int(mirror.cell_blocks.shape[1])
    nprobe = min(nprobe, int(mirror.cell_blocks.shape[0]))
    p = nprobe * bpc
    ksel = max(ksel, -(-k // bs))
    ksel = min(ksel, p)
    if ksel * bs < k:
        raise AnnIndexError(f"probe set of {p} blocks cannot hold top-{k}")
    Qc, bi, bound = ivf_probe(Y, Q, mirror, bs, nprobe)
    return ivf_phase_b(Y, Qc, mirror, bi, bound, k, bs, ksel)


# -- recall certificate -------------------------------------------------------

def measure_recall(model, mirror: IVFMirror, cfg: AnnConfig) -> float:
    """recall@N of the IVF path against the exact kernel on sampled
    queries: the generation's certificate.  The queries are user factors
    of the generation where it has any, topped up with seeded standard
    normals; both paths run on the live device snapshot, so the
    measurement covers the quantizer, the layout and the pruning."""
    from . import serving_model as sm

    vecs, active, _version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    k = min(cfg.recall_at, max(1, len(model.Y)))
    rng = np.random.default_rng(_RECALL_SEED)
    qs: list[np.ndarray] = []
    if len(model.X):
        xv, xa, _ids = model.X.host_arrays()
        user_rows = xv[xa]
        if len(user_rows):
            take = min(cfg.recall_queries, len(user_rows))
            qs.append(np.asarray(
                user_rows[rng.permutation(len(user_rows))[:take],
                          :model.features], dtype=np.float32))
    short = cfg.recall_queries - sum(len(q) for q in qs)
    if short > 0:
        qs.append(rng.standard_normal(
            (short, model.features)).astype(np.float32))
    Q = np.concatenate(qs)
    Qd = torch.from_numpy(Q).to(vecs.device)
    big, chunk = sm._stream_plan(n_rows, len(Q))
    if big and n_rows % chunk == 0 and k <= chunk:
        ex_s, ex_i = sm._fetch(*sm._batch_top_n_chunked_kernel(
            vecs, Qd, active, None, None, k, chunk, 0))
    else:
        ex_s, ex_i = sm._fetch(*sm._batch_top_n_kernel(vecs, Qd, active, k))
    bs = sm._BLOCK_ROWS
    ksel = sm._i8_ksel(min(sm._BLOCK_KSEL, n_rows // bs), n_rows, bs)
    an_s, an_i, _cert = sm._fetch(*batch_top_n_ivf(
        mirror, vecs, Qd, k, bs, ksel, cfg.nprobe))
    hits = total = 0
    for b in range(len(Q)):
        truth = {int(i) for s, i in zip(ex_s[b], ex_i[b])
                 if math.isfinite(s)}
        if not truth:
            continue
        got = {int(i) for s, i in zip(an_s[b], an_i[b])
               if math.isfinite(s)}
        hits += len(truth & got)
        total += len(truth)
    return 1.0 if total == 0 else hits / total


# -- per-slice index artifacts ------------------------------------------------

def publish_centroids(model_dir: str, centroids: np.ndarray) -> dict:
    """Write the generation's centroid artifact (deterministic gzip, as
    every slice artifact) and return its manifest entry."""
    c64 = np.round(np.asarray(centroids, dtype=np.float32)
                   .astype(np.float64), 8)
    payload = _gzip_bytes(json.dumps(
        {"cells": int(c64.shape[0]), "features": int(c64.shape[1]),
         "centroids": c64.tolist()}, separators=(",", ":")))
    with store.open_write(store.join(model_dir, CENTROIDS_FILE)) as f:
        f.write(payload)
    return {"path": CENTROIDS_FILE, "bytes": len(payload),
            "crc32": zlib.crc32(payload), "cells": int(c64.shape[0])}


def _gzip_bytes(text: str) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
        gz.write(text.encode("utf-8"))
    return buf.getvalue()


def _read_checked_ann(model_dir: str, entry: dict) -> bytes:
    """Checksum-verified ANN artifact bytes.  The chaos point
    ``ann-index-corrupt`` stands for a corrupt or missing artifact: the
    manager fails closed to the exact kinds with ``ann_index_fallbacks``."""
    _fault("ann-index-corrupt", error=lambda: AnnIndexError(
        f"injected corrupt ANN index artifact at {entry.get('path')}"))
    path = store.join(model_dir, entry["path"])
    try:
        with store.open_read(path) as f:
            payload = f.read()
    except OSError as e:
        raise AnnIndexError(f"unreadable ANN artifact {path}: {e}") from e
    if zlib.crc32(payload) != int(entry["crc32"]):
        raise AnnIndexError(f"checksum mismatch for {path}")
    return payload


def read_centroids(model_dir: str, entry: dict) -> np.ndarray:
    try:
        with gzip.open(io.BytesIO(_read_checked_ann(model_dir, entry)),
                       "rt", encoding="utf-8") as f:
            doc = json.load(f)
        c = np.asarray(doc["centroids"], dtype=np.float32)
        if c.shape != (int(doc["cells"]), int(doc["features"])) \
                or not np.isfinite(c).all():
            raise ValueError(f"bad centroid shape {c.shape}")
    except AnnIndexError:
        raise
    except (OSError, EOFError, ValueError, KeyError, TypeError) as e:
        raise AnnIndexError(f"undecodable centroid artifact: {e}") from e
    return c


def read_slice_cells(model_dir: str, entry: dict) -> list[int]:
    """One slice's cell assignments, in the slice artifact's row order."""
    try:
        with gzip.open(io.BytesIO(_read_checked_ann(model_dir, entry)),
                       "rt", encoding="utf-8") as f:
            cells = json.load(f)
        if not isinstance(cells, list) \
                or len(cells) != int(entry["rows"]):
            raise ValueError(
                f"{len(cells)} cells, manifest says {entry['rows']}")
    except AnnIndexError:
        raise
    except (OSError, EOFError, ValueError, KeyError, TypeError) as e:
        raise AnnIndexError(f"undecodable cell artifact: {e}") from e
    return [int(c) for c in cells]


def train_generation_centroids(Y, cfg: AnnConfig, device=None) -> np.ndarray:
    """The generation's coarse quantizer: k-means over a seeded sample of
    the item factors on ``device`` (None means ``cuda``); the same
    factors give the same centroids."""
    Y = np.asarray(Y, dtype=np.float32)
    rng = np.random.default_rng(_TRAIN_SEED)
    sample = Y if len(Y) <= cfg.train_sample else \
        Y[rng.permutation(len(Y))[:cfg.train_sample]]
    return ops_ann.train_centroids(sample, cfg.cells,
                                   cfg.train_iterations, _TRAIN_SEED,
                                   device=device)
