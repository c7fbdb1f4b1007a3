"""The ALS serving model: factor matrices in device memory, top-N on the
device.

Counterpart of ``oryx_tpu/app/als/serving_model.py`` (reference:
ALSServingModel.java:57-422, TopNConsumer.java:30).  The whole item
matrix lives in one device tensor beside per-item LSH bucket ids; top-N
over a small catalogue is

    scores = Q @ Yᵀ;  scores = where(active & lsh_mask, scores, -inf);  top_k

and over a large one the two-phase streaming top-k: phase A reduces
Q·Yᵀ to the maximum of every 128-row block, phase B rescores the best
blocks exactly and emits an exactness certificate, and a row whose
certificate fails is recomputed on the exact chunked scan.  Phase A has
the reference's kinds, each a hand-written kernel: "pallas" over the
store (``ops/phase_a.py``), "fold" over a folded mirror of a narrow store
(``ops/phase_a_fold.py``), "i8" over an int8 mirror with one scale per
block (``ops/phase_a_i8.py``) and "i8_fold" over the folded int8 mirror
(``ops/phase_a_i8_fold.py``); the int8 kinds turn their integer maxima
into sound float32 upper bounds before phase B.  "ivf" scores only the
blocks of each query's nearest cells of an IVF index (``ivf.py``, plain
PyTorch), and serves only while its measured recall certificate holds.
"scan" is the plain PyTorch build.

``top_n`` scores by dot product with one user vector or by mean cosine
similarity to a set of item vectors (``/similarity``).  Known items keep
an incremental per-item popularity counter.

Every top-k here has ``jax.lax.top_k``'s contract — descending, equal
values in ascending index order — so ids come out in the reference's
order, ties included (``torch.topk`` promises no order among ties).
The reference's ``approx_max_k`` block selection is an exact top-k here.

Float32 products run in full float32: on a CUDA device the scoring
paths refuse to run while ``torch.backends.cuda.matmul.allow_tf32`` is
set, because TF32 rounding in phase B or the flat path would break the
certificate's margin and change answers.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ...api.serving import ServingModel
from ...common.device import check_f32_matmul as _check_f32_matmul
from ...common.lang import AutoReadWriteLock
from ...ops.phase_a import MAX_WIDTH as PHASE_A_MAX_WIDTH
from ...ops.phase_a import phase_a
from ...ops.phase_a_fold import phase_a_fold
from ...ops.phase_a_i8 import I8_PENALTY as _I8_PENALTY
from ...ops.phase_a_i8 import phase_a_i8
from ...ops.phase_a_i8_fold import phase_a_i8_fold
from .factor_model import FactorModelBase
from .lsh import LocalitySensitiveHash, _bucket_kernel, _popcount
from .rescorer import Rescorer

__all__ = ["ALSServingModel"]

_log = logging.getLogger(__name__)

_NEG_INF = float("-inf")


def _pad_k(k: int) -> int:
    """Round requested top-N size up to a power of two, as the reference
    does for its compiled shapes; the window size decides when a host
    fallback is needed, so it must match."""
    return 1 << max(3, (k - 1).bit_length())


# Above this many bytes of (B, N) score matrix the batched path streams
# the item matrix in row chunks instead of materializing all scores.
# Chunk rows stay a power of two <= feature_vectors._LARGE_ALIGN so
# every store capacity divides evenly.
_FLAT_SCORES_LIMIT = 1 << 30
_MAX_CHUNK_ROWS = 1 << 17

# The streaming path pads every request batch to a window of the ladder
# and splits bigger drains into full windows.
_CHUNKED_BATCH = 256
_WINDOW_LADDER = (8, 32, 256)

# rows per float32 matmul when a bf16 store is widened for scoring:
# bounds the float32 copy
_WIDEN_CHUNK_ROWS = 1 << 20


def _window_sizes(n: int) -> list[int]:
    """Window shapes covering an ``n``-query drain: full windows plus one
    ladder window that fits the tail."""
    out = [_CHUNKED_BATCH] * (n // _CHUNKED_BATCH)
    tail = n % _CHUNKED_BATCH
    if tail:
        out.append(next(w for w in _WINDOW_LADDER if w >= tail))
    return out


def _q_cast(Q: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Match the query operand to a stored factor matrix: zero-pad its
    columns to the snapshot's padded width (every dot product stays
    bit-identical: 0-column contributions are exactly 0) and cast it to
    bfloat16 for a bf16 store, so products are bf16 x bf16 as on the
    reference."""
    fp = Y.shape[-1]
    if Q.shape[-1] != fp:
        Q = torch.nn.functional.pad(Q, (0, fp - Q.shape[-1]))
    return Q.to(Y.dtype) if Y.dtype == torch.bfloat16 else Q


def _scores(Qc: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(B, N) float32 ``Qc @ Yᵀ`` with float32 accumulation.  A bf16
    store is widened to float32 in row chunks (exact, so the products
    are the bf16 x bf16 products) — ``torch.matmul`` on bf16 would round
    its output to bf16."""
    q = Qc.to(torch.float32)
    if Y.dtype == torch.float32:
        return q @ Y.T
    return torch.cat([q @ Y[s:s + _WIDEN_CHUNK_ROWS].to(torch.float32).T
                      for s in range(0, Y.shape[0], _WIDEN_CHUNK_ROWS)],
                     dim=1)


def _dot_scores(Y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _scores(_q_cast(x[None, :], Y), Y)[0]


def _cosine_mean_scores(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(N,) mean cosine similarity of each row of Y to the column vectors
    of the (features, m) V (reference: CosineAverageFunction.java:25).
    V's rows are zero-padded to a lane-padded store's width; the rows of
    Y widen to float32 in chunks, so a bf16 store's norms accumulate in
    float32 as its dot products do."""
    if V.shape[0] != Y.shape[1]:
        V = torch.nn.functional.pad(V, (0, 0, 0, Y.shape[1] - V.shape[0]))
    v_norm = torch.linalg.norm(V, dim=0, keepdim=True)
    out = []
    for s in range(0, Y.shape[0], _WIDEN_CHUNK_ROWS):
        y = Y[s:s + _WIDEN_CHUNK_ROWS].to(torch.float32)
        y_norm = torch.linalg.norm(y, dim=1, keepdim=True)
        denom = torch.clamp(y_norm * v_norm, min=1e-12)
        out.append(torch.mean((y @ V) / denom, dim=1))
    return torch.cat(out)


def _lsh_ok(ok, buckets, target, max_bits: int):
    """Fuse the LSH Hamming-ball candidate test into a mask: ok AND
    popcount(bucket XOR target) <= max_bits — the one definition every
    scoring path shares, so phase A and phase B agree on the candidate
    set."""
    return ok & (_popcount(torch.bitwise_xor(buckets, target)) <= max_bits)


def _query_buckets(Q: torch.Tensor, hyperplanes: torch.Tensor):
    """LSH bucket id per query row, on the device, by the same kernel
    that bucketed the items."""
    return _bucket_kernel(Q, hyperplanes, int(hyperplanes.shape[0]))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the ``k`` largest values,
    descending, equal values in ascending index order.

    ``torch.topk`` finds the set; when values equal to the k-th one were
    left out, which of them belong is decided by index, so those rows
    take a stable full sort instead."""
    n = x.shape[-1]
    if k >= n:
        return torch.sort(x, dim=-1, descending=True, stable=True)
    vals, idx = torch.topk(x, k, dim=-1)
    kth = vals[..., -1:]
    if bool(((x == kth).sum(-1) == (vals == kth).sum(-1)).all()):
        idx, perm = idx.sort(dim=-1)
        vals, perm = vals.gather(-1, perm).sort(dim=-1, descending=True,
                                                stable=True)
        return vals, idx.gather(-1, perm)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _batch_top_n_kernel(Y, Q, active, k: int):
    """Score a whole request batch at once: masked top-k per row of
    ``Q @ Yᵀ`` (the request batcher's flat path)."""
    scores = _scores(_q_cast(Q, Y), Y)
    return _top_k(torch.where(active[None, :], scores, _NEG_INF), k)


def _batch_top_n_lsh_kernel(Y, Q, active, buckets, hyperplanes, k: int,
                            max_bits: int):
    """Batched top-k with the LSH Hamming-ball candidate mask fused in;
    each query's target bucket is computed on the device."""
    target = _query_buckets(Q, hyperplanes)
    scores = _scores(_q_cast(Q, Y), Y)
    ok = _lsh_ok(active[None, :], buckets[None, :], target[:, None],
                 max_bits)
    return _top_k(torch.where(ok, scores, _NEG_INF), k)


def _stream_plan(n_rows: int, b_pad: int) -> tuple[bool, int]:
    """(use_streaming_path, chunk_rows) for a batch of ``b_pad`` queries
    over ``n_rows`` items: stream whenever the item matrix is big."""
    chunk = _MAX_CHUNK_ROWS
    while chunk > 1024 and _CHUNKED_BATCH * chunk * 4 > _FLAT_SCORES_LIMIT:
        chunk //= 2
    big = (n_rows > (1 << 19)
           or b_pad * n_rows * 4 > _FLAT_SCORES_LIMIT)
    return big, chunk


# Two-phase streaming top-k: rows per block maximum, and blocks rescored
# exactly per query in phase B.
_BLOCK_ROWS = 128
_BLOCK_KSEL = 32


def _phase_b(Y, Qc, active, buckets, target, M, k: int, bs: int,
             ksel: int, max_bits: int):
    """Phase B shared by every phase-A build: pick the ``ksel`` best
    ``bs``-row blocks per query from the block maxima ``M`` (B, N // bs),
    exactly rescore the gathered rows, and emit top-k plus the exactness
    certificate kth_score >= max(unselected block maxima)."""
    b, f = Qc.shape
    _, bi = _top_k(M, ksel)
    m_rest = M.scatter(1, bi, _NEG_INF).amax(-1)
    # gathered blocks stay in the store dtype and widen exactly: phase B
    # must reduce the SAME bf16 products phase A did, or the
    # certificate's phase-A-bounds-phase-B argument breaks at the
    # rounding margin
    Yg = Y.view(-1, bs, f)[bi].view(b, ksel * bs, f)
    scores = torch.bmm(Yg.to(torch.float32),
                       Qc.to(torch.float32)[:, :, None])[:, :, 0]
    ok = active.view(-1, bs)[bi].reshape(b, ksel * bs)
    if target is not None:
        bg = buckets.view(-1, bs)[bi].reshape(b, ksel * bs)
        ok = _lsh_ok(ok, bg, target[:, None], max_bits)
    scores = torch.where(ok, scores, _NEG_INF)
    ts, ti = _top_k(scores, k)
    rows = (bi[:, :, None] * bs
            + torch.arange(bs, device=Y.device)[None, None, :]).reshape(
                b, ksel * bs)
    idx = rows.gather(1, ti)
    # conservative margin: phase A and phase B may sum the same products
    # in different orders; inflating m_rest by a relative epsilon can
    # only FAIL the certificate more often, never pass a true miss.
    # Relative only: zero-padded query rows score exactly 0 on both
    # phases and must keep passing; a -inf m_rest (every unselected
    # block masked) must stay -inf, not -inf + inf = NaN
    m_guard = torch.where(torch.isfinite(m_rest),
                          m_rest + m_rest.abs() * 1e-4, m_rest)
    cert = ts[:, k - 1] >= m_guard
    return ts, idx, cert


# Rows a store capacity must divide into for the "pallas" kind to be
# chosen — the reference's phase-A tile.  The CUDA kernel itself needs
# only N % 128 == 0; the rule is kept so the port picks its phase-A kind
# wherever the reference would pick its Pallas kernel.
_PA_TILE = 4096


def _batch_top_n_twophase_cuda(Y, Q, penalty, active, buckets,
                               hyperplanes, k: int, bs: int, ksel: int,
                               max_bits: int):
    """Two-phase streaming top-k with the phase-A block maxima computed
    by the hand-written kernel (ops/phase_a.py): the scores never reach
    device memory.  Counterpart of the reference's
    ``_batch_top_n_twophase_pallas``; ``penalty`` is the (N // bs, bs)
    0/-inf live-row mask."""
    Qc = _q_cast(Q, Y).contiguous()
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    M = phase_a(Qc, Y, penalty, buckets, target, max_bits, bs)
    return _phase_b(Y, Qc, active, buckets, target, M, k, bs, ksel,
                    max_bits)


def _fold_factor(width: int, features: int) -> int:
    """Rows-per-physical-row folding for the phase-A scan: the largest
    fold in {4, 2} whose per-slot width w = width // fold still holds a
    full feature vector (and is a multiple of 8), else 1.  The store pads
    features to a multiple of 32 columns, so at 32-column padding fold 2
    needs features <= 16 and fold 4 features <= 8."""
    for fold in (4, 2):
        w = width // fold
        if width % fold == 0 and w >= features and w % 8 == 0:
            return fold
    return 1


def _fold_eligible(width: int, features: int, bs: int) -> int:
    """Fold factor the serving dispatch uses for this shape (1 = no
    folding): ``_fold_factor`` gated by the block and tile divisibility
    the folded layout needs."""
    fold = _fold_factor(width, features)
    if fold > 1 and bs % fold == 0 and _PA_TILE % fold == 0:
        return fold
    return 1


def _fold_items_kernel(vecs, active, fold: int, bs: int):
    """The folded phase-A mirror: logical row ``i*fold + j`` occupies
    columns ``[j*w, j*w + w)`` of folded row ``i`` (w = width // fold),
    so folded rows ``[b*bs//fold, (b+1)*bs//fold)`` over all slots are
    logical block ``b``.  Returns (Yf, penalty_fold) with the 0/-inf
    penalty in the (fold, N // bs, bs // fold) slot-major layout; the
    LSH buckets fold separately (``_fold_buckets_kernel``) so LSH and
    exact drains share this mirror."""
    n, width = vecs.shape
    w = width // fold
    yf = vecs[:, :w].reshape(n // fold, width)
    pen = torch.where(active, 0.0, _NEG_INF).to(torch.float32)
    return yf.contiguous(), _slot_major(pen, fold, bs)


def _slot_major(per_row, fold: int, bs: int):
    """(N,) per-row values in the folded mirror's (fold, N // bs,
    bs // fold) layout: [j, b, r] is logical row b*bs + r*fold + j."""
    return per_row.reshape(-1, fold).T.reshape(fold, -1,
                                               bs // fold).contiguous()


def _fold_buckets_kernel(buckets, fold: int, bs: int):
    """Per-slot LSH bucket ids in the folded kernels' side-input
    layout."""
    return _slot_major(buckets, fold, bs)


def _i8_ksel(ksel: int, n_rows: int, bs: int) -> int:
    """Block-selection width for the int8 phase A: selection runs on
    margin-inflated bounds, so gather twice the blocks — the wider
    window buys back the margin's false certificate failures."""
    return min(ksel * 2, max(1, n_rows // bs - 1))


def _penalty_kernel_i32(active, bs: int):
    """(N // bs, bs) int32 additive mask for the int8 phase A: 0 for
    live rows, ``_I8_PENALTY`` for retired ones."""
    return torch.where(active, 0, _I8_PENALTY).to(torch.int32).reshape(
        -1, bs)


# rows per pass of the quantizer: bounds its float32 temporaries
_QUANT_CHUNK_ROWS = 1 << 20
# the reference's f32 reciprocal of 127: its compiler turns the division
# of a scale by the constant 127 into this product, and the port forms
# the same product so that scales agree bit for bit
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _l1_rows(a):
    """Sum over the last axis of the non-negative float32 ``a``, in the
    reference's order: each 32-column chunk summed left to right, then
    the chunk sums left to right.  A fixed order makes the sum bit-equal
    on every device and to the reference's on the CPU."""
    width = a.shape[-1]
    total = None
    for c0 in range(0, width, 32):
        part = a[..., c0]
        for c in range(c0 + 1, min(width, c0 + 32)):
            part = part + a[..., c]
        total = part if total is None else total + part
    return total


def _quantize_items_kernel(vecs, bs: int):
    """Per-``bs``-row-block int8 quantization of the item matrix:
    (Y8, per-block scale, per-block max row L1 norm).

    One scale per block makes ``max(s_int) * scale`` a sound transform
    of the block's quantized maxima; the L1 norms feed the quantization
    error margin that turns them into upper bounds on the exact block
    maxima.  ``blocks / safe`` is a true float32 division and rounds half
    to even, as the reference's does."""
    n, width = vecs.shape
    y8 = torch.empty((n, width), dtype=torch.int8, device=vecs.device)
    scale = torch.empty(n // bs, dtype=torch.float32, device=vecs.device)
    l1 = torch.empty(n // bs, dtype=torch.float32, device=vecs.device)
    step = max(bs, _QUANT_CHUNK_ROWS // bs * bs)
    for start in range(0, n, step):
        stop = min(n, start + step)
        blocks = vecs[start:stop].to(torch.float32).reshape(-1, bs, width)
        mag = blocks.abs()
        s = mag.amax(dim=(1, 2)) * _INV_127
        safe = s.clamp_min(1e-30)
        y8[start:stop] = torch.clamp(torch.round(blocks / safe[:, None, None]),
                                     -127, 127).to(torch.int8).reshape(
                                         -1, width)
        scale[start // bs:stop // bs] = s
        l1[start // bs:stop // bs] = _l1_rows(mag).amax(1)
    return y8, scale, l1


def _fold_items_i8_kernel(y8, active, fold: int, bs: int):
    """Fold the int8 mirror as ``_fold_items_kernel`` folds the store:
    sound because quantized lanes at or past the feature count are exact
    zeros, so the folded integer products equal the unfolded ones and
    the canonical scales and L1 norms apply unchanged.  Returns (Y8f,
    penalty_i_fold) with the int32 penalty slot-major."""
    n, width = y8.shape
    w = width // fold
    y8f = y8[:, :w].reshape(n // fold, width)
    pen = torch.where(active, 0, _I8_PENALTY).to(torch.int32)
    return y8f.contiguous(), _slot_major(pen, fold, bs)


def _quantize_queries(Qc):
    """(q8, sq, l1q): the per-row symmetric int8 quantization of the
    query, its scale and the query's L1 norms.  It quantizes the operand
    phase B reduces (padded, and bf16 for a bf16 store), so the error
    bound covers the scores the certificate checks."""
    Qf = Qc.to(torch.float32)
    mag = Qf.abs()
    sq = mag.amax(1).clamp_min(1e-30) * _INV_127
    q8 = torch.clamp(torch.round(Qf / sq[:, None]), -127, 127).to(
        torch.int8)
    return q8.contiguous(), sq, _l1_rows(mag)


def _i8_bounds(M_int, sy_b, l1y_b, sq, l1q, width: int):
    """Sound upper bounds (B, N // bs) on the exact block maxima from the
    int8 maxima ``M_int`` (B, N // bs):

        s = sy*sq*s_int + err,  |err| <= sq/2*L1(y) + sy/2*L1(q) + W*sy*sq/4

    over the ``width`` columns both operands were quantized at (any width
    >= the features is sound: padding lanes quantize to exact zeros).
    Masked blocks and zero query rows (window padding, exactly 0 on both
    phases) bound to -inf, so they can never fail a certificate."""
    sy = sy_b[None, :]
    s = sq[:, None]
    masked = M_int <= _I8_PENALTY // 2
    bound = (M_int.to(torch.float32) * sy * s
             + 0.5 * s * l1y_b[None, :]
             + 0.5 * sy * l1q[:, None]
             + 0.25 * width * sy * s)
    return torch.where(masked | (l1q[:, None] == 0.0), _NEG_INF, bound)


def _batch_top_n_twophase_cuda_i8(Y, Y8, sy_b, l1y_b, Q, penalty_i,
                                  active, buckets, hyperplanes, k: int,
                                  bs: int, ksel: int, max_bits: int):
    """Two-phase streaming top-k with an int8 phase A: block selection
    runs on the quantized mirror (``ops/phase_a_i8.py``), its integer
    maxima inflated into sound upper bounds; phase B rescores the
    winners from the exact store as always, and the kth >= max(unselected
    bound) certificate catches any quantization-induced miss.
    Counterpart of the reference's ``_batch_top_n_twophase_pallas_i8``;
    ``penalty_i`` is the int32 retired-row mask."""
    Qc = _q_cast(Q, Y).contiguous()
    q8, sq, l1q = _quantize_queries(Qc)
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    M = phase_a_i8(q8, Y8, penalty_i, buckets, target, max_bits, bs)
    bound = _i8_bounds(M, sy_b, l1y_b, sq, l1q, int(Y8.shape[1]))
    return _phase_b(Y, Qc, active, buckets, target, bound, k, bs, ksel,
                    max_bits)


def _batch_top_n_twophase_cuda_fold(Y, Yf, Q, pen_f, active, bkt_f,
                                    buckets, hyperplanes, k: int, bs: int,
                                    ksel: int, max_bits: int, fold: int,
                                    features: int | None = None):
    """Two-phase streaming top-k whose phase A scans the folded mirror
    (``ops/phase_a_fold.py``), multiplying the first ``features`` columns
    of each logical row (all of them when None).  Phase B and the
    certificate run on the store as always (the folded products are
    summed in another order, within the certificate's relative margin).
    Counterpart of the reference's ``_batch_top_n_twophase_pallas_fold``."""
    Qc = _q_cast(Q, Y).contiguous()
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    M = phase_a_fold(Qc, Yf, pen_f, bkt_f, target, max_bits, fold, bs,
                     features=features)
    return _phase_b(Y, Qc, active, buckets, target, M, k, bs, ksel,
                    max_bits)


def _batch_top_n_twophase_cuda_i8_fold(Y, Y8f, sy_b, l1y_b, Q, pen_i_f,
                                       active, bkt_f, buckets, hyperplanes,
                                       k: int, bs: int, ksel: int,
                                       max_bits: int, fold: int):
    """The int8 phase A over the folded int8 mirror
    (``ops/phase_a_i8_fold.py``): its integer maxima are the unfolded
    ones, so the bounds, the selection and phase B are those of
    ``_batch_top_n_twophase_cuda_i8``.  Counterpart of the reference's
    ``_batch_top_n_twophase_pallas_i8_fold``."""
    Qc = _q_cast(Q, Y).contiguous()
    q8, sq, l1q = _quantize_queries(Qc)
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    M = phase_a_i8_fold(q8, Y8f, pen_i_f, bkt_f, target, max_bits, fold,
                        bs)
    bound = _i8_bounds(M, sy_b, l1y_b, sq, l1q, int(Y8f.shape[1]))
    return _phase_b(Y, Qc, active, buckets, target, bound, k, bs, ksel,
                    max_bits)


def _batch_top_n_twophase_kernel(Y, Q, active, buckets, hyperplanes,
                                 k: int, chunk: int, bs: int, ksel: int,
                                 max_bits: int):
    """Streaming two-phase top-k with phase A as plain PyTorch over row
    chunks (the reference's ``scan`` kind): each chunk's (B, chunk)
    scores are reduced to block maxima, then phase B as always.
    ``buckets``/``hyperplanes`` of None select the exact scan."""
    b = Q.shape[0]
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    Qc = _q_cast(Q, Y)
    ms = []
    for start in range(0, Y.shape[0], chunk):
        stop = start + chunk
        scores = _scores(Qc, Y[start:stop])
        ok = active[None, start:stop]
        if target is not None:
            ok = _lsh_ok(ok, buckets[None, start:stop], target[:, None],
                         max_bits)
        scores = torch.where(ok, scores, _NEG_INF)
        ms.append(scores.view(b, chunk // bs, bs).amax(-1))
    M = torch.cat(ms, dim=1)
    return _phase_b(Y, Qc, active, buckets, target, M, k, bs, ksel,
                    max_bits)


def _batch_top_n_chunked_kernel(Y, Q, active, buckets, hyperplanes,
                                k: int, chunk: int, max_bits: int):
    """Streaming batched top-k with an exact per-chunk top-k and a
    running (B, k) carry — the fallback for certificate failures.
    ``buckets``/``hyperplanes`` of None select the exact scan."""
    b = Q.shape[0]
    target = None
    if buckets is not None:
        target = _query_buckets(Q, hyperplanes)
    Qc = _q_cast(Q, Y)
    best_s = torch.full((b, k), _NEG_INF, dtype=torch.float32,
                        device=Y.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=Y.device)
    for start in range(0, Y.shape[0], chunk):
        stop = start + chunk
        scores = _scores(Qc, Y[start:stop])
        ok = active[None, start:stop]
        if target is not None:
            ok = _lsh_ok(ok, buckets[None, start:stop], target[:, None],
                         max_bits)
        cs, ci = _top_k(torch.where(ok, scores, _NEG_INF), k)
        best_s, sel = _top_k(torch.cat([best_s, cs], dim=1), k)
        best_i = torch.cat([best_i, ci + start], dim=1).gather(1, sel)
    return best_s, best_i


def _masked_top_k(scores, mask, k: int):
    return _top_k(torch.where(mask, scores, _NEG_INF), k)


def _penalty_kernel(active, bs: int):
    """(N // bs, bs) float32 additive mask for phase A: 0 for live rows,
    -inf for retired ones."""
    return torch.where(active, 0.0, _NEG_INF).to(torch.float32).reshape(
        -1, bs)


# the phase-A mirror caches each kind serves from (each with an
# ``<attr>_version``), and all of them
_KIND_MIRRORS = {"i8_fold": ("_i8_fold", "_fold_bkt"),
                "i8": ("_i8", "_penalty_i"),
                "fold": ("_fold", "_fold_bkt"),
                "pallas": ("_penalty",),
                "ivf": ("_ivf_mirror",)}
_MIRROR_CACHES = tuple(dict.fromkeys(
    a for attrs in _KIND_MIRRORS.values() for a in attrs))


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


class ALSServingModel(FactorModelBase, ServingModel):
    """Factor stores + known-items, with device top-N."""

    def __init__(self, features: int, implicit: bool,
                 sample_rate: float = 1.0, rescorer_provider=None,
                 dtype="float32", device=None,
                 int8_selection: str | bool = "auto",
                 fold_scan: str | bool = "auto"):
        """``int8_selection`` ("auto", "true", "false"; the reference's
        ``oryx.serving.api.int8-selection``) selects phase A on an int8
        mirror: "auto" turns it on at features <= 64 where the store pads
        its columns.  ``fold_scan`` (``fold-scan``) lets phase A scan a
        folded mirror where the features fit 1/2 or 1/4 of the padded
        width.  The IVF index's state comes with each generation
        (``attach_ann``).  ``device=None`` means ``cuda``."""
        super().__init__(features, implicit, dtype=dtype, device=device)
        self.rescorer_provider = rescorer_provider
        self._known_items: dict[str, set[str]] = {}
        # item -> number of users whose known items hold it, kept with
        # every known-items write and prune
        self._item_pop: dict[str, int] = {}
        self._known_lock = AutoReadWriteLock()
        self.lsh = (LocalitySensitiveHash(sample_rate, features,
                                          device=self.device)
                    if sample_rate < 1.0 else None)
        self._item_buckets: torch.Tensor | None = None
        self._item_buckets_version: int = -1
        self._penalty: torch.Tensor | None = None
        self._penalty_version: int = -1
        # a bool normalises to the canonical string, so True gets the
        # explicit opt-in's place in the kind chain (which compares
        # strings)
        if isinstance(int8_selection, bool):
            int8_selection = "true" if int8_selection else "false"
        self._int8_selection = int8_selection
        self._fold_scan = fold_scan
        # phase-A mirrors, each rebuilt when the Y snapshot version
        # changes: int8 (Y8, scale, L1), its int32 penalty, the folded
        # store (Yf, penalty), the folded int8 mirror (Y8f, penalty,
        # scale, L1) and the folded buckets
        self._i8: tuple | None = None
        self._i8_version: int = -1
        self._penalty_i: torch.Tensor | None = None
        self._penalty_i_version: int = -1
        self._fold: tuple | None = None
        self._fold_version: int = -1
        self._i8_fold: tuple | None = None
        self._i8_fold_version: int = -1
        self._fold_bkt: torch.Tensor | None = None
        self._fold_bkt_version: int = -1
        # measured-cost route (kernel_router.measure_routes), keyed on
        # the Y store's padded capacity: UP-stream version bumps do not
        # re-measure
        self._route: dict | None = None
        self._route_capacity: int = -1
        self._route_lock = threading.Lock()
        # the IVF index: the generation's small state (centroids and
        # recall certificate) is attached by the manager at load; its
        # device mirror is version-keyed like the other phase-A mirrors.
        # "ivf" joins the kind chain only while the certificate holds
        self._ann = None
        self._ivf_mirror = None
        self._ivf_mirror_version: int = -1
        self._bucket_lock = threading.Lock()
        # exact-scan recomputes forced by a failed two-phase certificate
        self.twophase_fallbacks = 0

    # -- known items ---------------------------------------------------------

    def add_known_items(self, user_id: str, item_ids: Iterable[str]) -> None:
        with self._known_lock.write():
            known = self._known_items.setdefault(user_id, set())
            for iid in item_ids:
                if iid not in known:
                    known.add(iid)
                    self._item_pop[iid] = self._item_pop.get(iid, 0) + 1

    def get_known_items(self, user_id: str) -> set[str]:
        with self._known_lock.read():
            return set(self._known_items.get(user_id, ()))

    def get_known_item_counts(self) -> dict[str, int]:
        """user -> number of known items (users with none left out)."""
        with self._known_lock.read():
            return {u: len(s) for u, s in self._known_items.items() if s}

    def get_item_popularity_counts(self) -> dict[str, int]:
        """item -> number of users that know it, from the incremental
        counter."""
        with self._known_lock.read():
            return {i: c for i, c in self._item_pop.items() if c > 0}

    def retain_recent_and_known_items(self, user_ids: Sequence[str],
                                      item_ids: Sequence[str]) -> None:
        """Prune known items on a MODEL swap: keep the entries of users
        in the new model or recently updated in X, and within each set
        the items in the new model or recently updated in Y (reference:
        ALSServingModel.retainRecentAndKnownItems :350-383).  Runs
        before retain_recent_and_user/item_ids, which clear the recent
        sets."""
        keep_users = set(user_ids) | self.X.recent_ids()
        keep_items = set(item_ids) | self.Y.recent_ids()
        with self._known_lock.write():
            for u in [u for u in self._known_items if u not in keep_users]:
                for iid in self._known_items.pop(u):
                    self._item_pop[iid] -= 1
            for items in self._known_items.values():
                for iid in items - keep_items:
                    self._item_pop[iid] -= 1
                items &= keep_items
            self._item_pop = {i: c for i, c in self._item_pop.items()
                              if c > 0}

    # -- scoring -------------------------------------------------------------

    def metrics(self) -> dict:
        """App-level gauges."""
        out = {
            "users": len(self.X),
            "items": len(self.Y),
            # exact-scan recomputes forced by a failed streaming top-k
            # certificate; nonzero is worth an operator's attention
            "twophase_fallbacks": self.twophase_fallbacks,
        }
        # the measured-cost route: which kind serves this shape and the
        # costs the choice was made from
        r = self._route
        if r is not None:
            out["kernel_route"] = r
        return out

    @property
    def kernel_route_label(self) -> str | None:
        """Label of the measured-cost route serving this shape: the
        route's ``chosen`` kind, with ``+lsh`` when the Hamming-ball mask
        is honored.  None before a route is measured, or when it chose
        nothing."""
        r = self._route
        if not r or r.get("chosen") is None:
            return None
        return f"{r['chosen']}+lsh" if r.get("use_lsh") \
            else str(r["chosen"])

    def _lsh_active(self) -> bool:
        """True when this model's LSH configuration actually prunes."""
        return (self.lsh is not None and self.lsh.num_hashes > 0
                and self.lsh.max_bits_differing < self.lsh.num_hashes)

    def _cached_penalty(self, active, version) -> torch.Tensor:
        """(N // 128, 128) float32 additive live-row mask for phase A,
        recomputed only when the Y snapshot version changes."""
        with self._bucket_lock:
            if self._penalty is None or self._penalty_version != version:
                self._penalty = _penalty_kernel(active, _BLOCK_ROWS)
                self._penalty_version = version
            return self._penalty

    def _int8_enabled(self) -> bool:
        if self._int8_selection == "auto":
            # on at f <= 64 where the store pads its columns: there the
            # int8 (and folded int8) mirror reads the fewest bytes
            return (self.features <= 64
                    and self.Y.device_features != self.features)
        return bool(self._int8_selection) and self._int8_selection != "false"

    def _fold_enabled(self) -> bool:
        return bool(self._fold_scan) and self._fold_scan != "false"

    def _cached_fold(self, vecs, active, buckets, version, fold: int,
                     bs: int) -> tuple:
        """(Yf, penalty_fold, buckets_fold|None) folded phase-A mirror,
        rebuilt on the device when the Y snapshot version changes.  LSH
        and exact drains share it; the buckets fold on first LSH use per
        version."""
        with self._bucket_lock:
            if self._fold is None or self._fold_version != version:
                self._fold = _fold_items_kernel(vecs, active, fold, bs)
                self._fold_version = version
            yf, pen_f = self._fold
            bkt_f = self._fold_bkt_locked(buckets, version, fold, bs) \
                if buckets is not None else None
            return yf, pen_f, bkt_f

    def _cached_i8(self, vecs, version):
        """(Y8, per-block scale, per-block L1) quantization mirror,
        rebuilt on the device when the Y snapshot version changes."""
        with self._bucket_lock:
            if self._i8 is None or self._i8_version != version:
                self._i8 = _quantize_items_kernel(vecs, _BLOCK_ROWS)
                self._i8_version = version
            return self._i8

    def _cached_i8_fold(self, vecs, active, buckets, version, fold: int,
                        bs: int) -> tuple:
        """(Y8f, penalty_i_fold, buckets_fold|None, scale, L1) folded int8
        mirror.  It quantizes with the unfolded path's quantizer (the
        same scales and L1 norms, so the same bounds) but not through
        ``_cached_i8``: the unfolded Y8 is only an intermediate here and
        is not kept on the model beside the folded mirror that serves."""
        with self._bucket_lock:
            if self._i8_fold is None or self._i8_fold_version != version:
                y8, sy_b, l1y_b = _quantize_items_kernel(vecs, bs)
                y8f, pen_i_f = _fold_items_i8_kernel(y8, active, fold, bs)
                self._i8_fold = (y8f, pen_i_f, sy_b, l1y_b)
                self._i8_fold_version = version
            y8f, pen_i_f, sy_b, l1y_b = self._i8_fold
            bkt_f = self._fold_bkt_locked(buckets, version, fold, bs) \
                if buckets is not None else None
            return y8f, pen_i_f, bkt_f, sy_b, l1y_b

    def _evict_unused_mirrors(self, keep_kind: str | None) -> None:
        """Drop the phase-A mirror caches the routed kind does not use:
        route measurement builds every kind's mirror, and the losers
        must not stay on the card beside the store.  Version-keyed
        caches rebuild on demand."""
        keep = _KIND_MIRRORS.get(keep_kind, ())
        with self._bucket_lock:
            for attr in _MIRROR_CACHES:
                if attr not in keep:
                    setattr(self, attr, None)
                    setattr(self, attr + "_version", -1)

    def _fold_bkt_locked(self, buckets, version, fold: int,
                         bs: int) -> torch.Tensor:
        """Folded LSH bucket side input, shared by the folded store and
        the folded int8 mirror (the caller holds ``_bucket_lock``)."""
        if self._fold_bkt is None or self._fold_bkt_version != version:
            self._fold_bkt = _fold_buckets_kernel(buckets, fold, bs)
            self._fold_bkt_version = version
        return self._fold_bkt

    def _cached_penalty_i(self, active, version) -> torch.Tensor:
        with self._bucket_lock:
            if self._penalty_i is None \
                    or self._penalty_i_version != version:
                self._penalty_i = _penalty_kernel_i32(active, _BLOCK_ROWS)
                self._penalty_i_version = version
            return self._penalty_i

    def _cached_buckets(self, vecs, version) -> torch.Tensor:
        """Per-item LSH bucket ids on the device, recomputed only when
        the Y snapshot version changes."""
        with self._bucket_lock:
            if self._item_buckets is None \
                    or self._item_buckets_version != version:
                self._item_buckets = self.lsh.device_buckets(vecs)
                self._item_buckets_version = version
            return self._item_buckets

    def _lsh_mask(self, query_vec: np.ndarray | None, vecs, version, active):
        if self.lsh is None or query_vec is None \
                or self.lsh.num_hashes == 0:
            return active
        buckets = self._cached_buckets(vecs, version)
        return active & self.lsh.candidate_mask(query_vec, buckets)

    def top_n(self, how_many: int,
              user_vector: np.ndarray | None = None,
              cosine_to: np.ndarray | None = None,
              exclude: Iterable[str] = (),
              rescorer: Rescorer | None = None,
              allowed: Callable[[str], bool] | None = None,
              lowest: bool = False,
              use_lsh: bool = True) -> list[tuple[str, float]]:
        """Top (or bottom, with ``lowest``) scoring items with scores.
        Exactly one of ``user_vector`` (dot-product scores, the
        reference's DotsFunction) or ``cosine_to`` (a (features,) vector
        or (features, m) columns: mean-cosine scores,
        CosineAverageFunction) selects the scores; the cosine query's
        LSH bucket is that of the columns' mean.  ``use_lsh=False``
        forces an exact scan even on an LSH-configured model."""
        if (user_vector is None) == (cosine_to is None):
            raise ValueError("exactly one of user_vector and cosine_to")
        _check_f32_matmul(self.device)
        vecs, active, version = self.Y.device_arrays_versioned()
        if user_vector is not None:
            q = np.asarray(user_vector, dtype=np.float32)
            scores = _dot_scores(vecs, torch.from_numpy(q).to(self.device))
        else:
            V = np.asarray(cosine_to, dtype=np.float32)
            if V.ndim == 1:
                V = V[:, None]
            scores = _cosine_mean_scores(
                vecs, torch.from_numpy(V).to(self.device))
            q = V.mean(axis=1)
        if lowest:
            scores = -scores
        n_rows = int(vecs.shape[0])
        use_lsh = use_lsh and self._route_use_lsh(n_rows)
        mask = self._lsh_mask(q if use_lsh else None, vecs, version, active)

        exclude = set(exclude)
        if rescorer is not None or allowed is not None:
            # device-side top-M, rescore the M candidates on host; falls
            # back to the full pull only when filtering eats the window
            # (reference: Recommend.java:91-107)
            m = min(_pad_k(max(4 * (how_many + len(exclude)), 512)), n_rows)
            if m < n_rows:
                out = self._rescored_from_window(
                    scores, mask, m, how_many, exclude, rescorer,
                    allowed, lowest)
                if out is not None:
                    return out
            s, mk = _fetch(scores, mask)
            return self._host_top_n(s, mk, how_many, exclude, rescorer,
                                    allowed, lowest)
        # pull a padded window to absorb excluded ids, then host-filter
        k = min(_pad_k(how_many + len(exclude)), n_rows)
        top_scores, top_idx = _fetch(*_masked_top_k(scores, mask, k))
        out: list[tuple[str, float]] = []
        for s, i in zip(top_scores.tolist(), top_idx.tolist()):
            if not math.isfinite(s):
                break
            id_ = self.Y.id_of(i)
            if id_ is None or id_ in exclude:
                continue
            out.append((id_, -s if lowest else s))
            if len(out) == how_many:
                break
        if len(out) < how_many and k < n_rows:
            # excluded set ate into the window; fall back to exact host scan
            s, mk = _fetch(scores, mask)
            return self._host_top_n(s, mk, how_many, exclude, None, None,
                                    lowest)
        return out

    def top_n_batch(self, how_many: int | Sequence[int],
                    user_vectors: np.ndarray,
                    exclude: Sequence[Iterable[str]] | None = None,
                    use_lsh: bool = True) -> list[list[tuple[str, float]]]:
        """Batched top-N: one device pass for a whole batch of /recommend
        requests.  ``user_vectors`` is (B, features); ``how_many`` is one
        size for all requests or one per request; ``exclude`` optionally
        gives per-request excluded item IDs.

        On an LSH-configured model each query's Hamming-ball candidate
        mask is fused into the scoring.  ``use_lsh=False`` forces the
        exact scan.  Above ~0.5M items (or ~1 GB of score matrix) the
        batch runs the two-phase streaming top-k in windows of the
        ladder; below, one flat masked top-k."""
        _check_f32_matmul(self.device)
        Q = np.asarray(user_vectors, dtype=np.float32)
        if Q.ndim != 2 or Q.shape[1] != self.features:
            raise ValueError("user_vectors must be (B, features)")
        n_req = Q.shape[0]
        if n_req == 0:
            return []
        hm = [how_many] * n_req if isinstance(how_many, int) \
            else list(how_many)
        if len(hm) != n_req:
            raise ValueError("one how_many per user vector required")
        excl = [set(e) for e in exclude] if exclude is not None \
            else [set()] * n_req
        vecs, active, version = self.Y.device_arrays_versioned()
        n_rows = int(vecs.shape[0])
        k = min(_pad_k(max(h + len(e) for h, e in zip(hm, excl))), n_rows)
        # pow2 floor of 8 for the flat path's sizing decision, as the
        # reference sizes it
        b_pad = 1 << max(3, (n_req - 1).bit_length())
        lsh_on = (use_lsh and self._lsh_active()
                  and self._route_use_lsh(n_rows))
        buckets = self._cached_buckets(vecs, version) if lsh_on else None
        big, chunk = _stream_plan(n_rows, b_pad)
        bs = _BLOCK_ROWS
        ksel = min(_BLOCK_KSEL, n_rows // max(1, bs))
        if big and n_rows % chunk == 0 and k <= chunk:
            # streaming path: window shapes from the ladder (computed
            # from the TRUE request count — a 257-query drain is
            # [256, 8], not two full windows)
            hp = self.lsh._device_hyperplanes() if lsh_on else None
            mb = self.lsh.max_bits_differing if lsh_on else 0
            sizes = _window_sizes(n_req)
            Qp = np.zeros((sum(sizes), Q.shape[1]), np.float32)
            Qp[:n_req] = Q
            Qd = torch.from_numpy(Qp).to(self.device)
            starts = np.cumsum([0] + sizes[:-1]).tolist()
            windows = [Qd[s:s + size] for s, size in zip(starts, sizes)]
            if n_rows % bs == 0 and 1 <= ksel < n_rows // bs \
                    and k <= ksel * bs:
                fetched = self._dispatch_twophase(
                    vecs, windows, active, version, buckets, hp, k,
                    chunk, bs, ksel, mb)
                for w, (ts, ti, cert) in enumerate(fetched):
                    if not cert.all():
                        # block selection missed a head block for some
                        # row; recompute on the exact scan.  Counted per
                        # certificate-failing row, under the lock —
                        # batcher dispatcher threads race on this gauge
                        with self._bucket_lock:
                            self.twophase_fallbacks += int((~cert).sum())
                        ts, ti = _fetch(*_batch_top_n_chunked_kernel(
                            vecs, windows[w], active, buckets, hp, k,
                            chunk, mb))
                        fetched[w] = (ts, ti, None)
            else:
                fetched = [_fetch(*_batch_top_n_chunked_kernel(
                    vecs, qw, active, buckets, hp, k, chunk, mb))
                    for qw in windows]
            top_scores = np.concatenate([f[0] for f in fetched])
            top_idx = np.concatenate([f[1] for f in fetched])
        else:
            Qp = np.zeros((b_pad, Q.shape[1]), np.float32)
            Qp[:n_req] = Q
            Qd = torch.from_numpy(Qp).to(self.device)
            if lsh_on:
                out_dev = _batch_top_n_lsh_kernel(
                    vecs, Qd, active, buckets,
                    self.lsh._device_hyperplanes(), k,
                    self.lsh.max_bits_differing)
            else:
                out_dev = _batch_top_n_kernel(vecs, Qd, active, k)
            top_scores, top_idx = _fetch(*out_dev)
        return self._decode_top_n(top_scores, top_idx, hm, excl, n_req,
                                  k < n_rows, Q, use_lsh)

    def _dispatch_twophase(self, vecs, windows, active, version, buckets,
                           hp, k: int, chunk: int, bs: int, ksel: int,
                           mb: int) -> list:
        """Run every window's two-phase program on the first kind of the
        phase-A chain — ordered by measured cost once a route for this
        shape exists (``_route_order``) — and fetch the results together.
        There is no fallback to another kind: a kernel that fails to
        build or launch raises, and the batcher surfaces it per
        request."""
        n_rows = int(vecs.shape[0])
        static_kinds, fold = self._phase_a_kinds(n_rows, int(vecs.shape[1]),
                                                 bs)
        # "ivf" is an exact-variant kind: the Hamming mask and the cell
        # probe are competing pruners, never composed
        kinds = self._route_order(
            [kk for kk in static_kinds if kk != "ivf" or buckets is None],
            n_rows, lsh_on=buckets is not None)
        ctx: dict = {}
        handles = [self._dispatch_kind(kinds[0], qw, vecs, active, version,
                                       buckets, hp, k, bs, ksel, mb, fold,
                                       ctx, chunk=chunk)
                   for qw in windows]
        return [_fetch(*h) for h in handles]

    def _dispatch_kind(self, kind: str, qw, vecs, active, version,
                       buckets, hp, k: int, bs: int, ksel: int, mb: int,
                       fold: int, ctx: dict, chunk: int = 0):
        """Run ONE window's two-phase program with the given phase-A
        kind; ``ctx`` caches the phase-A mirrors across the windows of a
        drain."""
        n_rows = int(vecs.shape[0])
        if kind == "i8_fold":
            if "i8_fold" not in ctx:
                ctx["i8_fold"] = self._cached_i8_fold(
                    vecs, active, buckets, version, fold, bs)
            y8f, pen_i_f, bkt_f, sy_b, l1y_b = ctx["i8_fold"]
            return _batch_top_n_twophase_cuda_i8_fold(
                vecs, y8f, sy_b, l1y_b, qw, pen_i_f, active, bkt_f,
                buckets, hp, k, bs, _i8_ksel(ksel, n_rows, bs), mb, fold)
        if kind == "fold":
            if "fold" not in ctx:
                ctx["fold"] = self._cached_fold(
                    vecs, active, buckets, version, fold, bs)
            yf, pen_f, bkt_f = ctx["fold"]
            return _batch_top_n_twophase_cuda_fold(
                vecs, yf, qw, pen_f, active, bkt_f, buckets, hp, k, bs,
                ksel, mb, fold, self.features)
        if kind == "i8":
            if "i8" not in ctx:
                ctx["i8"] = (self._cached_i8(vecs, version),
                             self._cached_penalty_i(active, version))
            (y8, sy_b, l1y_b), penalty_i = ctx["i8"]
            return _batch_top_n_twophase_cuda_i8(
                vecs, y8, sy_b, l1y_b, qw, penalty_i, active, buckets, hp,
                k, bs, _i8_ksel(ksel, n_rows, bs), mb)
        if kind == "pallas":
            if "penalty" not in ctx:
                ctx["penalty"] = self._cached_penalty(active, version)
            return _batch_top_n_twophase_cuda(
                vecs, qw, ctx["penalty"], active, buckets, hp, k, bs,
                ksel, mb)
        if kind == "ivf":
            from . import ivf as _ivf
            if "ivf" not in ctx:
                ctx["ivf"] = self._cached_ivf(vecs, active, version)
            return _ivf.batch_top_n_ivf(
                ctx["ivf"], vecs, qw, k, bs, _i8_ksel(ksel, n_rows, bs),
                self._ann.cfg.nprobe)
        if kind == "scan":
            return _batch_top_n_twophase_kernel(
                vecs, qw, active, buckets, hp, k, chunk, bs, ksel, mb)
        raise ValueError(f"unknown phase-A kind {kind!r}")

    def _phase_a_kinds(self, n_rows: int, width: int,
                       bs: int) -> tuple[list[str], int]:
        """(phase-A kinds for a streaming shape, best first; fold factor).
        The kind names are the reference's, each a hand-written kernel
        but "ivf" and "scan", plain PyTorch.  The order is the
        reference's, fewest phase-A bytes first: "ivf" where its recall
        certificate admits it (it reads about nprobe/cells of the
        catalog), int8+fold, then fold and int8 (an explicit
        ``int8_selection="true"`` ahead of fold), then the store's own
        kernel, then the scan."""
        eligible = n_rows % _PA_TILE == 0
        want_i8 = self._int8_enabled()
        fold = _fold_eligible(width, self.features, bs) \
            if self._fold_enabled() else 1
        kinds: list[str] = []
        if self._ann_routable(n_rows):
            kinds.append("ivf")
        if eligible:
            if want_i8 and fold > 1:
                kinds.append("i8_fold")
            if want_i8 and self._int8_selection == "true":
                kinds.append("i8")
            if fold > 1:
                kinds.append("fold")
            if want_i8 and "i8" not in kinds:
                kinds.append("i8")
            # the store kernel keeps a query tile of the whole width in
            # shared memory; a wider store is served by the scan
            if width <= PHASE_A_MAX_WIDTH:
                kinds.append("pallas")
        kinds.append("scan")
        return kinds, fold

    # -- the IVF index (ivf.py) ----------------------------------------------

    def attach_ann(self, state) -> None:
        """Install the generation's ANN state (``ivf.AnnState``:
        centroids and recall certificate); None detaches it, and "ivf"
        leaves the chain.  The manager calls this before
        ``refresh_route``: the route's re-measure key holds the ANN
        shape (``_ann_route_key``), so an attach invalidates a route."""
        with self._bucket_lock:
            self._ann = state
            self._ivf_mirror = None
            self._ivf_mirror_version = -1

    def _ann_routable(self, n_rows: int) -> bool:
        """True when "ivf" may serve: state attached, the recall
        certificate measured and at or above ``oryx.als.ann.min-recall``,
        and a capacity of whole blocks, at least one per cell.  The one
        gate of the dispatch chain and the router, so the router can
        never serve the IVF index below min-recall."""
        a = self._ann
        return (a is not None and a.recall is not None
                and a.recall >= a.cfg.min_recall
                and n_rows % _BLOCK_ROWS == 0
                and n_rows // _BLOCK_ROWS >= int(a.centroids.shape[0]))

    def _ann_route_key(self) -> tuple | None:
        """The ANN half of the route's re-measure key: the configuration's
        shape and whether the certificate admits routing.  A certificate
        flipping either way re-measures (the kind chain changed)."""
        a = self._ann
        if a is None:
            return None
        return a.cfg.route_key() + (
            self._ann_routable(len(self.Y.row_ids())),)

    def _cached_ivf(self, vecs, active, version):
        """The cell-contiguous int8 IVF mirror (``ivf.IVFMirror``),
        rebuilt on the device when the Y snapshot version changes.  The
        first build after a generation load takes the published
        assignment if one came; later ones assign on the device (same
        centroids, same lowest-cell tie-break: same cells)."""
        from . import ivf as _ivf
        with self._bucket_lock:
            a = self._ann
            if a is None:
                raise ValueError("no ANN state attached")
            if self._ivf_mirror is None \
                    or self._ivf_mirror_version != version:
                cells = a.cells if a.cells is not None \
                    and len(a.cells) == int(vecs.shape[0]) else None
                a.cells = None  # one-shot: stale after any store write
                self._ivf_mirror = _ivf.build_mirror(
                    vecs, active, a, _BLOCK_ROWS, cells=cells)
                self._ivf_mirror_version = version
                a.index_bytes = self._ivf_mirror.index_bytes
            return self._ivf_mirror

    # -- measured-cost routing (kernel_router) -------------------------------

    def _route_order(self, kinds: list[str], n_rows: int,
                     lsh_on: bool = False) -> list[str]:
        """The eligible phase-A kinds ordered by measured ascending cost
        for the live shape, from the drain's own variant's cost table
        (the mask can invert the ranking between builds).  Kinds without
        a measurement keep their static order after the measured ones;
        without a current route the static order stands."""
        r = self._route_current(n_rows)
        if not r:
            return kinds
        costs = (r.get("costs_lsh_ms") if lsh_on
                 else r.get("costs_exact_ms")) \
            or r.get("phase_a_costs_ms") or {}
        measured = [kk for kk in kinds if costs.get(kk) is not None]
        if not measured:
            return kinds
        measured.sort(key=lambda kk: costs[kk])
        return measured + [kk for kk in kinds if costs.get(kk) is None]

    def _route_use_lsh(self, n_rows: int) -> bool:
        """False when the measured route found the Hamming-mask build
        slower than the exact scan for the live shape; the configuration
        decides where LSH wins or nothing was measured."""
        r = self._route_current(n_rows)
        if not r or r.get("use_lsh") is None:
            return True
        return bool(r["use_lsh"])

    def refresh_route(self, force: bool = False) -> dict | None:
        """Measure per-path cost for the live shape and install the
        route (``kernel_router.measure_routes``).  Called at model load
        and on hot-swap; concurrent callers serialize.  A route is
        reused while the padded capacity and the LSH configuration are
        unchanged; ``force`` re-measures."""
        from .kernel_router import measure_routes
        with self._route_lock:
            n_rows = len(self.Y.row_ids())
            r = self._route
            if (not force and r is not None
                    and self._route_capacity == n_rows
                    and r.get("lsh_configured") == self._lsh_active()
                    and r.get("ann_key") == self._ann_route_key()):
                return r
            try:
                route = measure_routes(self)
            except Exception:  # noqa: BLE001 — measurement is advisory
                # routing is an optimization, never a load gate: an
                # escaped exception would trap the update consumer in
                # replay-from-0 against the same failure.  Serving keeps
                # the static chain, whose kernels raise per request if
                # they are broken
                _log.exception(
                    "kernel route measurement failed; serving keeps "
                    "the static kernel order")
                return self._route
            self._route = route
            self._route_capacity = n_rows
            self._evict_unused_mirrors(
                (route or {}).get("chosen") if (route or {}).get(
                    "path") == "streaming" else None)
        return route

    def _route_current(self, n_rows: int) -> dict | None:
        """The installed route if it matches the live padded capacity
        and LSH configuration (a hot-swap that regrew the store, or a
        new sample rate, invalidates it)."""
        r = self._route
        return r if (r is not None and self._route_capacity == n_rows
                     and r.get("lsh_configured") == self._lsh_active()
                     and r.get("ann_key") == self._ann_route_key()) \
            else None

    def _decode_top_n(self, top_scores, top_idx, hm: list[int],
                      excl: list[set[str]], n_req: int, window_partial: bool,
                      Q: np.ndarray,
                      use_lsh: bool) -> list[list[tuple[str, float]]]:
        """Host decode shared by the flat and streaming batched paths:
        map rows to ids, drop excluded/retired rows, and retry a request
        on the single-request path when its exclusions ate the whole
        fetched window."""
        row_ids = self.Y.row_ids()
        results: list[list[tuple[str, float]]] = []
        for b in range(n_req):
            out: list[tuple[str, float]] = []
            for s, i in zip(top_scores[b].tolist(), top_idx[b].tolist()):
                if not math.isfinite(s):
                    break
                id_ = row_ids[i]
                if id_ is None or id_ in excl[b]:
                    continue
                out.append((id_, s))
                if len(out) == hm[b]:
                    break
            if len(out) < hm[b] and window_partial:
                out = self.top_n(hm[b], user_vector=Q[b],
                                 exclude=excl[b], use_lsh=use_lsh)
            results.append(out)
        return results

    def _rescored_from_window(self, scores, mask, m: int, how_many: int,
                              exclude: set[str],
                              rescorer: Rescorer | None,
                              allowed: Callable[[str], bool] | None,
                              lowest: bool) -> list[tuple[str, float]] | None:
        """Rescore/filter the device top-``m`` window; None when the
        filters ate the window without filling ``how_many`` AND more
        candidates exist beyond it (caller falls back to the full
        pull)."""
        ts, ti = _fetch(*_masked_top_k(scores, mask, m))
        out: list[tuple[str, float]] = []
        exhausted = False
        for s, i in zip(ts.tolist(), ti.tolist()):
            if not math.isfinite(s):
                exhausted = True  # -inf tail: no candidates remain
                break
            id_ = self.Y.id_of(i)
            if id_ is None or id_ in exclude:
                continue
            if allowed is not None and not allowed(id_):
                continue
            score = -s if lowest else s
            if rescorer is not None:
                if rescorer.is_filtered(id_):
                    continue
                score = rescorer.rescore(id_, score)
                if math.isnan(score):
                    continue
            out.append((id_, score))
        if len(out) < how_many and not exhausted:
            return None
        out.sort(key=lambda t: t[1] if lowest else -t[1])
        return out[:how_many]

    def _host_top_n(self, scores: np.ndarray, mask: np.ndarray,
                    how_many: int, exclude: set[str],
                    rescorer: Rescorer | None,
                    allowed: Callable[[str], bool] | None,
                    lowest: bool) -> list[tuple[str, float]]:
        """Exact host-side top-N.  ``scores`` arrive already negated when
        ``lowest``; emitted scores are restored to original sign."""
        order = np.argsort(-scores)
        out: list[tuple[str, float]] = []
        for i in order:
            if not mask[i] or not math.isfinite(scores[i]):
                continue
            id_ = self.Y.id_of(int(i))
            if id_ is None or id_ in exclude:
                continue
            if allowed is not None and not allowed(id_):
                continue
            score = -float(scores[i]) if lowest else float(scores[i])
            if rescorer is not None:
                if rescorer.is_filtered(id_):
                    continue
                score = rescorer.rescore(id_, score)
                if math.isnan(score):
                    continue
            out.append((id_, score))
            if rescorer is None and len(out) == how_many:
                return out
        if rescorer is not None:
            out.sort(key=lambda t: t[1] if lowest else -t[1])
            return out[:how_many]
        return out

    # -- misc queries --------------------------------------------------------

    def all_user_ids(self) -> list[str]:
        return self.X.all_ids()

    def all_item_ids(self) -> list[str]:
        return self.Y.all_ids()

    def __repr__(self):  # pragma: no cover
        return (f"ALSServingModel[features:{self.features}, "
                f"X:({len(self.X)} users), Y:({len(self.Y)} items)]")
