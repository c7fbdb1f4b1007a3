"""Phase A over the folded int8 mirror: per-128-row-block maxima of the
integer products, by the hand-written CUDA kernel of
``csrc/phase_a_i8_fold.cu`` (int8 ``wgmma`` on the tensor cores, fed by
TMA).

Counterpart of the Pallas kernel inside
``oryx_tpu/app/als/serving_model.py::_batch_top_n_twophase_pallas_i8_fold``,
both bodies.  The mirror ``Y8f`` (N / fold, 32) int8 is laid out as
``ops/phase_a_fold.py`` describes; the penalty is int32 in the same
slot-major layout.  The plain version, ``phase_a_i8_fold_reference``, and
the kernel both compute the reference's way: one integer product per slot
of each 32-byte physical row against a slot-shifted query, max over the
block's physical rows and over slots.  Both are exact, and equal
``phase_a_i8`` on the unfolded mirror bit for bit: quantized lanes past
the features are zeros.  ``phase_a_i8_fold`` launches the kernel for CUDA
tensors and raises if it cannot, and takes the plain version for CPU
tensors only.  ``LAUNCHES`` counts the kernel's launches (one per call,
whatever number of grids the entry point runs for it); ``plan`` says
which design a call of a given size runs.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..app.als.lsh import _popcount
from . import cuda_build
from . import phase_a_i8 as _i8
from .phase_a_fold import check_fold_operands, slot_queries

__all__ = ["phase_a_i8_fold", "phase_a_i8_fold_reference", "build",
           "check_operands", "plan", "library_plan", "query_tiles",
           "LAUNCHES", "BLOCK_ROWS", "PHYS_WIDTH", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a_i8_fold.cu"
BLOCK_ROWS = _i8.BLOCK_ROWS
# bytes of a physical row of the folded mirror the kernel takes: one int8
# wgmma K step; every store of the port pads its features to 32 columns
PHYS_WIDTH = 32
# physical rows per matmul in the plain version
_REF_CHUNK_ROWS = 1 << 16
# the kernel's sizes (csrc/phase_a_i8_fold.cu): physical rows per ring
# stage, queries per grid, ring stages at most, and the shared memory a
# thread block may have
_STAGE_ROWS = 128
_TILE = 256
_MAX_STAGES = 24
_SMEM_LIMIT = 232448
# slot-query columns the rows-as-M kernel takes at most
_ROWS_MAX_COLUMNS = 64

# kernel launches since the process started (or a caller reset it)
LAUNCHES = 0
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Build the kernel from its source if its library is not current,
    and load it."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load(SOURCE)
            lib.oryx_phase_a_i8_fold.argtypes = ([ctypes.c_void_p] * 6
                                                 + [ctypes.c_int] * 6
                                                 + [ctypes.c_void_p])
            lib.oryx_phase_a_i8_fold.restype = ctypes.c_int
            lib.oryx_phase_a_i8_fold_plan.argtypes = ([ctypes.c_int] * 3
                                                      + [ctypes.c_void_p] * 4)
            lib.oryx_phase_a_i8_fold_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def query_tiles(fold: int, n_queries: int) -> list[tuple]:
    """The kernel's grids for a window of ``n_queries``, one per tile of up
    to 256 queries: (first query, queries, orientation, size).  Where the
    tile's wgmma query tile QN (8, 16, 32, 64: the least that holds it)
    times ``fold`` stays within 64 columns, the orientation is "rows" (the
    rows the M side, ``fold`` * QN slot-query columns the N side) and the
    size QN; else "queries" (the queries the M side) and the size the
    m-tiles of 64 queries in use: one up to 64 queries, two up to 128,
    else four."""
    tiles = []
    for q0 in range(0, n_queries, _TILE):
        n = min(_TILE, n_queries - q0)
        qn = max(8, 1 << (n - 1).bit_length())
        if fold * qn <= _ROWS_MAX_COLUMNS:
            tiles.append((q0, n, "rows", qn))
        else:
            tiles.append((q0, n, "queries", 4 if n > 128 else 2 if n > 64
                          else 1))
    return tiles


def _stage_bytes(fold: int, lsh: bool) -> int:
    return _STAGE_ROWS * PHYS_WIDTH + fold * _STAGE_ROWS * 4 * (2 if lsh
                                                                else 1)


def _smem_bytes(fold: int, lsh: bool, stages: int, qn: int | None) -> int:
    """Dynamic shared memory of a thread block: the ring, the slot copies
    of the query tile (and the rows kernel's cross-warp maxima of two
    stages), barriers."""
    queries = _TILE if qn is None else qn
    return (1024 + stages * _stage_bytes(fold, lsh)
            + fold * queries * PHYS_WIDTH
            + (0 if qn is None else 2 * 8 * qn * 4) + 2 * stages * 8)


def plan(fold: int, n_queries: int, lsh: bool = False) -> dict:
    """What a kernel call of this size runs on its first query tile:
    ``body`` ("wgmma"), ``variant`` (the kernel's name in the compiler's
    output: ``phase_a_i8_fold_tc`` with the rows as the wgmma M side,
    ``phase_a_i8_fold_tq`` with the queries), ``tiles`` (grids of up to
    256 queries), ``tile`` (the queries the tile's wgmma covers: QN, or 64
    per m-tile in use), ring ``stages`` and ``smem_bytes`` of one thread
    block (two share an SM in the rows orientation).  Computed here as the
    kernel computes it; ``library_plan`` asks the built library."""
    if fold not in (2, 4) or n_queries <= 0:
        raise ValueError(f"phase_a_i8_fold: no kernel for fold {fold} and "
                         f"{n_queries} queries")
    tiles = query_tiles(fold, n_queries)
    _, _, orient, size = tiles[0]
    qn = size if orient == "rows" else None
    budget = _SMEM_LIMIT // 2 - 1024 if qn else _SMEM_LIMIT
    stages = _MAX_STAGES
    while stages > 2 and _smem_bytes(fold, lsh, stages, qn) > budget:
        stages -= 1
    flag = "true" if lsh else "false"
    variant = (f"phase_a_i8_fold_tc<{fold}, {qn}, {flag}>" if qn
               else f"phase_a_i8_fold_tq<{fold}, {flag}>")
    return {"body": "wgmma", "variant": variant, "tiles": len(tiles),
            "tile": qn or 64 * size, "stages": stages,
            "smem_bytes": _smem_bytes(fold, lsh, stages, qn)}


def library_plan(fold: int, n_queries: int, lsh: bool = False) -> dict:
    """``plan`` as the built library computes it (builds it if it is not
    current)."""
    tiles, size, stages, smem = (ctypes.c_int() for _ in range(4))
    code = build().oryx_phase_a_i8_fold_plan(
        int(fold), int(n_queries), int(bool(lsh)), ctypes.byref(tiles),
        ctypes.byref(size), ctypes.byref(stages), ctypes.byref(smem))
    if code < 0:
        raise ValueError(f"phase_a_i8_fold: no kernel for fold {fold} and "
                         f"{n_queries} queries")
    flag = "true" if lsh else "false"
    variant = (f"phase_a_i8_fold_tc<{fold}, {size.value}, {flag}>"
               if code == 0 else f"phase_a_i8_fold_tq<{fold}, {flag}>")
    return {"body": "wgmma", "variant": variant, "tiles": tiles.value,
            "tile": size.value if code == 0 else 64 * size.value,
            "stages": stages.value, "smem_bytes": smem.value}


def phase_a_i8_fold_reference(q8: torch.Tensor, Y8f: torch.Tensor,
                              pen_i_f: torch.Tensor,
                              bkt_f: torch.Tensor | None = None,
                              target: torch.Tensor | None = None,
                              max_bits: int = 0, fold: int = 2,
                              bs: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed as the reference
    computes it: per fold slot, exact integer products of the folded rows
    with the slot-shifted query, plus the slot's int32 penalty and the LSH
    replacement, max over each block's ``bs / fold`` physical rows; then
    the max over slots."""
    nf = Y8f.shape[0]
    bsf = bs // fold
    b = q8.shape[0]
    qs = slot_queries(q8, fold)
    out = None
    for j in range(fold):
        pen = pen_i_f[j].reshape(-1)
        bkt = bkt_f[j].reshape(-1) if bkt_f is not None else None
        mj = torch.empty((b, nf // bsf), dtype=torch.int32,
                         device=Y8f.device)
        for start in range(0, nf, _REF_CHUNK_ROWS):
            stop = min(nf, start + _REF_CHUNK_ROWS)
            s = _i8.int_scores(qs[j], Y8f[start:stop]) + pen[start:stop]
            if bkt is not None:
                ok = _popcount(torch.bitwise_xor(
                    bkt[None, start:stop], target[:, None])) <= max_bits
                s = torch.where(ok, s, _i8.I8_PENALTY)
            mj[:, start // bsf:stop // bsf] = s.view(b, -1, bsf).amax(-1)
        out = mj if out is None else torch.maximum(out, mj)
    return out


def check_operands(q8, Y8f, pen_i_f, bkt_f, target, fold: int,
                   bs: int) -> int:
    """Checks the kernel's C interface leaves to the caller, on any
    device; returns the logical row width w = 32 / fold."""
    w = check_fold_operands("phase_a_i8_fold", q8, Y8f, pen_i_f, bkt_f,
                            target, fold, bs, (torch.int8,), torch.int32)
    width = Y8f.shape[1]
    if width != PHYS_WIDTH:
        raise ValueError(f"phase_a_i8_fold kernel needs {PHYS_WIDTH}-byte "
                         f"physical rows (fold 2 or 4), got W={width}")
    cuda_build.check_operand("phase_a_i8_fold", q8, "q8", torch.int8,
                             Y8f.device, (q8.shape[0], width))
    if any(t.data_ptr() % 16 for t in (pen_i_f, bkt_f) if t is not None):
        raise ValueError("phase_a_i8_fold: pen_i_f and bkt_f must be "
                         "16-byte aligned for the kernel's bulk copies")
    return w


def phase_a_i8_fold(q8: torch.Tensor, Y8f: torch.Tensor,
                    pen_i_f: torch.Tensor,
                    bkt_f: torch.Tensor | None = None,
                    target: torch.Tensor | None = None, max_bits: int = 0,
                    fold: int = 2, bs: int = BLOCK_ROWS) -> torch.Tensor:
    """Block maxima (B, N // bs) int32 over the folded int8 mirror.

    ``Y8f`` is the (N / fold, W) int8 mirror, ``q8`` the (B, W) int8
    query, ``pen_i_f`` the (fold, N // bs, bs // fold) int32
    0/``I8_PENALTY`` mask, ``bkt_f`` the buckets in the same layout and
    ``target`` (B,), int32.  A CPU ``Y8f`` takes the plain version.  A
    CUDA ``Y8f`` launches the kernel, which needs W = 32 (fold 2 or 4:
    every mirror a store of the port folds), or raises."""
    if Y8f.device.type == "cpu":
        return phase_a_i8_fold_reference(q8, Y8f, pen_i_f, bkt_f, target,
                                         max_bits, fold, bs)
    if Y8f.device.type != "cuda":
        raise ValueError(f"phase_a_i8_fold: unsupported device {Y8f.device}")
    w = check_operands(q8, Y8f, pen_i_f, bkt_f, target, fold, bs)
    nf, width = Y8f.shape
    b = q8.shape[0]
    n = nf * fold
    out = torch.empty((b, n // bs), dtype=torch.int32, device=Y8f.device)
    lib = build()
    with torch.cuda.device(Y8f.device):
        rc = lib.oryx_phase_a_i8_fold(
            Y8f.data_ptr(), q8.data_ptr(), pen_i_f.data_ptr(),
            bkt_f.data_ptr() if bkt_f is not None else None,
            target.data_ptr() if target is not None else None,
            out.data_ptr(), n, w, width, b, int(max_bits), fold,
            torch.cuda.current_stream(Y8f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"phase_a_i8_fold kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
