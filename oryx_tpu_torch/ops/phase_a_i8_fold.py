"""Phase A over the folded int8 mirror: per-128-row-block maxima of the
integer products, by the hand-written CUDA kernel of
``csrc/phase_a_i8_fold.cu`` (``__dp4a`` on the CUDA cores).

Counterpart of the Pallas kernel inside
``oryx_tpu/app/als/serving_model.py::_batch_top_n_twophase_pallas_i8_fold``,
both bodies.  The mirror ``Y8f`` (N / fold, W) int8 is laid out as
``ops/phase_a_fold.py`` describes; the penalty is int32 in the same
slot-major layout.  The plain version, ``phase_a_i8_fold_reference``,
computes the reference's way (one integer product per slot against a
slot-shifted query, max over slots); the kernel reads N logical rows of
w bytes.  Both are exact, and equal ``phase_a_i8`` on the unfolded
mirror bit for bit: quantized lanes past the features are zeros.
``phase_a_i8_fold`` launches the kernel for CUDA tensors and raises if
it cannot, and takes the plain version for CPU tensors only.
``LAUNCHES`` counts the kernel's launches.
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
           "LAUNCHES", "BLOCK_ROWS", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a_i8_fold.cu"
BLOCK_ROWS = _i8.BLOCK_ROWS
# physical rows per matmul in the plain version
_REF_CHUNK_ROWS = 1 << 16

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
            _lib = lib
        return _lib


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


def phase_a_i8_fold(q8: torch.Tensor, Y8f: torch.Tensor,
                    pen_i_f: torch.Tensor,
                    bkt_f: torch.Tensor | None = None,
                    target: torch.Tensor | None = None, max_bits: int = 0,
                    fold: int = 2, bs: int = BLOCK_ROWS) -> torch.Tensor:
    """Block maxima (B, N // bs) int32 over the folded int8 mirror.

    ``Y8f`` is the (N / fold, W) int8 mirror, ``q8`` the (B, W) int8
    query, ``pen_i_f`` the (fold, N // bs, bs // fold) int32
    0/``I8_PENALTY`` mask, ``bkt_f`` the buckets in the same layout and
    ``target`` (B,), int32.  A CPU ``Y8f`` takes the plain version; a
    CUDA ``Y8f`` launches the kernel or raises."""
    if Y8f.device.type == "cpu":
        return phase_a_i8_fold_reference(q8, Y8f, pen_i_f, bkt_f, target,
                                         max_bits, fold, bs)
    if Y8f.device.type != "cuda":
        raise ValueError(f"phase_a_i8_fold: unsupported device {Y8f.device}")
    w = check_fold_operands("phase_a_i8_fold", q8, Y8f, pen_i_f, bkt_f,
                            target, fold, bs, (torch.int8,), torch.int32)
    nf, width = Y8f.shape
    cuda_build.check_operand("phase_a_i8_fold", q8, "q8", torch.int8,
                             Y8f.device, (q8.shape[0], width))
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
