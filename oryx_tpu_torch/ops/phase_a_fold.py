"""Phase A over the folded mirror of a narrow store: per-128-row-block
maxima of Q·Yᵀ, by the hand-written CUDA kernel of
``csrc/phase_a_fold.cu``.

Counterpart of the Pallas kernel inside
``oryx_tpu/app/als/serving_model.py::_batch_top_n_twophase_pallas_fold``,
both bodies.  The folded mirror ``Yf`` (N / fold, W) holds logical row
``i·fold + j`` in columns ``[j·w, j·w + w)`` of its row ``i``
(w = W / fold); the penalty and the LSH buckets come in its slot-major
(fold, N / 128, 128 / fold) layout.  The plain version,
``phase_a_fold_reference``, computes the reference's way: one product
per slot against a slot-shifted copy of the query, a block max per slot,
the max over slots.  The kernel reads the same memory as N logical rows
of w columns (``Yf.view(N, w)``) and the side inputs at their slot-major
offsets, and multiplies only the first ``features`` columns of each
(the rest are zeros in the store and the query; the plain version
multiplies all of them).  ``phase_a_fold`` launches the kernel for CUDA
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
from . import phase_a as _pa

__all__ = ["phase_a_fold", "phase_a_fold_reference", "slot_queries",
           "check_fold_operands", "check_fold_shape", "check_shape",
           "check_features", "build", "plan",
           "LAUNCHES", "BLOCK_ROWS", "SOURCE", "WIDTHS"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a_fold.cu"
BLOCK_ROWS = _pa.BLOCK_ROWS
# logical row widths w = W / fold the kernel takes: the store pads its
# rows to a multiple of 32 columns and folds only where the features fit
# half or a quarter of them, so its folded mirrors have 8 or 16 columns
WIDTHS = (8, 16)
# oryx_phase_a_fold_plan's body codes
_BODIES = {1: ("ffma", "fold_narrow"), 2: ("ffma", "fold_wide")}
# physical rows per matmul in the plain versions
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
            lib.oryx_phase_a_fold.argtypes = ([ctypes.c_void_p] * 6
                                              + [ctypes.c_int] * 8
                                              + [ctypes.c_void_p])
            lib.oryx_phase_a_fold.restype = ctypes.c_int
            lib.oryx_phase_a_fold_plan.argtypes = ([ctypes.c_int] * 3
                                                   + [ctypes.c_void_p] * 3)
            lib.oryx_phase_a_fold_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def plan(width: int, n_queries: int, bf16: bool,
         features: int | None = None) -> dict:
    """What a kernel call of this size runs (``width`` = w, the logical
    row width; ``features`` as ``phase_a_fold`` takes it): ``body``
    ("ffma"), ``variant`` (the kernel's name in the compiler's output),
    ``tile`` (queries per register tile), ring ``stages`` and
    ``smem_bytes`` of one thread block.  Builds the library if it is not
    current."""
    tile, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = build().oryx_phase_a_fold_plan(
        int(width), int(n_queries), int(bool(bf16)), ctypes.byref(tile),
        ctypes.byref(stages), ctypes.byref(smem))
    if code < 0:
        raise ValueError(f"phase_a_fold: no kernel for width {width} and "
                         f"{n_queries} queries")
    body, name = _BODIES[code]
    args = f"{'true' if bf16 else 'false'}, {width}"
    if code == 2:
        # the wide kernel's column groups: 3 or 4 of a 16-column row, all
        # of an 8-column one
        f = check_features("phase_a_fold", features, width)
        kg = max(3, -(-f // 4)) if width == 16 else width // 4
        args += f", {tile.value}, {kg}"
    return {"body": body, "variant": f"{name}<{args}>", "tile": tile.value,
            "stages": stages.value, "smem_bytes": smem.value}


def check_features(kernel: str, features: int | None, w: int) -> int:
    """The number of leading columns the kernel multiplies: ``features``,
    or all ``w`` when it is None; raises unless 0 < features <= w."""
    if features is None:
        return w
    if not 0 < features <= w:
        raise ValueError(f"{kernel}: features must be in 1..{w} (the "
                         f"logical row width), got {features}")
    return int(features)


def slot_queries(q: torch.Tensor, fold: int) -> torch.Tensor:
    """(fold, B, W) slot-shifted copies of the (B, W) query: copy ``j``
    holds the first w = W / fold columns of ``q`` in columns
    ``[j·w, j·w + w)`` and zeros elsewhere, which kill the other slots'
    features in a product with a folded row."""
    b, width = q.shape
    w = width // fold
    out = torch.zeros((fold, b, width), dtype=q.dtype, device=q.device)
    for j in range(fold):
        out[j, :, j * w:(j + 1) * w] = q[:, :w]
    return out


def phase_a_fold_reference(Qc: torch.Tensor, Yf: torch.Tensor,
                           pen_f: torch.Tensor,
                           bkt_f: torch.Tensor | None = None,
                           target: torch.Tensor | None = None,
                           max_bits: int = 0, fold: int = 2,
                           bs: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed as the reference
    computes it: per fold slot, ``Yf @ Qs[j]ᵀ`` in float32 (a bf16
    operand widens exactly) over physical-row chunks, plus the slot's
    penalty and LSH mask, max over each block's ``bs / fold`` physical
    rows; then the max over slots."""
    nf = Yf.shape[0]
    bsf = bs // fold
    b = Qc.shape[0]
    qs = slot_queries(_pa.pad_rows(Qc), fold).to(torch.float32)
    out = None
    for j in range(fold):
        pen = pen_f[j].reshape(-1)
        bkt = bkt_f[j].reshape(-1) if bkt_f is not None else None
        mj = torch.empty((b, nf // bsf), dtype=torch.float32,
                         device=Yf.device)
        for start in range(0, nf, _REF_CHUNK_ROWS):
            stop = min(nf, start + _REF_CHUNK_ROWS)
            s = (qs[j] @ Yf[start:stop].to(torch.float32).T)[:b] \
                + pen[start:stop]
            if bkt is not None:
                ok = _popcount(torch.bitwise_xor(
                    bkt[None, start:stop], target[:, None])) <= max_bits
                s = torch.where(ok, s, float("-inf"))
            mj[:, start // bsf:stop // bsf] = s.view(b, -1, bsf).amax(-1)
        out = mj if out is None else torch.maximum(out, mj)
    return out


def check_fold_shape(kernel: str, nf: int, width: int, fold: int, b: int,
                     bs: int = BLOCK_ROWS) -> int:
    """Raise unless a folded kernel takes ``b`` queries over an ``nf`` x
    ``width`` mirror of ``fold`` logical rows per physical row; returns
    the logical row width w = W / fold."""
    w = width // fold if fold else 0
    if bs != BLOCK_ROWS or fold not in (2, 4) or width % 32 \
            or w not in (8, 16) and w % 32 or nf % (bs // fold) or b == 0:
        raise ValueError(
            f"{kernel} kernel needs bs == {BLOCK_ROWS}, fold 2 or 4, W % 32 "
            "== 0, W / fold 8, 16 or a multiple of 32, whole blocks and "
            f"B > 0; got bs={bs}, fold={fold}, Yf {nf}x{width}, B={b}")
    return w


def check_shape(nf: int, width: int, fold: int, b: int,
                bs: int = BLOCK_ROWS) -> int:
    """``check_fold_shape`` for this kernel, which also needs W / fold in
    ``WIDTHS``; returns w."""
    w = check_fold_shape("phase_a_fold", nf, width, fold, b, bs)
    if w not in WIDTHS:
        raise ValueError(f"phase_a_fold kernel needs W / fold in {WIDTHS}, "
                         f"got {w}")
    return w


def check_fold_operands(kernel: str, q, Yf, pen_f, bkt_f, target,
                        fold: int, bs: int, y_dtypes, pen_dtype) -> int:
    """Checks the folded kernels' C interface leaves to the caller;
    returns the logical row width w = W / fold."""
    if Yf.dim() != 2 or Yf.dtype not in y_dtypes:
        raise ValueError(f"{kernel}: Yf must be a 2-D tensor of one of "
                         f"{y_dtypes}, got {Yf.dtype} {tuple(Yf.shape)}")
    nf, width = Yf.shape
    b = q.shape[0] if q.dim() == 2 else 0
    w = check_fold_shape(kernel, nf, width, fold, b, bs)
    dev = Yf.device
    check = cuda_build.check_operand
    n_blocks = nf * fold // bs
    check(kernel, Yf, "Yf", Yf.dtype, dev, (nf, width))
    check(kernel, pen_f, "pen_f", pen_dtype, dev, (fold, n_blocks, bs // fold))
    if (bkt_f is None) != (target is None):
        raise ValueError(f"{kernel}: bkt_f and target come together")
    if bkt_f is not None:
        check(kernel, bkt_f, "bkt_f", torch.int32, dev,
              (fold, n_blocks, bs // fold))
        check(kernel, target, "target", torch.int32, dev, (b,))
    if Yf.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{kernel}: Yf and the query must be 16-byte "
                         "aligned for the kernel's vector loads")
    return w


def phase_a_fold(Qc: torch.Tensor, Yf: torch.Tensor, pen_f: torch.Tensor,
                 bkt_f: torch.Tensor | None = None,
                 target: torch.Tensor | None = None, max_bits: int = 0,
                 fold: int = 2, bs: int = BLOCK_ROWS,
                 features: int | None = None) -> torch.Tensor:
    """Block maxima (B, N // bs) float32 over the folded mirror.

    ``Yf`` is the (N / fold, W) float32 or bfloat16 mirror, ``Qc`` the
    (B, W) query in its dtype, ``pen_f`` the (fold, N // bs, bs // fold)
    float32 0/-inf mask, ``bkt_f`` the buckets in the same layout and
    ``target`` (B,), int32.  ``features`` (default: all w = W / fold
    columns) is the number of leading columns of a logical row that may
    be non-zero; the kernel multiplies no further, which leaves the
    maxima unchanged when the columns past it are zeros.  It must be in
    1..w on every device.  A CPU ``Yf`` takes the plain version; a CUDA
    ``Yf`` launches the kernel or raises."""
    if Yf.dim() == 2 and fold:
        check_features("phase_a_fold", features, Yf.shape[1] // fold)
    if Yf.device.type == "cpu":
        return phase_a_fold_reference(Qc, Yf, pen_f, bkt_f, target,
                                      max_bits, fold, bs)
    if Yf.device.type != "cuda":
        raise ValueError(f"phase_a_fold: unsupported device {Yf.device}")
    w = check_fold_operands("phase_a_fold", Qc, Yf, pen_f, bkt_f, target,
                            fold, bs, (torch.float32, torch.bfloat16),
                            torch.float32)
    nf, width = Yf.shape
    b = Qc.shape[0]
    check_shape(nf, width, fold, b, bs)
    cuda_build.check_operand("phase_a_fold", Qc, "Qc", Yf.dtype, Yf.device,
                             (b, width))
    features = check_features("phase_a_fold", features, w)
    n = nf * fold
    out = torch.empty((b, n // bs), dtype=torch.float32, device=Yf.device)
    lib = build()
    with torch.cuda.device(Yf.device):
        rc = lib.oryx_phase_a_fold(
            Yf.data_ptr(), Qc.data_ptr(), pen_f.data_ptr(),
            bkt_f.data_ptr() if bkt_f is not None else None,
            target.data_ptr() if target is not None else None,
            out.data_ptr(), n, w, width, b, int(max_bits),
            int(Yf.dtype == torch.bfloat16), fold, features,
            torch.cuda.current_stream(Yf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"phase_a_fold kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
