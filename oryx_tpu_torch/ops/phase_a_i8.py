"""Phase A on the int8 mirror: per-128-row-block maxima of the integer
products ``Y8 · q8ᵀ``, by a hand-written CUDA kernel on the tensor cores
(``csrc/phase_a_i8.cu``: int8 ``wgmma`` fed by TMA).

Counterpart of the Pallas kernel inside
``oryx_tpu/app/als/serving_model.py::_batch_top_n_twophase_pallas_i8``,
both bodies: exact, and LSH (the score of a row outside the query's
Hamming ball replaced by ``I8_PENALTY``).  ``phase_a_i8`` launches the
kernel for CUDA tensors and raises if it cannot; for CPU tensors, and
only for them, it computes the same function with
``phase_a_i8_reference``, the plain PyTorch version.  ``LAUNCHES``
counts the kernel's launches (one per call, whatever number of grids
the entry point runs for it); ``plan`` says which design a call of a
given size runs.

The output is (B, N // 128) int32.  Integer sums are exact, so the
kernel's maxima equal the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..app.als.lsh import _popcount
from . import cuda_build

__all__ = ["phase_a_i8", "phase_a_i8_reference", "int_scores", "build",
           "plan", "LAUNCHES", "BLOCK_ROWS", "I8_PENALTY", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a_i8.cu"
# rows per block maximum; the kernel's BS
BLOCK_ROWS = 128
# retired-row penalty (the reference's _I8_PENALTY): far below any int8
# dot product, far from int32 overflow when added to one
I8_PENALTY = -(1 << 29)
# the kernel reads its rows in chunks of 32, 64 or 128 bytes (one wgmma
# K step is 32 bytes) and keeps |sums| < 2^23
_WIDTH_ALIGN = 32
_MAX_WIDTH = 256
# rows per matmul in the plain version: bounds its (B, rows) score tile
_REF_CHUNK_ROWS = 1 << 17
# float32 holds every integer below 2^24 exactly: int8 products summed
# over at most this many columns stay below it
_EXACT_F32_WIDTH = (1 << 24) // (127 * 127)

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
            lib.oryx_phase_a_i8.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p])
            lib.oryx_phase_a_i8.restype = ctypes.c_int
            lib.oryx_phase_a_i8_plan.argtypes = ([ctypes.c_int] * 2
                                                 + [ctypes.c_void_p] * 4)
            lib.oryx_phase_a_i8_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def plan(width: int, n_queries: int) -> dict:
    """What a kernel call of this size runs on its first query tile:
    ``body`` ("wgmma"), ``variant`` (the kernel's name in the compiler's
    output: ``phase_a_i8_tc`` with the queries as the wgmma N side up to
    64 queries, ``phase_a_i8_tq`` with them as the M side above), ``tile``
    (the queries of the tile), ``chunk_bytes`` (bytes of a row per ring
    stage, and the swizzle), ring ``stages`` and ``smem_bytes`` of one
    thread block.  Builds the library if it is not current."""
    tile, chunk, stages, smem = (ctypes.c_int() for _ in range(4))
    code = build().oryx_phase_a_i8_plan(
        int(width), int(n_queries), ctypes.byref(tile), ctypes.byref(chunk),
        ctypes.byref(stages), ctypes.byref(smem))
    if code < 0:
        raise ValueError(f"phase_a_i8: no kernel for width {width} and "
                         f"{n_queries} queries")
    variant = (f"phase_a_i8_tc<{tile.value}, {chunk.value}>" if code == 0
               else f"phase_a_i8_tq<{chunk.value}>")
    return {"body": "wgmma", "variant": variant,
            "tile": tile.value, "chunk_bytes": chunk.value,
            "stages": stages.value, "smem_bytes": smem.value}


def int_scores(q8: torch.Tensor, y8: torch.Tensor) -> torch.Tensor:
    """(B, rows) int32 products ``q8 · y8ᵀ`` of int8 operands, exact: a
    float32 product in full precision holds these integer sums exactly in
    any order, and runs on every device (CUDA has no int32 matmul)."""
    if y8.shape[-1] > _EXACT_F32_WIDTH:
        raise ValueError(f"int_scores: width {y8.shape[-1]} exceeds "
                         f"{_EXACT_F32_WIDTH}, where float32 sums stop "
                         "being exact")
    if y8.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int_scores needs full float32 products; "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    return (q8.to(torch.float32) @ y8.to(torch.float32).T).to(torch.int32)


def phase_a_i8_reference(q8: torch.Tensor, Y8: torch.Tensor,
                         penalty_i: torch.Tensor,
                         buckets: torch.Tensor | None = None,
                         target: torch.Tensor | None = None,
                         max_bits: int = 0,
                         bs: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch: exact integer products in
    row chunks, plus the int32 penalty, the LSH replacement, and the max
    over each ``bs``-row block."""
    n = Y8.shape[0]
    b = q8.shape[0]
    pen = penalty_i.reshape(-1)
    out = torch.empty((b, n // bs), dtype=torch.int32, device=Y8.device)
    for start in range(0, n, _REF_CHUNK_ROWS):
        stop = min(n, start + _REF_CHUNK_ROWS)
        s = int_scores(q8, Y8[start:stop]) + pen[start:stop]
        if buckets is not None:
            ok = _popcount(torch.bitwise_xor(buckets[None, start:stop],
                                             target[:, None])) <= max_bits
            s = torch.where(ok, s, I8_PENALTY)
        out[:, start // bs:stop // bs] = s.view(b, -1, bs).amax(-1)
    return out


def phase_a_i8(q8: torch.Tensor, Y8: torch.Tensor, penalty_i: torch.Tensor,
               buckets: torch.Tensor | None = None,
               target: torch.Tensor | None = None, max_bits: int = 0,
               bs: int = BLOCK_ROWS) -> torch.Tensor:
    """Block maxima (B, N // bs) int32 of ``q8 · Y8ᵀ + penalty_i``, with
    the LSH replacement when ``buckets``/``target`` are given.

    ``Y8`` is the (N, W) int8 mirror, ``q8`` the (B, W) int8 query,
    ``penalty_i`` the (N // bs, bs) int32 0/``I8_PENALTY`` live-row mask,
    ``buckets`` (N,) and ``target`` (B,) int32.  A CPU ``Y8`` takes the
    plain version.  A CUDA ``Y8`` launches the kernel, which needs
    ``bs == 128``, N % 128 == 0 and W a multiple of 32 up to 256;
    anything it does not take raises."""
    if Y8.device.type == "cpu":
        return phase_a_i8_reference(q8, Y8, penalty_i, buckets, target,
                                    max_bits, bs)
    if Y8.device.type != "cuda":
        raise ValueError(f"phase_a_i8: unsupported device {Y8.device}")
    if Y8.dim() != 2 or Y8.dtype != torch.int8:
        raise ValueError("phase_a_i8: Y8 must be a 2-D int8 tensor, got "
                         f"{Y8.dtype} {tuple(Y8.shape)}")
    n, w = Y8.shape
    b = q8.shape[0] if q8.dim() == 2 else 0
    if bs != BLOCK_ROWS or n % BLOCK_ROWS or w % _WIDTH_ALIGN \
            or w > _MAX_WIDTH or b == 0:
        raise ValueError(
            f"phase_a_i8 kernel needs bs == {BLOCK_ROWS}, N % {BLOCK_ROWS} "
            f"== 0, W % {_WIDTH_ALIGN} == 0, W <= {_MAX_WIDTH} and B > 0; "
            f"got bs={bs}, Y8 {n}x{w}, B={b}")
    dev = Y8.device
    check = cuda_build.check_operand
    check("phase_a_i8", Y8, "Y8", torch.int8, dev, (n, w))
    check("phase_a_i8", q8, "q8", torch.int8, dev, (b, w))
    check("phase_a_i8", penalty_i, "penalty_i", torch.int32, dev,
          (n // bs, bs))
    if (buckets is None) != (target is None):
        raise ValueError("phase_a_i8: buckets and target come together")
    if buckets is not None:
        check("phase_a_i8", buckets, "buckets", torch.int32, dev, (n,))
        check("phase_a_i8", target, "target", torch.int32, dev, (b,))
    if any(t.data_ptr() % 16 for t in (Y8, q8, penalty_i, buckets)
           if t is not None):
        raise ValueError("phase_a_i8: Y8, q8, penalty_i and buckets must be "
                         "16-byte aligned for the kernel's vector loads")
    out = torch.empty((b, n // bs), dtype=torch.int32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.oryx_phase_a_i8(
            Y8.data_ptr(), q8.data_ptr(), penalty_i.data_ptr(),
            buckets.data_ptr() if buckets is not None else None,
            target.data_ptr() if target is not None else None,
            out.data_ptr(), n, w, w, b, int(max_bits), 1,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"phase_a_i8 kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
