"""Phase A of the two-phase streaming top-k: per-128-row-block maxima of
Q·Yᵀ, by hand-written CUDA kernels (``csrc/phase_a.cu``): a bf16 store
on the tensor cores (``wgmma`` fed by TMA), a float32 store in FFMA.

Counterpart of the Pallas kernel inside
``oryx_tpu/app/als/serving_model.py::_batch_top_n_twophase_pallas``,
both bodies: exact, and LSH (rows outside the query's Hamming ball set
to -inf first).  ``phase_a`` launches the kernel for CUDA tensors and
raises if it cannot; for CPU tensors, and only for them, it computes the
same function with ``phase_a_reference``, the plain PyTorch version.
``LAUNCHES`` counts the kernel's launches (one per call, whatever number
of grids the entry point runs for it); ``plan`` says which design a call
of a given size runs.

The output is (B, N // 128) float32 — the layout phase B reads.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..app.als.lsh import _popcount
from . import cuda_build

__all__ = ["phase_a", "phase_a_reference", "build", "plan", "LAUNCHES",
           "BLOCK_ROWS", "SOURCE", "MIN_PLAIN_ROWS", "MAX_WIDTH",
           "pad_rows"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a.cu"
# rows per block maximum; the kernel's BS
BLOCK_ROWS = 128
# the kernel stages this many feature columns at a time: the store pads
# its columns to a multiple of it
_WIDTH_ALIGN = 32
# widest row the kernels take: they keep a whole query tile (up to 128
# float32 or 256 bf16 queries of this width) in shared memory
MAX_WIDTH = 256
# oryx_phase_a_plan's body codes
_BODIES = ("wgmma", "ffma", "ffma")
# rows per matmul in the plain version: bounds its (B, rows) score tile
_REF_CHUNK_ROWS = 1 << 17
# the plain version multiplies at least this many query rows (zero rows
# past B): cuBLAS then takes an SGEMM that sums each dot product over the
# columns in order, as the kernel's FMA chain does, so the two agree bit
# for bit; for a few rows it picks another algorithm, whose sums differ
# in the last bits (cuBLAS of CUDA 12.8 on an H100)
MIN_PLAIN_ROWS = 32

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
            lib.oryx_phase_a.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
            lib.oryx_phase_a.restype = ctypes.c_int
            lib.oryx_phase_a_plan.argtypes = ([ctypes.c_int] * 3
                                              + [ctypes.c_void_p] * 3)
            lib.oryx_phase_a_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def plan(features: int, n_queries: int, bf16: bool) -> dict:
    """What a kernel call of this size runs: ``body`` ("wgmma" or
    "ffma"), ``variant`` (the kernel's name in the compiler's output),
    ``tile`` (the wgmma N of the first query tile, or the queries per
    FFMA tile), ring ``stages`` and ``smem_bytes`` of one thread block.
    Builds the library if it is not current."""
    tile, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = build().oryx_phase_a_plan(
        int(features), int(n_queries), int(bool(bf16)), ctypes.byref(tile),
        ctypes.byref(stages), ctypes.byref(smem))
    if code < 0:
        raise ValueError(f"phase_a: no kernel for {features} columns and "
                         f"{n_queries} queries")
    kc = 64 if features % 64 == 0 else 32
    variant = (f"phase_a_tc<{tile.value}, {kc}>", "phase_a_narrow",
               f"phase_a_wide<{tile.value}, {kc}>")[code]
    return {"body": _BODIES[code], "variant": variant, "tile": tile.value,
            "stages": stages.value, "smem_bytes": smem.value}


def pad_rows(q: torch.Tensor, rows: int = MIN_PLAIN_ROWS) -> torch.Tensor:
    """``q`` with zero rows appended up to ``rows`` rows."""
    return torch.nn.functional.pad(q, (0, 0, 0, max(0, rows - q.shape[0])))


def phase_a_reference(Qc: torch.Tensor, Y: torch.Tensor,
                      penalty: torch.Tensor,
                      buckets: torch.Tensor | None = None,
                      target: torch.Tensor | None = None,
                      max_bits: int = 0,
                      bs: int = BLOCK_ROWS) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``Qc @ Yᵀ`` in row
    chunks, in float32 (a bf16 operand widens exactly, so its products
    are the bf16 x bf16 products the kernel forms), plus the penalty and
    the LSH mask, reshaped and max-reduced per ``bs``-row block."""
    n = Y.shape[0]
    b = Qc.shape[0]
    q = pad_rows(Qc.to(torch.float32))
    pen = penalty.reshape(-1)
    out = torch.empty((b, n // bs), dtype=torch.float32, device=Y.device)
    for start in range(0, n, _REF_CHUNK_ROWS):
        stop = min(n, start + _REF_CHUNK_ROWS)
        s = (q @ Y[start:stop].to(torch.float32).T)[:b] + pen[start:stop]
        if buckets is not None:
            ok = _popcount(torch.bitwise_xor(buckets[None, start:stop],
                                             target[:, None])) <= max_bits
            s = torch.where(ok, s, float("-inf"))
        out[:, start // bs:stop // bs] = s.view(b, -1, bs).amax(-1)
    return out


def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    cuda_build.check_operand("phase_a", t, name, dtype, device, shape)


def phase_a(Qc: torch.Tensor, Y: torch.Tensor, penalty: torch.Tensor,
            buckets: torch.Tensor | None = None,
            target: torch.Tensor | None = None, max_bits: int = 0,
            bs: int = BLOCK_ROWS) -> torch.Tensor:
    """Block maxima (B, N // bs) float32 of ``Qc @ Yᵀ + penalty``, with
    the LSH Hamming-ball mask when ``buckets``/``target`` are given.

    ``Y`` is the (N, F) store snapshot, float32 or bfloat16; ``Qc`` the
    (B, F) query in the same dtype; ``penalty`` the (N // bs, bs) float32
    0/-inf live-row mask; ``buckets`` (N,) and ``target`` (B,) int32.
    A CPU ``Y`` takes the plain version.  A CUDA ``Y`` launches the
    kernel, which needs ``bs == 128``, N % 128 == 0, F % 32 == 0 and
    F <= ``MAX_WIDTH``; anything it does not take raises."""
    if Y.device.type == "cpu":
        return phase_a_reference(Qc, Y, penalty, buckets, target, max_bits,
                                 bs)
    if Y.device.type != "cuda":
        raise ValueError(f"phase_a: unsupported device {Y.device}")
    if Y.dim() != 2 or Y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("phase_a: Y must be a 2-D float32 or bfloat16 "
                         f"tensor, got {Y.dtype} {tuple(Y.shape)}")
    n, f = Y.shape
    b = Qc.shape[0] if Qc.dim() == 2 else 0
    if bs != BLOCK_ROWS or n % BLOCK_ROWS or f % _WIDTH_ALIGN \
            or f > MAX_WIDTH or b == 0:
        raise ValueError(
            f"phase_a kernel needs bs == {BLOCK_ROWS}, N % {BLOCK_ROWS} == 0,"
            f" F % {_WIDTH_ALIGN} == 0, F <= {MAX_WIDTH} and B > 0; got "
            f"bs={bs}, Y {n}x{f}, B={b}")
    dev = Y.device
    _check(Y, "Y", Y.dtype, dev, (n, f))
    _check(Qc, "Qc", Y.dtype, dev, (b, f))
    _check(penalty, "penalty", torch.float32, dev, (n // bs, bs))
    if (buckets is None) != (target is None):
        raise ValueError("phase_a: buckets and target come together")
    if buckets is not None:
        _check(buckets, "buckets", torch.int32, dev, (n,))
        _check(target, "target", torch.int32, dev, (b,))
    if any(t.data_ptr() % 16 for t in (Y, Qc, penalty, buckets)
           if t is not None):
        raise ValueError("phase_a: Y, Qc, penalty and buckets must be "
                         "16-byte aligned for the kernel's vector loads")
    out = torch.empty((b, n // bs), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.oryx_phase_a(
            Y.data_ptr(), Qc.data_ptr(), penalty.data_ptr(),
            buckets.data_ptr() if buckets is not None else None,
            target.data_ptr() if target is not None else None,
            out.data_ptr(), n, f, f, b, int(max_bits),
            int(Y.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"phase_a kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
