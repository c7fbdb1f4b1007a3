"""Phase A with the queries as the tensor cores' M side: per-128-row-block
maxima of Q·Yᵀ over a bf16 store, by a hand-written CUDA kernel
(``csrc/phase_a_qm.cu``).

Counterpart of ``variant_b`` of ``docs/bench_diag/lsh_mask_probe.py``,
which computes the LSH body of kernel 1 (``ops/phase_a.py``) with the
scores transposed to (queries, rows).  It computes what ``phase_a``
computes on a bf16 store, exact and LSH, with the same arguments and
checks, and the same plain version (``phase_a.phase_a_reference``).  No
route serves it: the port's ``bench/diag/lsh_mask_probe.py`` and
``chip_smoke.py`` launch it, to compare the two orientations.

``phase_a_qm`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors, and only for them, it computes the same
function with the plain version.  ``LAUNCHES`` counts the kernel's
launches (one per call); ``plan`` says what a call of a given size runs.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from . import cuda_build
from .phase_a import BLOCK_ROWS, MAX_WIDTH, phase_a_reference

__all__ = ["phase_a_qm", "build", "plan", "LAUNCHES", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "phase_a_qm.cu"
_WIDTH_ALIGN = 32

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
            lib.oryx_phase_a_qm.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 5
                                            + [ctypes.c_void_p])
            lib.oryx_phase_a_qm.restype = ctypes.c_int
            lib.oryx_phase_a_qm_plan.argtypes = ([ctypes.c_int] * 3
                                                 + [ctypes.c_void_p] * 6)
            lib.oryx_phase_a_qm_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def plan(features: int, n_queries: int, lsh: bool = True) -> dict:
    """What a kernel call of this size runs on its first query tile:
    ``tile`` (the queries of the tile, 64 per consumer warpgroup),
    ``kc`` (columns per ring stage row), ring ``stages``, ``smem_bytes``
    of one thread block; of the instantiation (exact or LSH), the
    ``registers`` of a thread at launch and ``local_bytes`` (what a
    thread spills).  Builds the library if it is not current."""
    vals = [ctypes.c_int() for _ in range(6)]
    code = build().oryx_phase_a_qm_plan(
        int(features), int(n_queries), int(bool(lsh)),
        *(ctypes.byref(v) for v in vals))
    if code < 0:
        raise ValueError(f"phase_a_qm: no kernel for {features} columns "
                         f"and {n_queries} queries")
    if code > 0:
        raise RuntimeError(f"phase_a_qm: kernel attributes: CUDA error "
                           f"{code}")
    tile, kc, stages, smem, regs, local = (v.value for v in vals)
    return {"body": "wgmma",
            "variant": f"phase_a_qm<{tile // 64}, {kc}, "
            f"{'true' if lsh else 'false'}>", "tile": tile, "kc": kc,
            "stages": stages, "smem_bytes": smem, "registers": regs,
            "local_bytes": local}


def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    cuda_build.check_operand("phase_a_qm", t, name, dtype, device, shape)


def phase_a_qm(Qc: torch.Tensor, Y: torch.Tensor, penalty: torch.Tensor,
               buckets: torch.Tensor | None = None,
               target: torch.Tensor | None = None, max_bits: int = 0,
               bs: int = BLOCK_ROWS) -> torch.Tensor:
    """Block maxima (B, N // bs) float32 of ``Qc @ Yᵀ + penalty``, with
    the LSH Hamming-ball mask when ``buckets``/``target`` are given.

    ``Y`` is the (N, F) bfloat16 store snapshot and ``Qc`` the (B, F)
    bfloat16 query; ``penalty`` the (N // bs, bs) float32 0/-inf live-row
    mask; ``buckets`` (N,) and ``target`` (B,) int32.  A CPU ``Y`` takes
    the plain version.  A CUDA ``Y`` launches the kernel, which needs a
    bfloat16 store, ``bs == 128``, N % 128 == 0, F % 32 == 0 and F <=
    ``MAX_WIDTH``; anything it does not take raises.  The kernel writes
    the maxima block-major, (N // bs, B), and the result is the (B, N //
    bs) view of that, not contiguous."""
    if Y.device.type == "cpu":
        return phase_a_reference(Qc, Y, penalty, buckets, target, max_bits,
                                 bs)
    if Y.device.type != "cuda":
        raise ValueError(f"phase_a_qm: unsupported device {Y.device}")
    if Y.dim() != 2 or Y.dtype != torch.bfloat16:
        raise ValueError("phase_a_qm: Y must be a 2-D bfloat16 tensor, got "
                         f"{Y.dtype} {tuple(Y.shape)}")
    n, f = Y.shape
    b = Qc.shape[0] if Qc.dim() == 2 else 0
    if bs != BLOCK_ROWS or n % BLOCK_ROWS or f % _WIDTH_ALIGN \
            or f > MAX_WIDTH or b == 0:
        raise ValueError(
            f"phase_a_qm kernel needs bs == {BLOCK_ROWS}, N % {BLOCK_ROWS} "
            f"== 0, F % {_WIDTH_ALIGN} == 0, F <= {MAX_WIDTH} and B > 0; got "
            f"bs={bs}, Y {n}x{f}, B={b}")
    dev = Y.device
    _check(Y, "Y", torch.bfloat16, dev, (n, f))
    _check(Qc, "Qc", torch.bfloat16, dev, (b, f))
    _check(penalty, "penalty", torch.float32, dev, (n // bs, bs))
    if (buckets is None) != (target is None):
        raise ValueError("phase_a_qm: buckets and target come together")
    if buckets is not None:
        _check(buckets, "buckets", torch.int32, dev, (n,))
        _check(target, "target", torch.int32, dev, (b,))
    if any(t.data_ptr() % 16 for t in (Y, Qc, penalty, buckets)
           if t is not None):
        raise ValueError("phase_a_qm: Y, Qc, penalty and buckets must be "
                         "16-byte aligned for the kernel's copies")
    # block-major, as the kernel writes it: one block's maxima contiguous
    out = torch.empty((n // bs, b), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.oryx_phase_a_qm(
            Y.data_ptr(), Qc.data_ptr(), penalty.data_ptr(),
            buckets.data_ptr() if buckets is not None else None,
            target.data_ptr() if target is not None else None,
            out.data_ptr(), n, f, f, b, int(max_bits),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"phase_a_qm kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out.T
