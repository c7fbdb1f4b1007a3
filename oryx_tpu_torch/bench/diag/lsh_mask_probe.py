"""Phase-A LSH-mask layout probe (diagnostic, not product code).

Counterpart of ``docs/bench_diag/lsh_mask_probe.py``, whose three Pallas
variants compute kernel 1's block maxima in two layouts.  Here each is
the port's hand-written counterpart of that variant:

- ``variant_exact`` (kernel 7, the exact body): ``ops/phase_a.phase_a``;
- ``variant_a`` (kernel 5, the LSH body with (rows, queries) scores):
  ``phase_a`` with buckets — the item rows are the wgmma M side;
- ``variant_b`` (kernel 6, the LSH body with (queries, rows) scores):
  ``ops/phase_a_qm.phase_a_qm`` — the queries are the M side, and the
  block maximum reduces over each thread's own columns.

Each takes the reference's inputs (Y (N, W), Qc (B, W), penalty and
buckets (N // 128, 128), target (1, B)) and returns the port's (B, N //
128) float32 maxima.  ``run`` builds the reference's inputs on the card
from a seed (N = items rounded down to 4096 rows, W = 128 bf16, buckets
0-127, one differing bit allowed), holds the two LSH variants against
each other (-inf in the same places, finite maxima within rtol 1e-4:
the two wgmma orders sum differently), and times each variant's line:
``exec_ms`` from ``kernel_probe.time_exec``, the bound (each byte once,
2·N·W·B operations, from the card's data sheet), the plain version's
time and one ``torch.matmul`` per row chunk as the library yardstick.

Usage: python -m oryx_tpu_torch.bench.diag.lsh_mask_probe [--items-m 20]
Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import json

import torch

from ...common.device import resolve_device
from ...ops import phase_a as _pa
from ...ops import phase_a_qm as _qm
from ..kernel_probe import bound, matmul_block_max, time_exec

__all__ = ["variant_a", "variant_b", "variant_exact", "make_inputs",
           "check_agree", "run", "T", "BS", "MB", "W"]

T = 4096  # the reference's tile: N is a whole number of them
BS = 128
MB = 1
W = 128
REPLACES = "docs/bench_diag/lsh_mask_probe.py"


def variant_a(Y, Qc, pen, bkt, tgt, mb: int):
    """Kernel 5: the LSH body, item rows on the M side (``phase_a``)."""
    return _pa.phase_a(Qc, Y, pen, bkt.reshape(-1), tgt.reshape(-1), mb)


def variant_b(Y, Qc, pen, bkt, tgt, mb: int):
    """Kernel 6: the LSH body, queries on the M side (``phase_a_qm``)."""
    return _qm.phase_a_qm(Qc, Y, pen, bkt.reshape(-1), tgt.reshape(-1), mb)


def variant_exact(Y, Qc, pen):
    """Kernel 7: no mask, the floor both LSH variants chase."""
    return _pa.phase_a(Qc, Y, pen)


def make_inputs(items_m: float = 20.0, batch: int = 256, device=None,
                seed: int = 0):
    """The reference's inputs on ``device`` (None means ``cuda``): dense
    random bf16 rows and queries, a zero penalty, buckets and targets
    drawn from 0-127."""
    dev = resolve_device(device)
    n = int(items_m * 1e6) // T * T
    gen = torch.Generator(device=dev).manual_seed(seed)
    Y = torch.randn((n, W), generator=gen, device=dev, dtype=torch.bfloat16)
    Qc = torch.randn((batch, W), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    pen = torch.zeros((n // BS, BS), dtype=torch.float32, device=dev)
    bkt = torch.randint(0, 128, (n // BS, BS), generator=gen, device=dev,
                        dtype=torch.int32)
    tgt = torch.randint(0, 128, (1, batch), generator=gen, device=dev,
                        dtype=torch.int32)
    return Y, Qc, pen, bkt, tgt


def check_agree(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-4,
                atol: float = 0.0) -> float:
    """Raise unless ``a`` and ``b`` have -inf in the same places, no NaN,
    and finite entries within ``rtol`` (plus ``atol``); return the
    largest absolute difference."""
    fin = torch.isfinite(b)
    if not bool((torch.isfinite(a) == fin).all()):
        raise AssertionError("variant mismatch: -inf in other places")
    if bool(torch.isnan(a).any() or torch.isnan(b).any()):
        raise AssertionError("variant mismatch: NaN")
    diff = (a[fin] - b[fin]).abs()
    if bool((diff > rtol * b[fin].abs() + atol).any()):
        raise AssertionError(
            f"variant mismatch: largest difference {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def run(items_m: float = 20.0, batch: int = 256, device=None,
        log=None) -> list[dict]:
    """The probe's gate and its three timed lines."""
    Y, Qc, pen, bkt, tgt = make_inputs(items_m, batch, device)
    n = Y.shape[0]
    a = variant_a(Y, Qc, pen, bkt, tgt, MB)
    b = variant_b(Y, Qc, pen, bkt, tgt, MB)
    err = check_agree(b, a)
    del a, b
    flat_b, flat_t = bkt.reshape(-1), tgt.reshape(-1)
    out_bytes = batch * (n // BS) * 4
    base_bytes = n * W * 2 + batch * W * 2 + n * 4 + out_bytes
    lines = []
    for name, kernel, line, fn, lsh in (
            ("exact_floor", "phase_a", 99,
             lambda: variant_exact(Y, Qc, pen), False),
            ("mask_3d_current", "phase_a", 38,
             lambda: variant_a(Y, Qc, pen, bkt, tgt, MB), True),
            ("mask_2d_transposed", "phase_a_qm", 67,
             lambda: variant_b(Y, Qc, pen, bkt, tgt, MB), True)):
        # a shallow queue: each queued call holds its (B, N // 128) output
        before = _pa.LAUNCHES + _qm.LAUNCHES
        t = time_exec(fn, m=4, min_delta_ms=20.0)
        t["launches"] = _pa.LAUNCHES + _qm.LAUNCHES - before
        nbytes = base_bytes + (n * 4 + batch * 4 if lsh else 0)
        rec = {"variant": name, "kernel": kernel,
               "replaces": f"{REPLACES}:{line}", "rows": n, "width": W,
               "B": batch, "lsh": lsh, **t,
               **bound(nbytes, 2.0 * n * W * batch, Y.device),
               "variants_max_abs_diff": err}
        args = (flat_b, flat_t, MB) if lsh else (None, None, 0)
        rec["plain_ms"] = time_exec(
            lambda: _pa.phase_a_reference(Qc, Y, pen, *args), m=1, reps=1,
            min_delta_ms=0.0)["exec_ms"]
        rec["library_ms"] = time_exec(
            lambda: matmul_block_max(Y, Qc, pen, *args), m=1, reps=1,
            min_delta_ms=0.0)["exec_ms"]
        lines.append(rec)
        if log is not None:
            log(rec)
    return lines


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items-m", type=float, default=20.0)
    ap.add_argument("--features", type=int, default=50,
                    help="kept for the reference's command line; the "
                         "probe's rows are W = 128 wide")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(args.items_m, args.batch, args.device,
        log=lambda r: print(json.dumps(r), flush=True))


if __name__ == "__main__":
    main()
