"""Times of the probe kernel ``phase_a_qm`` at chosen shapes (diagnostic,
not product code).

For each store shape (rows x width) and window, exact and LSH: seeded
inputs on the card (bf16 rows and queries from a normal draw, the
last eighth of each window's queries zero, every 11th row and block 5
retired, buckets and targets 0-127, one differing bit allowed), the
kernel held against its plain version (``phase_a.phase_a_reference``:
-inf in the same places, no NaN, finite maxima within rtol 1e-4 plus
atol 1e-4) and timed (``kernel_probe.time_exec``, CUDA events) beside
its bound (``kernel_probe.bound``: each byte once, 2·N·F·B operations).

It imports the package by its absolute name, so that, run as a file with
another checkout first on ``PYTHONPATH``, it times that checkout's
kernel; that is how two versions of the kernel are compared in one call
to the card (run them in turn: a, b, b, a).

Usage: python -m oryx_tpu_torch.bench.diag.qm_time
       [--shape 1048576x96 1048576x256] [--batch 8 128 300]
       [--device cuda]
Prints one JSON line per case, then one with the compiler's notes on
the kernel source (``C75xx``: where ptxas serialised or waited on
``wgmma``).
"""

from __future__ import annotations

import argparse
import collections
import json
import re

import torch

import oryx_tpu_torch
from oryx_tpu_torch.bench.diag.lsh_mask_probe import MB, check_agree
from oryx_tpu_torch.bench.kernel_probe import bound, time_exec
from oryx_tpu_torch.ops import cuda_build
from oryx_tpu_torch.ops import phase_a as pa
from oryx_tpu_torch.ops import phase_a_qm as qm

__all__ = ["inputs", "run", "main"]

SEED = 0
ATOL = 1e-4


def inputs(rows: int, width: int, batch: int, device):
    """Rows, queries, penalty, buckets and targets on ``device``."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    Y = torch.randn((rows, width), generator=gen, device=device,
                    dtype=torch.bfloat16)
    Qc = torch.randn((batch, width), generator=gen, device=device,
                     dtype=torch.bfloat16)
    pen = torch.zeros((rows // 128, 128), dtype=torch.float32,
                      device=device)
    pen.view(-1)[::11] = float("-inf")
    pen[5] = float("-inf")
    bkt = torch.randint(0, 128, (rows,), generator=gen, device=device,
                        dtype=torch.int32)
    tgt = torch.randint(0, 128, (batch,), generator=gen, device=device,
                        dtype=torch.int32)
    return Y, Qc, pen, bkt, tgt


def run(shapes, batches, device="cuda", log=print) -> list[dict]:
    """One record per (shape, window, body) for ``shapes`` of (rows,
    width), each also passed to ``log``; raises if the kernel disagrees
    with its plain version."""
    root = str(oryx_tpu_torch.__path__[0])
    out = []
    for rows, width in shapes:
        Y, Qc, pen, bkt, tgt = inputs(rows, width, max(batches), device)
        for b in batches:
            q = Qc[:b].clone()
            q[b - b // 8:] = 0
            for lsh in (False, True):
                args = (bkt, tgt[:b], MB) if lsh else (None, None, 0)
                err = check_agree(qm.phase_a_qm(q, Y, pen, *args),
                                  pa.phase_a_reference(q, Y, pen, *args),
                                  atol=ATOL)
                t = time_exec(lambda: qm.phase_a_qm(q, Y, pen, *args), m=4,
                              min_delta_ms=20.0)
                nbytes = (rows * width * 2 + b * width * 2 + rows * 4
                          + b * (rows // 128) * 4
                          + (rows * 4 + b * 4 if lsh else 0))
                rec = {"package": root, "rows": rows, "width": width, "B": b,
                       "lsh": lsh, "ms": t["exec_ms"], "max_abs_err": err,
                       **bound(nbytes, 2.0 * rows * width * b, Y.device)}
                out.append(rec)
                log(json.dumps(rec))
        del Y, Qc, pen, bkt, tgt
    notes = collections.Counter(re.findall(
        r"\((C75\d\d)\)", cuda_build.LOGS.get(qm.SOURCE.name, "")))
    log(json.dumps({"package": root, "compiler_notes": dict(notes)}))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", nargs="+",
                    default=["1048576x96", "1048576x256"],
                    help="store shapes, ROWSxWIDTH")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 128, 300])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shape]
    run(shapes, args.batch, args.device,
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
