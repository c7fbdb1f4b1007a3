"""Small-feature phase-A probe (diagnostic, not product code).

Counterpart of ``docs/bench_diag/smallf_probe.py``, which asked why the
50-feature serving scan ran far below the 250-feature one: per F it
times a raw read of the (N, F) bf16 store, phase A alone, and the full
two-phase program.  Here phase A is kernel 1's counterpart,
``ops/phase_a.phase_a`` (kernel 8's ``phase_a`` is its exact body), on
the store as the port lays it out: F padded to a multiple of 32 columns
(50 -> 64, 250 -> 256), so each record gives GB/s, and the bound, over
both the logical bytes (N·F·2) and the stored ones (N·F_stored·2).

The reference timed its kernel at TPU grid steps T of 4096 and 8192
rows.  ``phase_a.cu`` runs persistent thread blocks that walk the
128-row blocks through a ring of stages and has no such step, so in its
place each record carries ``phase_a.plan`` (the design, query tile,
ring stages and shared memory a call of this size runs); the kernel
gets no knob for it.

Usage: python -m oryx_tpu_torch.bench.diag.smallf_probe [--items 20]
       [--f 50,250]
Prints one JSON line per F.
"""

from __future__ import annotations

import argparse
import json

import torch

from ...common.device import resolve_device
from ...ops import phase_a as _pa
from ..kernel_probe import bound, matmul_block_max, time_exec

__all__ = ["phase_a", "stored", "make_inputs", "run_f", "run"]

BS = 128
ROW_ALIGN = 8192  # the reference's N rounding
REPLACES = "docs/bench_diag/smallf_probe.py:32"


def stored(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its columns zero-padded to a multiple of 32, as the
    store lays out its rows (every product is unchanged: the padded
    columns contribute exactly 0)."""
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 32)).contiguous()


def phase_a(Y: torch.Tensor, Q: torch.Tensor,
            penalty: torch.Tensor) -> torch.Tensor:
    """Kernel 8: the exact body's (B, N // 128) block maxima of the
    stored (padded) rows ``Y`` and queries ``Q``."""
    return _pa.phase_a(Q, Y, penalty)


def make_inputs(n: int, features: int, batch: int, dev, gen):
    """(Y, Q, Qf, penalty, active): ``n`` random bf16 rows of
    ``features`` stored at a multiple of 32 columns, the float32 queries
    ``Qf`` and their stored bf16 form ``Q``, a zero penalty, every row
    live."""
    fs = features + (-features % 32)
    Y = torch.zeros((n, fs), dtype=torch.bfloat16, device=dev)
    Y[:, :features] = torch.randn((n, features), generator=gen, device=dev,
                                  dtype=torch.bfloat16)
    Qf = torch.randn((batch, features), generator=gen, device=dev)
    penalty = torch.zeros((n // BS, BS), dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    return Y, stored(Qf.to(torch.bfloat16)), Qf, penalty, active


def run_f(n: int, features: int, batch: int, dev, gen) -> dict:
    """One F's record: the raw read, phase A, and the full program at
    k = 16, ksel = 32."""
    from ...app.als import serving_model as sm

    Y, Q, Qf, penalty, active = make_inputs(n, features, batch, dev, gen)
    fs = Y.shape[1]
    logical, stored_b = n * features * 2, n * fs * 2
    rec: dict = {"N": n, "features": features, "stored_width": fs,
                 "B": batch, "replaces": REPLACES}
    if dev.type == "cuda":
        rec["plan"] = _pa.plan(fs, batch, True)

    # 1. the raw read: a sum over the whole store (a yardstick)
    t = time_exec(lambda: Y.sum(dim=0, dtype=torch.float32))
    rec["raw_read"] = {**t, "gbps_stored": stored_b / t["exec_ms"] / 1e6,
                       "gbps_logical": logical / t["exec_ms"] / 1e6}

    # 2. phase A alone, through the kernel
    before = _pa.LAUNCHES
    t = time_exec(lambda: phase_a(Y, Q, penalty))
    t["launches"] = _pa.LAUNCHES - before
    # the bound counts the stored bytes the kernel reads; beside it, the
    # bound of the logical F columns alone, which a store without the
    # padding would meet
    side = n * 4 + batch * (n // BS) * 4
    nbytes = stored_b + batch * fs * 2 + side
    rec["phase_a"] = {**t, "gbps_stored": stored_b / t["exec_ms"] / 1e6,
                      "gbps_logical": logical / t["exec_ms"] / 1e6,
                      **bound(nbytes, 2.0 * n * fs * batch, dev)}
    rec["phase_a"]["bound_ms_logical"] = bound(
        logical + batch * features * 2 + side,
        2.0 * n * features * batch, dev)["bound_ms"]
    rec["phase_a"]["plain_ms"] = time_exec(
        lambda: _pa.phase_a_reference(Q, Y, penalty), m=1, reps=1,
        min_delta_ms=0.0)["exec_ms"]
    rec["phase_a"]["library_ms"] = time_exec(
        lambda: matmul_block_max(Y, Q, penalty), m=1, reps=1,
        min_delta_ms=0.0)["exec_ms"]

    # 3. the full two-phase program as served (phase A + phase B)
    t = time_exec(lambda: sm._batch_top_n_twophase_cuda(
        Y, Qf, penalty, active, None, None, 16, BS, 32, 0))
    rec["full_twophase"] = {**t,
                            "gbps_stored": stored_b / t["exec_ms"] / 1e6}
    return rec


def run(items: float = 20, f=(50, 250), batch: int = 256, device=None,
        log=None) -> dict:
    dev = resolve_device(device)
    n = int(items * 1e6) // ROW_ALIGN * ROW_ALIGN
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"N": n, "B": batch, "results": {}}
    for features in f:
        rec = run_f(n, features, batch, dev, gen)
        out["results"][f"F{features}"] = rec
        if log is not None:
            log({f"F{features}": rec})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=float, default=20)
    ap.add_argument("--f", default="50,250")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(args.items, [int(x) for x in args.f.split(",")], args.batch,
              args.device, log=lambda r: print(json.dumps(r), flush=True))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
