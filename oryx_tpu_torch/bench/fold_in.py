"""Fold-in throughput bench: batched against per-event fold-in.

Counterpart of ``oryx_tpu/bench/fold_in.py``.  Single-row "UP" updates
are batch-hostile on an accelerator; the reference does one host solve
per (user, item) event in a parallelStream
(ALSSpeedModelManager.java:198-220).  The speed layer folds a whole
micro-batch in one program (``ops/als_fold_in.fold_in_batch``); this
bench records events/s for both paths, the device-only curve across
batch sizes (``fold_in_device``, timed by ``kernel_probe.time_exec``),
and an estimate of the reference's own mechanism on a 32-core host.

``dispatch_floor_s`` is the round trip of a trivial kernel's dispatch
and fetch (``grid.measure_dispatch_floor``): every batched call pays
one, so it bounds the batched rate from above at small batches.

Usage: python -m oryx_tpu_torch.bench.fold_in
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops import als_fold_in, solver

__all__ = ["run_fold_in_bench"]

EXEC_BATCHES = (64, 256, 1024, 4096, 16384)
# per-event host solves timed for the reference estimate
HOST_SOLVES = 2000


def run_fold_in_bench(features: int = 100, events: int = 4096,
                      per_event_sample: int = 64, seed: int = 7,
                      reps: int = 10, device=None) -> dict:
    """``device=None`` means ``cuda``."""
    from .grid import measure_dispatch_floor
    from .kernel_probe import time_exec

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((4 * features, features)).astype(np.float32)
    s = solver.get_solver(y.T @ y, device=dev)
    values = (rng.exponential(1.0, events) + 0.1).astype(np.float32)
    xu = (rng.standard_normal((events, features)) * 0.2).astype(np.float32)
    yi = rng.standard_normal((events, features)).astype(np.float32)

    # warm both paths at the timed shapes
    als_fold_in.fold_in_batch(s, values, xu, yi, implicit=True)
    als_fold_in.compute_updated_xu(s, float(values[0]), xu[0], yi[0], True)

    t0 = time.perf_counter()
    for _ in range(reps):
        new_xu, _ = als_fold_in.fold_in_batch(s, values, xu, yi,
                                              implicit=True)
    batch_s = (time.perf_counter() - t0) / reps
    # events whose estimate already exceeds the target fold to "no
    # change" (a NaN target): legitimate, not counted invalid
    assert np.isfinite(new_xu).all()

    t0 = time.perf_counter()
    for i in range(per_event_sample):
        als_fold_in.compute_updated_xu(s, float(values[i]), xu[i], yi[i],
                                       True)
    per_event_s = (time.perf_counter() - t0) / per_event_sample

    batched_eps = events / batch_s
    single_eps = 1.0 / per_event_s

    # device-only throughput across batch sizes: the fold-in's own
    # arithmetic on tensors already on the device, no copies
    exec_curve = []
    chol = s.cholesky
    for bs in EXEC_BATCHES:
        vb = torch.from_numpy(rng.exponential(1.0, bs).astype(np.float32)
                              + 0.1).to(dev)
        xb = torch.from_numpy((rng.standard_normal((bs, features)) * 0.2)
                              .astype(np.float32)).to(dev)
        yb = torch.from_numpy(rng.standard_normal((bs, features))
                              .astype(np.float32)).to(dev)
        ones = torch.ones(bs, dtype=torch.bool, device=dev)
        t = time_exec(
            lambda: als_fold_in.fold_in_device(chol, vb, xb, ones, yb, ones,
                                               True),
            m=16, reps=5, min_delta_ms=5.0)
        row = {"batch": bs, "exec_ms": t["exec_ms"]}
        if t["exec_ms"] <= 0:
            row["unmeasurable"] = True
            row["exec_events_per_s"] = None
        else:
            row["exec_events_per_s"] = bs / t["exec_ms"] * 1e3
        exec_curve.append(row)

    # anchor against the reference's mechanism: one k x k solve per
    # event against the micro-batch's prefactored Cholesky, on a 32-core
    # parallelStream (ALSSpeedModelManager.java:198-220, ALSUtils.java:
    # 74) — scipy's cho_solve per event on one host core, times 32
    # (optimistic for the JVM: no parallelStream overhead assumed)
    import scipy.linalg as sla

    A = (y.T @ y + 0.01 * np.eye(features)).astype(np.float64)
    cf = sla.cho_factor(A)
    t0 = time.perf_counter()
    for i in range(HOST_SOLVES):
        qui = values[i % events] * yi[i % events]
        sla.cho_solve(cf, qui.astype(np.float64))
    host_per_core_eps = HOST_SOLVES / (time.perf_counter() - t0)
    reference_estimate_eps = host_per_core_eps * 32
    measured = [r for r in exec_curve if r["exec_events_per_s"]]
    best_exec = max((r["exec_events_per_s"] for r in measured),
                    default=None)
    crossover = next((r["batch"] for r in measured
                      if r["exec_events_per_s"] > reference_estimate_eps),
                     None)

    return {
        "device": str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
        "exec_only_curve": exec_curve,
        "host_solves_per_core_per_s": host_per_core_eps,
        "vs_reference_estimate": {
            "reference_mechanism": "32-core parallelStream of per-event "
                                   "k x k cho_solve against the "
                                   "micro-batch's prefactored Cholesky "
                                   "(ALSSpeedModelManager.java:198-220)",
            "reference_estimate_events_per_s": reference_estimate_eps,
            "exec_only_best_events_per_s": best_exec,
            "device_wins_from_batch": crossover,
            "ratio_at_best": best_exec / reference_estimate_eps
            if best_exec else None,
        },
        "features": features,
        "events": events,
        "reps": reps,
        "batched_events_per_s": batched_eps,
        "per_event_dispatch_events_per_s": single_eps,
        "speedup": batched_eps / single_eps,
        # each batched call uploads, solves and fetches once: at small
        # batches the dispatch floor bounds it
        "batch_round_trip_s": batch_s,
        "dispatch_floor_s": measure_dispatch_floor(dev) / 1e3,
    }


if __name__ == "__main__":
    import json
    print(json.dumps(run_fold_in_bench()))
