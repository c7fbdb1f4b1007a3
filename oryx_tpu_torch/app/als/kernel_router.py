"""Measured-cost kernel routing for the ALS serving scan.

Counterpart of ``oryx_tpu/app/als/kernel_router.py``.  Which phase-A
build serves a shape fastest (the IVF index, int8+fold, fold, int8, the
store's own kernel, the plain scan), and whether the LSH Hamming mask pays for
itself, depends on the shape, the dtype and the card; a static
preference order encodes one measurement of one machine.  At model load
(and on a hot-swap that changes the store's padded capacity) this
module times each eligible path for the live shape and then:

  - orders the phase-A kinds by measured ascending cost, and
  - routes LSH-configured queries to the exact scan wherever the masked
    build measured slower than the exact one.

The decision and every measured cost are exposed through
``ALSServingModel.metrics()["kernel_route"]``, and with an IVF index
attached its recall certificate under ``["ann"]``.  "ivf" is timed on
the exact variant only: the Hamming mask and the cell probe are
competing pruners, never composed.

Timing: each reading is ``_ROUNDS`` rounds of dispatch + fetch, the median
of ``_REPS`` readings, floored at 1e-4 ms.  On a CUDA device the rounds
run between two ``torch.cuda.Event`` records on the current stream; on
the CPU, between two reads of the monotonic clock.  (The reference
divides a network tunnel's round trip out of its timings; a local card
has none.)  The fault points ``route-measure-lsh`` /
``route-measure-exact`` fire inside the timed region of their variant,
so a test can inflate one side's measured cost with ``mode="delay"``;
on the card a host delay between the two records is stream idle time
and is counted.

A kind that fails to measure is recorded under ``route["errors"]`` with
a cost of None, as the reference records it; the dispatch never falls
back from one kind to another (a kernel that fails raises per request).
"""

from __future__ import annotations

import logging
import statistics
import time

import numpy as np
import torch

from ...obs import device_time as device_time_mod
from ...resilience import faults

__all__ = ["measure_routes"]

_log = logging.getLogger(__name__)

# measurement batch: the serving streaming window; flat-path models
# measure at the largest pow2 drain bucket <= this
_DEFAULT_BATCH = 256
# timing repetitions: the median of _REPS readings of _ROUNDS rounds each
_REPS = 2
_ROUNDS = 3


def _fetch(out) -> None:
    for t in out:
        if t is not None:
            t.cpu()


def _time_exec_ms(run, device: torch.device) -> float:
    """Milliseconds per round of ``run`` (dispatch + fetch): one warm
    round, then the median of ``_REPS`` readings of ``_ROUNDS`` rounds.  A
    reading below the floor routes as 1e-4 ms, so indistinguishable
    kinds keep the static order."""
    _fetch(run())
    readings = []
    for _ in range(_REPS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(_ROUNDS):
                _fetch(run())
            e1.record()
            e1.synchronize()
            readings.append(e0.elapsed_time(e1) / _ROUNDS)
        else:
            t0 = time.monotonic()
            for _ in range(_ROUNDS):
                _fetch(run())
            readings.append((time.monotonic() - t0) * 1e3 / _ROUNDS)
    return max(1e-4, statistics.median(readings))


def _lsh_parts(model, lsh_on: bool):
    """(buckets, hyperplanes, max_bits) for a variant, building the
    bucket cache when LSH is measured."""
    if not lsh_on:
        return None, None, 0
    vecs, _active, version = model.Y.device_arrays_versioned()
    return (model._cached_buckets(vecs, version),
            model.lsh._device_hyperplanes(),
            model.lsh.max_bits_differing)


def _point(lsh_on: bool) -> str:
    # chaos-point: route-measure-lsh
    # chaos-point: route-measure-exact
    return "route-measure-lsh" if lsh_on else "route-measure-exact"


def measure_routes(model) -> dict | None:
    """Time every eligible serving kernel path for ``model``'s live
    shape and return the route decision (installed by
    ``ALSServingModel.refresh_route``).  Streaming-path models time each
    phase-A kind x {exact, LSH}; flat-path models the flat kernel x
    {exact, LSH}.  None when the model has no items yet."""
    from . import serving_model as sm

    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    if n_rows == 0 or len(model.Y) == 0:
        return None
    t_measure = time.monotonic()
    device = vecs.device
    features = model.features
    k = min(sm._pad_k(10), n_rows)
    big, chunk = sm._stream_plan(n_rows, sm._CHUNKED_BATCH)
    streaming = big and n_rows % chunk == 0 and k <= chunk
    batch = sm._CHUNKED_BATCH if streaming else min(
        _DEFAULT_BATCH, 1 << max(3, (n_rows - 1).bit_length() - 2))
    rng = np.random.default_rng(17)
    Q = torch.from_numpy(
        rng.standard_normal((batch, features)).astype(np.float32)).to(device)
    lsh_configured = model._lsh_active()
    variants = [False] + ([True] if lsh_configured else [])

    route: dict = {
        "measured": True,
        "batch": int(batch),
        "path": "streaming" if streaming else "flat",
        "capacity": n_rows,
        "lsh_configured": lsh_configured,
        "ann_key": model._ann_route_key(),
    }
    ann = model._ann
    if ann is not None:
        # the generation's recall certificate: whether the IVF index
        # serves, and on what evidence
        route["ann"] = {
            "recall": ann.recall,
            "min_recall": ann.cfg.min_recall,
            "recall_at": ann.cfg.recall_at,
            "cells": int(ann.centroids.shape[0]),
            "nprobe": ann.cfg.nprobe,
            "routable": model._ann_routable(n_rows),
            "index_bytes": ann.index_bytes,
        }
    costs_exact: dict = {}
    costs_lsh: dict = {}

    def timed(costs: dict, name: str, lsh_on: bool, call,
              error_key: str) -> None:
        point = _point(lsh_on)
        try:
            costs[name] = round(_time_exec_ms(
                lambda: (faults.fire(point), call())[1], device), 3)
        except Exception as e:  # noqa: BLE001 — recorded, never hidden
            costs[name] = None
            route.setdefault("errors", {})[error_key] = str(e)[:120]

    if streaming:
        bs = sm._BLOCK_ROWS
        ksel = min(sm._BLOCK_KSEL, n_rows // max(1, bs))
        twophase_ok = (n_rows % bs == 0 and 1 <= ksel < n_rows // bs
                       and k <= ksel * bs)
        # the dispatch's own chain: what is measured is what can serve
        kinds, fold = model._phase_a_kinds(n_rows, int(vecs.shape[1]), bs)
        if not twophase_ok:
            kinds = []
        # kind-outer loop with per-kind eviction: each kind's mirror is
        # built to be timed, and only one candidate mirror is live at a
        # time; the winner's is rebuilt below
        for kind in kinds:
            if kind == "scan" and any(
                    costs_exact.get(kk) is not None
                    or costs_lsh.get(kk) is not None
                    for kk in kinds if kk != "scan"):
                # the plain scan is timed only when no kernel measured
                continue
            for lsh_on in variants:
                if kind == "ivf" and lsh_on:
                    continue
                buckets, hp, mb = _lsh_parts(model, lsh_on)
                ctx: dict = {}
                timed(costs_lsh if lsh_on else costs_exact, kind, lsh_on,
                      lambda: model._dispatch_kind(
                          kind, Q, vecs, active, version, buckets, hp, k,
                          bs, ksel, mb, fold, ctx, chunk=chunk),
                      f"{kind}{'/lsh' if lsh_on else ''}")
                ctx.clear()
            model._evict_unused_mirrors(None)
        if not twophase_ok:
            for lsh_on in variants:
                buckets, hp, mb = _lsh_parts(model, lsh_on)
                timed(costs_lsh if lsh_on else costs_exact,
                      "chunked_exact", lsh_on,
                      lambda: sm._batch_top_n_chunked_kernel(
                          vecs, Q, active, buckets, hp, k, chunk, mb),
                      "chunked_exact")
    else:
        for lsh_on in variants:
            buckets, hp, mb = _lsh_parts(model, lsh_on)
            if lsh_on:
                timed(costs_lsh, "flat_lsh", True,
                      lambda: sm._batch_top_n_lsh_kernel(
                          vecs, Q, active, buckets, hp, k, mb), "flat_lsh")
            else:
                timed(costs_exact, "flat", False,
                      lambda: sm._batch_top_n_kernel(vecs, Q, active, k),
                      "flat")

    def best(costs: dict):
        finite = {kk: c for kk, c in costs.items() if c is not None}
        if not finite:
            return None, None
        kk = min(finite, key=finite.get)
        return kk, finite[kk]

    _, cost_exact = best(costs_exact)
    _, cost_lsh = best(costs_lsh)
    route["costs_exact_ms"] = costs_exact
    if lsh_configured and cost_lsh is not None and cost_exact is not None:
        route["costs_lsh_ms"] = costs_lsh
        # LSH must MEASURE faster to be honored: ties and losses serve
        # the exact scan, which returns the true top-N
        route["use_lsh"] = cost_lsh < cost_exact
    else:
        # not configured, or nothing measurable: the config decides
        if lsh_configured:
            route["costs_lsh_ms"] = costs_lsh
        route["use_lsh"] = None
    # the costs of the variant that will serve order the chain
    serving_lsh = route["use_lsh"] if route["use_lsh"] is not None \
        else lsh_configured
    effective = costs_lsh if serving_lsh else costs_exact
    route["phase_a_costs_ms"] = effective
    route["chosen"] = best(effective)[0]
    if streaming and route["chosen"] in ("i8_fold", "i8", "fold", "pallas",
                                         "ivf"):
        # rebuild the winner's mirror before traffic: the per-kind
        # eviction dropped it with the losers, and the first request
        # must not pay the mirror build
        buckets, hp, mb = _lsh_parts(model, serving_lsh)
        try:
            _fetch(model._dispatch_kind(
                route["chosen"], Q, vecs, active, version, buckets, hp,
                k, bs, ksel, mb, fold, {}, chunk=chunk))
        except Exception as e:  # noqa: BLE001 — recorded, never hidden
            _log.exception("warm dispatch of the routed kind %s failed",
                           route["chosen"])
            route.setdefault("errors", {})[
                f"{route['chosen']}/warm"] = str(e)[:120]
    _log.info(
        "kernel route for %d rows x %df (%s): chosen=%s use_lsh=%s "
        "exact=%s lsh=%s", n_rows, features, route["path"],
        route["chosen"], route.get("use_lsh"), costs_exact,
        costs_lsh or None)
    acct = device_time_mod.process_accountant()
    if acct is not None:
        acct.note("measure", route.get("chosen"),
                  getattr(model, "generation", None),
                  time.monotonic() - t_measure)
    return route
