"""Install-time warmup: build and load the kernel libraries the serving
dispatch can route to, before any traffic (or model) exists.

Counterpart of ``oryx_tpu/deploy/warmup.py``.  The reference lowers and
compiles each kernel variant from avals into XLA's persistent cache.
Here nothing compiles per shape: a first start pays ``nvcc``, one build
per kernel source (``ops/cuda_build``), into ``oryx.compile-cache-dir``
(``common/compile_cache``).  ``python -m oryx_tpu_torch warmup`` moves
that cost to install time:

- **Serving ladder** — for each (dtype x items x features) rung, the
  plan lists every variant the reference's warmup names, from the same
  planning functions the dispatch obeys (``planned_capacity``,
  ``_stream_plan``, ``_fold_eligible`` and the reference's eligibility
  tests).  A phase-A kind of a hand-written kernel (``pallas``,
  ``pallas_i8``, ``pallas_fold``, ``pallas_i8_fold``) goes under
  ``compiled`` once its source's library is built and loaded, or under
  ``failed`` with the wrapper's own message where one of its width
  limits refuses the rung's shape.  Work that is plain PyTorch here (the
  chunked exact scan, the flat kernels, the mirror builds, the LSH
  buckets, the ``ivf`` kind) is listed under ``plain``, with nothing
  built.  No device memory is allocated at a rung's size.
- **Training (optional, runs)** — ``--train-ratings N`` runs one real
  ALS iteration on synthetic data at that scale on the device, then
  plans the trained model's own (items, rank) shape.

Each needed source is built once, all at the same time, then loaded.
Without ``nvcc`` the build raises with ``cuda_build``'s message: a warm
that did not happen is never reported.
"""

from __future__ import annotations

import logging
import time

import torch

from ..ops import cuda_build
from ..ops import phase_a as _pa
from ..ops import phase_a_fold as _pa_fold
from ..ops import phase_a_i8 as _pa_i8
from ..ops import phase_a_i8_fold as _pa_i8_fold
from ..ops import phase_a_qm as _pa_qm

__all__ = ["plan_serving_shapes", "warm_serving_shapes", "run_warmup"]

_log = logging.getLogger(__name__)

# the wrapper module of each phase-A kind a rung can route to
_KIND_MODULES = {"pallas": _pa, "pallas_i8": _pa_i8,
                 "pallas_fold": _pa_fold, "pallas_i8_fold": _pa_i8_fold}
# a kernel no served path routes to, built so that the probes of
# bench/diag load it too
_PROBE_ENTRY = ("probe: phase_a_qm", _pa_qm)


def _width_refusal(kind: str, cap: int, width: int, fold: int,
                   window: int) -> str | None:
    """The wrapper's own message where one of its width limits refuses
    ``window`` queries over a ``cap`` x ``width`` store, else None."""
    try:
        if kind in ("pallas", "pallas_i8"):
            _KIND_MODULES[kind].check_shape(cap, width, window)
        else:
            _KIND_MODULES[kind].check_shape(cap // fold, width, fold,
                                            window)
    except ValueError as e:
        return str(e)
    return None


def plan_serving_shapes(features: int, items: int, dtype: str,
                        sample_rate: float, how_many: int = 10,
                        max_flat_batch: int = 1024, ann=None) -> dict:
    """Every serving variant of one (items, features) rung, named as the
    reference's warmup names them: ``{"kernels": [(name, module)],
    "failed": [{"kernel", "error"}], "plain": [name]}``.  ``ann`` (an
    ``ivf.AnnConfig``) adds the IVF ladder, which is plain PyTorch."""
    from ..app.als import serving_model as sm
    from ..app.als.feature_vectors import (device_width, planned_capacity,
                                           resolve_dtype)
    from ..app.als.lsh import choose_hash_count

    resolve_dtype(dtype)  # an unknown dtype fails here, as at load
    cap = planned_capacity(items)
    W = device_width(features)
    F = features
    k = min(sm._pad_k(how_many), cap)
    num_hashes, max_bits = choose_hash_count(sample_rate, 8) \
        if sample_rate < 1.0 else (0, 0)
    lsh_on = num_hashes > 0 and max_bits < num_hashes
    tag = f"{F}f/{items}"
    out: dict = {"kernels": [], "failed": [], "plain": []}
    plain = out["plain"]
    if lsh_on:
        plain.append(f"{tag}: lsh_buckets")

    big, chunk = sm._stream_plan(cap, sm._CHUNKED_BATCH)
    bs = sm._BLOCK_ROWS
    ksel = min(sm._BLOCK_KSEL, cap // max(1, bs))
    twophase_ok = (big and cap % chunk == 0 and k <= chunk
                   and cap % bs == 0 and 1 <= ksel < cap // bs
                   and k <= ksel * bs)
    pallas_ok = twophase_ok and cap % sm._PA_TILE == 0
    fold = sm._fold_eligible(W, F, bs)
    if twophase_ok:
        plain += [f"{tag}: penalty", f"{tag}: penalty_i8",
                  f"{tag}: quantize"]
        if fold > 1:
            plain += [f"{tag}: fold_items", f"{tag}: fold_items_i8"]
            if lsh_on:
                plain.append(f"{tag}: fold_buckets")
    plain += [f"{tag}: dot_scores", f"{tag}: masked_top_k"]

    if big:
        windows = sm._WINDOW_LADDER
    else:
        windows, b = [], 8
        while b <= max_flat_batch:
            windows.append(b)
            b *= 2
    variants = [False, True] if lsh_on else [False]
    kinds = ["pallas", "pallas_i8"]
    if fold > 1:
        kinds += ["pallas_fold", "pallas_i8_fold"]
    for w in windows:
        for masked in variants:
            suffix = f" B={w}" + ("/lsh" if masked else "")
            if not big:
                plain.append(f"{tag}: {'flat_lsh' if masked else 'flat'}"
                             f"{suffix}")
                continue
            plain.append(f"{tag}: chunked_exact{suffix}")
            if not twophase_ok:
                continue
            plain.append(f"{tag}: twophase_scan{suffix}")
            if (not masked and ann is not None and ann.enabled
                    and cap // bs >= ann.cells):
                nprobe = min(ann.nprobe, ann.cells)
                e = max(1, -(-cap // (ann.cells * bs)))
                e = 1 << (e - 1).bit_length()
                for bpc in (e, e * 2):
                    pp = nprobe * bpc
                    ks = min(max(sm._i8_ksel(ksel, cap, bs), -(-k // bs)),
                             pp)
                    if ks * bs >= k:
                        plain.append(f"{tag}: ivf bpc={bpc}{suffix}")
            if not pallas_ok:
                continue
            for kind in kinds:
                name = f"{tag}: {kind}{suffix}"
                error = _width_refusal(kind, cap, W, fold, w)
                if error is None:
                    out["kernels"].append((name, _KIND_MODULES[kind]))
                else:
                    out["failed"].append({"kernel": name, "error": error})
    return out


def _merge(report: dict, plan: dict) -> list:
    """Record ``plan``'s refusals and plain work in the report; returns
    its kernels, to build."""
    report["failed"] += plan["failed"]
    report["plain"] += plan["plain"]
    return plan["kernels"]


def _build(report: dict, entries: list) -> None:
    """Build every source the planned kernels need — once each, all at
    the same time — load each through its wrapper, and record every
    planned kernel under ``compiled``."""
    modules = list(dict.fromkeys(mod for _, mod in entries))
    if not modules:
        return
    sources = [mod.SOURCE for mod in modules]
    current = {src: cuda_build.library_path(src).exists() for src in sources}
    t0 = time.perf_counter()
    libs = cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    done = {}
    for mod, lib in zip(modules, libs):
        t1 = time.perf_counter()
        mod.build()
        load_s = time.perf_counter() - t1
        built = not current[mod.SOURCE]
        done[mod] = {"library": lib.name,
                     "status": "built" if built else "found current",
                     "sec": round((build_s if built else 0.0) + load_s, 3)}
    for name, mod in entries:
        report["compiled"].append({"kernel": name, **done[mod]})


def warm_serving_shapes(features: int, items: int, dtype: str,
                        sample_rate: float, report: dict,
                        how_many: int = 10, max_flat_batch: int = 1024,
                        ann=None) -> None:
    """Plan one (items, features) rung and build what it needs into the
    report (``compiled``, ``failed``, ``plain``)."""
    _build(report, _merge(report, plan_serving_shapes(
        features, items, dtype, sample_rate, how_many, max_flat_batch,
        ann)))


def _warm_training(ratings: int, rank: int, sample_rate: float,
                   factor_dtype: str, report: dict, device=None) -> list:
    """Run one real ALS iteration at the target scale on ``device``, then
    plan the trained model's (items, rank) shape: the generation a batch
    layer at this scale publishes is what its serving layer loads.
    Returns that shape's kernels, to build."""
    t0 = time.perf_counter()
    from ..app.als.common import ParsedRatings
    from ..app.als.trainer import train_als
    from ..bench.train import synthesize_movielens

    users, items_arr, implicit_vals, _, _ = synthesize_movielens(
        n_ratings=ratings, seed=11)
    n_items = int(items_arr.max()) + 1
    parsed = ParsedRatings(
        users=users, items=items_arr, values=implicit_vals,
        user_ids=[f"u{i}" for i in range(int(users.max()) + 1)],
        item_ids=[f"i{i}" for i in range(n_items)])
    train_als(parsed, rank, lam=0.01, alpha=1.0, implicit=True,
              iterations=1, seed=3, device=device)
    report["train_warm"] = {
        "ratings": ratings, "rank": rank, "items": n_items,
        "sec": round(time.perf_counter() - t0, 2),
    }
    return _merge(report, plan_serving_shapes(rank, n_items, factor_dtype,
                                              sample_rate))


def run_warmup(config, items_list: list[int], features_list: list[int],
               dtypes: list[str], how_many: int = 10,
               train_ratings: int = 0, train_rank: int = 0,
               device=None) -> dict:
    """Build and load the kernel libraries of the given shape ladder
    into ``oryx.compile-cache-dir``.  ``device`` (None means ``cuda``)
    is where the optional training iteration runs and whose name the
    report gives.  Returns the report dict."""
    from ..app.als.ivf import AnnConfig
    from ..common import compile_cache
    from ..common.device import resolve_device

    dev = resolve_device(device)
    cache_dir = compile_cache.enable_from_config(config)
    if cache_dir is None:
        _log.warning(
            "oryx.compile-cache-dir is null: the libraries go to %s",
            cuda_build.build_dir())
    sample_rate = config.get_double("oryx.als.sample-rate")
    ann = AnnConfig.from_config(config)
    report: dict = {"metric": "aot_warmup", "cache_dir": cache_dir,
                    "compiled": [], "failed": [], "plain": []}
    entries = [_PROBE_ENTRY]
    if ann.enabled:
        report["ann"] = {"cells": ann.cells, "nprobe": ann.nprobe}
    item_shards = config.get_int("oryx.serving.api.item-shards")
    if item_shards > 1:
        # the sharded scan (parallel/serving_dist) is per-shard torch
        # products and top-k over a live mesh: nothing of it is built
        # here.  Say so instead of reporting a warm of single-card
        # kernels the sharded serving layer never launches
        _log.warning(
            "item-shards=%d: the sharded merge path is NOT warmed (it is "
            "mesh-bound; the first sharded start runs it cold). Warming "
            "the single-card ladder anyway for tools/benches.",
            item_shards)
        report["sharded_not_warmed"] = item_shards
    t0 = time.perf_counter()
    runs0, build0 = cuda_build.NVCC_RUNS, cuda_build.BUILD_S
    report["device"] = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else str(dev))
    report["torch_version"] = torch.__version__
    report["cuda_version"] = torch.version.cuda
    for dtype in dtypes:
        for items in items_list:
            for features in features_list:
                entries += _merge(report, plan_serving_shapes(
                    features, items, dtype, sample_rate, how_many,
                    ann=ann if ann.enabled else None))
    if train_ratings and train_rank:
        entries += _warm_training(
            train_ratings, train_rank, sample_rate,
            config.get_string("oryx.als.factor-dtype"), report, device=dev)
    _build(report, entries)
    report["compiled_count"] = len(report["compiled"])
    report["failed_count"] = len(report["failed"])
    report["nvcc_runs"] = cuda_build.NVCC_RUNS - runs0
    report["build_s"] = round(cuda_build.BUILD_S - build0, 3)
    report["wall_s"] = round(time.perf_counter() - t0, 2)
    return report
