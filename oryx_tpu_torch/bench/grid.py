"""The published serving grid, over live HTTP.

Counterpart of ``oryx_tpu/bench/grid.py``.  The reference publishes a
12-row ``/recommend`` envelope — features in {50, 250} x items in {1M,
5M, 20M} x LSH {off, on(0.3)} — with qps and p-latency at 1-3
concurrent requests on a 32-core Haswell Xeon
(docs/docs/performance.html; BASELINE.md).  This harness serves every
cell through the port's stack (the stdlib HTTP server, route dispatch,
the request micro-batcher, the streaming or flat device programs) and
records, per row:

  - saturating closed-loop throughput (many keep-alive clients), and its
    p50 and p99 over every request of the saturation run;
  - the open-loop rate ladder (exponential inter-arrival, latency from
    the scheduled arrival): the highest offered rate each cell held,
    with that rung's p50 and p99;
  - p50 latency at low concurrency (1-3 workers, the reference's
    regime);
  - the device time of a 256-query window of the served kind
    (``kernel_probe.probe_model``), the host's share of the window, and
    the dispatch floor.

The reference's ``measure_tunnel_floor`` timed one tiny dispatch and
fetch to divide a TPU tunnel's round trip out of its latencies.  A card
attached to its host has no tunnel, but every request still pays one
launch and one fetch; ``measure_dispatch_floor`` keeps that role, and
its artifact key is ``dispatch_floor_ms``.

Factor storage is bfloat16 across the grid: the largest row (20M items
x 250 features) is a 10 GB store.

Usage: python -m oryx_tpu_torch.bench.grid [--items 1,5,20]
       [--features 50,250] [--out BENCH_TORCH_GRID_r11.json]
Prints one JSON line per step and the whole table last.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import threading
import time

import numpy as np
import torch

from ..common.device import card_line, resolve_device

__all__ = ["BASELINES", "build_model", "device_bytes", "serve",
           "measure_dispatch_floor", "descend_until_sustained",
           "bench_config", "host_loopback_capacity", "main"]

# (features, items_millions, lsh) -> (qps, p_lat_ms): the Java
# reference's published numbers (BASELINE.md, docs/docs/performance.html)
# on a 32-core Haswell Xeon at 1-3 concurrent requests — a comparison
# column, not a measurement of this package
BASELINES = {
    (50, 1, False): (70, 28), (250, 1, False): (24, 40),
    (50, 5, False): (16, 57), (250, 5, False): (6, 181),
    (50, 20, False): (4, 257), (250, 20, False): (1, 668),
    (50, 1, True): (437, 7), (250, 1, True): (160, 12),
    (50, 5, True): (91, 21), (250, 5, True): (37, 54),
    (50, 20, True): (25, 79), (250, 20, True): (7, 134),
}

N_USERS = 10_000
TOP_N = 10
# rows drawn on the host at a time while a model is built
SLAB_ROWS = 2_000_000
# concurrent keep-alive clients of the saturation run: the reference's
# value, tuned for its one-core host (qps <= workers / latency); kept,
# with host_loopback_capacity reported beside it
SAT_WORKERS = 512
LOW_WORKERS = 2
LOW_REQUESTS = 60
MEASURE_SEC = 15.0
# the saturation run's request count never falls below this, so its p99
# is not the slowest of a few requests
MIN_SAT_REQUESTS = 1000
MAX_BATCH = 1024
# open-loop rungs as multiples of the closed-loop qps, and the descent
# when none holds
LADDER = (1.0, 1.5, 2.0)
DESCENT = (0.7, 0.5, 0.35, 0.25)
RUNG_SEC = 6.0
# batch size of the kernel-only probe: the serving streaming window
PROBE_BATCH = 256


def measure_dispatch_floor(device=None, reps: int = 7) -> float:
    """Median ms of one trivial kernel's dispatch and fetch to the host:
    the per-request floor every served window pays on top of its device
    time, whatever the model's size.  ``device=None`` means ``cuda``."""
    dev = resolve_device(device)
    a = torch.zeros((8, 8), dtype=torch.float32, device=dev)
    (a + 1.0).cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (a + 1.0).cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def build_model(features: int, items: int, rng, device=None,
                dtype: str = "bfloat16"):
    """Synthetic serving model at grid scale, sample rate 0.3, bfloat16
    unless ``dtype`` says otherwise, loaded through the store's bulk
    path: rows drawn in slabs on the host (a bf16 store rounds each
    through ``torch.bfloat16``), so host memory stays about one slab
    above the store's own copy, then uploaded once, outside any timed
    region.  ``device=None`` means ``cuda``."""
    from ..app.als.serving_model import ALSServingModel

    model = ALSServingModel(features, implicit=True, sample_rate=0.3,
                            dtype=dtype, device=device)
    model.Y.reserve(items)
    for s in range(0, items, SLAB_ROWS):
        e = min(s + SLAB_ROWS, items)
        model.Y.bulk_load([str(i) for i in range(s, e)],
                          rng.standard_normal((e - s, features),
                                              dtype=np.float32))
    user_ids = [f"u{u}" for u in range(N_USERS)]
    model.X.bulk_load(user_ids, rng.standard_normal((N_USERS, features),
                                                    dtype=np.float32))
    model.Y.device_arrays()
    model.X.device_arrays()
    return model, user_ids


def device_bytes(model) -> int:
    caps = len(model.Y.row_ids()) + len(model.X.row_ids())
    return caps * model.features * model.Y.dtype.itemsize


def descend_until_sustained(base: str, user_ids, rates, ladder: list,
                            *, duration_sec: float, workers: int,
                            how_many: int) -> None:
    """Append open-loop rungs at descending ``rates`` to ``ladder``
    until one sustains — used when no ascending rung held, so a cell
    reports a measured sustained rate instead of 0.0.  Rates are
    deduped and rates already attempted in ``ladder`` are skipped."""
    from .load import run_recommend_open_loop

    seen = {o["offered_qps"] for o in ladder}
    for rate in dict.fromkeys(round(r, 1) for r in rates):
        if rate in seen:
            continue
        o = run_recommend_open_loop(base, user_ids, rate_qps=rate,
                                    duration_sec=duration_sec,
                                    workers=workers, how_many=how_many)
        ladder.append(o)
        if o["sustained"]:
            return


@contextlib.contextmanager
def serve(model, max_batch: int = MAX_BATCH, depth: int = 32):
    """The port's HttpApp + TopNBatcher (``depth`` dispatchers; none at
    0) + StaticModelManager around ``model``, on a free port: yields
    (base URL, batcher), and stops the server and the batcher after."""
    from ..lambda_rt.http import HttpApp, make_server
    from ..serving import als as als_resources
    from ..serving import framework as framework_resources
    from ..serving.batcher import TopNBatcher
    from .load import StaticModelManager

    class Manager(StaticModelManager):
        pass

    Manager.model = model
    batcher = TopNBatcher(max_batch=max_batch, pipeline=depth) \
        if depth else None
    app = HttpApp(
        framework_resources.ROUTES + als_resources.ROUTES,
        context={"model_manager": Manager(),
                 "input_producer": None, "config": None,
                 "min_model_load_fraction": 0.0,
                 "top_n_batcher": batcher},
        read_only=True)
    server = make_server(app, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", batcher
    finally:
        server.shutdown()
        server.server_close()
        if batcher is not None:
            batcher.close()
        thread.join(30)


def bench_config(features: int, items_m, model, user_ids,
                 host_cap_qps: float | None = None,
                 peaks: dict | None = None, *,
                 lsh_modes=(False, True), sat_workers: int = SAT_WORKERS,
                 measure_sec: float = MEASURE_SEC,
                 min_sat_requests: int = MIN_SAT_REQUESTS,
                 ladder=LADDER, descent=DESCENT, rung_sec: float = RUNG_SEC,
                 low_requests: int = LOW_REQUESTS,
                 max_batch: int = MAX_BATCH, probe_m: int = 4,
                 on_served=None, log=print) -> list[dict]:
    """One grid row per LSH mode of ``model``: warm, probe the device
    programs, calibrate, saturate, climb the open-loop ladder (descend
    when no rung holds), then the unloaded latencies, and
    ``on_served(base_url, lsh_on)`` while the cell's server still runs.
    The keyword arguments default to the reference's values; tests and
    the chip smoke run pass short rungs."""
    from .kernel_probe import probe_model
    from .load import run_recommend_load, run_recommend_open_loop

    rows = []
    lsh_obj = model.lsh
    for lsh_on in lsh_modes:
        model.lsh = lsh_obj if lsh_on else None
        # each in-flight streaming dispatch holds its window's score
        # state; cap the pipeline at 20M items
        depth = 16 if items_m >= 20 else 32
        fallbacks_at_start = model.twophase_fallbacks
        with serve(model, max_batch, depth) as (base, batcher):
            # every pow2 drain size the batcher can produce at the load
            # driver's how_many, the fallback scan, then the route
            model.warm_serving_kernels(TOP_N, max_batch)
            probe = probe_model(model, batch=PROBE_BATCH, m=probe_m,
                                peaks=peaks)
            cal = run_recommend_load(base, user_ids,
                                     requests=sat_workers * 4,
                                     workers=sat_workers, how_many=TOP_N)
            n_req = max(min_sat_requests, int(cal.qps * measure_sec))
            sat = run_recommend_load(base, user_ids, requests=n_req,
                                     workers=sat_workers, how_many=TOP_N)
            open_loop = []
            for mult in ladder:
                rate = max(50.0, sat.qps * mult)
                open_loop.append(run_recommend_open_loop(
                    base, user_ids, rate_qps=rate, duration_sec=rung_sec,
                    workers=sat_workers, how_many=TOP_N))
                if not open_loop[-1]["sustained"]:
                    break
            if not any(o["sustained"] for o in open_loop):
                descend_until_sustained(
                    base, user_ids, [max(25.0, sat.qps * d) for d in descent],
                    open_loop, duration_sec=rung_sec, workers=sat_workers,
                    how_many=TOP_N)
            held = [o for o in open_loop if o["sustained"]]
            best = max(held, key=lambda o: o["offered_qps"]) if held \
                else None
            # drain and pacing state while it reflects the saturation run
            batcher_stats = batcher.stats()
            sizes = batcher.batch_sizes[-2000:]
            batcher_stats["mean_batch_all"] = \
                sum(sizes) / max(1, len(sizes))
            # the floor at this cell, beside the unloaded latencies
            cell_floor = measure_dispatch_floor(model.device)
            unloaded = {}
            for w in (1, 2, 3):
                lw = run_recommend_load(base, user_ids,
                                        requests=low_requests * w,
                                        workers=w, how_many=TOP_N)
                unloaded[w] = {"p50_ms": lw.percentile_ms(50),
                               "p95_ms": lw.percentile_ms(95)}
            low = unloaded[LOW_WORKERS]
            if on_served is not None:
                on_served(base, lsh_on)
        base_qps, base_lat = BASELINES.get((features, items_m, lsh_on),
                                           (None, None))
        kernel_path = probe["served_path"]
        kern = probe.get(kernel_path, {})
        rows.append({
            "features": features,
            "items": round(items_m * 1_000_000),
            "lsh": lsh_on,
            # the highest offered arrival rate whose mid-window
            # completions kept up without backlog growth
            "open_loop_sustained_qps": best["offered_qps"] if best else 0.0,
            "sustained_p50_ms": best["p50_ms"] if best else None,
            "sustained_p99_ms": best["p99_ms"] if best else None,
            "sustained_requests": int(best["offered_qps"] * rung_sec)
            if best else 0,
            "open_loop": open_loop,
            "qps": sat.qps,
            "qps_errors": sat.errors,
            "sat_requests": sat.requests,
            "p50_ms_saturated": sat.percentile_ms(50),
            "p95_ms_saturated": sat.percentile_ms(95),
            "p99_ms_saturated": sat.percentile_ms(99),
            # client-independent server capacity: the host path with an
            # instant scorer x this cell's device-program ceiling
            "server_capacity_est_qps": min(
                host_cap_qps or float("inf"),
                kern.get("qps_ceiling") or float("inf"))
            if (host_cap_qps or kern.get("qps_ceiling")) else None,
            "p50_ms_at_2_workers": low["p50_ms"],
            "unloaded_latency_ms": unloaded,
            "device_exec_ms": kern.get("exec_ms"),
            "device_exec_batch": probe["batch"],
            "window_ms": probe["window_ms"],
            "host_ms": probe["host_ms"],
            "effective_gb_per_s": kern.get("effective_gb_per_s"),
            "kernel_qps_ceiling": kern.get("qps_ceiling"),
            "kernel_path": kernel_path,
            "roofline": kern.get("roofline"),
            "kernel_probe": {p: v for p, v in probe.items()
                             if isinstance(v, dict) and "exec_ms" in v},
            "kernel_route": probe.get("kernel_route"),
            "baseline_qps": base_qps,
            "baseline_p_lat_ms": base_lat,
            "dispatch_floor_ms": cell_floor,
            "p50_minus_dispatch_floor_ms": low["p50_ms"] - cell_floor,
            "device_mb": device_bytes(model) / 1e6,
            "batcher": batcher_stats,
            # exact-scan recomputes forced by failed certificates in
            # this cell's run
            "twophase_fallbacks": model.twophase_fallbacks
            - fallbacks_at_start,
        })
        log(json.dumps(rows[-1], default=str))
    model.lsh = lsh_obj
    return rows


def host_loopback_capacity(*, requests: int = 20_000, workers: int = 64,
                           open_workers: int = 128, rung_sec: float = 5.0,
                           fracs=(0.5, 0.75, 0.9),
                           descent=(0.35, 0.25, 0.15)) -> dict:
    """The serving host path with the device taken out: a stub model
    answers instantly, so the closed-loop qps and an open-loop ladder
    measure HTTP parse + route + JSON encode on this host alone.  A
    cell's server capacity is then min(host loopback, that cell's
    device-program ceiling)."""
    from ..app.als.serving_model import ALSServingModel
    from .load import run_recommend_load, run_recommend_open_loop

    class StubModel(ALSServingModel):
        # passes the route's isinstance gate but never touches a
        # device: every method the /recommend path calls is overridden
        features = 8
        rescorer_provider = None
        _result = [(f"i{j}", 1.0 - j / 100.0) for j in range(TOP_N)]

        def __init__(self):  # noqa: D401 — no stores, no device
            pass

        def get_fraction_loaded(self):
            return 1.0

        def get_user_vector(self, _id):
            return np.zeros(8, np.float32)

        def get_known_items(self, _id):
            return set()

        def top_n(self, how_many, **_kw):
            return self._result[:how_many]

    user_ids = [f"u{i}" for i in range(256)]
    with serve(StubModel(), MAX_BATCH, 0) as (base, _):
        closed = run_recommend_load(base, user_ids, requests=requests,
                                    workers=workers, how_many=TOP_N)
        rate, ladder = closed.qps, []
        for frac in fracs:
            ladder.append(run_recommend_open_loop(
                base, user_ids, rate_qps=rate * frac, duration_sec=rung_sec,
                workers=open_workers, how_many=TOP_N))
        if not any(o["sustained"] for o in ladder):
            descend_until_sustained(
                base, user_ids, [rate * f for f in descent], ladder,
                duration_sec=rung_sec, workers=open_workers, how_many=TOP_N)
        sustained = [o["offered_qps"] for o in ladder if o["sustained"]]
    return {
        "closed_loop_qps": closed.qps,
        "open_loop": ladder,
        "open_loop_sustained_qps": max(sustained) if sustained else 0.0,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", default="1,5,20",
                    help="millions of items, comma-separated")
    ap.add_argument("--features", default="50,250")
    ap.add_argument("--out", default=None,
                    help="write the grid artifact JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # fractional --items (e.g. 0.6) runs off-envelope scales; baseline
    # columns go None there
    items_list = [int(float(x)) if float(x) == int(float(x))
                  else float(x) for x in args.items.split(",")]
    features_list = [int(x) for x in args.features.split(",")]
    t_start = time.perf_counter()

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else dev.type}
    floor = measure_dispatch_floor(dev)
    print(json.dumps({"dispatch_floor_ms": floor, "device": device}),
          flush=True)
    from .kernel_probe import measure_peaks
    peaks = measure_peaks(device=dev)
    print(json.dumps({"peaks": peaks}), flush=True)
    host_cap = host_loopback_capacity()
    print(json.dumps({"host_loopback": host_cap}), flush=True)
    all_rows = []
    for items_m in items_list:
        for features in features_list:
            rng = np.random.default_rng(round(items_m * 1000) + features)
            t0 = time.perf_counter()
            model, user_ids = build_model(
                features, round(items_m * 1_000_000), rng, device=dev)
            print(json.dumps({"built": f"{features}f/{items_m}M",
                              "sec": time.perf_counter() - t0}), flush=True)
            all_rows.extend(bench_config(
                features, items_m, model, user_ids,
                host_cap_qps=host_cap.get("open_loop_sustained_qps"),
                peaks=peaks))
            # free this cell's store and mirrors before the next upload
            del model
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    grid_doc = {
        "metric": "als_recommend_http_grid",
        "device": device,
        # what bench/check_regression.py compares rounds by
        "backend": dev.type,
        "card": card_line() if dev.type == "cuda" else None,
        "dispatch_floor_ms": floor,
        "peaks": peaks,
        "host_loopback": host_cap,
        "summary": [
            {"config": f"{r['features']}f/"
                       f"{r['items'] / 1_000_000:g}M"
                       f"{'/lsh' if r['lsh'] else ''}",
             "sustained_qps": r["open_loop_sustained_qps"],
             "sustained_p50_ms": r["sustained_p50_ms"],
             "sustained_p99_ms": r["sustained_p99_ms"],
             "closed_loop_qps": r["qps"],
             "p99_ms_saturated": r["p99_ms_saturated"],
             "device_exec_ms": r["device_exec_ms"],
             "host_ms": r["host_ms"],
             "java_reference_qps": r["baseline_qps"]}
            for r in all_rows
        ],
        "headline_metric": "open_loop_sustained_qps",
        "rows": all_rows,
        "seconds": time.perf_counter() - t_start,
        "note": ("summary[].sustained_qps: the highest offered arrival "
                 "rate each cell held (open loop, exponential "
                 "inter-arrival, latency from the scheduled arrival). "
                 "Closed-loop qps and its p50/p99 come from the "
                 "saturation run (at least 1,000 requests). "
                 "device_exec_ms: the served kind's 256-query window "
                 "program on the card (CUDA events); host_ms: one "
                 "top_n_batch of the same window on the host clock less "
                 "device_exec_ms. A request's p50 decomposes as "
                 "dispatch_floor + device_exec/effective_batch + host + "
                 "HTTP. java_reference_qps / baseline_*: the Java "
                 "reference's published numbers on a 32-core Haswell "
                 "Xeon at 1-3 concurrent requests (BASELINE.md), a "
                 "comparison column only."),
    }
    print(json.dumps(grid_doc, default=str))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(grid_doc, default=str) + "\n")


if __name__ == "__main__":
    main()
