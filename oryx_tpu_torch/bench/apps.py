"""k-means and RDF training benchmarks at representative scale.

Counterpart of ``oryx_tpu/bench/apps.py``.  The reference defers
batch-layer performance to "the underlying MLlib implementations"
(docs/docs/performance.html); these record what the port's trainers
sustain on one card so the claim is a number: Lloyd iterations over
millions of points and level-synchronous forest growth over a
covtype-scale table.

Run: python -m oryx_tpu_torch.bench.apps [--points N] [--examples N]
     [--device cpu]
Prints one JSON line per app.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .train import device_name


def bench_kmeans(n_points: int = 5_000_000, dims: int = 20, k: int = 100,
                 iterations: int = 10, seed: int = 5, device=None) -> dict:
    import torch

    from ..app.kmeans.trainer import train_kmeans
    from ..common.device import resolve_device

    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    true_centers = rng.standard_normal((k, dims)).astype(np.float32) * 10
    assign = rng.integers(0, k, n_points)
    # float32 generation directly — a float64 intermediate would double
    # memory and generation time at bench scale
    pts = (true_centers[assign]
           + rng.standard_normal((n_points, dims), dtype=np.float32))

    # one upload, timed separately: training itself is device-resident
    # (only KBs of centers/counts/cost cross to the host), so the timed
    # region measures the Lloyd steps, not data movement
    t0 = time.perf_counter()
    dev_pts = torch.from_numpy(pts).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload = time.perf_counter() - t0

    # a warm-up run with the same shapes and iteration count: the first
    # run pays the libraries' first use and the allocator's pool
    train_kmeans(dev_pts, k=k, iterations=iterations, runs=1, seed=seed,
                 device=dev)
    timings: dict = {}
    t0 = time.perf_counter()
    clusters = train_kmeans(dev_pts, k=k, iterations=iterations, runs=1,
                            seed=seed, timings=timings, device=dev)
    total = time.perf_counter() - t0
    assert len(clusters) == k
    # quality gate: clustering must capture the planted structure —
    # mean squared distance to the nearest learned center has to be a
    # small fraction of the variance around the global mean (what k=1
    # would score); merged/failed clusterings land near the baseline
    centers = np.stack([c.center for c in clusters]).astype(np.float32)
    d2_total = 0.0
    for s in range(0, n_points, 1_000_000):
        blk = pts[s:s + 1_000_000]
        d = (np.sum(blk * blk, axis=1, keepdims=True)
             - 2.0 * blk @ centers.T
             + np.sum(centers * centers, axis=1)[None, :])
        d2_total += float(np.maximum(d.min(axis=1), 0).sum())
    mean_sq_dist = d2_total / n_points
    baseline_var = float(
        ((pts - pts.mean(axis=0)) ** 2).sum(axis=1).mean())
    assert mean_sq_dist < 0.1 * baseline_var, (mean_sq_dist, baseline_var)
    return {
        "metric": "kmeans_train",
        "points": n_points, "dims": dims, "k": k,
        "iterations": iterations,
        "upload_s": round(upload, 2),
        "total_s": round(total, 4),
        "init_s": round(timings["init_s"], 2),
        "lloyd_s": round(timings["lloyd_s"], 2),
        # per-Lloyd-iteration metrics divide by Lloyd time only, so
        # they stay comparable whatever the initialization strategy
        "iteration_s": round(timings["lloyd_s"] / iterations, 3),
        "points_per_s": round(
            n_points * iterations / timings["lloyd_s"], 0),
        "mean_sq_dist": round(mean_sq_dist, 2),
        "baseline_var": round(baseline_var, 2),
        "quality_gate": "mean_sq_dist < 0.1 * baseline_var",
        # which side of the host-to-device copy each number measures
        "timing_boundaries": {
            "upload_s": "host->device copy of the points (one-time, "
                        "outside total_s)",
            "total_s": "on the device (the warm train_kmeans call)",
            "init_s": "on the device (k-means|| initialization)",
            "lloyd_s": "on the device (Lloyd iterations)",
        },
    }


def bench_rdf(n_examples: int = 1_000_000, n_predictors: int = 20,
              num_trees: int = 20, max_depth: int = 10,
              bins: int = 32, seed: int = 6,
              min_accuracy: float = 0.9, device=None) -> dict:
    from ..app.rdf.trainer import train_forest
    from ..app.schema import InputSchema
    from ..common.config import from_dict

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n_examples, n_predictors)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 1] - 0.25 * x[:, 2]) > 0).astype(np.int32)
    # held-out split, the reference's eval semantics (Evaluation.java:
    # 27-50 scores the forest on data the trainer never saw)
    n_test = n_examples // 10
    x_train, y_train = x[n_test:], y[n_test:]
    x_test, y_test = x[:n_test], y[:n_test]
    names = [f"f{i}" for i in range(n_predictors)] + ["label"]
    schema = InputSchema(from_dict({
        "oryx.input-schema.feature-names": names,
        "oryx.input-schema.numeric-features": names[:-1],
        "oryx.input-schema.target-feature": "label",
    }))
    t0 = time.perf_counter()
    forest = train_forest(x_train, y_train, schema, category_counts={},
                          num_trees=num_trees, max_depth=max_depth,
                          max_split_candidates=bins, impurity="gini",
                          seed=seed, num_classes=2, device=device)
    total = time.perf_counter() - t0
    # second build = the production steady state: the batch layer
    # retrains every generation
    timings: dict = {}
    t0 = time.perf_counter()
    train_forest(x_train, y_train, schema, category_counts={},
                 num_trees=num_trees, max_depth=max_depth,
                 max_split_candidates=bins,
                 impurity="gini", seed=seed + 1, num_classes=2,
                 timings=timings, device=device)
    warm_total = time.perf_counter() - t0

    # held-out accuracy via the array-form batched forest, on a sample
    # (sample FIRST — materializing the full all-features matrix would
    # do 20x the work for rows never predicted)
    from ..app.rdf.forest_arrays import ForestArrays
    sample = rng.choice(n_test, min(n_test, 50_000), replace=False)
    full = np.full((len(sample), schema.num_features), np.nan, np.float32)
    full[:, :n_predictors] = x_test[sample]
    arrays = ForestArrays(forest, schema.num_features, 2, device=device)
    probs = arrays.predict_proba(full)
    acc = float((np.argmax(probs, axis=1) == y_test[sample]).mean())
    assert acc >= min_accuracy, (acc, min_accuracy)  # quality gate
    n_train = n_examples - n_test
    return {
        "metric": "rdf_train",
        "examples": n_train, "predictors": n_predictors,
        "trees": num_trees, "max_depth": max_depth, "bins": bins,
        "total_s": round(total, 4),
        "warm_total_s": round(warm_total, 4),
        "examples_x_trees_per_s": round(n_train * num_trees / total, 0),
        "warm_examples_x_trees_per_s": round(
            n_train * num_trees / warm_total, 0),
        "heldout_accuracy": round(acc, 4),
        "quality_gate": f"heldout_accuracy >= {min_accuracy}",
        # stage decomposition of the warm build (device work is async;
        # each fetch stage absorbs its pending kernel time)
        "warm_decomposition_s": {k: round(v, 2)
                                 for k, v in timings.items()},
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=5_000_000)
    ap.add_argument("--examples", type=int, default=1_000_000)
    ap.add_argument("--only", choices=["kmeans", "rdf"], default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    name = device_name(args.device)
    if args.only in (None, "kmeans"):
        print(json.dumps({**bench_kmeans(n_points=args.points,
                                         device=args.device),
                          "device": name}))
    if args.only in (None, "rdf"):
        print(json.dumps({**bench_rdf(n_examples=args.examples,
                                      device=args.device),
                          "device": name}))


if __name__ == "__main__":
    main()
