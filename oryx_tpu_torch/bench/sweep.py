"""Hyperparameter sweep through MLUpdate's candidate search at bench
scale — P2 (model-selection parallelism) exercised where it matters.

Counterpart of ``oryx_tpu/bench/sweep.py``, on the port's ``ALSUpdate``
and the card (``--device``, default the CUDA card).

Reference: MLUpdate.java:254-296 builds `candidates` models over the
hyperparameter combos (HyperParams.java:74-196) on a parallel stream,
evaluates each on the held-out split, and atomically publishes the best.
This bench drives the repo's real `ALSUpdate.run_update` loop (not a
shortcut) over a features x lambda grid on MovieLens-format data (real
files via $ORYX_ML_DATA / --data, synthetic fallback at the same shape)
and records every candidate's eval plus the one the search published —
gating that the published model IS the argmax.

Usage: python -m oryx_tpu_torch.bench.sweep [--ratings 2000000]
       [--data /path/to/ml-20m] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..common import pmml as pmml_io
from ..common.config import from_dict
from ..kafka.api import KeyMessage
from .datasets import movielens_or_synthetic
from .train import device_name

__all__ = ["run_sweep"]


def run_sweep(ratings: int = 2_000_000, data_path: str | None = None,
              features_grid=(20, 60), lambda_grid=(0.0005, 0.05),
              iterations: int = 6, seed: int = 7,
              n_users: int | None = None,
              n_items: int | None = None, device=None) -> dict:
    users, items, values, user_ids, item_ids, source = \
        movielens_or_synthetic(data_path, ratings, seed,
                               n_users=n_users, n_items=n_items)

    t0 = time.perf_counter()
    # the real ingestion surface: CSV input lines, exactly what the
    # batch layer hands MLUpdate (MLFunctions.PARSE_FN wire format)
    # increasing timestamps: ALSUpdate's train/test split is TIME-based
    # (newest fraction becomes test, update.py split_new_data_to_train_
    # test), so the wire events need a time order
    ts = 1_700_000_000_000
    msgs = [KeyMessage(None, f"{user_ids[u]},{item_ids[i]},{v:.2f},{ts + j}")
            for j, (u, i, v) in enumerate(zip(users.tolist(),
                                              items.tolist(),
                                              np.round(values,
                                                       2).tolist()))]
    encode_s = time.perf_counter() - t0

    from ..app.als.update import ALSUpdate

    evals: list[dict] = []

    class RecordingALSUpdate(ALSUpdate):
        def evaluate(self, model, candidate_path, test_data, train_data):
            e = super().evaluate(model, candidate_path, test_data,
                                 train_data)
            rescue = pmml_io.get_extension_value(model, "rescue")
            evals.append({
                "features": int(pmml_io.get_extension_value(model,
                                                            "features")),
                "lambda": float(pmml_io.get_extension_value(model,
                                                            "lambda")),
                "eval": float(e),
                # which rescue rung (if any) trained this candidate:
                # None = clean f32, else {precision, trigger_iteration,
                # escalated_lambda}
                "rescue": json.loads(rescue) if rescue else None,
            })
            return e

    n_candidates = len(features_grid) * len(lambda_grid)
    with tempfile.TemporaryDirectory() as td:
        cfg = from_dict({
            "oryx.als.implicit": False,
            "oryx.als.iterations": iterations,
            "oryx.als.hyperparams.features": list(features_grid),
            "oryx.als.hyperparams.lambda": list(lambda_grid),
            "oryx.ml.eval.candidates": n_candidates,
            "oryx.ml.eval.parallelism": 2,
            "oryx.ml.eval.test-fraction": 0.1,
        })
        upd = RecordingALSUpdate(cfg, device=device)
        t0 = time.perf_counter()
        upd.run_update(int(time.time() * 1000), msgs, [], td, None)
        sweep_s = time.perf_counter() - t0

        published = [d for d in os.listdir(td) if d.isdigit()]
        assert len(published) == 1, published
        from ..ml.mlupdate import MODEL_FILE_NAME
        doc = pmml_io.read(os.path.join(td, published[0], MODEL_FILE_NAME))
        chosen = {
            "features": int(pmml_io.get_extension_value(doc, "features")),
            "lambda": float(pmml_io.get_extension_value(doc, "lambda")),
        }

    # The rescue ladder (f32 -> f64 -> escalated lambda) means EVERY
    # candidate of the reference's grid trains — 0 NaN evals is the
    # gate (MLlib trains f64 at lambda=5e-4; pre-rescue the f32 path
    # diverged there and half the grid was lost).  Argmax is over the
    # finite evals; each candidate records the rescue rung it needed.
    finite = [d for d in evals if d["eval"] == d["eval"]]
    nan_candidates = len(evals) - len(finite)
    # candidates that never reached evaluate() at all (diverged beyond
    # rescue, or rejected by the pre-publish gate) are just as lost as
    # NaN ones — the 0-NaN acceptance gate must count them too
    missing_candidates = n_candidates - len(evals)
    best = max(finite, key=lambda d: d["eval"]) if finite else None
    gate_ok = (best is not None
               and chosen["features"] == best["features"]
               and chosen["lambda"] == best["lambda"]
               and len(evals) == n_candidates)
    rescued = [d for d in evals if d.get("rescue")]
    return {
        "metric": "als_hyperparam_sweep",
        "dataset": source,
        "ratings": int(len(msgs)),
        "grid": {"features": list(features_grid),
                 "lambda": list(lambda_grid)},
        "candidates": evals,
        "chosen": chosen,
        "eval_metric": "-RMSE (explicit; Evaluation.java:49-63 semantics)",
        "published_is_argmax": gate_ok,
        "nan_candidates": nan_candidates,
        "missing_candidates": missing_candidates,
        "all_candidates_trained": (nan_candidates == 0
                                   and missing_candidates == 0),
        "rescued_candidates": len(rescued),
        "rescues": {
            "float64": sum(1 for d in rescued
                           if d["rescue"].get("escalated_lambda") is None),
            "escalated_lambda": sum(
                1 for d in rescued
                if d["rescue"].get("escalated_lambda") is not None),
        },
        "eval_parallelism": 2,
        "sweep_wall_s": round(sweep_s, 1),
        "csv_encode_s": round(encode_s, 1),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratings", type=int, default=2_000_000)
    ap.add_argument("--data", default=None)
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    result = run_sweep(ratings=args.ratings, data_path=args.data,
                       iterations=args.iterations, device=args.device)
    result["device"] = device_name(args.device)
    assert result["published_is_argmax"], result
    # every grid candidate trained, the lambda=5e-4 half MLlib trains
    # in f64 included
    assert result["all_candidates_trained"], result
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
