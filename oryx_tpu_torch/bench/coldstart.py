"""Cold-start benchmark: process start -> trained generation + first query.

Counterpart of ``oryx_tpu/bench/coldstart.py``.  The JVM reference's
layers do useful work seconds after exec (deploy/oryx-batch/src/main/
java/com/cloudera/oryx/batch/Main.java — construct, start, await;
nothing to compile).  This runtime pays, on a first start, the ``nvcc``
build of each kernel source it launches (``ops/cuda_build``), plus the
first CUDA call and the first use of the card's libraries.  The kernel
library cache (``common/compile_cache.py``, ``oryx.compile-cache-dir``)
turns the builds into a per-machine cost.  This bench measures it end
to end:

  parent: a fresh cache directory, then the install-time warmup (the
          ``warmup`` subcommand in a process of its own: one real
          training iteration at this scale and the libraries of the
          trained model's serving ladder, into the cache), then two
          child processes in sequence —
  child:  enable the cache -> synthesize ALS data -> train 2 epochs
          (epoch1 also pays the host packing and first uses, epoch2 is
          steady) -> build the serving model -> warm its serving
          programs -> first query.

Each child reports ``build_s``, the seconds it spent in
``cuda_build.build`` (0 when every library was current), and
``nvcc_runs``.  ``--skip-warmup`` measures the uninstalled first start.

Usage:  python -m oryx_tpu_torch.bench.coldstart [--ratings N --rank K
        --out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

__all__ = ["main"]


def _child(args) -> None:
    t_proc = time.perf_counter()
    import torch

    from ..common import compile_cache
    from ..common.config import from_dict
    from ..common.device import resolve_device
    from ..ops import cuda_build

    cfg = from_dict({"oryx.compile-cache-dir": args.cache_dir})
    compile_cache.enable_from_config(cfg)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.synchronize(dev)
    t_backend = time.perf_counter()

    from ..app.als.common import ParsedRatings
    from .train import synthesize_movielens

    users, items, implicit_vals, _, _ = synthesize_movielens(
        n_ratings=args.ratings, seed=11)
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1
    ratings = ParsedRatings(
        users=users, items=items, values=implicit_vals,
        user_ids=[f"u{i}" for i in range(n_users)],
        item_ids=[f"i{i}" for i in range(n_items)])
    t_synth = time.perf_counter()

    from ..app.als.trainer import train_als

    epoch_times: list[float] = []
    last = [time.perf_counter()]

    def on_it(i, X, Y):
        now = time.perf_counter()
        epoch_times.append(now - last[0])
        last[0] = now

    model = train_als(ratings, args.rank, lam=0.01, alpha=1.0,
                      implicit=True, iterations=2, seed=3,
                      on_iteration=on_it, device=dev)
    t_train = time.perf_counter()

    from ..app.als.serving_model import ALSServingModel

    sm = ALSServingModel(features=args.rank, implicit=True, device=dev)
    sm.Y.bulk_load(ratings.item_ids, model.Y)
    sm.X.bulk_load(ratings.user_ids, model.X)
    sm.warm_serving_kernels(10)
    t_warm = time.perf_counter()
    got = sm.top_n_batch(10, model.X[:2])
    assert len(got) == 2 and got[0]
    t_query = time.perf_counter()

    print(json.dumps({
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "backend_up_s": round(t_backend - t_proc, 2),
        "synth_s": round(t_synth - t_backend, 2),
        "epoch1_s": round(epoch_times[0], 2),
        "epoch2_s": round(epoch_times[1], 2),
        "train_total_s": round(t_train - t_synth, 2),
        "serving_warm_s": round(t_warm - t_train, 2),
        "first_query_s": round(t_query - t_warm, 2),
        # what a start pays beyond steady-state execution
        "compile_overhead_s": round(
            (epoch_times[0] - epoch_times[1])
            + (t_warm - t_train) + (t_query - t_warm), 2),
        "build_s": round(cuda_build.BUILD_S, 2),
        "nvcc_runs": cuda_build.NVCC_RUNS,
    }))


def _run(cmd: list[str], what: str) -> tuple[dict, float]:
    """The last stdout line of ``cmd`` as JSON, and its wall seconds."""
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         env=os.environ, check=False)
    wall = round(time.perf_counter() - t0, 2)
    if out.returncode != 0:
        sys.stderr.write(out.stderr)
        raise SystemExit(f"{what} failed rc={out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1]), wall


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ratings", type=int, default=20_000_000)
    p.add_argument("--rank", type=int, default=100)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--child", action="store_true")
    p.add_argument("--skip-warmup", action="store_true",
                   help="measure the uninstalled first cold start")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    if args.child:
        _child(args)
        return

    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="oryx-cc-")
    os.makedirs(cache_dir, exist_ok=True)
    device_args = ["--device", args.device] if args.device else []
    warmup_stats = None
    if not args.skip_warmup:
        # the install-time warmup runs in a process of its own: what it
        # builds reaches the children through the disk, not process state
        conf_path = os.path.join(cache_dir, "warmup.conf")
        with open(conf_path, "w", encoding="utf-8") as f:
            f.write('oryx { compile-cache-dir = %s }\n'
                    % json.dumps(cache_dir))
        warmup_stats, wall = _run(
            [sys.executable, "-m", "oryx_tpu_torch", "warmup",
             "--conf", conf_path, "--items", "", "--features", "",
             "--train-ratings", str(args.ratings),
             "--train-rank", str(args.rank), *device_args], "warmup")
        warmup_stats["process_wall_s"] = wall
    runs = []
    for label in ("cold", "second_cold"):
        stats, wall = _run(
            [sys.executable, "-m", "oryx_tpu_torch.bench.coldstart",
             "--child", "--cache-dir", cache_dir,
             "--ratings", str(args.ratings), "--rank", str(args.rank),
             *device_args], f"{label} child")
        stats["label"] = label
        stats["process_wall_s"] = wall
        runs.append(stats)

    cold, warm = runs
    result = {
        "metric": "als_cold_start",
        "ratings": args.ratings, "rank": args.rank,
        "device": warm.get("device"),
        "torch_version": warm.get("torch_version"),
        "cuda_version": warm.get("cuda_version"),
        # the one-time cost that makes the first start below load
        # libraries instead of building them (null with --skip-warmup)
        "install_warmup": warmup_stats,
        "first_cold_after_install": not args.skip_warmup,
        "cache_dir": cache_dir,
        "cold": cold, "second_cold": warm,
        "compile_overhead_cold_s": cold["compile_overhead_s"],
        "compile_overhead_second_cold_s": warm["compile_overhead_s"],
        "compile_speedup": round(
            cold["compile_overhead_s"]
            / max(warm["compile_overhead_s"], 1e-9), 1),
        "warm_restart_ok": warm["nvcc_runs"] == 0
        and warm["serving_warm_s"]
        < max(5.0, cold["serving_warm_s"] / 3.0),
        "warm_restart_ok_definition": (
            "no nvcc run on the restart, and its serving warm < "
            "max(5 s, cold_serving_warm / 3)"),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
