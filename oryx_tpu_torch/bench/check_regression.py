"""Regression gate over the port's serving bench rounds.

Counterpart of ``oryx_tpu/bench/check_regression.py``.  Three artifact
families share the machinery, selected by ``--kind``:

- ``grid`` (default): ``BENCH_TORCH_GRID_*.json``, cells keyed by
  (features, items, lsh) — the single-node serving envelope.
- ``gateway``: ``BENCH_TORCH_GATEWAY_*.json``, cells keyed by
  (features, items, replicas, replicas-per-shard) — the scatter-gather
  cluster's per-topology rounds.  A row's pseudo-cells gate on their
  own, so a regression cannot hide behind a healthy cold cell: the
  hot-user Zipf rung (``zipf``), per-replica model-load speed
  (``load``, 1 / max replica ``model_load_s``), the ``--regions 2``
  mirror probe's healed-partition catch-up records/s (``mirror``), the
  connection-count rung (``conns``), the write-heavy rung's acked
  writes/s (``writes``) and the IVF-ANN door's sustained qps (``ann``).
  A round that lacks a pseudo-cell reports it new, never compared.
- ``obs``: ``BENCH_TORCH_OBS_OVERHEAD_*.json`` — the observability
  hot-path microbench (bench/obs_overhead.py).  A hard absolute budget
  (the worst unsampled per-request pipeline under 10 µs) and a relative
  creep gate between comparable rounds (default threshold 50%).

Joins the two most recent rounds (by round number in the filename) on
the cell key and exits non-zero when any cell's headline metric —
``open_loop_sustained_qps`` — dropped by more than ``--threshold``
(default 10%).  Closed-loop qps and device_exec_ms are reported
alongside for diagnosis but do not gate.

Only the port's own ``BENCH_TORCH_*`` rounds are read; a reference
artifact (``BENCH_GATEWAY_r15.json`` and the rest) is never found, so
never compared.  Rounds from different backends (``cuda``, ``cpu``,
``host``) — or, on ``cuda``, from different cards — are never compared:
the guard reports the skip and exits 0.  A round without a ``backend``
key (the r11 grid) is read through its ``device`` block.

Usage:
    python -m oryx_tpu_torch.bench.check_regression
        [--kind grid|gateway|obs] [--dir .] [--threshold 0.10]
        [--current F] [--previous F]
Exit codes: 0 ok/skip, 1 regression, 2 usage/artifact error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

__all__ = ["compare_grids", "compare_obs", "find_grid_artifacts",
           "find_gateway_artifacts", "find_obs_artifacts",
           "backend_of", "backends_comparable", "main"]

_GRID_RE = re.compile(r"BENCH_TORCH_GRID_r(\d+)([a-z]?)\.json$")
_GATEWAY_RE = re.compile(r"BENCH_TORCH_GATEWAY_r(\d+)([a-z]?)\.json$")
_OBS_RE = re.compile(r"BENCH_TORCH_OBS_OVERHEAD_r(\d+)([a-z]?)\.json$")

# the unsampled obs pipeline's hard budget (ns/request): single-digit
# microseconds
OBS_BUDGET_NS = 10_000


def _find_artifacts(directory: str, pattern: re.Pattern) -> list[str]:
    found = []
    for name in os.listdir(directory):
        m = pattern.match(name)
        if m:
            found.append((int(m.group(1)), m.group(2),
                          os.path.join(directory, name)))
    return [p for _, _, p in sorted(found)]


def find_grid_artifacts(directory: str) -> list[str]:
    """Grid artifact paths sorted oldest-to-newest by (round, suffix)."""
    return _find_artifacts(directory, _GRID_RE)


def find_gateway_artifacts(directory: str) -> list[str]:
    return _find_artifacts(directory, _GATEWAY_RE)


def find_obs_artifacts(directory: str) -> list[str]:
    return _find_artifacts(directory, _OBS_RE)


def compare_obs(prev: dict, cur: dict, threshold: float = 0.50,
                budget_ns: int = OBS_BUDGET_NS) -> dict:
    """Obs-overhead comparison: the absolute per-request budget gates
    unconditionally; the relative gate compares only keys both rounds
    measured."""
    report: dict = {"regressions": [], "improved": [], "ok": [],
                    "skipped": None, "budget_ns": budget_ns}
    if not backends_comparable(prev, cur):
        report["skipped"] = (
            f"backend mismatch: previous={_describe(prev)} "
            f"current={_describe(cur)} — cross-backend ns is not "
            f"a regression signal")
        # the absolute budget still applies to the current round
        prev = {"microbench_ns_per_request": {}}
    p = prev.get("microbench_ns_per_request") or {}
    c = cur.get("microbench_ns_per_request") or {}
    # the budget gates the WORST unsampled cell the round measured:
    # recorder-armed > full pipeline > tracer-only
    hot = c.get("unsampled_recorder_armed",
                c.get("unsampled_full_pipeline",
                      c.get("unsampled_begin_branch_current")))
    if hot is None:
        report["regressions"].append(
            {"cell": "unsampled hot path",
             "error": "current round measured no unsampled ns"})
        return report
    if hot > budget_ns:
        report["regressions"].append(
            {"cell": "unsampled hot path", "ns_cur": hot,
             "over_budget_ns": budget_ns,
             "detail": "single-digit-µs contract broken"})
    for key in ("unsampled_begin_branch_current",
                "unsampled_full_pipeline",
                "unsampled_recorder_armed"):
        if key not in p or key not in c:
            continue
        old, new = float(p[key]), float(c[key])
        cell = {"cell": key, "ns_prev": old, "ns_cur": new}
        if old <= 0:
            report["ok"].append(cell)
            continue
        cell["ratio"] = round(new / old, 3)
        if new > old * (1.0 + threshold):
            report["regressions"].append(cell)
        elif new < old * (1.0 - threshold):
            report["improved"].append(cell)
        else:
            report["ok"].append(cell)
    return report


def _cells(doc: dict) -> dict:
    if doc.get("metric") == "gateway_recommend_scaling":
        # per-replica-count scaling cells (bench/gateway.py), keyed with
        # the replica-group size R; each pseudo-cell gates on its own
        # headline, and a round that lacks one simply lacks the cell
        out = {}
        for r in doc.get("rows", []):
            key = (r["features"], r["items"], r["replicas"],
                   r.get("replicas_per_shard", 1))
            out[key] = r
            # the hot-user Zipf rung: a result-cache regression cannot
            # hide behind a healthy cold cell
            z = r.get("zipf")
            if isinstance(z, dict) \
                    and z.get("open_loop_sustained_qps") is not None:
                out[key + ("zipf",)] = z
            # per-replica model load: the headline is LOAD SPEED, 1 /
            # max-replica model_load_s, so a >10% drop means load time
            # rose >11%
            load = r.get("model_load")
            if isinstance(load, dict) \
                    and load.get("max_replica_load_s"):
                out[key + ("load",)] = {
                    "open_loop_sustained_qps": round(
                        1.0 / load["max_replica_load_s"], 4),
                    "model_load_s": load["max_replica_load_s"],
                    "mode": load.get("mode"),
                }
            # the --regions 2 mirror probe: healed-partition CATCH-UP
            # SPEED (records replayed per second after the link
            # returns); steady-state staleness rides along
            mir = r.get("mirror")
            if isinstance(mir, dict) \
                    and mir.get("catch_up_records_per_s"):
                out[key + ("mirror",)] = {
                    "open_loop_sustained_qps":
                        mir["catch_up_records_per_s"],
                    "catch_up_s": mir.get("catch_up_s"),
                    "steady_staleness_ms":
                        mir.get("steady_staleness_ms"),
                }
            # the connection-count rung: qps sustained THROUGH the top
            # rung's concurrent sockets (errors zero the gated number)
            conns = r.get("conns")
            if isinstance(conns, dict) \
                    and conns.get("open_loop_sustained_qps") \
                    is not None:
                out[key + ("conns",)] = {
                    "open_loop_sustained_qps":
                        conns["open_loop_sustained_qps"],
                    "connections": conns.get("connections"),
                    "router_threads_at_load":
                        conns.get("router_threads_at_load"),
                    "hit_p50_ms": conns.get("hit_p50_ms"),
                }
            # the write-heavy rung: sustained ACKED writes/s through the
            # durable-ack ingest path
            w = r.get("writes")
            if isinstance(w, dict) \
                    and w.get("open_loop_sustained_qps") is not None:
                out[key + ("writes",)] = {
                    "open_loop_sustained_qps":
                        w["open_loop_sustained_qps"],
                    "acked_equals_durable":
                        w.get("acked_equals_durable"),
                    "ingest_to_servable_ms":
                        w.get("ingest_to_servable_ms"),
                    "p50_shed_ms":
                        (w.get("overload") or {}).get("p50_shed_ms"),
                }
            # the IVF-ANN rung: the ANN door's sustained qps at the
            # large-catalog cell (an index that silently fails closed
            # to the exact kernel collapses the gated number); the
            # recall certificate, the speedup over the exact door on
            # the same generation and p99 ride along
            a = r.get("ann")
            if isinstance(a, dict) \
                    and a.get("open_loop_sustained_qps") is not None:
                out[key + ("ann",)] = {
                    "open_loop_sustained_qps":
                        a["open_loop_sustained_qps"],
                    "speedup_vs_exact": a.get("speedup_vs_exact"),
                    "recall": (a.get("certificate") or {}).get("recall"),
                    "sustained_p99_ms": a.get("sustained_p99_ms"),
                }
        return out
    return {(r["features"], r["items"], r["lsh"]): r
            for r in doc.get("rows", [])}


def _cell_label(doc: dict, key: tuple) -> str:
    if doc.get("metric") == "gateway_recommend_scaling":
        label = f"{key[0]}f/{key[1] / 1e6:g}M/{key[2]}rep"
        if key[3] != 1:
            label += f"x{key[3]}"
        if len(key) > 4:
            label += f"/{key[4]}"
        return label
    return f"{key[0]}f/{key[1] / 1e6:g}M{'/lsh' if key[2] else ''}"


def backend_of(doc: dict) -> tuple[str | None, str | None]:
    """A round's (backend, card name).  The backend is ``cuda``,
    ``cpu`` or ``host`` (a host-only microbench); a round without a
    ``backend`` key is read through its ``device`` block (platform
    ``gpu`` is ``cuda``).  The card name drops the power limit that
    ``nvidia-smi`` prints after it."""
    backend = doc.get("backend")
    card = doc.get("card")
    device = doc.get("device")
    if isinstance(device, dict):
        if backend is None:
            platform = device.get("platform")
            backend = "cuda" if platform == "gpu" else platform
        if card is None and backend == "cuda":
            card = device.get("kind")
    if backend != "cuda":
        return backend, None
    if isinstance(card, str):
        card = card.split(",")[0].strip() or None
    return backend, card


def _describe(doc: dict) -> str:
    backend, card = backend_of(doc)
    return f"{backend}" if card is None else f"{backend} ({card})"


def backends_comparable(prev: dict, cur: dict) -> bool:
    """Whether two rounds' numbers are a regression signal: the same
    backend and, on ``cuda``, the same card.  An unknown backend (no
    ``backend`` key and no ``device`` block) compares with nothing."""
    pb, pc = backend_of(prev)
    cb, cc = backend_of(cur)
    if pb is None or cb is None or pb != cb:
        return False
    return pb != "cuda" or (pc is not None and pc == cc)


def compare_grids(prev: dict, cur: dict,
                  threshold: float = 0.10) -> dict:
    """Cell-by-cell comparison report; ``report["regressions"]`` is the
    gating list."""
    report: dict = {"regressions": [], "improved": [], "ok": [],
                    "missing_cells": [], "new_cells": [],
                    "skipped": None}
    if not backends_comparable(prev, cur):
        report["skipped"] = (
            f"backend mismatch: previous={_describe(prev)} "
            f"current={_describe(cur)} — cross-backend qps is not a "
            f"regression signal")
        return report
    pc, cc = _cells(prev), _cells(cur)
    report["missing_cells"] = sorted(str(k) for k in pc if k not in cc)
    report["new_cells"] = sorted(str(k) for k in cc if k not in pc)
    for key in sorted(k for k in pc if k in cc):
        p, c = pc[key], cc[key]
        old = p.get("open_loop_sustained_qps") or 0.0
        new = c.get("open_loop_sustained_qps") or 0.0
        cell = {
            "cell": _cell_label(cur, key),
            "sustained_qps_prev": old,
            "sustained_qps_cur": new,
            "closed_loop_prev": p.get("qps"),
            "closed_loop_cur": c.get("qps"),
            "device_exec_ms_prev": p.get("device_exec_ms"),
            "device_exec_ms_cur": c.get("device_exec_ms"),
        }
        if old <= 0.0:
            # nothing sustained last round: any measurement is progress
            report["ok"].append(cell)
            continue
        ratio = new / old
        cell["ratio"] = round(ratio, 3)
        if ratio < 1.0 - threshold:
            report["regressions"].append(cell)
        elif ratio > 1.0 + threshold:
            report["improved"].append(cell)
        else:
            report["ok"].append(cell)
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("grid", "gateway", "obs"),
                    default="grid",
                    help="artifact family: single-node serving grid, "
                         "the cluster gateway's per-replica scaling, "
                         "or the observability overhead microbench")
    ap.add_argument("--dir", default=".",
                    help="directory holding BENCH_TORCH_*_r*.json rounds")
    ap.add_argument("--threshold", type=float, default=None,
                    help="relative regression gate (default 0.10; "
                         "0.50 for --kind obs, where the absolute "
                         "budget is the real contract)")
    ap.add_argument("--current", default=None,
                    help="explicit current artifact (else newest)")
    ap.add_argument("--previous", default=None,
                    help="explicit previous artifact (else second-newest)")
    args = ap.parse_args(argv)
    if args.threshold is None:
        args.threshold = 0.50 if args.kind == "obs" else 0.10

    def _load(path):
        with open(path) as f:
            return json.load(f)

    skipped_rounds: list[str] = []
    if args.current and args.previous:
        cur_path, prev_path = args.current, args.previous
        try:
            cur, prev = _load(cur_path), _load(prev_path)
        except (OSError, json.JSONDecodeError) as e:
            print(json.dumps({"error": f"unreadable artifact: {e}"}))
            return 2
    else:
        finders = {"gateway": find_gateway_artifacts,
                   "obs": find_obs_artifacts,
                   "grid": find_grid_artifacts}
        arts = finders[args.kind](args.dir)
        if args.current:
            cur_path = args.current
            arts = [a for a in arts
                    if os.path.abspath(a) != os.path.abspath(cur_path)]
        elif arts:
            cur_path = arts.pop()
        else:
            kind = {"gateway": "GATEWAY", "obs": "OBS_OVERHEAD",
                    "grid": "GRID"}[args.kind]
            print(json.dumps(
                {"error": f"no BENCH_TORCH_{kind}_*.json found"}))
            return 2
        try:
            cur = _load(cur_path)
        except (OSError, json.JSONDecodeError) as e:
            print(json.dumps({"error": f"unreadable artifact: {e}"}))
            return 2
        if args.previous:
            prev_path = args.previous
            try:
                prev = _load(prev_path)
            except (OSError, json.JSONDecodeError) as e:
                print(json.dumps({"error": f"unreadable artifact: {e}"}))
                return 2
        else:
            # walk back to the NEWEST artifact on the same backend and
            # card: a CPU smoke round committed between two card rounds
            # must not un-gate the card's sequence
            prev_path = prev = None
            for cand in reversed(arts):
                try:
                    doc = _load(cand)
                except (OSError, json.JSONDecodeError):
                    skipped_rounds.append(os.path.basename(cand))
                    continue
                if backends_comparable(doc, cur):
                    prev_path, prev = cand, doc
                    break
                skipped_rounds.append(os.path.basename(cand))
            if prev is None:
                if args.kind == "obs":
                    # no relative comparison possible, but the HARD
                    # absolute budget is unconditional — a first round
                    # (or first round on a new backend) is exactly
                    # where a budget break is most likely
                    report = compare_obs(
                        {**{k: cur.get(k) for k in ("backend", "card",
                                                    "device")},
                         "microbench_ns_per_request": {}},
                        cur, threshold=args.threshold)
                    report["skipped"] = ("no prior obs round on "
                                        f"backend {_describe(cur)!r}"
                                        " — absolute budget only")
                    report["skipped_rounds"] = skipped_rounds
                    report["current"] = os.path.basename(cur_path)
                    print(json.dumps(report, indent=1))
                    return 1 if report["regressions"] else 0
                print(json.dumps({
                    "skipped": f"no prior {args.kind} round on backend "
                               f"{_describe(cur)!r}",
                    "skipped_rounds": skipped_rounds,
                    "current": os.path.basename(cur_path)}))
                return 0
    compare = compare_obs if args.kind == "obs" else compare_grids
    report = compare(prev, cur, threshold=args.threshold)
    report["previous"] = os.path.basename(prev_path)
    report["current"] = os.path.basename(cur_path)
    report["threshold"] = args.threshold
    if skipped_rounds:
        # rounds between current and the chosen base that were not
        # comparable (other backend / unreadable) — visible so a gap in
        # the gated sequence is never silent
        report["skipped_rounds"] = skipped_rounds
    print(json.dumps(report, indent=1))
    return 1 if report["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
