"""The port's regression gate (``oryx_tpu_torch/bench/check_regression.py``)
held against the reference's.

The same artifact documents through both packages' ``compare_grids`` and
``compare_obs`` give equal reports on every cell and pseudo-cell kind
(``zipf``, ``load``, ``mirror``, ``conns``, ``writes``, ``ann``) and on
the obs budget; ``main()`` gives the same exit codes and reports on the
same rounds, each package reading its own file names.  The port finds
``BENCH_TORCH_*`` files only, and compares two rounds only on the same
backend and, on ``cuda``, the same card — a round without a ``backend``
key is read through its ``device`` block.  Every artifact is written
into ``tmp_path``."""

from __future__ import annotations

import copy
import json

import pytest

from oryx_tpu.bench import check_regression as jcr
from oryx_tpu_torch.bench import check_regression as tcr

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _gateway_row(replicas: int, qps: float, scale: float = 1.0,
                 rps: int = 1) -> dict:
    return {
        "features": 129, "items": 524288, "replicas": replicas,
        "replicas_per_shard": rps, "open_loop_sustained_qps": qps * scale,
        "qps": qps * 1.1, "device_exec_ms": 1.5,
        "zipf": {"open_loop_sustained_qps": 3000.0 * scale,
                 "hit_rate": 0.99},
        "model_load": {"max_replica_load_s": 30.0 / scale,
                       "mode": "slices"},
        "mirror": {"catch_up_records_per_s": 800.0 * scale,
                   "catch_up_s": 2.5, "steady_staleness_ms": 120.0},
        "conns": {"open_loop_sustained_qps": 500.0 * scale,
                  "connections": 1024, "router_threads_at_load": 12,
                  "hit_p50_ms": 1.1},
        "writes": {"open_loop_sustained_qps": 700.0 * scale,
                   "acked_equals_durable": True,
                   "ingest_to_servable_ms": 900,
                   "overload": {"p50_shed_ms": 1.2}},
        "ann": {"open_loop_sustained_qps": 400.0 * scale,
                "speedup_vs_exact": 1.4, "certificate": {"recall": 0.97},
                "sustained_p99_ms": 30.0},
    }


def _gateway(scale: float = 1.0, **top) -> dict:
    return {"metric": "gateway_recommend_scaling", "backend": "cuda",
            "card": CARD, **top,
            "rows": [_gateway_row(1, 950.0, scale),
                     _gateway_row(2, 400.0, scale),
                     _gateway_row(2, 380.0, scale, rps=2)]}


def _grid(scale: float = 1.0, **top) -> dict:
    return {"metric": "als_recommend_http_grid", "backend": "cuda",
            "card": CARD, **top,
            "rows": [{"features": f, "items": n, "lsh": lsh,
                      "open_loop_sustained_qps": q * scale,
                      "qps": q, "device_exec_ms": 2.0}
                     for f, n, lsh, q in ((50, 1_000_000, False, 900.0),
                                          (50, 1_000_000, True, 1200.0),
                                          (250, 5_000_000, False, 300.0))]}


def _obs(ns: float, **top) -> dict:
    return {"metric": "obs_tracing_overhead", "backend": "host", **top,
            "microbench_ns_per_request": {
                "unsampled_begin_branch_current": ns / 10,
                "unsampled_full_pipeline": ns,
                "unsampled_recorder_armed": ns * 1.2}}


def _degrade(doc: dict, key: str, factor: float) -> dict:
    """``doc`` with one pseudo-cell (or the cold cell: None) of every row
    scaled by ``factor``."""
    out = copy.deepcopy(doc)
    for row in out["rows"]:
        if key is None:
            row["open_loop_sustained_qps"] *= factor
        elif key == "load":
            row["model_load"]["max_replica_load_s"] /= factor
        elif key == "mirror":
            row["mirror"]["catch_up_records_per_s"] *= factor
        else:
            row[key]["open_loop_sustained_qps"] *= factor
    return out


@pytest.mark.parametrize("key", [None, "zipf", "load", "mirror", "conns",
                                 "writes", "ann"])
@pytest.mark.parametrize("factor", [0.5, 0.95, 1.5])
def test_gateway_reports_equal_on_every_pseudo_cell(key, factor):
    prev = _gateway()
    cur = _degrade(prev, key, factor)
    reports = [m.compare_grids(prev, cur) for m in (jcr, tcr)]
    assert reports[0] == reports[1]
    gated = reports[1]["regressions"] if factor < 0.9 else \
        reports[1]["improved"] if factor > 1.1 else reports[1]["ok"]
    suffix = "" if key is None else f"/{key}"
    assert any(c["cell"].endswith(f"rep{suffix}") for c in gated)


def test_gateway_lacking_cells_are_new_or_missing_in_both():
    prev = _gateway()
    cur = copy.deepcopy(prev)
    for row in prev["rows"]:
        del row["ann"], row["mirror"]
    cur["rows"][0]["ann"]["open_loop_sustained_qps"] = None
    reports = [m.compare_grids(prev, cur) for m in (jcr, tcr)]
    assert reports[0] == reports[1]
    assert reports[1]["new_cells"] and not reports[1]["regressions"]


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_grid_reports_equal(factor):
    prev = _grid()
    cur = _grid(factor)
    del cur["rows"][2]
    reports = [m.compare_grids(prev, cur) for m in (jcr, tcr)]
    assert reports[0] == reports[1]
    assert reports[1]["missing_cells"] == ["(250, 5000000, False)"]


@pytest.mark.parametrize("prev_ns, cur_ns", [
    (4000.0, 4100.0), (4000.0, 7000.0), (4000.0, 1000.0),
    (4000.0, 9000.0), (None, 3000.0)])
def test_obs_reports_equal(prev_ns, cur_ns):
    prev = _obs(prev_ns) if prev_ns else {
        "backend": "host", "microbench_ns_per_request": {}}
    cur = _obs(cur_ns)
    reports = [m.compare_obs(prev, cur) for m in (jcr, tcr)]
    assert reports[0] == reports[1]
    # the recorder-armed cell gates the budget: 9000 x 1.2 breaks it
    assert any(c["cell"] == "unsampled hot path"
               for c in reports[1]["regressions"]) == (cur_ns == 9000.0)


def _write_rounds(directory, names_docs) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    for name, doc in names_docs:
        (directory / name).write_text(json.dumps(doc))


@pytest.mark.parametrize("kind, rounds", [
    ("gateway", [("r15", _gateway()), ("r16", _gateway(0.5))]),
    ("gateway", [("r15", _gateway()), ("r16", _gateway(1.02))]),
    ("grid", [("r11", _grid()), ("r12", _grid(1.3))]),
    ("grid", [("r11", _grid())]),
    ("obs", [("r13", _obs(3000.0))]),
    ("obs", [("r13", _obs(3000.0)), ("r16", _obs(3200.0))]),
    ("obs", [("r13", _obs(3000.0)), ("r16", _obs(9500.0))]),
    ("gateway", []),
])
def test_main_exit_codes_and_reports_match(tmp_path, capsys, kind, rounds):
    stem = {"gateway": "GATEWAY", "grid": "GRID",
            "obs": "OBS_OVERHEAD"}[kind]
    got = []
    for mod, prefix in ((jcr, "BENCH_"), (tcr, "BENCH_TORCH_")):
        d = tmp_path / prefix
        _write_rounds(d, [(f"{prefix}{stem}_{r}.json", doc)
                          for r, doc in rounds])
        rc = mod.main(["--kind", kind, "--dir", str(d)])
        text = capsys.readouterr().out.replace(prefix, "BENCH_X_")
        got.append((rc, json.loads(text)))
    assert got[0][0] == got[1][0]
    ref, port = got[0][1], got[1][1]
    if "skipped" in port and isinstance(port["skipped"], str):
        # the skip names the round's backend; the port adds its card
        ref.pop("skipped", None)
        port.pop("skipped", None)
    assert ref == port


def test_discovery_finds_port_rounds_only(tmp_path):
    _write_rounds(tmp_path, [
        ("BENCH_GATEWAY_r15.json", _gateway()),
        ("BENCH_GATEWAY_r17.json", _gateway()),
        ("BENCH_GRID_r03.json", _grid()),
        ("BENCH_GRID20M_r04.json", _grid()),
        ("BENCH_OBS_OVERHEAD_r16.json", _obs(1.0)),
        ("BENCH_TORCH_GATEWAY_r15.json", _gateway()),
        ("BENCH_TORCH_GATEWAY_r16b.json", _gateway()),
        ("BENCH_TORCH_GRID_r11.json", _grid()),
        ("BENCH_TORCH_OBS_OVERHEAD_r16.json", _obs(1.0))])
    names = {k: [p.rsplit("/", 1)[1] for p in f(str(tmp_path))]
             for k, f in (("gateway", tcr.find_gateway_artifacts),
                          ("grid", tcr.find_grid_artifacts),
                          ("obs", tcr.find_obs_artifacts))}
    assert names == {
        "gateway": ["BENCH_TORCH_GATEWAY_r15.json",
                    "BENCH_TORCH_GATEWAY_r16b.json"],
        "grid": ["BENCH_TORCH_GRID_r11.json"],
        "obs": ["BENCH_TORCH_OBS_OVERHEAD_r16.json"]}


R11_DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("prev, cur, comparable", [
    # the r11 grid: no backend key, a device block
    ({"device": R11_DEVICE}, {"backend": "cuda", "card": CARD}, True),
    ({"device": R11_DEVICE}, {"backend": "cuda",
                              "card": "NVIDIA H100 80GB HBM3, 500.00 W"},
     True),
    ({"device": R11_DEVICE}, {"backend": "cuda",
                              "card": "NVIDIA A100-SXM4-80GB, 400.00 W"},
     False),
    ({"device": {"platform": "cpu", "kind": "cpu"}}, {"backend": "cpu"},
     True),
    ({"backend": "cpu"}, {"backend": "cuda", "card": CARD}, False),
    ({"backend": "host"}, {"backend": "host"}, True),
    ({"backend": "host"}, {"backend": "cpu"}, False),
    # the reference's legacy rule does not carry over: a round with no
    # backend at all compares with nothing
    ({}, {"backend": "cuda", "card": CARD}, False),
    ({}, {}, False),
    ({"backend": "tpu"}, {"backend": "tpu"}, True),
    ({"backend": "cuda"}, {"backend": "cuda"}, False),
])
def test_backend_rule(prev, cur, comparable):
    assert tcr.backends_comparable(prev, cur) is comparable
    assert tcr.backends_comparable(cur, prev) is comparable
    report = tcr.compare_grids({**prev, "rows": []}, {**cur, "rows": []})
    assert (report["skipped"] is None) is comparable


def test_r11_grid_compares_with_a_later_card_round(tmp_path, capsys):
    """The committed r11 grid shape (``device`` block, no ``backend``)
    is the base of the next grid round on the same card."""
    r11 = {k: v for k, v in _grid().items() if k not in ("backend", "card")}
    r11["device"] = R11_DEVICE
    _write_rounds(tmp_path, [("BENCH_TORCH_GRID_r11.json", r11),
                             ("BENCH_TORCH_GRID_r16.json", _grid(0.5)),
                             ("BENCH_TORCH_GRID_r15.json",
                              {**_grid(), "backend": "cpu", "card": None})])
    assert tcr.main(["--kind", "grid", "--dir", str(tmp_path)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["previous"] == "BENCH_TORCH_GRID_r11.json"
    assert report["skipped_rounds"] == ["BENCH_TORCH_GRID_r15.json"]
    assert len(report["regressions"]) == 3
