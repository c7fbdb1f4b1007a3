"""The port's serving grid (``oryx_tpu_torch/bench/grid.py``) end to end
at toy scale on the CPU, as ``tests/test_bench_load.py::
test_grid_bench_toy_scale`` runs the reference's, and
``warm_serving_kernels``, which the grid runs before it times."""

import numpy as np
import pytest

from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.bench import grid

SHORT = dict(sat_workers=4, measure_sec=0.3, min_sat_requests=40,
             ladder=(1.0,), descent=(0.5,), rung_sec=0.5, low_requests=8,
             max_batch=32, probe_m=1)


def test_grid_bench_toy_scale(monkeypatch):
    monkeypatch.setitem(grid.BASELINES, (4, 0, False), (10, 10))
    monkeypatch.setitem(grid.BASELINES, (4, 0, True), (10, 10))
    rng = np.random.default_rng(0)
    model, user_ids = grid.build_model(4, 600, rng, device="cpu")
    assert str(model.Y.device_arrays()[0].dtype) == "torch.bfloat16"
    seen = []
    rows = grid.bench_config(4, 0, model, user_ids, log=lambda line: None,
                             on_served=lambda base, lsh: seen.append(lsh),
                             **SHORT)
    assert len(rows) == 2 and seen == [False, True]
    for r in rows:
        assert r["qps"] > 0 and r["qps_errors"] == 0
        assert r["sat_requests"] >= SHORT["min_sat_requests"]
        assert np.isfinite(r["p50_ms_at_2_workers"])
        assert np.isfinite(r["p99_ms_saturated"])
        assert r["device_exec_ms"] > 0 and r["dispatch_floor_ms"] > 0
        assert r["host_ms"] == pytest.approx(r["window_ms"]
                                             - r["device_exec_ms"])
        assert r["baseline_qps"] == 10 and r["twophase_fallbacks"] == 0
        assert r["kernel_path"] in r["kernel_probe"]
    assert rows[0]["lsh"] is False and rows[1]["lsh"] is True
    assert model.lsh is not None  # restored after the exact rows


def test_build_model_reserves_and_uploads(monkeypatch):
    rng = np.random.default_rng(1)
    monkeypatch.setattr(grid, "SLAB_ROWS", 1500)
    model, users = grid.build_model(6, 5000, rng, device="cpu")
    vecs, active = model.Y.device_arrays()
    assert len(model.Y) == 5000 and int(active.sum()) == 5000
    assert len(users) == grid.N_USERS and model.lsh is not None
    assert grid.device_bytes(model) == (vecs.shape[0] + len(
        model.X.row_ids())) * 6 * 2


def test_host_loopback_capacity():
    out = grid.host_loopback_capacity(requests=200, workers=4,
                                      open_workers=8, rung_sec=0.5,
                                      fracs=(0.25,), descent=(0.1,))
    assert out["closed_loop_qps"] > 0
    assert out["open_loop"] and out["open_loop"][0]["errors"] == 0


def test_dispatch_floor_on_the_cpu():
    assert grid.measure_dispatch_floor("cpu") > 0


def test_warm_serving_kernels_installs_a_route(monkeypatch):
    """Warming drains every ladder size and the fallback, installs the
    measured route, and leaves the answers as they were."""
    monkeypatch.setattr(tsm, "_FLAT_SCORES_LIMIT", 1)
    monkeypatch.setattr(tsm, "_MAX_CHUNK_ROWS", 1024)
    monkeypatch.setattr(tsm, "_PA_TILE", 2048)
    rng = np.random.default_rng(2)
    model = tsm.ALSServingModel(16, True, sample_rate=0.5, device="cpu")
    model.Y.bulk_load([f"i{j}" for j in range(4096)],
                      rng.standard_normal((4096, 16)).astype(np.float32))
    q = rng.standard_normal((12, 16)).astype(np.float32)
    before = model.top_n_batch(10, q)
    before_exact = model.top_n_batch(10, q, use_lsh=False)
    assert model._route is None
    model.warm_serving_kernels(10, 64)
    n_rows = len(model.Y.row_ids())
    assert model._route_current(n_rows) is not None
    assert model.kernel_route_label is not None
    assert model.top_n_batch(10, q, use_lsh=False) == before_exact
    if model._route_use_lsh(n_rows):
        assert model.top_n_batch(10, q) == before
    assert model.twophase_fallbacks == 0
