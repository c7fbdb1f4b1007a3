"""The port's bench harnesses at toy sizes on the CPU, held against the
reference's: the MovieLens adapter (bench/datasets.py), the training
bench's gates (bench/train.py), the hyperparameter sweep (bench/sweep.py),
the k-means and RDF benches (bench/apps.py), the cold-start bench's
children (bench/coldstart.py) and the lambda-loop smoke
(bench/e2e_smoke.py)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from oryx_tpu.bench import datasets as jdatasets
from oryx_tpu.common.rand import RandomManager as JRandom
from oryx_tpu_torch.bench import datasets as tdatasets
from oryx_tpu_torch.common.rand import RandomManager as TRandom


@pytest.fixture
def seeded(monkeypatch):
    """Both packages' RandomManager in test-seed mode (the AUC's sampled
    negatives, the candidates' initial factors), restored afterwards."""
    monkeypatch.setattr(JRandom, "_use_test_seed", True)
    monkeypatch.setattr(TRandom, "_use_test_seed", True)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name, text", [
    ("ratings.csv", "userId,movieId,rating,timestamp\n"
                    "3,10,4.5,111\n7,10,2.0,112\n3,99,5.0,113\n"),
    ("ratings.dat", "1::20::3.5::900\n2::20::1.0::901\n9::4::5.0::902\n"),
])
def test_datasets_load_like_reference(tmp_path, name, text):
    (tmp_path / name).write_text(text)
    for path in (str(tmp_path), str(tmp_path / name)):
        _same(tdatasets.load_movielens(path), jdatasets.load_movielens(path))


def test_datasets_env_and_synthetic_fallback_like_reference(tmp_path,
                                                            monkeypatch):
    (tmp_path / "ratings.csv").write_text(
        "userId,movieId,rating,timestamp\n1,2,3.0,4\n")
    monkeypatch.setenv("ORYX_ML_DATA", str(tmp_path))
    _same(tdatasets.movielens_or_synthetic(None, n_ratings=1000),
          jdatasets.movielens_or_synthetic(None, n_ratings=1000))
    monkeypatch.delenv("ORYX_ML_DATA")
    port = tdatasets.movielens_or_synthetic(None, n_ratings=5000, seed=3,
                                            n_users=200, n_items=90)
    _same(port, jdatasets.movielens_or_synthetic(
        None, n_ratings=5000, seed=3, n_users=200, n_items=90))
    assert port[-1].startswith("synthetic")


def test_training_bench_gates_and_reference(seeded):
    from oryx_tpu.bench.train import run_training_bench as jbench
    from oryx_tpu_torch.bench.train import run_training_bench as tbench
    kw = dict(n_users=300, n_items=150, n_ratings=20000, rank=8,
              iterations=4, explicit_iterations=10, auc_max_users=100)
    port = tbench(**kw, device="cpu")  # its RMSE gate asserts inside
    ref = jbench(**kw)
    assert port["auc_test_pairs"] == ref["auc_test_pairs"] > 0
    assert 0.5 < port["implicit_test_auc"] == pytest.approx(
        ref["implicit_test_auc"], abs=2e-3)
    np.testing.assert_allclose(port["explicit_rmse_curve"],
                               ref["explicit_rmse_curve"], rtol=2e-3)
    assert port["explicit_test_rmse"] < 1.5 * port["explicit_noise_floor"]
    assert port["implicit_epoch_s"] > 0 and port["explicit_epoch_s"] > 0


def test_sweep_publishes_the_argmax_like_reference(seeded):
    from oryx_tpu.bench.sweep import run_sweep as jsweep
    from oryx_tpu_torch.bench.sweep import run_sweep as tsweep
    kw = dict(ratings=3000, iterations=2, n_users=150, n_items=80)
    port = tsweep(**kw, device="cpu")
    ref = jsweep(**kw)
    assert port["published_is_argmax"] and port["all_candidates_trained"]
    assert port["chosen"] == ref["chosen"]
    by = {(c["features"], c["lambda"]): c["eval"] for c in ref["candidates"]}
    assert len(port["candidates"]) == len(by) == 4
    for c in port["candidates"]:
        assert c["eval"] == pytest.approx(by[(c["features"], c["lambda"])],
                                          rel=2e-3)


def test_apps_benches_pass_their_gates_like_reference():
    from oryx_tpu.bench.apps import bench_kmeans as jkm
    from oryx_tpu.bench.apps import bench_rdf as jrdf
    from oryx_tpu_torch.bench.apps import bench_kmeans, bench_rdf
    km = bench_kmeans(n_points=2000, dims=4, k=3, iterations=2,
                      device="cpu")
    ref_km = jkm(n_points=2000, dims=4, k=3, iterations=2)
    assert km["points"] == 2000 and km["total_s"] > 0
    assert np.isfinite([km["upload_s"], km["init_s"], km["lloyd_s"]]).all()
    assert km["baseline_var"] == ref_km["baseline_var"]
    assert km["mean_sq_dist"] == pytest.approx(ref_km["mean_sq_dist"],
                                               rel=0.1)
    kw = dict(n_examples=1500, n_predictors=4, num_trees=2, max_depth=3,
              min_accuracy=0.6)
    rdf = bench_rdf(**kw, device="cpu")
    ref_rdf = jrdf(**kw)
    assert rdf["warm_total_s"] > 0 and rdf["total_s"] > 0
    assert all(np.isfinite(v) for v in rdf["warm_decomposition_s"].values())
    assert rdf["examples"] == ref_rdf["examples"]
    assert rdf["heldout_accuracy"] == pytest.approx(
        ref_rdf["heldout_accuracy"], abs=0.05)


def test_coldstart_children_report_the_reference_keys(tmp_path, capsys):
    from oryx_tpu_torch.bench import coldstart
    coldstart.main(["--skip-warmup", "--device", "cpu", "--ratings",
                    "5000", "--rank", "4", "--cache-dir",
                    str(tmp_path / "cache")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "als_cold_start"
    assert out["install_warmup"] is None
    assert out["first_cold_after_install"] is False
    keys = {"backend_up_s", "synth_s", "epoch1_s", "epoch2_s",
            "train_total_s", "serving_warm_s", "first_query_s",
            "compile_overhead_s", "build_s", "nvcc_runs"}
    for label in ("cold", "second_cold"):
        child = out[label]
        assert keys <= set(child) and child["label"] == label
        assert child["device"] == "cpu"
        assert child["build_s"] == 0 and child["nvcc_runs"] == 0
        assert child["compile_overhead_s"] == pytest.approx(
            child["epoch1_s"] - child["epoch2_s"] + child["serving_warm_s"]
            + child["first_query_s"], abs=0.03)
    assert out["warm_restart_ok"] in (True, False)


def test_e2e_smoke_passes_on_the_cpu(capsys):
    from oryx_tpu_torch.bench import e2e_smoke
    e2e_smoke.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] is True and line["device"] == "cpu"
    assert line["input_records"] > 0
    for stage in ("batch_generation_s", "speed_fold_in_s",
                  "serving_replay_query_s", "total_s"):
        assert line[stage] >= 0
