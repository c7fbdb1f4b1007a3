"""The port's kernel probe (``oryx_tpu_torch/bench/kernel_probe.py``):
its per-pass byte and operation counts equal the reference's for the
same inputs, and the probe runs at a toy size on the CPU (as
``tests/test_bench_tools.py`` runs the reference's), where every time
comes from the monotonic clock."""

import numpy as np
import pytest
import torch

from oryx_tpu.bench import kernel_probe as jkp
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.bench import kernel_probe as tkp

NAMES = ["twophase_pallas", "twophase_pallas_fold", "twophase_pallas_i8",
         "twophase_pallas_i8_fold", "twophase", "chunked_exact", "flat",
         "flat_lsh", "ivf"]
KEYS = ("phase_a_bytes", "phase_a_flops", "phase_b_bytes", "phase_b_flops",
        "mxu_dtype", "phase_split_unavailable")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lsh,itemsize,fold", [(False, 2, 2), (True, 4, 4)])
def test_phase_decomposition_counts_are_the_reference(name, lsh, itemsize,
                                                      fold):
    n_rows, width, b, bs, ksel = 1 << 20, 64, 256, 128, 32
    vecs = np.zeros((4, width), np.float32)  # only its shape is read
    buckets = np.zeros(4, np.int32) if lsh else None
    peaks = {"hbm_gb_per_s": 3000.0, "matmul_bf16_tflops": 700.0,
             "matmul_f32_tflops": 50.0, "matmul_int8_tflops": 1400.0}
    out = {}
    for mod in (jkp, tkp):
        timing = {"exec_ms": 2.5}
        kw = dict(vecs=vecs, buckets=buckets, n_rows=n_rows, B=b, bs=bs,
                  ksel=ksel, fold=fold, itemsize=itemsize, peaks=peaks,
                  phase_b_ms={ksel: 0.5, tsm._i8_ksel(ksel, n_rows, bs): 0.7})
        mod._phase_decomposition(name, timing, **kw)
        out[mod] = timing.get("roofline")
    want, got = out[jkp], out[tkp]
    assert (got is None) == (want is None)
    if want is None:
        return
    for key in KEYS:
        assert got.get(key) == want.get(key), key
    for key in ("phase_a_ms", "phase_b_ms", "phase_a_gb_per_s",
                "phase_a_tflops", "hbm_fraction", "mxu_occupancy_est"):
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-2, abs=1e-3)


def test_measured_split_is_kept():
    """A timing that carries its parts measured apart keeps them: phase
    A is its own measurement, not the program less phase B."""
    timing = {"exec_ms": 3.0, "phase_a_ms": 1.0, "phase_b_ms": 1.5,
              "epilogue_ms": 0.5}
    tkp._phase_decomposition(
        "twophase_pallas_i8", timing, vecs=np.zeros((1, 64)), buckets=None,
        n_rows=1 << 20, B=256, bs=128, ksel=32, fold=1, itemsize=4,
        peaks=None, phase_b_ms=None)
    roof = timing["roofline"]
    assert roof["phase_a_ms"] == 1.0 and roof["phase_b_ms"] == 1.5
    assert roof["epilogue_ms"] == 0.5
    assert roof["phase_a_gb_per_s"] == pytest.approx(
        roof["phase_a_bytes"] / 1.0 / 1e6)


def test_time_exec_keys_on_the_cpu():
    x = torch.ones(1000)
    t = tkp.time_exec(lambda: x * 2.0, m=2, reps=2, min_delta_ms=0.0)
    assert set(t) == {"t1_ms", "tm_ms", "m", "exec_ms"}
    assert t["m"] == 2 and t["exec_ms"] == pytest.approx(t["tm_ms"] / 2)
    deep = tkp.time_exec(lambda: x * 2.0, m=2, reps=1, min_delta_ms=1e9,
                         max_m=32)
    assert deep["m"] == 32  # deepened until max_m


def test_measure_peaks_on_the_cpu():
    peaks = tkp.measure_peaks(m=2, device="cpu")
    assert peaks["device"] == "cpu" and peaks["hbm_gb_per_s"] > 0
    assert peaks["matmul_f32_tflops"] > 0
    assert peaks["matmul_bf16_tflops"] > 0


def test_bound_is_not_computed_off_a_card():
    assert tkp.bound(1e9, 1e12, "cpu")["bound_ms"] is None


@pytest.fixture
def streaming(monkeypatch):
    monkeypatch.setattr(tsm, "_FLAT_SCORES_LIMIT", 1)
    monkeypatch.setattr(tsm, "_MAX_CHUNK_ROWS", 2048)
    monkeypatch.setattr(tsm, "_PA_TILE", 2048)


@pytest.mark.parametrize("features,probe_int8", [(50, None), (10, True)])
def test_probe_model_small_shape(streaming, features, probe_int8):
    rng = np.random.default_rng(3)
    model = ALSServingModel(features=features, implicit=True, device="cpu")
    n = 8192
    model.Y.bulk_load([f"i{j}" for j in range(n)],
                      rng.standard_normal((n, features)).astype(np.float32))
    peaks = tkp.measure_peaks(m=2, device="cpu")
    out = tkp.probe_model(model, batch=32, m=2, peaks=peaks,
                          probe_int8=probe_int8)
    assert out["streaming"] and out["device"] == "cpu"
    kinds, fold = model._phase_a_kinds(n, 64 if features == 50 else 32, 128)
    for kind in kinds:
        rec = out[tkp.KIND_KEYS[kind]]
        roof = rec["roofline"]
        parts = rec["phase_a_ms"] + rec["phase_b_ms"] \
            + rec.get("epilogue_ms", 0.0)
        assert rec["exec_ms"] == pytest.approx(parts, rel=1e-9)
        assert roof["phase_a_flops"] == 2 * 32 * n * int(
            model.Y.device_arrays()[0].shape[1])
        if kind in ("i8", "i8_fold"):
            assert rec["cert_fail_rows"] >= 0
    assert "chunked_exact" in out
    assert out["window_ms"] > 0
    assert out["host_ms"] == pytest.approx(out["window_ms"]
                                           - out["exec_ms"])


def test_probe_model_flat_path():
    rng = np.random.default_rng(4)
    model = ALSServingModel(features=8, implicit=True, device="cpu")
    model.Y.bulk_load([f"i{j}" for j in range(300)],
                      rng.standard_normal((300, 8)).astype(np.float32))
    out = tkp.probe_model(model, batch=8, m=2)
    assert not out["streaming"] and out["served_path"] == "flat"
    assert out["flat"]["roofline"]["phase_a_flops"] == 2 * 8 * \
        int(model.Y.device_arrays()[0].shape[0]) * 32


def test_kind_program_matches_the_served_window(streaming):
    """Phase A then phase B of ``kind_program`` give the model's own
    served answer for the window."""
    rng = np.random.default_rng(6)
    model = ALSServingModel(features=12, implicit=True, device="cpu")
    n = 8192
    model.Y.bulk_load([f"i{j}" for j in range(n)],
                      rng.standard_normal((n, 12)).astype(np.float32))
    q = rng.standard_normal((8, 12)).astype(np.float32)
    for kind in ("pallas", "scan", "fold"):
        _, run_b, run_e = tkp.kind_program(model, kind, torch.from_numpy(q))
        assert run_e is None
        ts, idx, cert = run_b()
        assert bool(cert.all())
        served = model.top_n_batch(10, q)
        for j in range(8):
            assert [model.Y.id_of(int(i)) for i in idx[j, :10]] == \
                [i for i, _ in served[j]]
            np.testing.assert_allclose(ts[j, :10].numpy(),
                                       [v for _, v in served[j]], rtol=1e-6)
    with pytest.raises(ValueError, match="no phase-A program"):
        tkp.kind_program(model, "ivf", torch.from_numpy(q))
