"""The port's fold-in bench (``oryx_tpu_torch/bench/fold_in.py``) on the
CPU at a toy size: the batched and per-event paths fold the same events,
and every record field is there."""

from oryx_tpu_torch.bench.fold_in import EXEC_BATCHES, run_fold_in_bench


def test_fold_in_bench_toy_size():
    out = run_fold_in_bench(features=8, events=64, per_event_sample=4,
                            reps=2, device="cpu")
    assert out["device"] == "cpu" and out["events"] == 64
    assert [r["batch"] for r in out["exec_only_curve"]] == \
        list(EXEC_BATCHES)
    assert all(r["exec_events_per_s"] > 0 for r in out["exec_only_curve"])
    assert out["batched_events_per_s"] > 0 and out["speedup"] > 0
    assert out["dispatch_floor_s"] > 0
    ref = out["vs_reference_estimate"]
    assert ref["reference_estimate_events_per_s"] > 0
    assert ref["exec_only_best_events_per_s"] == max(
        r["exec_events_per_s"] for r in out["exec_only_curve"])
