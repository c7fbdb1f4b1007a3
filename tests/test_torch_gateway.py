"""The port's gateway bench (``oryx_tpu_torch/bench/gateway.py``) at toy
size on the CPU — replicas 1 and 2 over 4,096 items x 8 features, 1 s
rungs, with the reference's fast path (asyncio front end, frames, the
result cache) and its Zipf and coalescing rungs — writes every key of
the reference's artifact, rows and report alike; ``--regions 2`` and
``--ann`` write their ``mirror`` and ``ann`` blocks (a real mirror
process, ANN and exact doors over one generation, 1 s rungs); the
option that waits for a later part of the package exits 2 naming its
flag."""

from __future__ import annotations

import ast
import json
import os

import pytest

from oryx_tpu_torch.bench import gateway

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_keys() -> tuple[set, set]:
    """The keys of the reference's row (``run_cell``'s returned dict)
    and report (``main``'s ``report``), read from its source."""
    with open(os.path.join(REPO, "oryx_tpu", "bench", "gateway.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())

    def keys(node) -> set:
        return {k.value for k in node.keys if isinstance(k, ast.Constant)}

    row = report = None
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == "run_cell":
            row = next(keys(n.value) for n in ast.walk(fn)
                       if isinstance(n, ast.Return)
                       and isinstance(n.value, ast.Dict))
        if isinstance(fn, ast.FunctionDef) and fn.name == "main":
            report = next(keys(n.value) for n in ast.walk(fn)
                          if isinstance(n, ast.Assign)
                          and isinstance(n.value, ast.Dict)
                          and any(getattr(t, "id", None) == "report"
                                  for t in n.targets))
    return row | {"publish_s"}, report


def test_toy_cells_write_the_reference_artifact(tmp_path):
    out = tmp_path / "gw.json"
    assert gateway.main([
        "--replicas", "1,2", "--items", "4096", "--features", "8",
        "--users", "50", "--rates", "20,40", "--duration", "1",
        "--device", "cpu", "--zipf", "1.1", "--coalesce-burst", "8",
        "--sharded-publish", "8", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    row_keys, report_keys = _reference_keys()
    assert set(report) == report_keys | {"card"}
    assert report["backend"] == "cpu" and report["card"] is None
    assert [r["replicas"] for r in report["rows"]] == [1, 2]
    for row in report["rows"]:
        assert set(row) == row_keys | {"device"}
        assert row["device"] == "cpu"
        assert row["merge_spotcheck_ok"] is True
        assert row["partial_answers_during_run"] == 0
        assert row["async_front_end"] and row["framed_transport"]
        # every shard query rode the frames
        scatter = row["scatter_stats_after_ladder"]
        assert scatter["pool"]["attempts"] == 0
        assert scatter["transport"]["open_connections"] == row["replicas"]
        assert row["model_load"]["mode"] == "slices"
        assert row["model_load"]["fallbacks"] == 0
        burst = row["coalesce_burst"]
        assert burst["errors"] == 0
        assert sum(burst["verdicts"].values()) == 8 * burst["waves"]
        assert burst["verdicts"].get("miss", 0) <= burst["waves"]
        assert row["zipf"]["cache"]["hit"] > 0
    assert set(report["scaling_vs_1"]) == {"1", "2"}


@pytest.fixture(scope="module")
def probes_report(tmp_path_factory):
    """One toy run with the two-region mirror probe and the ANN rung
    (its ladder cut to 1 s rungs up to 2 qps)."""
    out = tmp_path_factory.mktemp("gw-probes") / "gw.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(gateway, "ANN_LADDER_TOP_QPS", 2.0)
    mp.setattr(gateway, "ANN_RUNG_MIN_S", 1.0)
    try:
        assert gateway.main([
            "--replicas", "1", "--items", "4096", "--features", "8",
            "--users", "50", "--rates", "20", "--duration", "1",
            "--device", "cpu", "--sharded-publish", "8",
            "--regions", "2", "--mirror-records", "200",
            "--ann", "--ann-items", "8192", "--ann-cells", "16",
            "--ann-nprobe", "4", "--out", str(out)]) == 0
    finally:
        mp.undo()
    return json.loads(out.read_text())


@pytest.mark.parametrize("block", ["mirror", "ann"])
def test_regions_and_ann_write_their_blocks(probes_report, block):
    report = probes_report
    row = report["rows"][0]
    assert report[f"{block}_probe"] == row[block]
    if block == "mirror":
        assert report["regions"] == 2
        mir = row["mirror"]
        # every backlog record replayed once, at a measured speed
        assert mir["replayed"] == 200 and mir["dedup_skips"] == 0
        assert mir["catch_up_records_per_s"] > 0
        assert mir["steady_staleness_ms"] is not None
    else:
        ann = row["ann"]
        assert ann["items"] == 8192 and ann["cells"] == 16
        assert ann["certificate"]["routable"] is True
        assert ann["answers_match_exact"] is True
        # the headline only where the route chose ivf; the routed kind
        # and the cost table ride beside it either way
        assert ann["ivf_routed"] == (ann["route_chosen"] == "ivf")
        assert (ann["open_loop_sustained_qps"] is None) \
            == (not ann["ivf_routed"])
        assert ann["route_costs_exact_ms"]
        assert ann["small_cell"]["served"] is True
        assert ann["exact"]["ladder"] and ann["ladder"]


@pytest.mark.parametrize("argv,flag", [
    (["--write-heavy"], "--write-heavy"),
])
def test_deferred_flags_exit_2_by_name(argv, flag, capsys, tmp_path):
    out = tmp_path / "never.json"
    assert gateway.main([*argv, "--device", "cpu", "--out",
                         str(out)]) == 2
    assert flag in capsys.readouterr().err
    assert not out.exists()


def test_device_emulation_is_refused_on_the_card(monkeypatch):
    """The emulated device is a host-run option: without --device cpu
    the bench refuses it before spawning anything."""
    with pytest.raises(SystemExit) as e:
        gateway.main(["--device-ms-per-mrow", "5"])
    assert e.value.code == 2
