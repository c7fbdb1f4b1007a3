"""The port's gateway bench (``oryx_tpu_torch/bench/gateway.py``) at toy
size on the CPU — replicas 1 and 2 over 4,096 items x 8 features, 1 s
rungs, with the reference's fast path (asyncio front end, frames, the
result cache) and its Zipf and coalescing rungs — writes every key of
the reference's artifact, rows and report alike; the three options
that wait for a later part of the package exit 2 naming their flag."""

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


@pytest.mark.parametrize("argv,flag", [
    (["--regions", "2"], "--regions"),
    (["--write-heavy"], "--write-heavy"),
    (["--ann"], "--ann"),
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
