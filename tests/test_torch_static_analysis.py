"""oryx-lint over the port: ``oryx_tpu_torch.analysis`` runs its six
passes clean over ``oryx_tpu_torch/``, its own suppression ledger is
justified and live, the walk still sees the idioms each pass depends
on, and on the seeded-defect fixtures it reports exactly what the JAX
package's ``oryx_tpu.analysis`` reports (and the golden ``--json``
report).  The reference's passes are imported for that comparison
only; ``run_passes`` needs no TOML reader.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import pytest

from oryx_tpu.analysis import SourceModel as RefSourceModel
from oryx_tpu.analysis import run_passes as ref_run_passes
from oryx_tpu_torch.analysis import (PASS_NAMES, SourceModel,
                                     apply_suppressions, load_suppressions,
                                     run_passes)
from oryx_tpu_torch.analysis import async_blocking
from oryx_tpu_torch.analysis import drift as drift_pass
from oryx_tpu_torch.analysis import lock_order
from oryx_tpu_torch.analysis.__main__ import main as analysis_main

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "oryx_tpu_torch"
LEDGER = PKG / "analysis" / "suppressions.toml"
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
SEAM = "oryx_tpu_torch.resilience.faults.fire"


# -- the port's package -------------------------------------------------------

@pytest.fixture(scope="module")
def package_report():
    """One timed full run over oryx_tpu_torch/, shared by every check.
    The run is timed in this process's CPU seconds: the run is
    single-threaded, and under a loaded parallel test run the wall clock
    reads two to three times the run's own cost."""
    t0 = time.process_time()
    model = SourceModel(PKG, conf_path=PKG / "common" / "reference.conf",
                        doc_path=REPO / "docs" / "RESILIENCE.md")
    findings = run_passes(model)
    suppressions = load_suppressions(LEDGER)
    apply_suppressions(findings, suppressions)
    elapsed = time.process_time() - t0
    return model, findings, suppressions, elapsed


@pytest.mark.parametrize("pass_name", PASS_NAMES)
def test_package_runs_clean(package_report, pass_name):
    _, findings, _, _ = package_report
    open_findings = [
        f"{f.file}:{f.line} [{f.rule}] {f.symbol}: {f.message}"
        for f in findings
        if f.pass_name == pass_name and not f.suppressed]
    assert not open_findings, (
        f"{pass_name} findings outside the suppression ledger "
        f"(fix the code, annotate, or add a justified ledger "
        f"entry):\n  " + "\n  ".join(open_findings))


def test_ledger_entries_justified_and_live(package_report):
    _, _, suppressions, _ = package_report
    # the reference's three entries, at the port's paths and symbols
    assert sorted((s.pass_name, s.file, s.symbol) for s in suppressions) \
        == [("async-blocking", "oryx_tpu_torch/cluster/async_http.py", SEAM),
            ("sim-clock", "oryx_tpu_torch/cluster/async_http.py",
             "self._started.wait"),
            ("sim-clock", "oryx_tpu_torch/cluster/autoscaler.py",
             "self._proc.wait")]
    for s in suppressions:
        assert s.justification and len(s.justification.strip()) >= 15, \
            f"suppression {s.pass_name}/{s.symbol}: justification " \
            f"must be a real sentence, got {s.justification!r}"
        assert s.hits > 0, (
            f"stale suppression (matches no live finding): "
            f"pass={s.pass_name} file={s.file} symbol={s.symbol}")


def test_run_time_budget(package_report):
    model, _, _, elapsed = package_report
    assert len(model.modules) > 100, "package walk collapsed"
    assert elapsed < 10.0, (
        f"full-package analysis took {elapsed:.1f} CPU s — past the 10 s "
        f"tier-1 budget; profile the passes before adding more")


# -- walk pins on the port (a lint is only as good as its walk) --------------

def test_walk_sees_known_config_reads(package_report):
    model, _, _, _ = package_report
    reads = drift_pass._KeyReads()
    for mod in model.modules:
        drift_pass._collect_key_reads(mod, reads)
    # a plain literal, an f-string-prefix key, a default-parameter
    # prefix key and a chained f-string key
    assert "oryx.cluster.heartbeat-ttl-ms" in reads.getter_reads
    assert "oryx.cluster.async.max-connections" in reads.getter_reads
    assert "oryx.resilience.retry.initial-backoff-ms" \
        in reads.getter_reads
    assert "oryx.cluster.region.mirror.poll-interval-ms" \
        in reads.getter_reads
    # the keys the walk lost before they were read as literals: the
    # RDF hyperparameters as literal arguments (a subtree read), the
    # TLS alias through the getter
    for key in ("oryx.rdf.hyperparams.max-split-candidates",
                "oryx.rdf.hyperparams.max-depth",
                "oryx.rdf.hyperparams.impurity"):
        assert key in reads.prefix_reads, key
    assert "oryx.serving.api.key-alias" in reads.getter_reads


def test_walk_sees_known_fault_points(package_report):
    model, _, _, _ = package_report
    points: dict = {}
    for mod in model.modules:
        drift_pass._collect_fire_points(mod, points)
    assert "wire-read" in points          # literal fire()
    assert "store-write" in points        # aliased import (_fault)
    assert "route-measure-lsh" in points  # # chaos-point: annotation
    assert all(file.startswith("oryx_tpu_torch/")
               for file, _ in points.values())


def test_walk_sees_known_lock_edges(package_report):
    model, _, _, _ = package_report
    edges = lock_order.build_graph(model)
    names = {(a.display(), b.display()) for a, b in edges}
    assert ("serving_model.ALSServingModel._route_lock",
            "serving_model.ALSServingModel._bucket_lock") in names
    assert len(edges) >= 3


def test_passes_track_the_ports_fault_seam():
    """The two dotted names of the seam are the port's: the reference's
    would match no call in this package, so the drift pass would call
    every documented point stale and the event-loop lint would stop
    seeing fault seams on the loop."""
    assert drift_pass.FIRE_FUNCTIONS == frozenset({SEAM})
    assert SEAM in async_blocking.DENY_CALLS
    assert not any(name.startswith("oryx_tpu.")
                   for name in async_blocking.DENY_CALLS)


# -- the seeded-defect fixtures, held against the reference ------------------

def _port_fixture_tree(tmp_path: pathlib.Path) -> pathlib.Path:
    """The fixture tree with its one fault-seam import pointing at the
    port's package (the passes resolve the seam by dotted name)."""
    root = tmp_path / FIXTURES.name
    shutil.copytree(FIXTURES, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    chaos = root / "chaos_points.py"
    text = chaos.read_text(encoding="utf-8")
    old = "from oryx_tpu.resilience.faults import fire as _fault"
    assert old in text
    chaos.write_text(text.replace(
        old, "from oryx_tpu_torch.resilience.faults import fire as _fault"),
        encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return _port_fixture_tree(tmp_path_factory.mktemp("lint"))


@pytest.fixture(scope="module")
def fixture_findings(fixture_root):
    model = SourceModel(fixture_root,
                        conf_path=fixture_root / "reference.conf",
                        doc_path=fixture_root / "RESILIENCE.md")
    return run_passes(model)


def _key(f: dict) -> tuple:
    norm = {k: str(v).replace("oryx_tpu_torch", "oryx_tpu")
            for k, v in f.items()}
    return (norm["pass"], norm["rule"], norm["file"], int(norm["line"]),
            norm["symbol"])


def test_fixture_findings_match_the_reference(fixture_findings):
    ref_model = RefSourceModel(FIXTURES,
                               conf_path=FIXTURES / "reference.conf",
                               doc_path=FIXTURES / "RESILIENCE.md")
    ref = [_key(f.to_dict()) for f in ref_run_passes(ref_model)]
    got = [_key(f.to_dict()) for f in fixture_findings]
    assert got == ref
    assert {k[0] for k in got} == set(PASS_NAMES)


def test_fixture_findings_match_golden(fixture_findings):
    golden = json.loads((FIXTURES / "golden.json").read_text(
        encoding="utf-8"))
    assert [_key(f.to_dict()) for f in fixture_findings] \
        == [_key(f) for f in golden["findings"]]


def _have(findings, pass_name, rule, symbol):
    return any(f.pass_name == pass_name and f.rule == rule
               and f.symbol == symbol for f in findings)


def test_fixture_guarded_by_fires(fixture_findings):
    assert _have(fixture_findings, "guarded-by", "unguarded-mutation",
                 "TopologyCache._entries")
    assert _have(fixture_findings, "guarded-by", "unguarded-mutation",
                 "TopologyCache._epoch")
    assert not any(f.symbol == "TopologyCache.loop_stats"
                   for f in fixture_findings)
    assert not any("_purge_locked" in f.message
                   for f in fixture_findings)


def test_fixture_async_blocking_fires(fixture_findings):
    mine = [f for f in fixture_findings
            if f.pass_name == "async-blocking"]
    assert {"time.sleep", "open", ".acquire", ".scatter"} \
        <= {f.symbol for f in mine}
    sleeps = [f for f in mine if f.symbol == "time.sleep"]
    assert len({f.line for f in sleeps}) == 2
    assert all(f.line < 40 for f in mine), \
        "the bridged/wrapped negative case was flagged"


def test_fixture_lock_order_fires(fixture_findings):
    cycles = {f.symbol for f in fixture_findings
              if f.pass_name == "lock-order"}
    assert ("lock_cycle.Registry._a -> lock_cycle.Registry._b -> "
            "lock_cycle.Registry._a") in cycles
    assert ("lock_cycle.SelfDeadlock._lock -> "
            "lock_cycle.SelfDeadlock._lock") in cycles
    assert ("lock_cycle.LOCK_L -> lock_cycle.LOCK_M -> "
            "lock_cycle.LOCK_L") in cycles
    assert not any("Ordered" in c for c in cycles)


def test_fixture_drift_fires(fixture_findings):
    assert _have(fixture_findings, "drift", "unknown-config-key",
                 "oryx.fixture.unknown-key")
    assert _have(fixture_findings, "drift", "dead-config-key",
                 "oryx.fixture.dead-key")
    assert _have(fixture_findings, "drift", "undocumented-fault-point",
                 "fixture-undocumented")
    assert _have(fixture_findings, "drift", "unregistered-fault-point",
                 "fixture-stale")
    quiet = {"oryx.fixture.compat-key", "oryx.fixture.tuning.depth",
             "oryx.fixture.subtree.inner", "fixture-annotated",
             "fixture-documented"}
    assert not quiet & {f.symbol for f in fixture_findings}


def test_fixture_diagnose_catalog_fires(fixture_findings):
    assert _have(fixture_findings, "diagnose-catalog",
                 "uncatalogued-metric", "fixture_renamed_away_counter")
    assert _have(fixture_findings, "diagnose-catalog",
                 "uncatalogued-flight-field", "fixture_ghost_field")
    quiet = {"fixture_catalogued_counter", "fixture_catalogued_gauge",
             "trigger_id"}
    assert not quiet & {f.symbol for f in fixture_findings
                        if f.pass_name == "diagnose-catalog"}


def test_fixture_sim_clock_fires(fixture_findings):
    mine = [f for f in fixture_findings if f.pass_name == "sim-clock"]
    assert _have(mine, "sim-clock", "direct-time", "time.monotonic")
    assert _have(mine, "sim-clock", "direct-time", "time.sleep")
    assert _have(mine, "sim-clock", "event-wait", "self._stop.wait")
    assert all(f.line < 30 for f in mine), \
        "a clock-seam/annotated negative case was flagged"


# -- the CLI ------------------------------------------------------------------

def _cli(capsys, *args):
    rc = analysis_main(list(args))
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _fixture_args(root):
    return ("--root", str(root), "--conf", str(root / "reference.conf"),
            "--doc", str(root / "RESILIENCE.md"))


def test_cli_golden_json(capsys, fixture_root):
    rc, out, _ = _cli(capsys, *_fixture_args(fixture_root), "--json",
                      "--no-suppressions")
    assert rc == 1  # findings -> non-zero, so it can gate CI
    got = json.loads(out)
    golden = json.loads((FIXTURES / "golden.json").read_text(
        encoding="utf-8"))
    assert sorted(got) == ["counts", "findings", "passes", "root",
                           "version"]
    assert got == golden


def test_cli_clean_package_exits_zero(capsys):
    rc, _, err = _cli(capsys)  # the defaults: the port, its conf, its ledger
    assert rc == 0
    assert ", 0 open;" in err


def test_cli_without_ledger_reports_only_the_ledgers_findings(capsys):
    rc, out, _ = _cli(capsys, "--json", "--no-suppressions")
    assert rc == 1
    got = json.loads(out)
    assert got["root"] == "oryx_tpu_torch"
    keys = {(f["pass"], f["file"], f["symbol"]) for f in got["findings"]}
    assert keys == {
        ("async-blocking", "oryx_tpu_torch/cluster/async_http.py", SEAM),
        ("sim-clock", "oryx_tpu_torch/cluster/async_http.py",
         "self._started.wait"),
        ("sim-clock", "oryx_tpu_torch/cluster/autoscaler.py",
         "self._proc.wait")}
    assert got["counts"] == {"total": len(got["findings"]),
                             "suppressed": 0,
                             "open": len(got["findings"])}


def test_cli_single_pass_selection(capsys, fixture_root):
    rc, out, _ = _cli(capsys, *_fixture_args(fixture_root), "--json",
                      "--no-suppressions", "--pass", "lock-order")
    assert rc == 1
    got = json.loads(out)
    assert got["passes"] == ["lock-order"]
    assert {f["pass"] for f in got["findings"]} == {"lock-order"}


def test_cli_usage_errors_exit_two(capsys, tmp_path):
    rc, _, err = _cli(capsys, "--root", str(tmp_path / "missing"))
    assert rc == 2 and "not a directory" in err
    with pytest.raises(SystemExit) as e:
        analysis_main(["--pass", "no-such-pass"])
    assert e.value.code == 2
    assert "python -m oryx_tpu_torch.analysis" in capsys.readouterr().err
