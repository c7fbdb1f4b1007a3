"""Install-time warmup (deploy/warmup.py), the kernel library cache
(common/compile_cache.py) and where ``ops/cuda_build`` builds, on the
CPU: the port's plan names what the reference's warmup names for the
same rungs, a warmup builds each needed source once and finds it
current the second time, a warmup without ``nvcc`` fails naming it,
the first cache configuration wins, and two processes building one
source into one directory each leave a whole library."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.deploy import warmup as jwarmup
from oryx_tpu_torch.common import compile_cache
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.deploy import warmup as twarmup
from oryx_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_cache(monkeypatch):
    """A process with no cache configured and the default build
    directory, restored afterwards."""
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(cuda_build, "_build_dir", cuda_build.BUILD_DIR)
    monkeypatch.setattr(cuda_build, "_libs", {})


def test_warmup_planned_capacity_matches_bulk_load():
    """The plan's capacity is the one a real bulk_load produces, as the
    reference's test holds for its store (tests/test_bench_tools.py)."""
    from oryx_tpu.app.als.feature_vectors import \
        planned_capacity as jplanned
    from oryx_tpu_torch.app.als.feature_vectors import (FeatureVectorStore,
                                                        planned_capacity)

    for n in (1, 16, 17, 40, 1000, 131072, 131073, 400000):
        store = FeatureVectorStore(8, device="cpu")
        store.bulk_load([f"i{j}" for j in range(n)],
                        np.zeros((n, 8), np.float32))
        assert len(store.row_ids()) == planned_capacity(n) == jplanned(n)
    n = 3000
    store = FeatureVectorStore(8, device="cpu")
    store.reserve(n)
    assert len(store.row_ids()) == planned_capacity(n)
    for j in range(n):
        store.set_vector(f"i{j}", np.ones(8, np.float32))
    assert len(store.row_ids()) == planned_capacity(n)  # no regrow


# The reference lane-pads a store to 128 columns, the port to 32: at 50
# features the reference folds (W 128, fold 2) and the port does not (W
# 64 holds no two 50-feature rows).  These entries are the reference's
# alone, and the only allowed difference.
_FOLD_ONLY = ("fold_items", "fold_items_i8", "fold_buckets",
              "pallas_fold", "pallas_i8_fold")


def _reference_names(features, items, sample_rate, ann=None):
    report = {"compiled": [], "failed": []}
    orig = jwarmup._compile
    jwarmup._compile = lambda rep, name, fn, *a, **k: \
        rep["compiled"].append({"kernel": name})
    try:
        jwarmup.warm_serving_shapes(features, items, "float32",
                                    sample_rate, report, ann=ann)
    finally:
        jwarmup._compile = orig
    return {e["kernel"] for e in report["compiled"] + report["failed"]}


@pytest.mark.parametrize("sample_rate", [1.0, 0.3])
@pytest.mark.parametrize("items", [2000, 1_000_000, 5_000_000, 20_000_000])
@pytest.mark.parametrize("features", [10, 50, 250, 300])
def test_plan_names_match_reference(features, items, sample_rate):
    """Nothing compiles on either side: the reference's ``_compile`` only
    records names, and the port's plan builds nothing."""
    ref = _reference_names(features, items, sample_rate)
    plan = twarmup.plan_serving_shapes(features, items, "float32",
                                       sample_rate)
    port = ({n for n, _ in plan["kernels"]}
            | {e["kernel"] for e in plan["failed"]} | set(plan["plain"]))
    assert port <= ref
    missing = ref - port
    assert all(n.split(": ")[1].split(" ")[0] in _FOLD_ONLY
               for n in missing), sorted(missing)
    assert bool(missing) == (features == 50 and items > 2000)
    # a kind of a hand-written kernel is built or refused by width, and
    # the plain work never goes under the kernels
    kinds = {n.split(": ")[1].split(" ")[0] for n, _ in plan["kernels"]}
    assert kinds <= {"pallas", "pallas_i8", "pallas_fold", "pallas_i8_fold"}
    assert not any(n.split(": ")[1].startswith("pallas")
                   for n in plan["plain"])
    if features == 300 and items > 2000:
        # phase_a and phase_a_i8 take rows of at most 256 columns
        assert plan["failed"] and not plan["kernels"]
        assert all("W <= 256" in e["error"] or "F <= 256" in e["error"]
                   for e in plan["failed"])
    else:
        assert not plan["failed"]


def test_plan_ivf_ladder_matches_reference():
    from oryx_tpu.app.als.ivf import AnnConfig as JAnn
    from oryx_tpu_torch.app.als.ivf import AnnConfig as TAnn
    settings = {"oryx.als.ann.enabled": True}
    ref = _reference_names(50, 5_000_000, 1.0,
                           JAnn.from_config(jconfig.from_dict(settings)))
    plan = twarmup.plan_serving_shapes(50, 5_000_000, "float32", 1.0,
                                       ann=TAnn.from_config(
                                           from_dict(settings)))
    ivf = {n for n in plan["plain"] if ": ivf " in n}
    assert ivf and ivf == {n for n in ref if ": ivf " in n}


def _fake_build(calls):
    """``cuda_build.build`` as a fake that writes each missing library."""
    def build(sources):
        outs = [cuda_build.library_path(s) for s in sources]
        for out in outs:
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_bytes(b"library")
                calls.append(out.name)
        return outs
    return build


def test_run_warmup_builds_once_then_finds_current(tmp_path, monkeypatch,
                                                   fresh_cache):
    calls, loads = [], []
    monkeypatch.setattr(cuda_build, "build", _fake_build(calls))
    for mod in set(twarmup._KIND_MODULES.values()) | {twarmup._pa_qm}:
        monkeypatch.setattr(mod, "build",
                            lambda m=mod: loads.append(m.__name__))
    cache = tmp_path / "cache"
    config = from_dict({"oryx.compile-cache-dir": str(cache)})
    reports = [twarmup.run_warmup(config, [1_000_000, 20_000_000],
                                  [10, 50, 250], ["float32"], device="cpu")
               for _ in range(2)]
    first, second = reports
    assert first["metric"] == "aot_warmup"
    assert first["cache_dir"] == str(cache)
    assert first["compiled_count"] == len(first["compiled"]) > 0
    assert first["failed_count"] == 0 and first["plain"]
    assert first["device"] == "cpu" and "torch_version" in first
    # one build per source, each source loaded through its wrapper
    assert sorted(calls) == sorted(cuda_build.library_path(s).name
                                   for s in cuda_build.SOURCES)
    assert len(loads) == 2 * len(cuda_build.SOURCES)
    assert {e["status"] for e in first["compiled"]} == {"built"}
    assert {e["status"] for e in second["compiled"]} == {"found current"}
    assert [e["kernel"] for e in second["compiled"]] == \
        [e["kernel"] for e in first["compiled"]]
    assert sorted(os.listdir(cache / "kernels")) == sorted(calls)
    assert cuda_build.build_dir() == cache / "kernels"


def test_warmup_cli_without_nvcc_fails_naming_it(tmp_path):
    conf = tmp_path / "w.conf"
    conf.write_text(f'oryx.compile-cache-dir = "{tmp_path / "cache"}"\n')
    env = dict(os.environ, PYTHONPATH=REPO, PATH=os.path.dirname(
        sys.executable), CUDA_HOME=str(tmp_path / "no-cuda"))
    proc = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch", "warmup", "--conf",
         str(conf), "--device", "cpu", "--items", "1", "--features", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "nvcc" in proc.stderr
    assert not proc.stdout.strip()  # no report of a warm that did not run


def test_compile_cache_first_configuration_wins(tmp_path, fresh_cache,
                                               caplog):
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    assert compile_cache.enable_from_config(
        from_dict({"oryx.compile-cache-dir": first})) == first
    assert cuda_build.build_dir() == Path(first) / "kernels"
    assert compile_cache.enable_from_config(
        from_dict({"oryx.compile-cache-dir": second})) == first
    assert cuda_build.build_dir() == Path(first) / "kernels"
    assert "ignoring" in caplog.text and second in caplog.text
    # the key reads, and has no effect
    from_dict({"oryx.compile-cache-min-compile-secs": 9.0}).get_double(
        "oryx.compile-cache-min-compile-secs")


def test_compile_cache_null_disables(fresh_cache):
    assert compile_cache.enable_from_config(
        from_dict({"oryx.compile-cache-dir": None})) is None
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


def test_set_build_dir_keeps_loaded_libraries(tmp_path, fresh_cache,
                                              caplog):
    loaded = object()
    cuda_build._libs[cuda_build.SOURCES[0]] = loaded
    cuda_build.set_build_dir(tmp_path)
    assert cuda_build.load(cuda_build.SOURCES[0]) is loaded
    assert cuda_build.library_path(cuda_build.SOURCES[1]).parent == tmp_path
    assert "stay loaded" in caplog.text


@pytest.mark.parametrize("layer", ["serving", "batch", "speed"])
def test_layer_start_sets_the_build_dir(tmp_path, fresh_cache, layer):
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
    uri = f"memory://warmup-{layer}"
    cfg = from_dict({
        "oryx.compile-cache-dir": str(tmp_path / "cc"),
        "oryx.input-topic.broker": uri, "oryx.update-topic.broker": uri,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.batch.update-class": "oryx_tpu_torch.app.als.update.ALSUpdate",
        "oryx.speed.model-manager-class":
            "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager",
        "oryx.batch.streaming.generation-interval-sec": 3600,
        "oryx.speed.streaming.generation-interval-sec": 3600})
    cls = {"serving": ServingLayer, "batch": BatchLayer,
           "speed": SpeedLayer}[layer]
    obj = cls(cfg, port=0, device="cpu") if layer == "serving" \
        else cls(cfg, device="cpu")
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR
    obj.start()
    try:
        assert cuda_build.build_dir() == tmp_path / "cc" / "kernels"
    finally:
        obj.close()


_BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from oryx_tpu_torch.ops import cuda_build
    cuda_build.set_build_dir(sys.argv[1])
    out = cuda_build.build([cuda_build.SOURCES[0]])[0]
    print(out, cuda_build.NVCC_RUNS)
""")

_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(out, "wb") as f:
        f.write(b"half")
        f.flush()
        time.sleep(1.0)
        f.write(b" and whole")
""")


def test_two_processes_build_one_source_into_one_directory(tmp_path):
    """Both builds run nvcc at once; each writes a file of its own and
    renames it into place, so the library is whole and no partial file
    is left."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    out_dir = tmp_path / "kernels"
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT,
                               str(out_dir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0][0] == outs[1][0]
    assert [o[1] for o in outs] == ["1", "1"]  # each ran its own nvcc
    assert os.listdir(out_dir) == [Path(outs[0][0]).name]
    assert Path(outs[0][0]).read_bytes() == b"half and whole"
