"""The port's batch layer — ``ml/params.py``, ``ml/mlupdate.py``,
``app/als/update.py`` (``ALSUpdate``), ``lambda_rt/data_store.py`` and
``lambda_rt/batch.py`` — against the reference's, on the CPU.

Exact: hyperparameter combinations under one seed, PMML extensions,
the slice manifest's shape and slice membership, generation files, and
the vectors a manager loads from a generation of either package (both
parse the same JSON).  Factors trained by the two packages agree within
rtol 1e-3, atol 1e-5 after 3 sweeps (float32 roundoff compounding over
the sweeps)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from oryx_tpu.app.als.serving_manager import \
    ALSServingModelManager as JServingManager
from oryx_tpu.app.als.speed import ALSSpeedModelManager as JSpeedManager
from oryx_tpu.app.als.update import ALSUpdate as JALSUpdate
from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.kafka.inproc import InProcTopicProducer as JProducer
from oryx_tpu.kafka.inproc import resolve_broker as jresolve_broker
from oryx_tpu.lambda_rt import data_store as jdata_store
from oryx_tpu.ml import params as jhp
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als.serving_manager import ALSServingModelManager
from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.app.als.update import ALSUpdate, load_features, \
    save_features
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.kafka.api import KeyMessage
from oryx_tpu_torch.kafka.inproc import InProcTopicProducer, get_broker, \
    resolve_broker
from oryx_tpu_torch.lambda_rt import data_store
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.ml import params as hp
from oryx_tpu_torch.ml.mlupdate import MODEL_FILE_NAME, MLUpdate
from oryx_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def _seeded_and_clear():
    TorchRandomManager.use_test_seed()
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


# -- hyperparameters ----------------------------------------------------------

@pytest.mark.parametrize("overlay,how_many", [
    ({"a": [2, 8], "b": [0.1, 0.9], "c": ["x", "y", "z"]}, 5),
    ({"a": [2, 8], "b": [0.1, 0.9], "c": ["x", "y", "z"]}, 100),
    ({"a": 5, "b": 1.5, "c": "gini"}, 1),
    ({"a": [1, 3, 9, 27], "b": [0.001, 0.01], "c": [10, 20]}, 7),
])
def test_combos_match_the_reference_under_one_seed(overlay, how_many):
    from oryx_tpu.common.rand import RandomManager as JaxRandomManager
    JaxRandomManager.use_test_seed()
    keys = [f"p.{k}" for k in overlay]
    cfg = from_dict({f"p.{k}": v for k, v in overlay.items()})
    jcfg = jfrom_dict({f"p.{k}": v for k, v in overlay.items()})
    ranges = [hp.from_config(cfg, k) for k in keys]
    jranges = [jhp.from_config(jcfg, k) for k in keys]
    per = hp.choose_values_per_hyperparam(len(ranges), how_many)
    assert per == jhp.choose_values_per_hyperparam(len(jranges), how_many)
    for r, j in zip(ranges, jranges):
        for n in (1, 2, 3, 5):
            assert r.get_trial_values(n) == j.get_trial_values(n)
    got = hp.choose_hyper_parameter_combos(ranges, how_many, per)
    want = jhp.choose_hyper_parameter_combos(jranges, how_many, per)
    assert got == want


def test_around_and_errors_match_the_reference():
    for lo, hi in ((3, 1), (2.0, 1.0)):
        with pytest.raises(ValueError):
            hp.range_values(lo, hi)
    assert hp.around(10, 2).get_trial_values(3) == \
        jhp.around(10, 2).get_trial_values(3)
    assert hp.around(0.5, 0.1).get_trial_values(4) == \
        jhp.around(0.5, 0.1).get_trial_values(4)
    assert hp.choose_hyper_parameter_combos([], 3, 0) == [[]]
    with pytest.raises(ValueError):
        hp.choose_hyper_parameter_combos([hp.fixed(1)], 0, 1)


# -- the MLUpdate loop --------------------------------------------------------

class MockMLUpdate(MLUpdate):
    """The reference's test double (``tests/test_ml.py``): a dummy PMML
    whose evaluation the test sets."""

    evals: list[float] = []
    train_counts: list[int] = []
    test_counts: list[int] = []
    calls = 0

    def get_hyper_parameter_values(self):
        return []

    def build_model(self, train_data, hyper_parameters, candidate_path):
        MockMLUpdate.train_counts.append(len(train_data))
        doc = pmml_io.build_skeleton_pmml()
        pmml_io.add_extension(doc, "mock", "yes")
        return doc

    def evaluate(self, model, candidate_path, test_data, train_data):
        MockMLUpdate.test_counts.append(len(test_data))
        i = MockMLUpdate.calls
        MockMLUpdate.calls += 1
        return MockMLUpdate.evals[i % len(MockMLUpdate.evals)]


def _run_mock(evals, overlay, tmp_path, n=60):
    MockMLUpdate.evals = evals
    MockMLUpdate.train_counts, MockMLUpdate.test_counts = [], []
    MockMLUpdate.calls = 0
    name = f"tml-{time.monotonic_ns()}"
    update = MockMLUpdate(from_dict(overlay))
    producer = InProcTopicProducer(f"memory://{name}", "T")
    model_dir = str(tmp_path / "model")
    update.run_update(0, [KeyMessage(None, f"line{i}") for i in range(n)],
                      [], model_dir, producer)
    return model_dir, list(get_broker(name).consume(
        "T", from_beginning=True, max_idle_sec=0.1))


@pytest.mark.parametrize("case", ["publish", "threshold", "best",
                                  "best-parallel", "no-eval", "model-ref",
                                  "inf-eval"])
def test_mlupdate_loop(tmp_path, case):
    """The reference's MLUpdate behaviours (``tests/test_ml.py`` and the
    +Inf refusal of ``tests/test_numerics.py``)."""
    if case == "publish":
        model_dir, msgs = _run_mock([0.5], {}, tmp_path, n=100)
        assert [m.key for m in msgs] == ["MODEL"]
        doc = pmml_io.from_string(msgs[0].message)
        assert pmml_io.get_extension_value(doc, "mock") == "yes"
        entries = os.listdir(model_dir)
        assert len(entries) == 1 and entries[0].isdigit()
        assert MODEL_FILE_NAME in os.listdir(
            os.path.join(model_dir, entries[0]))
        assert sum(MockMLUpdate.train_counts + MockMLUpdate.test_counts) \
            == 100
        assert 1 <= MockMLUpdate.test_counts[0] <= 30
    elif case == "threshold":
        model_dir, msgs = _run_mock([0.1], {"oryx.ml.eval.threshold": 0.9},
                                    tmp_path)
        assert msgs == [] and os.listdir(model_dir) == []
    elif case in ("best", "best-parallel"):
        _, msgs = _run_mock([0.1, 0.9, 0.3], {
            "oryx.ml.eval.candidates": 3,
            "oryx.ml.eval.parallelism": 1 if case == "best" else 3},
            tmp_path)
        assert [m.key for m in msgs] == ["MODEL"]
        assert MockMLUpdate.calls == 3
    elif case == "no-eval":
        _, msgs = _run_mock([float("nan")],
                            {"oryx.ml.eval.test-fraction": 0.0}, tmp_path)
        assert len(msgs) == 1 and MockMLUpdate.test_counts == []
    elif case == "model-ref":
        _, msgs = _run_mock([0.5], {"oryx.update-topic.message.max-size": 10},
                            tmp_path)
        assert [m.key for m in msgs] == ["MODEL-REF"]
        assert os.path.exists(msgs[0].message)
    else:
        _, msgs = _run_mock([float("inf"), 0.4], {
            "oryx.ml.eval.candidates": 2, "oryx.ml.eval.parallelism": 1},
            tmp_path)
        assert len(msgs) == 1  # the finite candidate won


def test_mlupdate_profile_dir_writes_a_torch_trace(tmp_path):
    MockMLUpdate.evals = [0.5]
    update = MockMLUpdate(from_dict(
        {"oryx.ml.profile-dir": str(tmp_path / "traces")}))
    update.run_update(1234, [KeyMessage(None, f"l{i}") for i in range(20)],
                      [], str(tmp_path / "model"), None)
    assert os.listdir(tmp_path / "traces") == ["1234"]
    trace = tmp_path / "traces" / "1234" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]


# -- ALSUpdate ----------------------------------------------------------------

def _als_overlay(**extra):
    overlay = {
        "oryx.als.iterations": 3,
        "oryx.als.implicit": True,
        "oryx.als.hyperparams.features": 4,
        "oryx.als.hyperparams.lambda": 0.01,
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.update-topic.message.max-size": 128,
        "oryx.als.publish.slices": 4,
    }
    overlay.update(extra)
    return overlay


def _lines(n=400, nu=30, ni=20, seed=4, deletes=True):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    out = []
    for j in range(n):
        u, i = rng.integers(0, nu), rng.integers(0, ni)
        value = "" if deletes and j % 37 == 5 else f"{rng.exponential(1):.3f}"
        out.append(f"u{u},i{i},{value},{t + j * 1000}")
    return out


def _generation(pkg: str, lines, tmp_path, broker_uri: str, overlay):
    """One ALSUpdate generation of package ``pkg`` onto ``broker_uri``'s
    topic "Up"; returns the model dir."""
    model_dir = str(tmp_path / f"model-{pkg}")
    if pkg == "torch":
        update = ALSUpdate(from_dict(overlay), device="cpu")
        producer = InProcTopicProducer(broker_uri, "Up")
        data = [KeyMessage(None, m) for m in lines]
    else:
        update = JALSUpdate(jfrom_dict(overlay))
        producer = JProducer(broker_uri, "Up")
        data = [JKeyMessage(None, m) for m in lines]
    update.run_update(0, data, [], model_dir, producer)
    return model_dir


def _generation_dir(model_dir: str) -> str:
    (gen,) = [d for d in os.listdir(model_dir) if d.isdigit()]
    return os.path.join(model_dir, gen)


def test_als_update_writes_the_reference_pmml_and_manifest(tmp_path):
    from oryx_tpu.common.rand import RandomManager as JaxRandomManager
    JaxRandomManager.use_test_seed()
    lines = _lines()
    overlay = _als_overlay()
    t_dir = _generation_dir(_generation("torch", lines, tmp_path,
                                        f"file://{tmp_path}/b1", overlay))
    j_dir = _generation_dir(_generation("jax", lines, tmp_path,
                                        f"file://{tmp_path}/b2", overlay))
    t_doc = pmml_io.read(os.path.join(t_dir, MODEL_FILE_NAME))
    j_doc = pmml_io.read(os.path.join(j_dir, MODEL_FILE_NAME))
    for name in ("X", "Y", "features", "lambda", "implicit", "alpha",
                 "logStrength", "epsilon", "rescue"):
        assert pmml_io.get_extension_value(t_doc, name) == \
            pmml_io.get_extension_value(j_doc, name), name
    for name in ("XIDs", "YIDs"):
        assert pmml_io.get_extension_content(t_doc, name) == \
            pmml_io.get_extension_content(j_doc, name)
    with open(os.path.join(t_dir, "manifest.json")) as f:
        t_man = json.load(f)
    with open(os.path.join(j_dir, "manifest.json")) as f:
        j_man = json.load(f)
    for key in ("version", "ring", "features", "items", "users"):
        assert t_man[key] == j_man[key]
    assert [(e["slice"], e["path"], e["rows"]) for e in t_man["slices"]] == \
        [(e["slice"], e["path"], e["rows"]) for e in j_man["slices"]]
    assert t_man["x"]["rows"] == j_man["x"]["rows"]
    assert t_man["x"]["known_items"] is j_man["x"]["known_items"] is True
    for side in ("X", "Y"):
        t_ids, t_m = load_features(os.path.join(t_dir, side))
        j_ids, j_m = load_features(os.path.join(j_dir, side))
        assert t_ids == j_ids
        np.testing.assert_allclose(t_m, j_m, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("eval_disabled", [False, True])
def test_nonfinite_factors_are_never_published(tmp_path, eval_disabled):
    """Mirrors ``tests/test_numerics.py``: a candidate whose written
    factor artifact carries NaN or Inf is refused, even as the only
    candidate and with evaluation disabled."""
    class PoisonedALSUpdate(ALSUpdate):
        def build_model(self, train_data, hyper_parameters, candidate_path):
            doc = super().build_model(train_data, hyper_parameters,
                                      candidate_path)
            save_features(os.path.join(candidate_path, "Y"),
                          [f"i{i}" for i in range(3)],
                          np.full((3, 3), np.inf if eval_disabled else np.nan,
                                  dtype=np.float32))
            return doc

    overlay = {"oryx.als.implicit": False, "oryx.als.iterations": 2,
               "oryx.als.hyperparams.features": 3,
               "oryx.als.hyperparams.lambda": 0.1,
               "oryx.ml.eval.test-fraction": 0.0 if eval_disabled else 0.1}
    update = PoisonedALSUpdate(from_dict(overlay), device="cpu")
    name = f"tgate-{time.monotonic_ns()}"
    model_dir = str(tmp_path / "model")
    update.run_update(0, [KeyMessage(None, m) for m in _lines(300)], [],
                      model_dir, InProcTopicProducer(f"memory://{name}", "T"))
    assert list(get_broker(name).consume("T", from_beginning=True,
                                         max_idle_sec=0.1)) == []
    assert [d for d in os.listdir(model_dir) if d.isdigit()] == []


def test_als_update_time_split_and_evaluation(tmp_path):
    """The time-based split of the reference, and an implicit candidate
    evaluated by AUC on the held-out tail."""
    update = ALSUpdate(from_dict({"oryx.ml.eval.test-fraction": 0.25}),
                       device="cpu")
    data = [KeyMessage(None, f"u,i,1,{1000 + i}") for i in range(100)]
    train, test = update.split_new_data_to_train_test(data)
    assert len(test) == pytest.approx(25, abs=2)
    assert max(int(k.message.split(",")[3]) for k in train) < \
        min(int(k.message.split(",")[3]) for k in test)
    update = ALSUpdate(from_dict(_als_overlay(**{
        "oryx.ml.eval.test-fraction": 0.2})), device="cpu")
    update.run_update(0, [KeyMessage(None, m) for m in
                          _lines(2000, deletes=False)], [],
                      str(tmp_path / "m"), None)
    assert set(update.stage_s) >= {"parse", "train", "write", "evaluate",
                                   "validate"}


@pytest.mark.parametrize("key,value", [
    # the IVF publish is supported now; its configuration is validated at
    # boot
    ("oryx.als.ann.cells", 1),
    ("oryx.batch.streaming.master", "mesh"),
    ("oryx.distributed.coordinator-address", "localhost:1234"),
])
def test_deferred_update_keys_raise(key, value):
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ALSUpdate(from_dict({key: value}), device="cpu")


# -- the data store -----------------------------------------------------------

def test_data_store_ttl_and_cross_package_files(tmp_path):
    """Mirrors ``tests/test_lambda_it.py::test_data_store_ttl``; each
    package reads the other's generation files and offset headers."""
    old_ts = int(time.time() * 1000) - 10 * 3_600_000
    new_ts = int(time.time() * 1000)
    data_store.save_generation(str(tmp_path), old_ts, [KeyMessage(None, "a")])
    data_store.save_generation(str(tmp_path), new_ts, [KeyMessage(None, "b")],
                               end_offsets={"In": [1, 2]})
    assert len(data_store.read_all_data(str(tmp_path))) == 2
    assert [k.message for k in jdata_store.read_all_data(str(tmp_path))] == \
        ["a", "b"]
    assert jdata_store.last_saved_offsets(str(tmp_path)) == {"In": [1, 2]}
    assert data_store.delete_old_data(str(tmp_path), 5) == 1
    assert [k.message for k in data_store.read_all_data(str(tmp_path))] == \
        ["b"]
    assert data_store.delete_old_data(str(tmp_path), -1) == 0
    assert data_store.save_generation(str(tmp_path), new_ts + 1, []) is None
    jdata_store.save_generation(str(tmp_path), new_ts + 2,
                                [JKeyMessage("k", "c")],
                                end_offsets={"In": [3, 4]})
    assert data_store.last_saved_offsets(str(tmp_path)) == {"In": [3, 4]}
    assert [(k.key, k.message) for k in
            data_store.read_all_data(str(tmp_path))] == [(None, "b"),
                                                          ("k", "c")]
    os.makedirs(tmp_path / "models" / "1000")
    os.makedirs(tmp_path / "models" / str(new_ts))
    assert data_store.delete_old_models(str(tmp_path / "models"), 1) == 1
    assert os.listdir(tmp_path / "models") == [str(new_ts)]


# -- a generation of either package loads in the other's managers -------------

def _consume_all(broker, managers):
    for m in broker.consume("Up", from_beginning=True, max_idle_sec=0.2):
        for mgr in managers:
            mgr.consume_key_message(m.key, m.message)


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("max_size", [128, 1 << 24])
def test_a_generation_loads_in_both_packages(tmp_path, writer, max_size):
    """The PMML, the X/Y artifacts, the slice manifest (MODEL-REF) or the
    UP stream (inline MODEL) written by either package's ALSUpdate load
    into both packages' serving and speed managers alike."""
    uri = f"file://{tmp_path}/broker"
    _generation(writer, _lines(), tmp_path, uri,
                _als_overlay(**{"oryx.update-topic.message.max-size":
                                max_size}))
    keys = [m.key for m in resolve_broker(uri).consume(
        "Up", from_beginning=True, max_idle_sec=0.2)]
    assert keys[0] == ("MODEL-REF" if max_size == 128 else "MODEL")
    t_serving = ALSServingModelManager(from_dict({}), device="cpu")
    t_speed = ALSSpeedModelManager(from_dict({}), device="cpu")
    _consume_all(resolve_broker(uri), [t_serving, t_speed])
    j_serving = JServingManager(jfrom_dict({}))
    j_speed = JSpeedManager(jfrom_dict({}))
    _consume_all(jresolve_broker(uri), [j_serving, j_speed])
    t_model, j_model = t_serving.get_model(), j_serving.get_model()
    assert t_model.get_fraction_loaded() == 1.0
    assert t_speed.model.get_fraction_loaded() == 1.0
    assert sorted(t_model.all_user_ids()) == sorted(j_model.all_user_ids())
    assert sorted(t_model.all_item_ids()) == sorted(j_model.all_item_ids())
    for uid in j_model.all_user_ids():
        want = np.asarray(j_model.get_user_vector(uid))
        assert np.array_equal(t_model.get_user_vector(uid), want)
        assert np.array_equal(t_speed.model.get_user_vector(uid), want)
        assert np.array_equal(np.asarray(j_speed.model.get_user_vector(uid)),
                              want)
        assert t_model.get_known_items(uid) == j_model.get_known_items(uid)
    for iid in j_model.all_item_ids():
        want = np.asarray(j_model.get_item_vector(iid))
        assert np.array_equal(t_model.get_item_vector(iid), want)
        assert np.array_equal(t_speed.model.get_item_vector(iid), want)
    if max_size == 128:
        assert t_serving.slice_loads == t_speed.slice_loads == 4
        assert t_serving.slice_load_fallbacks == 0


# -- the layer ----------------------------------------------------------------

def _layer_config(tmp_path, broker_uri, **extra):
    overlay = {
        "oryx.id": "it",
        "oryx.input-topic.broker": broker_uri,
        "oryx.input-topic.partitions": 2,
        "oryx.input-topic.message.topic": "In",
        "oryx.update-topic.broker": broker_uri,
        "oryx.update-topic.message.topic": "Up",
        "oryx.batch.update-class": "oryx_tpu_torch.app.als.update.ALSUpdate",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        **_als_overlay(),
    }
    overlay.update(extra)
    return from_dict(overlay)


def test_generation_commits_offsets_and_recovers_a_lost_commit(tmp_path):
    """A generation reads the input from the committed offsets, saves it
    and commits the ends; a crash between the save and the commit
    (``batch-crash-before-commit``) is completed at the next start, so
    no record is read twice."""
    uri = f"file://{tmp_path}/broker"
    cfg = _layer_config(tmp_path, uri)
    batch = BatchLayer(cfg, device="cpu")
    batch.start()
    batch.close()
    broker = resolve_broker(uri)
    assert broker.num_partitions("In") == 2
    producer = InProcTopicProducer(uri, "In")
    lines = _lines(deletes=False)
    for m in lines[:200]:
        producer.send(f"{m.split(',')[0]}", m)
    group = "OryxGroup-BatchLayer-it"
    batch.run_one_generation()
    assert broker.get_offsets(group, "In") == broker.latest_offsets("In")
    assert batch.last_generation_records == 200
    assert len(data_store.read_all_data(str(tmp_path / "data"))) == 200
    committed = broker.get_offsets(group, "In")
    for m in lines[200:]:
        producer.send(f"{m.split(',')[0]}", m)
    tfaults.inject("batch-crash-before-commit", mode="error", times=1)
    with pytest.raises(tfaults.InjectedFault):
        batch.run_one_generation()
    assert broker.get_offsets(group, "In") == committed
    assert len(data_store.read_all_data(str(tmp_path / "data"))) == 400
    again = BatchLayer(cfg, device="cpu")
    time.sleep(0.002)  # a later generation timestamp
    again.run_one_generation()
    assert again.last_generation_records == 0
    assert broker.get_offsets(group, "In") == broker.latest_offsets("In")
    assert len(data_store.read_all_data(str(tmp_path / "data"))) == 400
    msgs = list(broker.consume("Up", from_beginning=True, max_idle_sec=0.2))
    assert [m.key for m in msgs].count("MODEL-REF") == 3


def _side_door(port: int, path: str, method: str = "GET"):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("key,value", [
    ("oryx.obs.metrics-port", 0),
    ("oryx.obs.tracing.enabled", True),
    ("oryx.obs.events.dir", "events"),
    ("oryx.obs.flight.dir", "flight"),
])
def test_obs_batch_key_starts_its_feature(tmp_path, key, value):
    """Each observability key that used to be refused starts the layer:
    the side door's /metrics carries the freshness gauges, tracing
    answers /admin/traces there, the flight recorder /admin/flight and a
    dumped bundle.  The batch layer keeps no event log (nor does the
    reference's): with only ``events.dir`` the layer runs a generation
    and writes nothing there."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    door = {} if key in ("oryx.obs.metrics-port", "oryx.obs.events.dir") \
        else {"oryx.obs.metrics-port": 0}
    cfg = _layer_config(tmp_path, f"memory://tb-{time.monotonic_ns()}",
                        **{key: value, **door})
    batch = BatchLayer(cfg, device="cpu")
    batch.start()
    try:
        if key == "oryx.obs.events.dir":
            assert not batch.obs_server.enabled
            batch.run_one_generation()
            assert not os.path.exists(value)
            return
        port = batch.obs_server.port
        status, body = _side_door(port, "/metrics")
        assert status == 200
        out = json.loads(body)
        assert {"input_lag_records", "batch_generation_age_sec"} <= \
            set(out["freshness"])
        if key == "oryx.obs.tracing.enabled":
            status, body = _side_door(port, "/admin/traces")
            assert status == 200 and json.loads(body)["service"] == "batch"
        elif key == "oryx.obs.flight.dir":
            assert _side_door(port, "/admin/flight")[0] == 200
            status, body = _side_door(port, "/admin/flight/dump", "POST")
            dump = json.loads(body)
            assert status == 200 and dump["dumped"], dump
            assert os.path.exists(dump["path"])
        else:
            assert _side_door(port, "/admin/traces")[0] == 404
    finally:
        batch.close()


def test_batch_layer_raises_without_cuda(tmp_path, monkeypatch):
    cfg = _layer_config(tmp_path, f"memory://tb-{time.monotonic_ns()}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchLayer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALSUpdate(cfg)
