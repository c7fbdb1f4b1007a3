"""The port's RDF app (``oryx_tpu_torch/app/rdf/{update,speed,serving}``,
``serving/classreg``) against the reference's on the same inputs, the
port on the CPU:

- ``RDFUpdate.build_model`` writes the reference's PMML bytes and
  ``evaluate`` gives its accuracy (or -RMSE), the reference's random
  draws injected into the port's trainer;
- the speed manager's UP lines equal the reference's byte for byte for
  the same PMML; the serving manager applies UP as the reference's does;
- every classreg route of a ``ServingLayer`` started from
  ``oryx_tpu_torch/conf/rdf-example.conf`` answers as the reference's
  layer does on one ``file://`` broker, and ``/train`` leaves the same
  records in the same partitions of its input topic;
- the mesh keys are refused by name.
"""

from __future__ import annotations

import http.client
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from oryx_tpu.app.rdf import pmml as jrdf_pmml
from oryx_tpu.app.rdf.serving import RDFServingModelManager as JaxServing
from oryx_tpu.app.rdf.speed import RDFSpeedModelManager as JaxSpeed
from oryx_tpu.app.rdf.update import RDFUpdate as JaxUpdate
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml_io
from oryx_tpu.common.rand import RandomManager as JaxRandom
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.kafka.api import KeyMessage as JaxKeyMessage
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.app.rdf import trainer as ttrainer
from oryx_tpu_torch.app.rdf.serving import RDFServingModelManager
from oryx_tpu_torch.app.rdf.speed import RDFSpeedModelManager
from oryx_tpu_torch.app.rdf.update import RDFUpdate
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.common.rand import RandomManager as TorchRandom
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka.api import KEY_MODEL, KEY_UP, KeyMessage
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "oryx_tpu_torch", "conf", "rdf-example.conf")
SEED = 77
WAIT_S = 60.0
HTTP_TIMEOUT_S = 30.0
JAX_INPUT, TORCH_INPUT = "JaxRInput", "TorchRInput"


def _schema_entries():
    return {
        "oryx.input-schema.feature-names": ["a", "color", "label"],
        "oryx.input-schema.categorical-features": ["color", "label"],
        "oryx.input-schema.target-feature": "label",
    }


def _batch_entries(**extra):
    return {
        "oryx.ml.eval.test-fraction": 0.2,
        "oryx.ml.eval.candidates": 1,
        "oryx.ml.eval.parallelism": 1,
        "oryx.ml.eval.threshold": None,
        "oryx.update-topic.message.max-size": 1 << 24,
        "oryx.rdf.num-trees": 3,
        "oryx.rdf.hyperparams.max-split-candidates": 16,
        "oryx.rdf.hyperparams.max-depth": 4,
        "oryx.rdf.hyperparams.impurity": "gini",
        **_schema_entries(), **extra}


def _lines(n=400, seed=11):
    """tests/test_rdf_app.py's data."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        a = rng.uniform(-1, 1)
        color = rng.choice(["red", "green", "blue"])
        label = "yes" if (a >= 0.1 or color == "blue") else "no"
        lines.append(f"{a:.4f},{color},{label}")
    return lines


def _regression_lines(n=300, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.uniform(0, 4)
        out.append(f"{a:.4f},{1.0 if a < 2 else 5.0}")
    return out


@pytest.fixture
def reference_draws(monkeypatch):
    """Both packages train from seed SEED; the port draws the reference's
    bootstrap weights and feature uniforms (``jax.random``) from it."""
    for cls in (JaxRandom, TorchRandom):
        monkeypatch.setattr(cls, "random_seed", classmethod(lambda c: SEED))
    key = jax.random.PRNGKey(SEED)
    monkeypatch.setattr(
        ttrainer, "_bootstrap_weights", lambda gen, shape, device:
        torch.from_numpy(np.array(jax.random.poisson(key, 1.0, shape),
                                  np.float32)).to(device))
    monkeypatch.setattr(
        ttrainer, "_feature_uniforms", lambda gen, depth, shape, device:
        torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, depth + 1), shape))).to(device))


@pytest.mark.parametrize("regression", [False, True])
def test_update_builds_and_evaluates_as_the_reference(reference_draws,
                                                      regression):
    if regression:
        entries = _batch_entries(**{
            "oryx.rdf.hyperparams.max-split-candidates": 64,
            "oryx.rdf.hyperparams.max-depth": 3,
            "oryx.rdf.hyperparams.impurity": "variance",
            "oryx.input-schema.feature-names": ["a", "y"],
            "oryx.input-schema.categorical-features": [],
            "oryx.input-schema.numeric-features": ["a", "y"],
            "oryx.input-schema.target-feature": "y"})
        lines, hyper = _regression_lines(), [64, 3, "variance"]
    else:
        entries = _batch_entries()
        # an unlabeled line and a malformed one are dropped alike
        lines, hyper = _lines() + ["0.5,red,", "0.5,red"], [16, 4, "gini"]
    jupd = JaxUpdate(jconfig.from_dict(entries))
    tupd = RDFUpdate(tconfig.from_dict(entries), device="cpu")
    jdata = [JaxKeyMessage(None, ln) for ln in lines]
    tdata = [KeyMessage(None, ln) for ln in lines]
    jdoc = jupd.build_model(jdata, hyper, "unused")
    tdoc = tupd.build_model(tdata, hyper, "unused")
    assert pmml_io.to_string(tdoc) == jpmml_io.to_string(jdoc)
    # evaluation: unseen categorical values ride the default branches,
    # unseen targets are skipped
    test = ["0.9,purple,yes", "0.9,red,maybe"] + lines[:80] \
        if not regression else lines[:50]
    want = jupd.evaluate(jdoc, "unused",
                         [JaxKeyMessage(None, ln) for ln in test], jdata)
    got = tupd.evaluate(tdoc, "unused", [KeyMessage(None, ln) for ln in test],
                        tdata)
    assert got == pytest.approx(want, rel=1e-6)
    assert got > (0.9 if not regression else -0.5)


@pytest.fixture(scope="module")
def model_message():
    """A reference RDFUpdate's PMML on tests/test_rdf_app.py's data."""
    data = [JaxKeyMessage(None, ln) for ln in _lines()]
    doc = JaxUpdate(jconfig.from_dict(_batch_entries())).build_model(
        data, [16, 4, "gini"], "unused")
    return jpmml_io.to_string(doc)


def test_speed_manager_up_lines_match_reference(model_message):
    jmgr = JaxSpeed(jconfig.from_dict(_schema_entries()))
    tmgr = RDFSpeedModelManager(tconfig.from_dict(_schema_entries()),
                                device="cpu")
    for mgr in (jmgr, tmgr):
        mgr.consume_key_message(KEY_MODEL, model_message)
        mgr.consume_key_message(KEY_UP, '[0,"r",{"0":1}]')  # ignored
    rng = np.random.default_rng(5)
    colors, labels = ["red", "green", "blue", "pink"], ["yes", "no", ""]
    lines = [f"{rng.uniform(-1, 1):.3f},{rng.choice(colors)},"
             f"{rng.choice(labels)}" for _ in range(200)]
    want = list(jmgr.build_updates([JaxKeyMessage(None, ln) for ln in lines]))
    got = list(tmgr.build_updates([KeyMessage(None, ln) for ln in lines]))
    assert got == want and len(got) > 3
    assert list(tmgr.build_updates([])) == []
    with pytest.raises(ValueError):
        tmgr.consume_key_message("BOGUS", "x")


def test_speed_manager_regression_up_lines_match_reference():
    entries = {"oryx.input-schema.feature-names": ["a", "y"],
               "oryx.input-schema.numeric-features": ["a", "y"],
               "oryx.input-schema.target-feature": "y"}
    cfg = _batch_entries(**entries, **{
        "oryx.input-schema.categorical-features": []})
    doc = jpmml_io.to_string(JaxUpdate(jconfig.from_dict(cfg)).build_model(
        [JaxKeyMessage(None, ln) for ln in _regression_lines()],
        [64, 3, "variance"], "unused"))
    jmgr = JaxSpeed(jconfig.from_dict(entries))
    tmgr = RDFSpeedModelManager(tconfig.from_dict(entries), device="cpu")
    for mgr in (jmgr, tmgr):
        mgr.consume_key_message(KEY_MODEL, doc)
    lines = _regression_lines(60, seed=9)
    assert list(tmgr.build_updates([KeyMessage(None, ln) for ln in lines])) \
        == list(jmgr.build_updates([JaxKeyMessage(None, ln) for ln in lines]))


def test_serving_manager_applies_up_as_the_reference(model_message):
    entries = {**_schema_entries(), "oryx.serving.api.read-only": False}
    jmgr = JaxServing(jconfig.from_dict(entries))
    tmgr = RDFServingModelManager(tconfig.from_dict(entries), device="cpu")
    tmgr.consume_key_message(KEY_UP, '[0,"r",{"0":1}]')  # no model: skip
    assert tmgr.get_model() is None
    rows = [["0.9", "red", ""], ["-0.9", "green", ""], ["0.05", "blue", ""],
            ["0.2", "pink", ""], ["0.1", "red", "no"]]
    for mgr in (jmgr, tmgr):
        mgr.consume_key_message(KEY_MODEL, model_message)
    jm, tm = jmgr.get_model(), tmgr.get_model()
    assert tm.predict_bulk(rows) == jm.predict_bulk(rows) == \
        [tm.predict(r) for r in rows]
    # leaf updates: the bulk path's node tables are rebuilt after each
    enc_no = tm.encodings.encode(2, "no")
    for tree in range(3):
        leaf = tm.forest.trees[tree].find_terminal(tm._example(rows[0]))
        up = json.dumps([tree, leaf.id, {str(enc_no): 500}])
        for mgr in (jmgr, tmgr):
            mgr.consume_key_message(KEY_UP, up)
    assert tm.predict(rows[0]) == "no"
    assert tm.predict_bulk(rows) == jm.predict_bulk(rows) == \
        [tm.predict(r) for r in rows]
    for r in rows:
        np.testing.assert_array_equal(
            tm.make_prediction(r).category_probabilities,
            jm.make_prediction(r).category_probabilities)
    with pytest.raises(ValueError):
        tm.predict(["0.9", "red"])


# -- the routes, against the reference's layer --------------------------------

def _request(port, method, path, body=None, accept="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request(method, path, body=body, headers={"Accept": accept})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class Layers:
    """The reference's and the port's RDF layer on one broker."""

    def __init__(self, tmp_path):
        self.broker_dir = str(tmp_path / "broker")
        self.uri = f"file://{self.broker_dir}"
        schema = {"oryx.input-schema.feature-names": ["a", "color", "label"],
                  "oryx.input-schema.categorical-features":
                      ["color", "label"],
                  "oryx.input-schema.target-feature": "label"}
        tcfg = tconfig.overlay_on(
            {"oryx.update-topic.broker": self.uri,
             "oryx.input-topic.broker": self.uri,
             "oryx.input-topic.message.topic": TORCH_INPUT, **schema},
            tconfig.from_file(CONF))
        jcfg = jconfig.from_dict({
            "oryx.update-topic.broker": self.uri,
            "oryx.input-topic.broker": self.uri,
            "oryx.input-topic.message.topic": JAX_INPUT,
            "oryx.serving.model-manager-class":
                "oryx_tpu.app.rdf.serving.RDFServingModelManager",
            "oryx.serving.application-resources": "oryx_tpu.serving.classreg",
            **schema})
        self.topic = tcfg.get_string("oryx.update-topic.message.topic")
        self.jl = JaxLayer(jcfg, port=0)
        self.tl = TorchLayer(tcfg, port=0, device="cpu")
        self.started = []

    def start(self):
        for layer in (self.jl, self.tl):
            layer.start()
            self.started.append(layer)

    def close(self):
        for layer in self.started:
            layer.close()
        name = f"file:{os.path.abspath(self.broker_dir)}"
        jinproc.drop_broker(name)
        tinproc.drop_broker(name)

    def both(self, method, path, body=None, accept="application/json"):
        return [_request(layer.port, method, path, body, accept)
                for layer in (self.jl, self.tl)]

    def log(self, topic):
        """Per partition, the (key, message) of a topic's JSONL log."""
        with open(os.path.join(self.broker_dir, f"{topic}.meta.json")) as f:
            n = json.load(f)["partitions"]
        out = []
        for i in range(n):
            name = f"{topic}.topic.jsonl" if i == 0 else \
                f"{topic}.p{i}.topic.jsonl"
            path = os.path.join(self.broker_dir, name)
            recs = []
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    recs = [tuple(json.loads(line)[:2]) for line in f
                            if line.strip()]
            out.append(recs)
        return out


UP_COUNT = 250


def _applied(layer):
    model = layer.model_manager.get_model()
    if model is None:
        return False
    leaf = model.forest.trees[0].find_by_id(layer.up_leaf)
    return leaf.prediction.count >= UP_COUNT


@pytest.fixture(scope="module")
def layers(tmp_path_factory, model_message):
    made = Layers(tmp_path_factory.mktemp("classreg"))
    try:
        # /train needs no model: before the first one, both layers append
        made.start()
        for layer in (made.jl, made.tl):
            assert _request(layer.port, "GET", "/ready")[0] == 503
            assert _request(layer.port, "GET", "/predict/0.5,red,")[0] == 503
        producer = jinproc.InProcTopicProducer(made.uri, made.topic)
        producer.send("MODEL", model_message)
        forest, _ = jrdf_pmml.read_forest(jpmml_io.from_string(model_message))
        leaf = [n for n in forest.trees[0].nodes() if n.is_terminal][0]
        producer.send("UP", json.dumps([0, leaf.id, {"1": UP_COUNT}]))
        for layer in (made.jl, made.tl):
            layer.up_leaf = leaf.id
            _wait(lambda: _applied(layer), "the replay")
            _wait(lambda: _request(layer.port, "GET", "/ready")[0]
                  in (200, 204), "/ready")
        yield made
    finally:
        made.close()


DATA = ["0.9,red,", "-0.9,green,", "0.05,blue,", "0.2,pink,",
        "0.09,red,yes", "-0.3,blue,no"]


@pytest.mark.parametrize("datum", DATA)
def test_predict_and_distribution_match(layers, datum):
    for path in (f"/predict/{datum}", f"/classificationDistribution/{datum}"):
        for accept in ("application/json", "text/csv"):
            (js, jb), (ts, tb) = layers.both("GET", path, accept=accept)
            assert (ts, tb) == (js, jb), path
            assert ts == 200


def test_predict_post_matches_get(layers):
    body = ("\n".join(DATA) + "\n\n").encode()
    (js, jb), (ts, tb) = layers.both("POST", "/predict", body)
    assert ts == js == 200
    assert tb == jb
    got = json.loads(tb)
    assert got == [json.loads(_request(layers.tl.port, "GET",
                                       f"/predict/{d}")[1]) for d in DATA]


@pytest.mark.parametrize("path", ["/feature/importance",
                                  "/feature/importance/0",
                                  "/feature/importance/1"])
def test_feature_importance_matches(layers, path):
    (js, jb), (ts, tb) = layers.both("GET", path)
    assert (ts, tb) == (js, jb)
    assert ts == 200


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/predict/0.5,red", None),
    ("GET", "/predict/x,red,", None),
    ("GET", "/predict/,red,", None),
    ("POST", "/predict", b"0.5,red\n"),
    ("GET", "/classificationDistribution/1,2", None),
    ("GET", "/feature/importance/2", None),
    ("GET", "/feature/importance/-1", None),
    ("GET", "/feature/importance/x", None),
    ("POST", "/train", None),
    ("GET", "/nope", None),
])
def test_errors_match(layers, method, path, body):
    (js, jb), (ts, tb) = layers.both(method, path, body)
    assert ts == js
    assert tb == jb


def test_console_page_bytes_match(layers):
    (js, jb), (ts, tb) = layers.both("GET", "/", accept="text/html")
    assert ts == js == 200
    assert tb == jb and b"Random Decision Forest" in tb


def test_train_writes_the_same_input_records(layers):
    lines = ["0.5,red,yes", "-0.25,blue,no", "0.75,green,yes", "0,red,no"]
    for layer in (layers.jl, layers.tl):
        assert _request(layer.port, "POST", f"/train/{lines[0]}",
                        b"")[0] in (200, 204)
        status, _ = _request(layer.port, "POST", "/train",
                             "\n".join(lines[1:]).encode())
        assert status in (200, 204)
    want, got = layers.log(JAX_INPUT), layers.log(TORCH_INPUT)
    assert got == want
    assert sorted(m for part in got for _, m in part) == sorted(lines)


# -- configuration ------------------------------------------------------------

def test_port_rdf_example_conf_differs_only_in_its_classes():
    port = tconfig.from_file(CONF).as_dict()
    ref = jconfig.from_file(os.path.join(REPO, "conf",
                                         "rdf-example.conf")).as_dict()
    classes = {("serving", "model-manager-class"):
               "app.rdf.serving.RDFServingModelManager",
               ("serving", "application-resources"): "serving.classreg",
               ("batch", "update-class"): "app.rdf.update.RDFUpdate",
               ("speed", "model-manager-class"):
               "app.rdf.speed.RDFSpeedModelManager"}
    for (layer, key), name in classes.items():
        assert port["oryx"][layer][key] == f"oryx_tpu_torch.{name}"
        assert ref["oryx"][layer][key] == f"oryx_tpu.{name}"
        for tree in (port, ref):
            del tree["oryx"][layer][key]
    assert port == ref


@pytest.mark.parametrize("extra,key", [
    ({"oryx.batch.streaming.master": "mesh"}, "oryx.batch.streaming.master"),
    ({"oryx.distributed.coordinator-address": "localhost:1234"},
     "oryx.distributed.coordinator-address"),
])
def test_update_refuses_the_mesh(extra, key):
    with pytest.raises(ValueError, match=key):
        RDFUpdate(tconfig.from_dict(_batch_entries(**extra)), device="cpu")


def test_update_refuses_what_the_reference_refuses():
    for extra in ({"oryx.rdf.num-trees": 0},
                  {"oryx.input-schema.target-feature": None,
                   "oryx.input-schema.categorical-features": ["color"]}):
        with pytest.raises(ValueError):
            RDFUpdate(tconfig.from_dict(_batch_entries(**extra)),
                      device="cpu")
    upd = RDFUpdate(tconfig.from_dict(_batch_entries()), device="cpu")
    data = [KeyMessage(None, ln) for ln in _lines(50)]
    for hyper in ([1, 4, "gini"], [16, 0, "gini"], [16, 4, "misc"]):
        with pytest.raises(ValueError):
            upd.build_model(data, hyper, "unused")
