"""Two serving layers on one ``file://`` update topic — the reference's,
configured with ``oryx_tpu`` classes, and the port's, from
``oryx_tpu_torch/conf/als-example.conf`` on the CPU — replay the same
MODEL + UP records and then answer ``/recommend``, ``/recommendToMany``,
``considerKnownItems`` and ``/knownItems`` alike over HTTP.  Every wait
is bounded, so no test can hang the run."""

from __future__ import annotations

import http.client
import json
import os
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, N_USERS, F = 600, 30, 10
WAIT_S = 60.0
HTTP_TIMEOUT_S = 30.0


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", path, headers={"Accept": "application/json"})
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


def _loaded(layer):
    model = layer.model_manager.get_model()
    return (model is not None and len(model.X) == N_USERS
            and len(model.Y) == N_ITEMS
            and len(model.get_known_items(f"u{N_USERS - 1}")) > 0)


@pytest.fixture
def layers(tmp_path):
    broker_dir = str(tmp_path / "broker")
    uri = f"file://{broker_dir}"
    jcfg = jconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu.serving.als",
        "oryx.input-topic.broker": None,
        "oryx.update-topic.broker": uri,
    })
    tcfg = tconfig.overlay_on(
        {"oryx.input-topic.broker": None, "oryx.update-topic.broker": uri},
        tconfig.from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                       "als-example.conf")))
    jl = JaxLayer(jcfg, port=0)
    tl = TorchLayer(tcfg, port=0, device="cpu")
    started = []
    try:
        for layer in (jl, tl):
            layer.start()
            started.append(layer)
        yield jl, tl, uri, tcfg.get_string("oryx.update-topic.message.topic")
    finally:
        for layer in started:
            layer.close()
        name = f"file:{os.path.abspath(broker_dir)}"
        jinproc.drop_broker(name)
        tinproc.drop_broker(name)


def _publish(uri, topic):
    rng = np.random.default_rng(42)
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    x_ids = [f"u{j}" for j in range(N_USERS)]
    Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
    X = rng.standard_normal((N_USERS, F)).astype(np.float32)
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    producer = tinproc.InProcTopicProducer(uri, topic)
    producer.send("MODEL", pmml_io.to_string(doc))
    for i, row in zip(y_ids, Y):
        producer.send("UP", json.dumps(["Y", i, [float(v) for v in row]]))
    for u, row in zip(x_ids, X):
        known = [f"i{j}" for j in rng.integers(0, N_ITEMS, 6)]
        producer.send("UP", json.dumps(["X", u, [float(v) for v in row],
                                        known]))


def _pairs(body):
    return [(d["id"], d["value"]) for d in json.loads(body)]


def test_two_layers_on_one_update_topic_answer_alike(layers):
    jl, tl, uri, topic = layers
    ports = (jl.port, tl.port)
    for p in ports:
        assert _get(p, "/ready")[0] == 503
        assert _get(p, "/recommend/u0")[0] == 503
    assert tl.consuming
    _publish(uri, topic)
    for layer in (jl, tl):
        _wait(lambda: _loaded(layer), "the replay")
    for p in ports:
        _wait(lambda: _get(p, "/ready")[0] in (200, 204), "/ready")
    paths = [f"/recommend/u{u}?howMany=8" for u in range(0, N_USERS, 3)]
    paths += [f"/recommend/u{u}?howMany=5&offset=2&considerKnownItems=true"
              for u in range(1, N_USERS, 5)]
    paths += [f"/recommendToMany/u{u}/u{u + 1}/u{u + 2}?howMany=6"
              for u in range(0, N_USERS - 3, 7)]
    paths += ["/recommendToMany/u3/nobody?howMany=4&considerKnownItems=true"]
    for path in paths:
        (js, jb), (ts, tb) = (_get(p, path) for p in ports)
        assert js == ts == 200, (path, js, ts, tb[:200])
        want, got = _pairs(jb), _pairs(tb)
        assert [i for i, _ in got] == [i for i, _ in want], path
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=1e-5)
    for u in range(0, N_USERS, 4):
        (js, jb), (ts, tb) = (_get(p, f"/knownItems/u{u}") for p in ports)
        assert js == ts == 200 and json.loads(tb) == json.loads(jb)
    for path in ("/recommend/nobody", "/recommendToMany/nobody"):
        assert [_get(p, path)[0] for p in ports] == [404, 404]
    assert _get(tl.port, "/recommend/u0?howMany=0")[0] == \
        _get(jl.port, "/recommend/u0?howMany=0")[0] == 400
    # the port measured its route during the replay
    route = tl.model_manager.get_model().metrics()["kernel_route"]
    assert route["measured"] and "errors" not in route


def test_close_stops_the_consume_thread(layers):
    _, tl, _, _ = layers
    assert tl.consuming
    tl.close()
    assert not tl.consuming
    with pytest.raises(OSError):
        _get(tl.port, "/ready")


def test_port_layer_refuses_reference_classes(tmp_path):
    cfg = tconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
        "oryx.update-topic.broker": None, "oryx.input-topic.broker": None})
    with pytest.raises(ValueError, match="not part of oryx_tpu_torch"):
        TorchLayer(cfg, port=0, device="cpu")
    cfg = tconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu.serving.als",
        "oryx.update-topic.broker": None, "oryx.input-topic.broker": None})
    with pytest.raises(ValueError, match="not part of oryx_tpu_torch"):
        TorchLayer(cfg, port=0, device="cpu")
