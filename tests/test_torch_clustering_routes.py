"""The clustering routes of the reference's serving layer held against the
port's.  Two layers share one ``file://`` broker — the reference's,
configured with ``oryx_tpu`` classes, and the port's, from
``oryx_tpu_torch/conf/kmeans-example.conf`` on the CPU — each with an
input topic of its own on it.  After the same k-means MODEL and UP
replay, ``/assign`` (GET and POST), ``/distanceToNearest``, the errors
and the console page give the same bytes on both, and ``/add`` (GET and
POST) leaves the same keys and messages in the same partitions of their
input topics (the ``ts`` header is the only field that differs).  Every
wait is bounded."""

from __future__ import annotations

import http.client
import json
import os
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.app.kmeans import pmml as tpmml
from oryx_tpu_torch.app.kmeans.common import ClusterInfo
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "oryx_tpu_torch", "conf", "kmeans-example.conf")
WAIT_S = 60.0
HTTP_TIMEOUT_S = 30.0
JAX_INPUT, TORCH_INPUT = "JaxKInput", "TorchKInput"
CENTERS = [[0.0, 0.0, 0.0, 0.0, 0.0], [10.0, 0.0, 0.0, 0.0, 0.0],
           [0.0, 10.0, 1.0, 0.0, -1.0], [3.0, 3.0, 3.0, 3.0, 3.0]]
UP = [2, [0.5, 12.0, 1.5, -0.25, -1.0], 42]


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
    """The reference's and the port's k-means layer on one broker."""

    def __init__(self, tmp_path):
        self.broker_dir = str(tmp_path / "broker")
        self.uri = f"file://{self.broker_dir}"
        tcfg = tconfig.overlay_on(
            {"oryx.update-topic.broker": self.uri,
             "oryx.input-topic.broker": self.uri,
             "oryx.input-topic.message.topic": TORCH_INPUT},
            tconfig.from_file(CONF))
        jcfg = jconfig.from_dict({
            "oryx.update-topic.broker": self.uri,
            "oryx.input-topic.broker": self.uri,
            "oryx.input-topic.message.topic": JAX_INPUT,
            "oryx.serving.model-manager-class":
                "oryx_tpu.app.kmeans.serving.KMeansServingModelManager",
            "oryx.serving.application-resources":
                "oryx_tpu.serving.clustering",
            "oryx.input-schema.num-features": 5,
            "oryx.input-schema.numeric-features":
                ["0", "1", "2", "3", "4"]})
        self.schema = InputSchema(tcfg)
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


def _applied(layer):
    model = layer.model_manager.get_model()
    return model is not None and model.get_cluster(UP[0]).count == UP[2]


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    made = Layers(tmp_path_factory.mktemp("clustering"))
    try:
        made.start()
        for layer in (made.jl, made.tl):
            assert _request(layer.port, "GET", "/ready")[0] == 503
        clusters = [ClusterInfo(i, c, 10 + i) for i, c in enumerate(CENTERS)]
        producer = jinproc.InProcTopicProducer(made.uri, made.topic)
        producer.send("MODEL", pmml_io.to_string(
            tpmml.clusters_to_pmml(clusters, made.schema)))
        producer.send("UP", json.dumps(UP))
        for layer in (made.jl, made.tl):
            _wait(lambda: _applied(layer), "the replay")
            _wait(lambda: _request(layer.port, "GET", "/ready")[0]
                  in (200, 204), "/ready")
        yield made
    finally:
        made.close()


DATA = ["1,1,0,0,0", "9,0.5,0,0,0", "0.5,11,1,0,-1", "3,3,3,3,2.5",
        "-4,-4,0,0,0", "100,0,0,0,0"]


@pytest.mark.parametrize("datum", DATA)
def test_assign_and_distance_match(layers, datum):
    for path in (f"/assign/{datum}", f"/distanceToNearest/{datum}"):
        (js, jb), (ts, tb) = layers.both("GET", path)
        assert (ts, tb) == (js, jb), path
        assert ts == 200


def test_assign_answers_the_nearest_center(layers):
    centers = np.array(CENTERS, np.float64)
    centers[UP[0]] = UP[1]
    for datum in DATA:
        v = np.array([float(x) for x in datum.split(",")])
        d = np.linalg.norm(centers - v, axis=1)
        _, body = _request(layers.tl.port, "GET", f"/assign/{datum}")
        assert json.loads(body) == str(int(np.argmin(d)))
        _, body = _request(layers.tl.port, "GET",
                           f"/distanceToNearest/{datum}")
        np.testing.assert_allclose(float(json.loads(body)), d.min(),
                                   rtol=1e-12)


def test_assign_post_matches(layers):
    body = ("\n".join(DATA) + "\n\n").encode()
    (js, jb), (ts, tb) = layers.both("POST", "/assign", body)
    assert ts == js == 200
    assert tb == jb
    assert len(json.loads(tb)) == len(DATA)


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/assign/1,2", None),
    ("GET", "/distanceToNearest/1,x,0,0,0", None),
    ("POST", "/assign", b"1,2,3\n"),
    ("GET", "/nope", None),
])
def test_errors_match(layers, method, path, body):
    (js, jb), (ts, tb) = layers.both(method, path, body)
    assert ts == js and ts >= 400
    assert tb == jb


def test_console_page_bytes_match(layers):
    (js, jb), (ts, tb) = layers.both("GET", "/", accept="text/html")
    assert ts == js == 200
    assert tb == jb and b"k-means Clustering" in tb


def test_add_writes_the_same_input_records(layers):
    lines = ["1,2,3,4,5", "0.5,0.25,0,0,-1", "7,7,7,7,7"]
    for layer in (layers.jl, layers.tl):
        assert _request(layer.port, "GET", f"/add/{lines[0]}")[0] in (200,
                                                                      204)
        status, _ = _request(layer.port, "POST", "/add",
                             "\n".join(lines[1:]).encode())
        assert status in (200, 204)
    want, got = layers.log(JAX_INPUT), layers.log(TORCH_INPUT)
    assert got == want
    assert sorted(m for part in got for _, m in part) == sorted(lines)
