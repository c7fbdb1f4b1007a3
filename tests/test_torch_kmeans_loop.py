"""The k-means lambda loop on the port's three layers, on the CPU, held
against the reference's loop on the same input.

Both batch layers train with ``random`` initialization from the test
seed, so they start from the same rows and their centers agree within
rtol 1e-5; each serving layer then answers ``/assign`` with the same
clusters and ``/distanceToNearest`` within rtol 1e-4.  On the port,
``/add`` lines reach the input topic, one speed micro-batch folds them
into UP records equal to a float64 moving average of the speed model's
centers, and the serving layer then holds and serves those centers."""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest

from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.kafka.inproc import get_broker as jget_broker
from oryx_tpu.lambda_rt.batch import BatchLayer as JBatchLayer
from oryx_tpu.lambda_rt.serving import ServingLayer as JServingLayer
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.kafka.inproc import get_broker
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer

CENTERS = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [0.0, 10.0, 5.0],
                    [-8.0, 4.0, -6.0]])
PROBES = ["0.5,0.5,0", "9,1,0.5", "0,9,4", "-7,3,-5", "4,4,0", "-2,9,9"]


@pytest.fixture(autouse=True)
def _seeded():
    from oryx_tpu.common.rand import RandomManager as JaxRandomManager
    JaxRandomManager.use_test_seed()
    TorchRandomManager.use_test_seed()
    yield


def _overlay(tmp_path, broker_name, package):
    return {
        "oryx.id": "kit",
        "oryx.input-topic.broker": f"memory://{broker_name}",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "KInput",
        "oryx.update-topic.broker": f"memory://{broker_name}",
        "oryx.update-topic.message.topic": "KUpdate",
        "oryx.batch.update-class": f"{package}.app.kmeans.update.KMeansUpdate",
        "oryx.speed.model-manager-class":
            f"{package}.app.kmeans.speed.KMeansSpeedModelManager",
        "oryx.serving.model-manager-class":
            f"{package}.app.kmeans.serving.KMeansServingModelManager",
        "oryx.serving.application-resources": f"{package}.serving.clustering",
        "oryx.batch.storage.data-dir": str(tmp_path / package / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / package / "model"),
        "oryx.kmeans.hyperparams.k": 4,
        "oryx.kmeans.iterations": 10,
        "oryx.kmeans.runs": 2,
        "oryx.kmeans.initialization-strategy": "random",
        "oryx.kmeans.evaluation-strategy": "SSE",
        "oryx.input-schema.num-features": 3,
        "oryx.input-schema.numeric-features": ["0", "1", "2"],
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.speed.streaming.generation-interval-sec": 3600,
    }


def _produce_points(broker, n_per=40, seed=3):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([c + 0.5 * rng.standard_normal((n_per, 3))
                          for c in CENTERS])
    for p in pts[rng.permutation(len(pts))]:
        broker.send("KInput", None, ",".join(f"{v:.4f}" for v in p))
    return len(pts)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def _wait_model(get_model, cond=lambda m: True, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        model = get_model()
        if model is not None and cond(model):
            return model
        time.sleep(0.02)
    raise AssertionError("the model did not load")


def _loop(batch_cls, serving_cls, broker, cfg, ref: bool):
    n = _produce_points(broker)
    batch = batch_cls(cfg) if ref else batch_cls(cfg, device="cpu")
    batch.run_one_generation()
    msgs = list(broker.consume("KUpdate", from_beginning=True,
                               max_idle_sec=0.2))
    assert [m.key for m in msgs] == ["MODEL"]
    assert broker.get_offsets("OryxGroup-BatchLayer-kit", "KInput") == [n]
    serving = serving_cls(cfg, port=0) if ref else \
        serving_cls(cfg, port=0, device="cpu")
    serving.start()
    try:
        model = _wait_model(serving.model_manager.get_model)
        assert _get(serving.port, "/ready")[0] in (200, 204)
        assign = [json.loads(_get(serving.port, f"/assign/{p}")[1])
                  for p in PROBES]
        dist = [float(json.loads(_get(serving.port,
                                      f"/distanceToNearest/{p}")[1]))
                for p in PROBES]
        _, body = _post(serving.port, "/assign",
                        "\n".join(PROBES).encode())
        assert json.loads(body) == assign
        return model.clusters, assign, dist
    finally:
        serving.close()


def test_kmeans_loop_matches_the_reference(tmp_path):
    name = f"kloop-{time.monotonic_ns()}"
    jc, ja, jd = _loop(JBatchLayer, JServingLayer, jget_broker(name),
                       jfrom_dict(_overlay(tmp_path, name, "oryx_tpu")),
                       ref=True)
    tc, ta, td = _loop(BatchLayer, ServingLayer, get_broker(name),
                       from_dict(_overlay(tmp_path, name, "oryx_tpu_torch")),
                       ref=False)
    assert [(c.id, c.count) for c in tc] == [(c.id, c.count) for c in jc]
    np.testing.assert_allclose(np.stack([c.center for c in tc]),
                               np.stack([c.center for c in jc]),
                               rtol=1e-5, atol=1e-5)
    assert ta == ja
    np.testing.assert_allclose(td, jd, rtol=1e-4)


def test_add_through_the_speed_layer_reaches_serving(tmp_path):
    name = f"kloop-{time.monotonic_ns()}"
    cfg = from_dict(_overlay(tmp_path, name, "oryx_tpu_torch"))
    broker = get_broker(name)
    _produce_points(broker)
    BatchLayer(cfg, device="cpu").run_one_generation()
    serving = ServingLayer(cfg, port=0, device="cpu")
    speed = SpeedLayer(cfg, device="cpu")
    serving.start()
    speed.start()
    try:
        model = _wait_model(serving.model_manager.get_model)
        smodel = _wait_model(lambda: speed.model_manager.model)
        before = {c.id: (c.center.copy(), c.count) for c in smodel.clusters}
        broker.set_offsets(speed._group, "KInput",
                           broker.latest_offsets("KInput"))
        added = ["9.5,0.5,0.25", "10.5,-0.5,0", "0.25,0.25,-0.25"]
        assert _get(serving.port, f"/add/{added[0]}")[0] in (200, 204)
        assert _post(serving.port, "/add",
                     "\n".join(added[1:]).encode())[0] in (200, 204)
        up_before = broker.latest_offsets("KUpdate")
        speed.run_one_micro_batch()
        assert speed.last_micro_batch["records"] == 3
        ups = [json.loads(m.message) for m in broker.read_ranges(
            "KUpdate", up_before, broker.latest_offsets("KUpdate"))]
        pts = np.array([[float(v) for v in a.split(",")] for a in added])
        centers = np.stack([before[i][0] for i in sorted(before)])
        near = np.argmin(((pts[:, None, :] - centers[None]) ** 2).sum(-1),
                         axis=1)
        want = {}
        for cid in np.unique(near):
            members = pts[near == cid]
            c, n = before[int(cid)]
            total = n + len(members)
            want[int(cid)] = (c + (len(members) / total)
                              * (members.mean(0) - c), total)
        assert sorted(u[0] for u in ups) == sorted(want)
        for cid, center, count in ups:
            assert count == want[cid][1]
            np.testing.assert_allclose(center, want[cid][0], rtol=1e-12)
        _wait_model(serving.model_manager.get_model,
                    lambda m: all(m.get_cluster(u[0]).count == u[2]
                                  for u in ups))
        for cid, center, _ in ups:
            np.testing.assert_array_equal(model.get_cluster(cid).center,
                                          center)
        got = json.loads(_get(serving.port, f"/assign/{added[0]}")[1])
        assert got == str(int(near[0]))
    finally:
        speed.close()
        serving.close()
