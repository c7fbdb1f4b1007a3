"""The whole lambda loop on the port's three layers, against the
reference's loop on the same input: ``tests/test_lambda_it.py::
test_batch_then_serving_loop`` run on ``oryx_tpu_torch``'s
``BatchLayer`` and ``ServingLayer``, then a ``SpeedLayer`` micro-batch
fed by ``/pref`` and served back, on the CPU.

Both packages train from the same seed; their factors agree to float32
roundoff, so every user's ``/recommend`` answer has the same ids in the
same order as the reference's, and the scores agree within rtol 1e-3
(float32 roundoff over 3 sweeps)."""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest

from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.kafka.inproc import get_broker as jget_broker
from oryx_tpu.lambda_rt import data_store as jdata_store
from oryx_tpu.lambda_rt.batch import BatchLayer as JBatchLayer
from oryx_tpu.lambda_rt.serving import ServingLayer as JServingLayer
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.kafka.inproc import get_broker
from oryx_tpu_torch.lambda_rt import data_store
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer


@pytest.fixture(autouse=True)
def _seeded():
    TorchRandomManager.use_test_seed()
    yield


def _overlay(tmp_path, broker_name, package):
    return {
        "oryx.id": "it",
        "oryx.input-topic.broker": f"memory://{broker_name}",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "ItInput",
        "oryx.update-topic.broker": f"memory://{broker_name}",
        "oryx.update-topic.message.topic": "ItUpdate",
        "oryx.batch.update-class": f"{package}.app.als.update.ALSUpdate",
        "oryx.speed.model-manager-class":
            f"{package}.app.als.speed.ALSSpeedModelManager",
        "oryx.serving.model-manager-class":
            f"{package}.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": f"{package}.serving.als",
        "oryx.batch.storage.data-dir": str(tmp_path / package / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / package / "model"),
        "oryx.als.iterations": 3,
        "oryx.als.implicit": True,
        "oryx.als.hyperparams.features": 3,
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.speed.streaming.generation-interval-sec": 3600,
    }


def _produce_ratings(broker, topic, nu=20, ni=12, seed=5):
    """``tests/test_lambda_it.py``'s input."""
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    n = 0
    for u in range(nu):
        for i in range(ni):
            if rng.random() < 0.4:
                broker.send(topic, None,
                            f"u{u},i{i},{rng.exponential(1):.2f},{t}")
                t += 1000
                n += 1
    return n


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def _wait_loaded(layer_model, timeout=20.0):
    """The model once every id of its generation is loaded."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        model = layer_model()
        if model is not None and model.get_fraction_loaded() >= 1.0:
            return model
        time.sleep(0.05)
    raise AssertionError("the model did not load")


def _loop(layers, broker, cfg, tmp_path, ref: bool):
    """The reference test's steps; returns every user's /recommend."""
    batch_cls, serving_cls, store = layers
    n = _produce_ratings(broker, "ItInput")
    batch = batch_cls(cfg) if ref else batch_cls(cfg, device="cpu")
    batch.run_one_generation()
    msgs = list(broker.consume("ItUpdate", from_beginning=True,
                               max_idle_sec=0.2))
    assert msgs[0].key == "MODEL" and len(msgs) > 1
    package = "oryx_tpu" if ref else "oryx_tpu_torch"
    assert len(store.read_all_data(str(tmp_path / package / "data"))) == n
    assert broker.get_offsets("OryxGroup-BatchLayer-it", "ItInput") == [n]
    # a second generation with no new data still rebuilds from past data
    batch.run_one_generation()
    msgs = list(broker.consume("ItUpdate", from_beginning=True,
                               max_idle_sec=0.2))
    assert sum(1 for m in msgs if m.key == "MODEL") == 2
    serving = serving_cls(cfg, port=0) if ref else \
        serving_cls(cfg, port=0, device="cpu")
    serving.start()
    try:
        model = _wait_loaded(serving.model_manager.get_model)
        status, _ = _get(serving.port, "/ready")
        assert status in (200, 204)
        answers = {}
        for uid in sorted(model.all_user_ids()):
            _, body = _get(serving.port, f"/recommend/{uid}")
            answers[uid] = json.loads(body)
        return answers
    finally:
        serving.close()


def test_batch_then_serving_loop_matches_the_reference(tmp_path):
    from oryx_tpu.common.rand import RandomManager as JaxRandomManager
    JaxRandomManager.use_test_seed()
    name = f"tloop-{time.monotonic_ns()}"
    want = _loop((JBatchLayer, JServingLayer, jdata_store), jget_broker(name),
                 jfrom_dict(_overlay(tmp_path, name, "oryx_tpu")), tmp_path,
                 ref=True)
    got = _loop((BatchLayer, ServingLayer, data_store), get_broker(name),
                from_dict(_overlay(tmp_path, name, "oryx_tpu_torch")),
                tmp_path, ref=False)
    assert sorted(got) == sorted(want) and len(got) == 20
    for uid in want:
        assert [r["id"] for r in got[uid]] == [r["id"] for r in want[uid]]
        np.testing.assert_allclose([r["value"] for r in got[uid]],
                                   [r["value"] for r in want[uid]],
                                   rtol=1e-3, atol=1e-5)


def test_pref_through_the_speed_layer_reaches_serving(tmp_path):
    """The rest of the loop on the port alone: ``/pref`` appends to the
    input topic, one speed micro-batch folds it in, and the serving
    layer answers with the UP vector it published."""
    name = f"tloop-{time.monotonic_ns()}"
    cfg = from_dict(_overlay(tmp_path, name, "oryx_tpu_torch"))
    broker = get_broker(name)
    _produce_ratings(broker, "ItInput")
    BatchLayer(cfg, device="cpu").run_one_generation()
    serving = ServingLayer(cfg, port=0, device="cpu")
    speed = SpeedLayer(cfg, device="cpu")
    serving.start()
    speed.start()
    try:
        model = _wait_loaded(serving.model_manager.get_model)
        _wait_loaded(lambda: speed.model_manager.model)
        broker.set_offsets(speed._group, "ItInput",
                           broker.latest_offsets("ItInput"))
        before = broker.latest_offsets("ItUpdate")[0]
        for path, body in (("/pref/newbie/i2", b"1.0"),
                           ("/pref/u0/i3", b"2.5")):
            req = urllib.request.Request(
                f"http://127.0.0.1:{serving.port}{path}", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status in (200, 204)
        speed.run_one_micro_batch()
        assert speed.last_micro_batch["records"] == 2
        ups = [json.loads(m.message) for m in broker.read_ranges(
            "ItUpdate", [before], broker.latest_offsets("ItUpdate"))]
        x_newbie = [u for u in ups if u[:2] == ["X", "newbie"]]
        assert len(x_newbie) == 1
        want = np.asarray(x_newbie[0][2], dtype=np.float32)
        deadline = time.time() + 10
        while time.time() < deadline:
            got = model.get_user_vector("newbie")
            if got is not None and np.array_equal(got, want):
                break
            time.sleep(0.02)
        assert np.array_equal(model.get_user_vector("newbie"), want)
        assert model.get_known_items("newbie") == {"i2"}
        _, body = _get(serving.port, "/recommend/newbie?howMany=3")
        ids = [r["id"] for r in json.loads(body)]
        y_ids = [i for i in model.all_item_ids() if i != "i2"]
        scores = np.asarray([model.get_item_vector(i) for i in y_ids]) @ want
        assert ids == [y_ids[j] for j in np.argsort(-scores,
                                                    kind="stable")[:3]]
    finally:
        speed.close()
        serving.close()
