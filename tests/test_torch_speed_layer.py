"""The port's speed layer (``oryx_tpu_torch/app/als/speed.py``,
``lambda_rt/speed.py``) and the broker's consumer-group offsets against
the reference's, on the CPU.

The same MODEL, UP records and micro-batch go through the reference's
and the port's speed manager: the UP messages agree in order, kind, id
and known items exactly, and in vector within rtol 1e-4, atol 1e-5 (the
fold-in's tolerance, ``tests/test_torch_fold_in.py``)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from oryx_tpu.app.als.speed import ALSSpeedModelManager as JSpeedManager
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.common import text as jtext
from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.kafka.inproc import resolve_broker as jresolve_broker
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.kafka.api import KeyMessage
from oryx_tpu_torch.kafka.inproc import drop_broker, get_broker, \
    resolve_broker
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.resilience import faults as tfaults

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _model_messages(nu=12, ni=12, k=3, seed=4):
    """The MODEL document and UP records of ``tests/test_als.py``'s
    speed model: small vectors, so every implicit target is finite."""
    rng = np.random.default_rng(seed)
    doc = jpmml.build_skeleton_pmml()
    jpmml.add_extension(doc, "features", k)
    jpmml.add_extension(doc, "implicit", True)
    jpmml.add_extension(doc, "logStrength", False)
    x_ids = [f"u{i}" for i in range(nu)]
    y_ids = [f"i{j}" for j in range(ni)]
    jpmml.add_extension_content(doc, "XIDs", x_ids)
    jpmml.add_extension_content(doc, "YIDs", y_ids)
    X = (0.3 * rng.standard_normal((nu, k))).astype(np.float32)
    Y = (0.3 * rng.standard_normal((ni, k))).astype(np.float32)
    msgs = [("MODEL", jpmml.to_string(doc))]
    msgs += [("UP", jtext.join_json(["X", u, [float(v) for v in X[i]]]))
             for i, u in enumerate(x_ids)]
    msgs += [("UP", jtext.join_json(["Y", y, [float(v) for v in Y[j]]]))
             for j, y in enumerate(y_ids)]
    return msgs, X, Y


def _managers(msgs, **overlay):
    jm = JSpeedManager(jfrom_dict(overlay))
    tm = ALSSpeedModelManager(from_dict(overlay), device="cpu")
    for key, message in msgs:
        jm.consume_key_message(key, message)
        tm.consume_key_message(key, message)
    return jm, tm


def _assert_same_updates(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        assert g[0] == w[0] and g[1] == w[1] and g[3:] == w[3:]
        np.testing.assert_allclose(g[2], w[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("no_known", [False, True])
def test_build_updates_match_the_reference(no_known):
    """Mirrors ``tests/test_als.py::test_speed_manager_builds_fold_in_
    updates``: an existing user, a new user, a repeated pair, a delete,
    and an item the model does not know."""
    msgs, X, Y = _model_messages()
    jm, tm = _managers(msgs, **{"oryx.als.no-known-items": no_known})
    assert tm.model.get_fraction_loaded() == 1.0
    lines = ["u0,i1,2.5,1000", "unew,i2,1.0,2000", "u3,i4,0.5,2500",
             "u3,i4,0.7,2600", "u5,i6,,2700", "u5,i6,1.0,2650",
             "u7,inew,1.0,2800", "u8,i9,-0.5,2900"]
    got = list(tm.build_updates([KeyMessage(None, m) for m in lines]))
    want = list(jm.build_updates([JKeyMessage(None, m) for m in lines]))
    _assert_same_updates(got, want)
    parsed = [json.loads(u) for u in got]
    assert any(p[0] == "X" and p[1] == "unew" for p in parsed)
    if not no_known:
        assert [p[3] for p in parsed if p[:2] == ["X", "u0"]] == [["i1"]]
    # the update moves u0's estimate of i1 toward 1
    new_xu = np.asarray(next(p[2] for p in parsed if p[:2] == ["X", "u0"]),
                        dtype=np.float32)
    assert float(new_xu @ Y[1]) > float(X[0] @ Y[1])


def test_build_updates_of_a_larger_batch_match_the_reference():
    msgs, _, _ = _model_messages(nu=40, ni=30, k=5, seed=8)
    jm, tm = _managers(msgs)
    rng = np.random.default_rng(1)
    lines = [f"u{rng.integers(0, 45)},i{rng.integers(0, 32)},"
             f"{rng.exponential(1.0):.3f},{1000 + j}" for j in range(300)]
    _assert_same_updates(
        list(tm.build_updates([KeyMessage(None, m) for m in lines])),
        list(jm.build_updates([JKeyMessage(None, m) for m in lines])))


def test_manager_without_a_model_and_after_a_feature_change():
    tm = ALSSpeedModelManager(from_dict({}), device="cpu")
    assert list(tm.build_updates([KeyMessage(None, "u,i,1,1")])) == []
    tm.consume_key_message("UP", '["X","u",[0.1,0.2]]')
    assert tm.model is None
    msgs, _, _ = _model_messages(k=3)
    for key, message in msgs:
        tm.consume_key_message(key, message)
    # a poison record is refused and counted, not absorbed
    tm.consume_key_message("UP", '["X","u0",[NaN,0.1,0.2]]')
    assert tm.rejected_updates == 1
    doc = jpmml.build_skeleton_pmml()
    jpmml.add_extension(doc, "features", 5)
    jpmml.add_extension(doc, "implicit", True)
    jpmml.add_extension(doc, "logStrength", False)
    jpmml.add_extension_content(doc, "XIDs", ["u0"])
    jpmml.add_extension_content(doc, "YIDs", ["i0"])
    tm.consume_key_message("MODEL", jpmml.to_string(doc))
    assert tm.model.features == 5 and len(tm.model.X) == 0


# -- the broker's group offsets and range reads -------------------------------

def test_offsets_persist_and_cross_packages(tmp_path):
    """Committed offsets go to the reference's ``offsets.json`` sidecar:
    a flushed commit survives a new broker, and each package reads the
    other's groups; ``read_ranges`` drains what the reference's does."""
    uri = f"file://{tmp_path}"
    broker = resolve_broker(uri)
    broker.create_topic("In", 3)
    for j in range(20):
        broker.send("In", f"k{j}", f"m{j}")
    ends = broker.latest_offsets("In")
    assert sum(ends) == 20
    assert broker.get_offsets("g", "In") == [None, None, None]
    broker.set_offsets("g", "In", [1, 0, 2])
    broker.flush()
    got = broker.read_ranges("In", [1, None, 2], ends)
    ref = jresolve_broker(uri)
    assert [(m.key, m.message) for m in got] == [
        (m.key, m.message) for m in ref.read_ranges("In", [1, None, 2], ends)]
    assert ref.get_offsets("g", "In") == [1, 0, 2]
    ref.set_offsets("jg", "In", ends)
    ref.flush()
    drop_broker(f"file:{tmp_path}")
    again = resolve_broker(uri)
    assert again.get_offsets("g", "In") == [1, 0, 2]
    assert again.get_offsets("jg", "In") == ends
    with pytest.raises(ValueError):
        again.read_ranges("In", [0], [1])
    drop_broker(f"file:{tmp_path}")


# -- the layer ----------------------------------------------------------------

def _config(tmp_path, name, **extra):
    overlay = {
        "oryx.id": "it",
        "oryx.input-topic.broker": f"memory://{name}",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "ItInput",
        "oryx.update-topic.broker": f"memory://{name}",
        "oryx.update-topic.message.topic": "ItUpdate",
        "oryx.batch.update-class": "oryx_tpu_torch.app.als.update.ALSUpdate",
        "oryx.speed.model-manager-class":
            "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.als.iterations": 3,
        "oryx.als.implicit": True,
        "oryx.als.hyperparams.features": 3,
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.speed.streaming.generation-interval-sec": 3600,
    }
    overlay.update(extra)
    return from_dict(overlay)


def _produce(broker, topic, nu=20, ni=12, seed=5):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    for u in range(nu):
        for i in range(ni):
            if rng.random() < 0.4:
                broker.send(topic, None,
                            f"u{u},i{i},{rng.exponential(1):.2f},{t}")
                t += 1000


def _ups(broker, before):
    after = broker.latest_offsets("ItUpdate")[0]
    return [json.loads(m.message) for m in broker.read_ranges(
        "ItUpdate", [before], [after]) if m.key == "UP"]


def test_micro_batch_loop_follows_group_offsets(tmp_path):
    """Mirrors ``tests/test_lambda_it.py::test_speed_layer_micro_batch_
    loop``: after a generation, a micro-batch folds the new input into UP
    deltas and commits the group offsets, so the next one reads only
    what came after."""
    name = f"tspeed-{time.monotonic_ns()}"
    cfg = _config(tmp_path, name)
    broker = get_broker(name)
    _produce(broker, "ItInput")
    BatchLayer(cfg, device="cpu").run_one_generation()
    speed = SpeedLayer(cfg, device="cpu")
    speed.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            m = speed.model_manager.model
            if m is not None and m.get_fraction_loaded() >= 0.8:
                break
            time.sleep(0.05)
        group = speed._group
        assert group == "OryxGroup-SpeedLayer-it"
        # a fresh group reads from 0: start this one at the end instead
        broker.set_offsets(group, "ItInput",
                           broker.latest_offsets("ItInput"))
        before = broker.latest_offsets("ItUpdate")[0]
        broker.send("ItInput", None, "u0,i1,3.0,1800000000000")
        broker.send("ItInput", None, "newuser,i2,1.0,1800000000001")
        speed.run_one_micro_batch()
        parsed = _ups(broker, before)
        assert any(p[0] == "X" and p[1] == "newuser" for p in parsed)
        assert {p[1] for p in parsed if p[0] == "X"} == {"u0", "newuser"}
        assert speed.last_micro_batch["records"] == 2
        assert speed.last_micro_batch["updates"] == len(parsed)
        assert broker.get_offsets(group, "ItInput") == \
            broker.latest_offsets("ItInput")
        # nothing new: no records read, no UP published
        mid = broker.latest_offsets("ItUpdate")[0]
        speed.run_one_micro_batch()
        assert broker.latest_offsets("ItUpdate")[0] == mid
        broker.send("ItInput", None, "later,i3,2.0,1800000000002")
        speed.run_one_micro_batch()
        assert speed.last_micro_batch["records"] == 1
        assert {p[1] for p in _ups(broker, mid) if p[0] == "X"} == {"later"}
    finally:
        speed.close()
    assert not speed.consuming


def test_failed_publish_commits_nothing(tmp_path):
    """An UP publish that fails past its retries leaves the offsets
    where they were, so the same input is read again; a crash between
    the publishes and the commit (the checkpointed path) commits nothing
    either, and the next micro-batch skips what landed."""
    name = f"tspeed-{time.monotonic_ns()}"
    cfg = _config(tmp_path, name, **{
        "oryx.resilience.retry.max-attempts": 1})
    broker = get_broker(name)
    _produce(broker, "ItInput")
    BatchLayer(cfg, device="cpu").run_one_generation()
    speed = SpeedLayer(cfg, device="cpu")
    for m in broker.consume("ItUpdate", from_beginning=True,
                            max_idle_sec=0.2):
        speed.model_manager.consume_key_message(m.key, m.message)
    group = speed._group
    start = broker.latest_offsets("ItInput")
    broker.set_offsets(group, "ItInput", start)
    broker.send("ItInput", None, "u0,i1,3.0,1800000000000")
    tfaults.inject("speed-publish", mode="error", times=None)
    with pytest.raises(tfaults.InjectedFault):
        speed.run_one_micro_batch()
    assert broker.get_offsets(group, "ItInput") == start
    tfaults.clear()
    # the crash point sits on the checkpointed path, as the
    # reference's: the publishes land, the commit does not, and the next
    # micro-batch finds them in the log instead of folding again
    ckpt = SpeedLayer(_config(tmp_path, name, **{
        "oryx.resilience.retry.max-attempts": 1,
        "oryx.speed.checkpoint-dir": str(tmp_path / "ckpt")}),
        device="cpu")
    for m in broker.consume("ItUpdate", from_beginning=True,
                            max_idle_sec=0.2):
        ckpt.model_manager.consume_key_message(m.key, m.message)
    assert ckpt._group == group
    tfaults.inject("speed-crash-mid-batch", mode="error", times=1)
    with pytest.raises(tfaults.InjectedFault):
        ckpt.run_one_micro_batch()
    assert broker.get_offsets(group, "ItInput") == start
    ckpt.run_one_micro_batch()
    assert ckpt.dedup_skips > 0
    assert broker.get_offsets(group, "ItInput") == \
        broker.latest_offsets("ItInput")
    ckpt.close()
    speed.close()


@pytest.mark.parametrize("key,value", [
    ("oryx.speed.checkpoint-dir", "/tmp/ckpt"),
    ("oryx.speed.shard", "1/2"),
])
def test_deferred_speed_keys_raise(tmp_path, key, value):
    """The keys the port once refused now start a layer: with
    ``oryx.speed.checkpoint-dir`` the micro-batch loop pins its fence in
    ``shard-0-of-1`` and the side door's gauge reads its age; with
    ``oryx.speed.shard = 1/2`` the worker takes the reference's group
    and its manager folds slice 1 of 2."""
    if key == "oryx.speed.checkpoint-dir":
        value = str(tmp_path / "ckpt")
    name = f"tspeed-{time.monotonic_ns()}"
    cfg = _config(tmp_path, name, **{key: value})
    layer = SpeedLayer(cfg, device="cpu")
    layer.start()
    try:
        if key == "oryx.speed.checkpoint-dir":
            path = os.path.join(value, "shard-0-of-1",
                                "speed-checkpoint.json")
            deadline = time.monotonic() + 30
            while not os.path.exists(path) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            assert doc == {"dest_scanned": {}, "input": {"0": 0},
                           "next_batch": 1, "pending": None}
            assert layer.metrics.gauge_value(
                "speed_checkpoint_age_sec") is not None
            assert layer._group == "OryxGroup-SpeedLayer-it"
        else:
            assert layer.shard_tag == "1/2" and layer.checkpoint is None
            assert layer._group == "OryxGroup-SpeedLayer-it-1x2"
            mgr = ALSSpeedModelManager(cfg, device="cpu")
            assert (mgr.shard_index, mgr.shard_count) == (1, 2)
            assert (layer.model_manager.shard_index,
                    layer.model_manager.shard_count) == (1, 2)
        assert layer.consuming
    finally:
        layer.close()
        drop_broker(name)


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
def test_obs_speed_key_starts_its_feature(tmp_path, key, value):
    """Each observability key that used to be refused starts the layer,
    and its feature answers on the side door: /metrics with the
    freshness gauges, /admin/traces, an event line stamped with the
    shard (every request emits at ``always-slow-ms`` 0), /admin/flight
    and a dumped bundle."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    extra = {key: value}
    if key != "oryx.obs.metrics-port":
        extra["oryx.obs.metrics-port"] = 0
    if key == "oryx.obs.events.dir":
        extra["oryx.obs.events.always-slow-ms"] = 0
    speed = SpeedLayer(_config(tmp_path, f"tspeed-{time.monotonic_ns()}",
                               **extra), device="cpu")
    speed.start()
    try:
        port = speed.obs_server.port
        status, body = _side_door(port, "/metrics")
        assert status == 200
        assert {"input_lag_records", "update_lag_records",
                "model_generation_age_sec"} <= \
            set(json.loads(body)["freshness"])
        if key == "oryx.obs.tracing.enabled":
            status, body = _side_door(port, "/admin/traces")
            assert status == 200 and json.loads(body)["service"] == "speed"
        elif key == "oryx.obs.events.dir":
            (name,) = os.listdir(value)
            with open(os.path.join(value, name), encoding="utf-8") as f:
                line = json.loads(f.readline())
            assert line["route"] == "GET /metrics" and \
                line["speed_shard"] == "0/1"
        elif key == "oryx.obs.flight.dir":
            assert _side_door(port, "/admin/flight")[0] == 200
            status, body = _side_door(port, "/admin/flight/dump", "POST")
            dump = json.loads(body)
            assert status == 200 and dump["dumped"], dump
            assert os.path.exists(dump["path"])
        else:
            assert _side_door(port, "/admin/traces")[0] == 404
    finally:
        speed.close()


def test_speed_layer_and_manager_raise_without_cuda(tmp_path, monkeypatch):
    cfg = _config(tmp_path, f"tspeed-{time.monotonic_ns()}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeedLayer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALSSpeedModelManager(cfg)
    assert ALSSpeedModelManager(cfg, device="cpu").device.type == "cpu"
