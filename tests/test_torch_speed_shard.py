"""The port's crash-safe sharded speed layer (``oryx_tpu_torch/lambda_rt/
speed_checkpoint.py``, ``lambda_rt/speed.py``, ``app/als/speed.py``)
against the reference's, on the CPU.

- The same stage, commit and recover sequence leaves byte-equal
  ``SpeedCheckpoint`` documents in both packages, and ``recover_pending``
  republishes and skips the same sequences of equal logs.
- A ``speed-crash-mid-batch`` crash between a micro-batch's UP
  publishes and its commit, followed by a restart, leaves an update
  topic byte-identical to an uncrashed control run: the restart finds
  every staged record in the log and republishes none.
- Two shards fold disjoint item slices whose union is the unsharded
  worker's UP set, pair for pair, with vectors within rtol 1e-4, atol
  1e-5 of the reference's (the fold-in's tolerance).
- close() interrupts the poll wait and joins an in-flight micro-batch
  before it closes the model manager.
- A real ``python -m oryx_tpu_torch speed --shard 0/1 --device cpu``
  process killed at the crash point and restarted ends in the control
  run's update topic."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from oryx_tpu.app.als.speed import ALSSpeedModelManager as JSpeedManager
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.common import text as jtext
from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.lambda_rt import speed_checkpoint as jckpt
from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.bench.gateway import (_await, _free_port, _get_json,
                                          _spawn, keys_to_hocon)
from oryx_tpu_torch.cluster.sharding import is_local_item
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.kafka.api import KEY_UP, KeyMessage
from oryx_tpu_torch.kafka.inproc import drop_broker, get_broker, \
    resolve_broker
from oryx_tpu_torch.lambda_rt import speed_checkpoint as tckpt
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.lambda_rt.speed_checkpoint import (
    H_SPEED_BATCH, H_SPEED_SEQ, H_SPEED_SHARD, SpeedCheckpoint,
    stamp_headers)
from oryx_tpu_torch.resilience import faults

RTOL, ATOL = 1e-4, 1e-5
NEW_LINES = ["u0,i1,3.0,1800000000000",
             "newuser,i2,1.0,1800000000001",
             "u3,i5,2.0,1800000000002"]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _overlay(broker_uri: str, tmp_path, **extra) -> dict:
    kv = {
        "oryx.id": "it",
        "oryx.input-topic.broker": broker_uri,
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "ItInput",
        "oryx.update-topic.broker": broker_uri,
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
        "oryx.resilience.retry.max-attempts": 2,
        "oryx.resilience.retry.initial-backoff-ms": 1,
        "oryx.resilience.retry.max-backoff-ms": 2,
        "oryx.resilience.supervisor.enabled": False,
    }
    kv.update(extra)
    return kv


def _config(tmp_path, name, **extra):
    return from_dict(_overlay(f"memory://{name}", tmp_path, **extra))


def _produce_ratings(broker, topic="ItInput", nu=20, ni=12, seed=5):
    rng = np.random.default_rng(seed)
    t = 1_700_000_000_000
    for u in range(nu):
        for i in range(ni):
            if rng.random() < 0.4:
                broker.send(topic, None,
                            f"u{u},i{i},{rng.exponential(1):.2f},{t}")
                t += 1000


def _replay_into(manager, broker, topic="ItUpdate"):
    manager.consume(broker.consume(topic, from_beginning=True,
                                   max_idle_sec=0.3))


def _up_records(broker, topic="ItUpdate"):
    return [km for km in broker.read_range(topic, 0,
                                           broker.latest_offset(topic))
            if km.key == KEY_UP]


@pytest.fixture
def trained(tmp_path):
    """A memory:// broker holding a generation the port's batch layer
    trained on 20 users x 12 items, and its name."""
    name = f"spd-{time.monotonic_ns()}"
    cfg = _config(tmp_path, name)
    broker = get_broker(name)
    _produce_ratings(broker)
    BatchLayer(cfg, device="cpu").run_one_generation()
    yield name, broker
    drop_broker(name)


# -- the single-document fence -----------------------------------------------

def _doc(ck) -> bytes:
    with open(ck.path, "rb") as f:
        return f.read()


def test_checkpoint_documents_match_the_reference(tmp_path):
    cks = [mod.SpeedCheckpoint(str(tmp_path / name))
           for mod, name in ((tckpt, "port"), (jckpt, "ref"))]
    for ck in cks:
        assert ck.input == {} and ck.pending is None and ck.next_batch == 0
    steps = [("stage", ([5], ["ua", "ub"], {"ts": "123"})),
             ("commit", ([5], [9])),
             ("commit", ([6], [7])),       # a stale head never rewinds
             ("stage", ([8], ["uc"], {"ts": "124", "traceparent": "t"})),
             ("commit", ([8], [None])),    # an unknown head keeps the mark
             ("commit", ([9], None))]
    for op, args in steps:
        for ck in cks:
            if op == "stage":
                assert ck.stage_batch(*args) == ck.next_batch
            else:
                ck.commit_batch(args[0], dest_ends=args[1])
        assert _doc(cks[0]) == _doc(cks[1])
        reloaded = [type(ck)(os.path.dirname(ck.path)) for ck in cks]
        assert [(r.input, r.dest_scanned, r.next_batch, r.pending)
                for r in reloaded][0] == \
            [(r.input, r.dest_scanned, r.next_batch, r.pending)
             for r in reloaded][1]
    assert cks[0].dest_scanned == {0: 9} and cks[0].next_batch == 4
    # a torn document loads as a clean start in both
    for ck in cks:
        with open(ck.path, "wb") as f:
            f.write(b"{not json")
        again = type(ck)(os.path.dirname(ck.path))
        assert again.input == {} and again.pending is None


class _Rec:
    def __init__(self, headers):
        self.headers = headers


def test_recover_pending_matches_the_reference(tmp_path):
    results = []
    for mod, name in ((tckpt, "port"), (jckpt, "ref")):
        ck = mod.SpeedCheckpoint(str(tmp_path / name))
        ck.commit_batch([1], dest_ends=[3])
        batch = ck.stage_batch([7], ["ua", "ub", "uc", "ud"], {"ts": "1"})
        # seqs 0 and 2 landed; a foreign shard's and a foreign batch's
        # records, and headerless ones, do not count
        dest = [_Rec(mod.stamp_headers({}, "0/2", batch, 0)),
                _Rec(mod.stamp_headers({}, "1/2", batch, 1)),
                _Rec(mod.stamp_headers({}, "0/2", batch + 9, 1)),
                _Rec(mod.stamp_headers({}, "0/2", batch, 2)),
                _Rec({H_SPEED_SHARD: "0/2", H_SPEED_BATCH: "x"}),
                _Rec({}), _Rec(None)]
        scans, sent = [], []

        def read_dest(starts, ends, dest=dest, scans=scans):
            scans.append((starts, ends))
            return dest

        counts = mod.recover_pending(ck, "0/2", read_dest, [len(dest)],
                                     lambda m, h, sent=sent:
                                     sent.append((m, h)))
        noop = mod.recover_pending(ck, "0/2", read_dest, [99],
                                   lambda m, h: sent.append(("!", h)))
        results.append((counts, noop, scans, sent, _doc(ck)))
    assert results[0] == results[1]
    counts, noop, scans, sent, _ = results[0]
    assert counts == (2, 2) and noop == (0, 0)
    assert scans == [([3], [7])]      # incremental from dest_scanned
    assert sent == [("ub", stamp_headers({"ts": "1"}, "0/2", 1, 1)),
                    ("ud", stamp_headers({"ts": "1"}, "0/2", 1, 3))]


# -- the crash point: between the publishes and the commit -------------------

def _copy_topic(src, dst, topic):
    for km in src.read_range(topic, 0, src.latest_offset(topic)):
        dst.send(topic, km.key, km.message, headers=km.headers)


def test_crash_mid_batch_replays_byte_identically(tmp_path, trained):
    name, broker = trained
    ckpt = {"oryx.speed.shard": "0/1",
            "oryx.speed.checkpoint-dir": str(tmp_path / "speed-ckpt")}
    cfg = _config(tmp_path, name, **ckpt)
    # the control: the same generation (records copied, artifacts shared
    # on disk), the same input, no crash
    ctl_name = f"{name}-ctl"
    ctl_broker = get_broker(ctl_name)
    try:
        for topic in ("ItInput", "ItUpdate"):
            ctl_broker.create_topic(topic, partitions=1)
            _copy_topic(broker, ctl_broker, topic)
        for line in NEW_LINES:
            broker.send("ItInput", None, line)
            ctl_broker.send("ItInput", None, line)
        ctl = SpeedLayer(_config(tmp_path, ctl_name, **{
            **ckpt, "oryx.speed.checkpoint-dir": str(tmp_path / "ctl")}),
            device="cpu")
        _replay_into(ctl.model_manager, ctl_broker)
        ctl.run_one_micro_batch()

        first = SpeedLayer(cfg, device="cpu")
        _replay_into(first.model_manager, broker)
        up_before = len(_up_records(broker))
        faults.inject("speed-crash-mid-batch", mode="crash", times=1)
        with pytest.raises(faults.InjectedCrash):
            first.run_one_micro_batch()
        # every UP of the batch is in the log, the fence has not moved,
        # the batch is staged
        staged = SpeedCheckpoint(str(tmp_path / "speed-ckpt" /
                                     "shard-0-of-1"))
        assert staged.pending is not None
        n_staged = len(staged.pending["updates"])
        assert n_staged > 0
        assert len(_up_records(broker)) == up_before + n_staged

        # the restart finds every staged record and republishes none
        second = SpeedLayer(cfg, device="cpu")
        second.run_one_micro_batch()
        assert second.checkpoint.pending is None
        assert second.dedup_skips == n_staged
        assert second.metrics.counters_snapshot()[
            "speed_shard_dedup_skips"] == n_staged
        ups = _up_records(broker)
        assert len(ups) == up_before + n_staged
        assert second.checkpoint.input == \
            {0: broker.latest_offset("ItInput")}
        assert broker.get_offsets(second._group, "ItInput") == \
            [broker.latest_offset("ItInput")]
        # byte-identical to the control's update topic
        assert [km.message for km in ups] == \
            [km.message for km in _up_records(ctl_broker)]
        stamped = [(km.headers[H_SPEED_SHARD], km.headers[H_SPEED_BATCH],
                    km.headers[H_SPEED_SEQ]) for km in ups[up_before:]]
        assert stamped == [("0/1", "0", str(s)) for s in range(n_staged)]
    finally:
        drop_broker(ctl_name)


def test_crash_before_first_commit_resumes_from_the_pinned_fence(
        tmp_path, trained):
    name, broker = trained
    cfg = _config(tmp_path, name, **{
        "oryx.speed.shard": "0/1",
        "oryx.speed.checkpoint-dir": str(tmp_path / "pin")})
    head = broker.latest_offset("ItInput")
    first = SpeedLayer(cfg, device="cpu")
    assert first._init_pos(broker) == [head]
    assert first.checkpoint.input == {0: head}
    assert broker.get_offsets(first._group, "ItInput") == [head]
    # the worker dies before any commit; records keep arriving
    up_before = len(_up_records(broker))
    for line in NEW_LINES:
        broker.send("ItInput", None, line)
    second = SpeedLayer(cfg, device="cpu")
    _replay_into(second.model_manager, broker)
    assert second._init_pos(broker) == [head]
    second.run_one_micro_batch()
    assert second.metrics.gauge_value("micro_batch_records") == \
        len(NEW_LINES)
    assert second.checkpoint.input == {0: broker.latest_offset("ItInput")}
    assert len(_up_records(broker)) > up_before


def test_publish_failure_mid_batch_finishes_from_staged_bytes(
        tmp_path, trained):
    name, broker = trained
    cfg = _config(tmp_path, name, **{
        "oryx.speed.checkpoint-dir": str(tmp_path / "ckpt")})
    speed = SpeedLayer(cfg, device="cpu")
    _replay_into(speed.model_manager, broker)
    broker.send("ItInput", None, "u1,i2,2.0,1800000000000")
    up_before = len(_up_records(broker))
    # before the first send: staged, nothing in the log
    faults.inject("speed-publish", mode="error", times=1)
    with pytest.raises(faults.InjectedFault):
        speed.run_one_micro_batch()
    assert speed.checkpoint.pending is not None
    staged = list(speed.checkpoint.pending["updates"])
    assert len(_up_records(broker)) == up_before
    # the next micro-batch republishes the staged bytes under batch 0
    speed.run_one_micro_batch()
    assert speed.checkpoint.pending is None
    tail = _up_records(broker)[up_before:]
    assert [km.message for km in tail] == staged
    assert [(km.headers[H_SPEED_SHARD], int(km.headers[H_SPEED_BATCH]),
             int(km.headers[H_SPEED_SEQ])) for km in tail] == \
        [("0/1", 0, s) for s in range(len(staged))]
    assert speed.dedup_skips == 0


# -- ring-sharded fold-in ----------------------------------------------------

def _model_messages(nu=60, ni=40, k=4, seed=12):
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
    return msgs


def _keyed(updates) -> dict:
    out = {}
    for u in updates:
        p = json.loads(u)
        key = (p[0], p[1], tuple(p[3]) if len(p) > 3 else ())
        assert key not in out
        out[key] = np.asarray(p[2], np.float64)
    return out


def test_two_shards_union_equals_the_unsharded_updates():
    msgs = _model_messages()
    rng = np.random.default_rng(3)
    lines = [f"u{rng.integers(0, 66)},i{rng.integers(0, 44)},"
             f"{rng.exponential(1.0):.3f},{1000 + j}" for j in range(400)]
    managers = [ALSSpeedModelManager(from_dict(
        {"oryx.speed.shard": f"{s}/2"}), device="cpu") for s in range(2)]
    whole = ALSSpeedModelManager(from_dict({}), device="cpu")
    ref = JSpeedManager(jfrom_dict({}))
    for key, message in msgs:
        for m in (*managers, whole, ref):
            m.consume_key_message(key, message)
    data = [KeyMessage(None, m) for m in lines]
    shards = [_keyed(m.build_updates(data)) for m in managers]
    unsharded = _keyed(whole.build_updates(data))
    want = _keyed(ref.build_updates([JKeyMessage(None, m) for m in lines]))
    assert shards[0] and shards[1]
    assert not set(shards[0]) & set(shards[1])
    union = {**shards[0], **shards[1]}
    assert set(union) == set(unsharded) == set(want)
    for key, vec in union.items():
        np.testing.assert_allclose(vec, want[key], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(vec, unsharded[key], rtol=RTOL,
                                   atol=ATOL)
    for s, ups in enumerate(shards):
        for kind, id_, other in ups:
            item = id_ if kind == "Y" else other[0]
            assert is_local_item(item, s, 2)
    # every event is another worker's for exactly one of the two
    assert sum(m.skipped_remote_events for m in managers) == len(lines)
    assert all(0 < m.skipped_remote_events < len(lines) for m in managers)


def test_two_sharded_layers_over_one_broker(tmp_path, trained):
    name, broker = trained
    lines = [f"u{u},i{i},1.5,{1_800_000_000_000 + u * 13 + i}"
             for u in range(4) for i in range(6)]
    for line in lines:
        broker.send("ItInput", None, line)
    workers = []
    for s in range(2):
        w = SpeedLayer(_config(tmp_path, name, **{
            "oryx.speed.shard": f"{s}/2",
            "oryx.speed.checkpoint-dir": str(tmp_path / "shards")}),
            device="cpu")
        assert w._group.endswith(f"-{s}x2")
        _replay_into(w.model_manager, broker)
        workers.append(w)
    up_before = len(_up_records(broker))
    for w in workers:
        w.run_one_micro_batch()
    ups = _up_records(broker)[up_before:]
    triples = [(km.headers[H_SPEED_SHARD], km.headers[H_SPEED_BATCH],
                km.headers[H_SPEED_SEQ]) for km in ups]
    assert len(triples) == len(set(triples))
    items: dict[str, set] = {"0/2": set(), "1/2": set()}
    for km in ups:
        tag = km.headers[H_SPEED_SHARD]
        kind, id_ = json.loads(km.message)[:2]
        if kind == "Y":
            items[tag].add(id_)
            assert is_local_item(id_, int(tag[0]), 2)
    assert items["0/2"] and items["1/2"]
    assert not items["0/2"] & items["1/2"]
    # both read the whole topic from 0: each event is remote to one
    total = broker.latest_offset("ItInput")
    assert sum(w.model_manager.skipped_remote_events
               for w in workers) == total
    for w in workers:
        assert os.path.exists(os.path.join(
            str(tmp_path / "shards"),
            f"shard-{w.shard_index}-of-2", "speed-checkpoint.json"))


# -- close() and an in-flight micro-batch ------------------------------------

@pytest.fixture
def blocking_manager(monkeypatch):
    """The ALS speed manager with a build_updates that blocks until
    released and a close that notes whether a build was in flight."""
    state = {"in_build": threading.Event(), "release": threading.Event(),
             "building": False, "closed": False,
             "closed_while_building": False}

    def build_updates(self, new_data):
        state["building"] = True
        state["in_build"].set()
        state["release"].wait(15.0)
        state["building"] = False
        return ["stub-update"]

    def close(self):
        state["closed"] = True
        state["closed_while_building"] = state["building"]

    monkeypatch.setattr(ALSSpeedModelManager, "build_updates",
                        build_updates)
    monkeypatch.setattr(ALSSpeedModelManager, "close", close)
    yield state
    state["release"].set()


def test_close_joins_the_inflight_micro_batch(tmp_path, blocking_manager):
    state = blocking_manager
    name = f"closerace-{time.monotonic_ns()}"
    broker = get_broker(name)
    try:
        broker.send("ItInput", None, "u0,i0,1.0,1800000000000")
        broker.set_offsets("OryxGroup-SpeedLayer-it", "ItInput", [0])
        speed = SpeedLayer(_config(tmp_path, name, **{
            "oryx.speed.streaming.generation-interval-sec": 1}),
            device="cpu")
        speed.start()
        assert state["in_build"].wait(10.0), "no micro-batch started"
        closer = threading.Thread(target=speed.close)
        closer.start()
        time.sleep(0.25)
        assert not state["closed"], "close() closed the manager mid-batch"
        state["release"].set()
        closer.join(15.0)
        assert not closer.is_alive()
        assert state["closed"] and not state["closed_while_building"]
    finally:
        drop_broker(name)


def test_close_interrupts_the_poll_wait(tmp_path, blocking_manager):
    name = f"closewait-{time.monotonic_ns()}"
    get_broker(name)
    try:
        speed = SpeedLayer(_config(tmp_path, name, **{
            "oryx.speed.streaming.generation-interval-sec": 300}),
            device="cpu")
        speed.start()
        time.sleep(0.3)  # the batch thread is in its 300 s wait
        t0 = time.monotonic()
        speed.close()
        assert time.monotonic() - t0 < 5.0
        assert not speed._batch_thread.is_alive()
        assert blocking_manager["closed"]
    finally:
        drop_broker(name)


# -- a real process killed at the crash point --------------------------------

def test_kill_and_restart_of_a_real_speed_process(tmp_path):
    """``speed --shard 0/1 --device cpu`` with the crash armed in its
    conf dies between its publishes and its commit; a restart on the
    same checkpoint skips every staged record and ends in the update
    topic of an uncrashed control run."""
    crash_dir, ctl_dir = tmp_path / "broker-crash", tmp_path / "broker-ctl"
    ckpt_dir = str(tmp_path / "ckpt")
    crash_uri, ctl_uri = f"file://{crash_dir}", f"file://{ctl_dir}"
    group = "OryxGroup-SpeedLayer-it-0x1"
    broker = resolve_broker(crash_uri)
    try:
        _produce_ratings(broker)
        BatchLayer(from_dict(_overlay(crash_uri, tmp_path)),
                   device="cpu").run_one_generation()
        history = broker.latest_offset("ItInput")
        up_history = len(_up_records(broker))
        os.makedirs(ctl_dir)
        for fn in os.listdir(crash_dir):
            if fn.endswith((".topic.jsonl", ".meta.json")):
                shutil.copy(crash_dir / fn, ctl_dir / fn)
        ctl_broker = resolve_broker(ctl_uri)
        for b in (broker, ctl_broker):
            # both start folding at the history's head
            b.set_offsets(group, "ItInput", [history])
            b.flush()

        def conf(name, **extra):
            path = str(tmp_path / f"{name}.conf")
            with open(path, "w", encoding="utf-8") as f:
                f.write(keys_to_hocon(sorted(_overlay(
                    crash_uri, tmp_path, **{
                        "oryx.speed.checkpoint-dir": ckpt_dir,
                        "oryx.speed.streaming.generation-interval-sec": 1,
                        **extra}).items())))
            return path

        log = str(tmp_path / "speed.log")
        obs = _free_port()
        proc = _spawn(["speed", "--shard", "0/1"], conf(
            "crash", **{"oryx.obs.metrics-port": obs,
                        "oryx.resilience.faults.speed-crash-mid-batch":
                            {"mode": "crash", "times": 1}}),
            None, log, "cpu")
        try:
            _await(lambda: (lambda g: g.get("update_lag_records") == 0
                            and g.get("model_generation_age_sec")
                            is not None)(
                                _get_json(obs, "/metrics")["freshness"]),
                   "the worker's model replay", timeout=60.0)
            broker.send_many("ItInput", [(None, line, None)
                                         for line in NEW_LINES])
            assert proc.wait(timeout=60) is not None
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=15)
        staged = SpeedCheckpoint(os.path.join(ckpt_dir, "shard-0-of-1"))
        assert staged.pending is not None, open(log).read()[-3000:]
        n_staged = len(staged.pending["updates"])
        assert staged.pending["ends"] == [history + len(NEW_LINES)]
        assert len(_up_records(broker)) == up_history + n_staged

        # the control, in process: the same model, input and batch
        ctl = SpeedLayer(from_dict(_overlay(ctl_uri, tmp_path, **{
            "oryx.speed.shard": "0/1",
            "oryx.speed.checkpoint-dir": str(tmp_path / "ctl-ckpt")})),
            device="cpu")
        for line in NEW_LINES:
            ctl_broker.send("ItInput", None, line)
        _replay_into(ctl.model_manager, ctl_broker)
        ctl.run_one_micro_batch()

        obs2 = _free_port()
        proc2 = _spawn(["speed", "--shard", "0/1"], conf(
            "restart", **{"oryx.obs.metrics-port": obs2}), None, log,
            "cpu")
        try:
            _await(lambda: (lambda m: m["counters"].get(
                "speed_shard_dedup_skips") == n_staged and m[
                "freshness"].get("input_lag_records") == 0)(
                    _get_json(obs2, "/metrics")),
                "the restart's recovery", timeout=60.0)
        finally:
            proc2.terminate()
            proc2.wait(timeout=15)
        after = SpeedCheckpoint(os.path.join(ckpt_dir, "shard-0-of-1"))
        assert after.pending is None
        assert after.input == {0: broker.latest_offset("ItInput")}
        ups = _up_records(broker)
        stamped = [(km.headers[H_SPEED_SHARD], km.headers[H_SPEED_BATCH],
                    km.headers[H_SPEED_SEQ]) for km in ups
                   if km.headers and H_SPEED_SHARD in km.headers]
        assert len(stamped) == len(set(stamped)) == n_staged
        assert [km.message for km in ups] == \
            [km.message for km in _up_records(ctl_broker)]
    finally:
        for d in (crash_dir, ctl_dir):
            drop_broker(f"file:{os.path.abspath(d)}")
