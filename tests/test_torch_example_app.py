"""The word-count example app on the port (``oryx_tpu_torch/example/``),
held against the reference's (``tests/test_example_app.py``): the
distinct co-occurring word counts, the speed manager's UP lines, and the
full loop — ``/add`` writes the input topic, a batch generation
publishes the MODEL, ``/distinct`` serves it — through the port's three
layers on the port's ``conf/wordcount-example.conf``."""

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from oryx_tpu.example.batch import \
    count_distinct_other_words as jcount
from oryx_tpu.example.speed import ExampleSpeedModelManager as JSpeed
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu_torch.common.config import from_dict, from_file, overlay_on
from oryx_tpu_torch.example.batch import count_distinct_other_words
from oryx_tpu_torch.example.speed import ExampleSpeedModelManager
from oryx_tpu_torch.kafka.api import KEY_MODEL, KeyMessage
from oryx_tpu_torch.kafka.inproc import get_broker
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.serving import ServingLayer

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "oryx_tpu_torch", "conf", "wordcount-example.conf")


def test_count_distinct_other_words():
    lines = ["a b c", "a b", "a a b", "cats and dogs", "dogs are dogs"]
    counts = count_distinct_other_words([KeyMessage(None, ln)
                                         for ln in lines])
    assert counts == jcount([JKeyMessage(None, ln) for ln in lines])
    assert counts["a"] == 2 and counts["dogs"] == 3


def test_speed_manager_accumulates():
    port = ExampleSpeedModelManager(from_dict({}), device="cpu")
    ref = JSpeed(None)
    for m in (port, ref):
        m.consume_key_message(KEY_MODEL, json.dumps({"a": 1}))
    ups = sorted(port.build_updates([KeyMessage(None, "a b")]))
    assert ups == ["a,2", "b,1"]
    assert ups == sorted(ref.build_updates([JKeyMessage(None, "a b")]))


def test_example_full_loop(tmp_path):
    cfg = overlay_on({
        "oryx.id": "ex",
        "oryx.input-topic.broker": "memory://ex-torch",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "ExIn",
        "oryx.update-topic.broker": "memory://ex-torch",
        "oryx.update-topic.message.topic": "ExUp",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.serving.api.port": 0,
    }, from_file(CONF))
    assert cfg.get_string("oryx.batch.update-class").startswith(
        "oryx_tpu_torch.example.")
    broker = get_broker("ex-torch")
    serving = ServingLayer(cfg, port=0, device="cpu")
    serving.start()
    try:
        base = f"http://127.0.0.1:{serving.port}"
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"{base}/add/" + urllib.parse.quote("cats and dogs"),
                    data=b"", method="POST"), timeout=2)
                break
            except urllib.error.URLError:
                time.sleep(0.1)
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/add/" + urllib.parse.quote("cats are great"),
            data=b"", method="POST"), timeout=5)
        assert broker.latest_offset("ExIn") == 2

        BatchLayer(cfg, device="cpu").run_one_generation()
        deadline = time.time() + 10
        words = None
        while time.time() < deadline:
            words = json.loads(urllib.request.urlopen(
                f"{base}/distinct", timeout=5).read())
            if words:
                break
            time.sleep(0.2)
        assert words["cats"] == 4  # and, dogs, are, great
        one = json.loads(urllib.request.urlopen(
            f"{base}/distinct/dogs", timeout=5).read())
        assert one == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/distinct/zebra", timeout=5)
        assert e.value.code == 400
    finally:
        serving.close()
