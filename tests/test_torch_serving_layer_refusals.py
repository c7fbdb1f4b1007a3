"""The port's ServingLayer refuses, by name, each reference key whose
feature the port does not have yet (the serving cluster), instead of
constructing and quietly ignoring it; and each observability key that
used to be refused (tracing, the SLO engine, the event log and the
flight recorder) now starts its layer and its feature answers."""

import http.client
import json
import os

import pytest

from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt.serving import ServingLayer

BASE = {
    "oryx.serving.model-manager-class":
        "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
    "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
    "oryx.update-topic.broker": None, "oryx.input-topic.broker": None}


@pytest.mark.parametrize("key,value", [
    ("oryx.cluster.enabled", True),
])
def test_unported_key_is_refused_by_name(tmp_path, key, value):
    if isinstance(value, str):
        value = str(tmp_path / value)
    cfg = tconfig.from_dict({**BASE, key: value})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ServingLayer(cfg, port=0, device="cpu")


def _get(port: int, path: str, method: str = "GET"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("key,value,path", [
    ("oryx.obs.tracing.enabled", True, "/admin/traces"),
    ("oryx.obs.slo.enabled", True, "/admin/slo"),
    ("oryx.obs.events.dir", "EVENTS", None),
    ("oryx.obs.flight.dir", "FLIGHT", "/admin/flight"),
])
def test_obs_key_starts_its_feature(tmp_path, key, value, path):
    """Each key that was refused starts the layer, and its feature
    answers: its admin route with 200 (404 without the key), or, for
    the event log, one line for a request that failed with 503 (no
    model yet: a server error always leaves a line)."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    layer = ServingLayer(tconfig.from_dict({**BASE, key: value}), port=0,
                         device="cpu")
    bare = ServingLayer(tconfig.from_dict(BASE), port=0, device="cpu")
    with layer, bare:
        if path is not None:
            status, body = _get(layer.port, path)
            assert status == 200, body
            assert isinstance(json.loads(body), dict)
            assert _get(bare.port, path)[0] == 404
        else:
            assert _get(layer.port, "/ready")[0] == 503
            log = [f for f in os.listdir(value) if f.endswith(".jsonl")]
            assert len(log) == 1
            with open(os.path.join(value, log[0]), encoding="utf-8") as f:
                lines = [json.loads(x) for x in f]
            assert [(e["route"], e["status"]) for e in lines] == \
                [("GET /ready", 503)]


def test_defaults_construct():
    """The keys at their reference.conf defaults (off, unset) pass."""
    layer = ServingLayer(tconfig.from_dict(BASE), port=0, device="cpu")
    assert layer.model_manager is not None
