"""The port's ServingLayer and RouterLayer refuse, by name, each
reference key whose feature the port does not have yet (the serving
cluster's framed transport, result caches, asyncio front end and region
mirror), instead of constructing and quietly ignoring it; and each key
that used to be refused now starts its layer and its feature answers:
the observability keys (tracing, the SLO engine, the event log and the
flight recorder), the serving cluster's replica mode
(``oryx.cluster.enabled``), TLS (``keystore-file``) and DIGEST auth
(``user-name`` and ``password``)."""

import http.client
import json
import os

import pytest

from oryx_tpu_torch.cluster.router import RouterLayer
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from tests.test_torch_http_auth import _self_signed_pem

BASE = {
    "oryx.serving.model-manager-class":
        "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
    "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
    "oryx.update-topic.broker": None, "oryx.input-topic.broker": None}


@pytest.mark.parametrize("key,value", [
    ("oryx.cluster.transport.enabled", True),
    ("oryx.cluster.replica-cache.enabled", True),
])
def test_unported_key_is_refused_by_name(tmp_path, key, value):
    """A replica (``oryx.cluster.enabled``) refuses the framed transport
    and its result cache."""
    cfg = tconfig.from_dict({**BASE, "oryx.cluster.enabled": True,
                             key: value})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ServingLayer(cfg, port=0, device="cpu")


ROUTER_BASE = {"oryx.update-topic.broker": "memory://refusals",
               "oryx.input-topic.broker": None}


@pytest.mark.parametrize("key,value", [
    ("oryx.cluster.cache.enabled", True),
    ("oryx.cluster.coalesce.enabled", True),
    ("oryx.cluster.async.enabled", True),
    ("oryx.cluster.transport.enabled", True),
    ("oryx.cluster.region.mirror.source-broker", "memory://far"),
    ("oryx.cluster.region.mirror.source-topic", "FarUpdate"),
    ("oryx.cluster.region.mirror.checkpoint-dir", "/tmp/mirror"),
])
def test_router_refuses_unported_key_by_name(key, value):
    cfg = tconfig.from_dict({**ROUTER_BASE, key: value})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        RouterLayer(cfg, port=0, device="cpu")
    # at the defaults the router constructs
    RouterLayer(tconfig.from_dict(ROUTER_BASE), port=0,
                device="cpu").scatter.close()


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


def _https_get(port, path):
    import ssl
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30,
                                       context=ctx)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("key", ["oryx.cluster.enabled",
                                 "oryx.serving.api.keystore-file",
                                 "oryx.serving.api.user-name"])
def test_lifted_key_starts_its_feature(tmp_path, key):
    """Each key that was refused starts the layer, and its feature
    answers: the replica's /shard/meta, HTTPS, or a DIGEST challenge on
    every route."""
    extra = {"oryx.cluster.enabled": {"oryx.cluster.enabled": True},
             "oryx.serving.api.keystore-file": {
                 key: _self_signed_pem(tmp_path)},
             "oryx.serving.api.user-name": {
                 key: "oryx", "oryx.serving.api.password": "pw"}}[key]
    layer = ServingLayer(tconfig.from_dict({**BASE, **extra}), port=0,
                         device="cpu")
    with layer:
        if key == "oryx.cluster.enabled":
            status, body = _get(layer.port, "/shard/meta")
            assert status == 200, body
            meta = json.loads(body)
            assert (meta["shard"], meta["of"], meta["ready"]) == \
                (0, 1, False)
        elif key == "oryx.serving.api.keystore-file":
            assert layer.scheme == "https"
            assert _https_get(layer.port, "/ready")[0] == 503
        else:
            assert _get(layer.port, "/ready")[0] == 401
            assert _get(layer.port, "/metrics")[0] == 401


def test_defaults_construct():
    """The keys at their reference.conf defaults (off, unset) pass."""
    layer = ServingLayer(tconfig.from_dict(BASE), port=0, device="cpu")
    assert layer.model_manager is not None
