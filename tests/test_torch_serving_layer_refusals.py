"""The port's ServingLayer refuses, by name, an item shard count that is
not a power of two, as the reference does, instead of constructing and
quietly ignoring it; and each key that used to be refused now starts its layer and its
feature answers: the observability keys (tracing, the SLO engine, the
event log and the flight recorder), the serving cluster's replica mode
(``oryx.cluster.enabled``), TLS (``keystore-file``), DIGEST auth
(``user-name`` and ``password``), the replica's framed transport and
shard cache, the router's result cache, coalescing, asyncio front end
and framed transport, and the region mirror's keys, which configure the
mirror process and which the router accepts."""

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
    ("oryx.serving.api.item-shards", 3),
])
def test_unported_key_is_refused_by_name(tmp_path, key, value):
    """A replica (``oryx.cluster.enabled``) refuses an item shard count
    that is not a power of two, with the reference's message."""
    cfg = tconfig.from_dict({**BASE, "oryx.cluster.enabled": True,
                             key: value})
    with pytest.raises(ValueError, match=key.rsplit(".", 1)[1]):
        ServingLayer(cfg, port=0, device="cpu")


ROUTER_BASE = {"oryx.update-topic.broker": "memory://refusals",
               "oryx.input-topic.broker": None}


@pytest.mark.parametrize("key,value", [
    ("oryx.cluster.region.mirror.source-broker", "memory://far"),
    ("oryx.cluster.region.mirror.source-topic", "FarUpdate"),
    ("oryx.cluster.region.mirror.checkpoint-dir", "/tmp/mirror"),
])
def test_router_accepts_the_mirror_key(key, value):
    """The mirror's keys configure the mirror process that reads the
    same conf: the router starts with each, and its ``/admin/region``
    answers the region's name and the router's block."""
    cfg = tconfig.from_dict({**ROUTER_BASE, key: value,
                             "oryx.cluster.region.name": "east"})
    with RouterLayer(cfg, port=0, device="cpu") as router:
        status, body = _get(router.port, "/admin/region")
    assert status == 200, body
    region = json.loads(body)
    assert region["region"] == "east" and region["role"] == "router"


@pytest.mark.parametrize("key", ["oryx.cluster.cache.enabled",
                                 "oryx.cluster.coalesce.enabled",
                                 "oryx.cluster.async.enabled",
                                 "oryx.cluster.transport.enabled"])
def test_lifted_router_key_starts_its_feature(key):
    """Each router key that was refused starts the router, and its
    feature answers: the cache's /admin/cache block (404 without a
    cache), the asyncio front end on the public door, or the scatter's
    framed transport."""
    router = RouterLayer(tconfig.from_dict({**ROUTER_BASE, key: True}),
                         port=0, device="cpu")
    with router:
        if key in ("oryx.cluster.cache.enabled",
                   "oryx.cluster.coalesce.enabled"):
            status, body = _get(router.port, "/admin/cache")
            assert status == 200, body
            stats = json.loads(body)
            assert stats["enabled"] == (key == "oryx.cluster.cache.enabled")
            assert stats["coalesce"] == \
                (key == "oryx.cluster.coalesce.enabled")
        elif key == "oryx.cluster.async.enabled":
            assert router._frontend is not None and router._server is None
            assert _get(router.port, "/ready")[0] == 503
        else:
            assert router.scatter.transport is not None
            assert router.scatter.stats()["transport"][
                "open_connections"] == 0
        assert _get(router.port, "/ready")[0] == 503


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
                                 "oryx.serving.api.user-name",
                                 "oryx.cluster.transport.enabled",
                                 "oryx.cluster.replica-cache.enabled"])
def test_lifted_key_starts_its_feature(tmp_path, key):
    """Each key that was refused starts the layer, and its feature
    answers: the replica's /shard/meta (over HTTP, or over the framed
    transport), HTTPS, a DIGEST challenge on every route, or the
    replica's shard cache."""
    extra = {"oryx.cluster.enabled": {"oryx.cluster.enabled": True},
             # the frame listener starts beside the heartbeat, which
             # needs an update topic
             "oryx.cluster.transport.enabled": {
                 "oryx.cluster.enabled": True, key: True,
                 "oryx.update-topic.broker": "memory://lifted-transport"},
             "oryx.cluster.replica-cache.enabled": {
                 "oryx.cluster.enabled": True, key: True},
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
        elif key == "oryx.cluster.transport.enabled":
            from oryx_tpu_torch.cluster.transport import FrameTransport

            class _Hb:
                url = f"http://127.0.0.1:{layer.port}"
                tport = layer._frame_server.port

            ft = FrameTransport(tconfig.from_dict(BASE))
            try:
                status, body, _ = ft.request(_Hb, "GET", "/shard/meta",
                                             None, {}, 30.0)
            finally:
                ft.close()
            assert status == 200, body
            assert json.loads(body)["of"] == 1
        elif key == "oryx.cluster.replica-cache.enabled":
            assert layer._shard_cache is not None
            assert layer._shard_cache.stats()["enabled"] is True
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
