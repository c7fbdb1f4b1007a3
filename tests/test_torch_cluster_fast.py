"""The port's serving cluster with every gate of its fast path on — two
replicas with the framed transport and the shard cache, and a router on
the asyncio front end with the result cache and coalescing — answers
every routed read as the port's default cluster (the threaded router
over the HTTP/1.1 pool, on the same replicas) and as the reference's
cluster built the same way (on a ``memory://`` broker of its own
carrying the same records).  The ``X-Oryx-Cache`` verdicts, a coalesced
wave and the invalidation after ``/pref`` match the reference's."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu.cluster.router import RouterLayer as JRouter
from oryx_tpu.common import config as jconfig
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JLayer
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.cluster.router import RouterLayer
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.resilience import faults as tfaults

N_USERS, N_ITEMS, F = 10, 48, 5
WAIT_S = 60.0
FAST = {"oryx.cluster.transport.enabled": True}
REPLICA = {**FAST, "oryx.cluster.replica-cache.enabled": True}
ROUTER = {**FAST, "oryx.cluster.async.enabled": True,
          "oryx.cluster.cache.enabled": True,
          "oryx.cluster.coalesce.enabled": True}


def _overlay(pkg, broker, **extra):
    return {
        "oryx.input-topic.broker": f"memory://{broker}",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "FIn",
        "oryx.update-topic.broker": f"memory://{broker}",
        "oryx.update-topic.message.topic": "FUp",
        "oryx.serving.model-manager-class":
            f"{pkg}.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": f"{pkg}.serving.als",
        "oryx.cluster.heartbeat-interval-ms": 60,
        "oryx.cluster.heartbeat-ttl-ms": 2000,
        "oryx.cluster.shard-timeout-ms": 5000,
        **extra}


def _records():
    rng = np.random.default_rng(5)
    users = [f"u{j}" for j in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", users)
    pmml_io.add_extension_content(doc, "YIDs", items)
    out = [("MODEL", pmml_io.to_string(doc))]
    out += [("UP", json.dumps(["Y", i, np.round(rng.standard_normal(F), 4)
                               .tolist()])) for i in items]
    out += [("UP", json.dumps(["X", u, np.round(rng.standard_normal(F), 4)
                               .tolist(), [f"i{j}" for j in range(3)]]))
            for u in users]
    return out


def _get(port, path, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("X-Oryx-Cache"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Oryx-Cache"), e.read()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _await(predicate, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def clusters():
    tag = f"fast-{time.monotonic_ns()}"
    tb, jb = f"{tag}-t", f"{tag}-j"
    t_replicas = [ServingLayer(tconfig.from_dict(_overlay(
        "oryx_tpu_torch", tb, **REPLICA, **{
            "oryx.cluster.enabled": True, "oryx.cluster.shard": f"{s}/2"})),
        port=0, device="cpu") for s in range(2)]
    fast = RouterLayer(tconfig.from_dict(_overlay("oryx_tpu_torch", tb,
                                                  **ROUTER)),
                       port=0, device="cpu")
    default = RouterLayer(tconfig.from_dict(_overlay("oryx_tpu_torch", tb)),
                          port=0, device="cpu")
    j_replicas = [JLayer(jconfig.from_dict(_overlay(
        "oryx_tpu", jb, **REPLICA, **{
            "oryx.cluster.enabled": True, "oryx.cluster.shard": f"{s}/2"})),
        port=0) for s in range(2)]
    ref = JRouter(jconfig.from_dict(_overlay("oryx_tpu", jb, **ROUTER)),
                  port=0)
    nodes = t_replicas + [fast, default] + j_replicas + [ref]
    started = []
    try:
        for node in nodes:
            node.start()
            started.append(node)
        for producer_cls, broker in ((tinproc.InProcTopicProducer, tb),
                                     (jinproc.InProcTopicProducer, jb)):
            producer = producer_cls(f"memory://{broker}", "FUp")
            for key, message in _records():
                producer.send(key, message)
            producer.close()
        # every record applied on every replica, then every router
        # ready; no cacheable read before that (an early 404 would be
        # cached until the next publish, by design)
        for layer in t_replicas + j_replicas:
            _await(lambda: (lambda m: m is not None
                            and m.get_fraction_loaded() >= 1.0
                            and len(m.X) == N_USERS and len(m.Y) > 0)(
                layer.model_manager.get_model()), "the replicas' loads")
        for router in (fast, default, ref):
            _await(lambda: _get(router.port, "/ready")[0] in (200, 204),
                   "the routers' coverage")
        yield {"fast": fast, "default": default, "ref": ref,
               "t_replicas": t_replicas, "j_replicas": j_replicas,
               "brokers": (tb, jb)}
    finally:
        for node in reversed(started):
            node.close()


ROUTES = [
    "/recommend/u1?howMany=5",
    "/recommend/u2?howMany=4&considerKnownItems=true",
    "/recommendToMany/u1/u3?howMany=6",
    "/recommendToAnonymous/i1=1.5/i4?howMany=5",
    "/recommendWithContext/u2/i7=2?howMany=5",
    "/similarity/i1/i2?howMany=5",
    "/similarityToItem/i3/i5/i9",
    "/estimate/u4/i1/i2/i30",
    "/estimateForAnonymous/i3/i1=0.5/i2",
    "/because/u1/i6?howMany=3",
    "/mostSurprising/u3?howMany=3",
    "/knownItems/u5",
    "/recommend/nobody",
    "/mostPopularItems?howMany=5",
    "/mostActiveUsers?howMany=5",
    "/allItemIDs",
]
FOLD_IN = ("/recommendToAnonymous", "/recommendWithContext",
           "/estimateForAnonymous")


def _same(path, got, want):
    """Same ids in the same order and scores within tolerance, or the
    same document."""
    g, w = json.loads(got), json.loads(want)
    if path.startswith("/allItemIDs"):
        assert sorted(g) == sorted(w), path
    elif isinstance(g, list) and g and isinstance(g[0], dict) \
            and "value" in g[0]:
        assert [d["id"] for d in g] == [d["id"] for d in w], path
        rtol = 1e-4 if path.startswith(FOLD_IN) else 1e-5
        np.testing.assert_allclose([d["value"] for d in g],
                                   [d["value"] for d in w], rtol=rtol,
                                   atol=1e-5, err_msg=path)
    elif isinstance(g, (int, float)) or (
            isinstance(g, list) and g and isinstance(g[0], (int, float))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    else:
        assert g == w, path


@pytest.mark.parametrize("path", ROUTES)
def test_route_answers_as_default_and_reference(clusters, path):
    fast, default, ref = (clusters[k] for k in ("fast", "default", "ref"))
    miss = _get(fast.port, path)
    hit = _get(fast.port, path)
    cold = _get(default.port, path)
    rmiss, rhit = _get(ref.port, path), _get(ref.port, path)
    # the fast path's answer is the default cluster's, byte for byte,
    # and a hit is its miss
    assert miss[0] == cold[0] == rmiss[0], path
    assert miss[2] == cold[2] == hit[2], path
    # the verdicts are the reference's
    assert (miss[1], hit[1]) == (rmiss[1], rhit[1]), path
    if miss[0] == 200:
        _same(path, miss[2], rmiss[2])
    # every scatter of the fast router rode the frames
    assert fast.scatter.stats()["pool"]["attempts"] == 0
    assert fast.scatter.stats()["transport"]["open_connections"] == 2
    # and the default router's over its HTTP/1.1 pool
    assert "transport" not in default.scatter.stats()
    assert default.scatter.stats()["pool"]["attempts"] > 0


def test_coalesced_wave_collapses_like_the_reference(clusters):
    """A wave of identical requests on a cold key, its leader held by
    the ``router-shard-timeout`` delay: one miss, the rest coalesced,
    one body, in both packages."""
    out = {}
    for name, faults in (("fast", tfaults), ("ref", jfaults)):
        router = clusters[name]
        faults.inject("router-shard-timeout", mode="delay", times=2,
                      delay_sec=0.4)
        gate = threading.Barrier(8)
        got = []
        lock = threading.Lock()

        def one():
            gate.wait()
            answer = _get(router.port, "/recommend/u7?howMany=3")
            with lock:
                got.append(answer)

        try:
            threads = [threading.Thread(target=one) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert faults.fired("router-shard-timeout") == 2
        finally:
            faults.clear("router-shard-timeout")
        assert all(a[0] == 200 for a in got)
        assert len({a[2] for a in got}) == 1
        out[name] = sorted(a[1] for a in got)
        _same("/recommend", got[0][2], got[0][2])
    assert out["fast"] == ["coalesced"] * 7 + ["miss"]
    assert out["fast"] == out["ref"]


def test_pref_invalidates_the_users_entries(clusters):
    """``/pref`` through the router lands on the input topic; the speed
    layer's UP for that user evicts its cached answers, and the next one
    is a miss that sees the new vector — in both packages, and equal to
    the default router's answer."""
    fast, default, ref = (clusters[k] for k in ("fast", "default", "ref"))
    tb, jb = clusters["brokers"]
    path = "/recommend/u6?howMany=5"
    for router in (fast, ref):
        assert [_get(router.port, path)[1] for _ in range(2)] == \
            ["miss", "hit"]
    new = [0.9, -0.4, 0.3, 0.2, -0.7]
    for router, get_broker, producer_cls, broker, replicas in (
            (fast, tinproc.get_broker, tinproc.InProcTopicProducer, tb,
             clusters["t_replicas"]),
            (ref, jinproc.get_broker, jinproc.InProcTopicProducer, jb,
             clusters["j_replicas"])):
        topic = get_broker(broker)
        before = sum(topic.latest_offsets("FIn"))
        assert _post(router.port, "/pref/u6/i40", b"2.5") in (200, 204)
        assert sum(topic.latest_offsets("FIn")) == before + 1
        evicted = router.result_cache.stats()["invalidations"]
        producer = producer_cls(f"memory://{broker}", "FUp")
        producer.send("UP", json.dumps(["X", "u6", new, ["i40"]]))
        producer.close()
        _await(lambda: router.result_cache.stats()["invalidations"]
               > evicted, "the router's eviction")
        _await(lambda: all(np.allclose(
            r.model_manager.get_model().get_user_vector("u6"), new)
            for r in replicas), "the replicas' UP")
    after = [_get(router.port, path) for router in (fast, ref)]
    assert [a[1] for a in after] == ["miss", "miss"]
    assert after[0][2] == _get(default.port, path)[2]
    _same(path, after[0][2], after[1][2])
    assert "i40" not in [d["id"] for d in json.loads(after[0][2])]


def test_cli_router_async_serves_and_exits_on_sigint(tmp_path):
    """``python -m oryx_tpu_torch router --async`` serves its public door
    on the asyncio front end and exits 0 on SIGINT."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    conf = tmp_path / "router.conf"
    conf.write_text(f'oryx.update-topic.broker = "file://{tmp_path}/b"\n'
                    "oryx.input-topic.broker = null\n"
                    f"oryx.serving.api.port = {port}\n")
    log = tmp_path / "router.log"
    with open(log, "w", encoding="utf-8") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch", "router", "--async",
             "--conf", str(conf), "--device", "cpu"], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), stdout=log_f,
            stderr=subprocess.STDOUT)
    try:
        # no replica yet: the door answers 503, from the event loop
        _await(lambda: proc.poll() is None
               and _get(port, "/ready")[0] == 503, "the CLI's router")
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert "Router (async front end) listening on port" in log.read_text()
