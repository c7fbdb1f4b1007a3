"""The port's serving cluster on the CPU — two replicas (shards ``0/2``
and ``1/2``) behind the port's router — proves what the reference's
``tests/test_cluster_it.py`` proves of the reference's cluster:

1. router top-N equals the single-node exact top-N across the public
   endpoint surface (the same ids in the same order; scores within rtol
   1e-5 and atol 1e-6; fold-in scores within rtol 1e-4), a user and an
   item with the same id included;
2. a killed replica gives a partial answer (HTTP 200 with
   ``X-Oryx-Partial: shards=1/2``, inside the deadline) and exact
   answers again after it rejoins, with no router restart;
3. the chaos points ``router-shard-timeout`` and
   ``replica-heartbeat-drop``;
4. hedged failover inside the heartbeat TTL;
5. the write path onto the input topic, and the ``/metrics`` surface.

Beyond those, the port's router answers ``/recommend``,
``/recommendToAnonymous`` and ``/estimateForAnonymous`` like the
reference's router over reference replicas on the same records: the
same ids in the same order, ``/recommend`` scores within rtol 1e-5 and
atol 1e-6, fold-in scores within rtol 1e-4 and atol 1e-5 (the fold-in
parity of ``tests/test_torch_fold_in.py``).  Each package runs on its
own ``memory://`` broker carrying the same records."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from oryx_tpu.cluster.router import RouterLayer as JRouter
from oryx_tpu.common import config as jconfig
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JLayer
from oryx_tpu_torch.cluster.router import RouterLayer
from oryx_tpu_torch.cluster.sharding import shard_of
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.resilience import faults

BROKER = "torch-router"
N_USERS, N_ITEMS, F = 12, 60, 6
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _overlay(pkg, **extra):
    overlay = {
        "oryx.input-topic.broker": f"memory://{BROKER}",
        "oryx.input-topic.partitions": 1,
        "oryx.input-topic.message.topic": "RIn",
        "oryx.update-topic.broker": f"memory://{BROKER}",
        "oryx.update-topic.message.topic": "RUp",
        "oryx.serving.model-manager-class":
            f"{pkg}.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": f"{pkg}.serving.als",
        # fast cluster timings, so membership moves inside the budget
        "oryx.cluster.heartbeat-interval-ms": 60,
        "oryx.cluster.heartbeat-ttl-ms": 400,
        "oryx.cluster.hedge-after-ms": 50,
        "oryx.cluster.shard-timeout-ms": 5000,
        "oryx.resilience.retry.max-attempts": 2,
        "oryx.resilience.retry.initial-backoff-ms": 1,
        "oryx.resilience.retry.max-backoff-ms": 2,
        "oryx.resilience.breaker.reset-timeout-ms": 50,
    }
    overlay.update(extra)
    return overlay


def _records():
    """MODEL + UP records of a seeded model.  "dual" names both a user
    and an item; "sp ace" needs percent-encoding on the internal hop."""
    rng = np.random.default_rng(21)
    users = [f"u{j}" for j in range(N_USERS)] + ["dual", "sp ace"]
    items = [f"i{j}" for j in range(N_ITEMS)] + ["dual"]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", users)
    pmml_io.add_extension_content(doc, "YIDs", items)
    out = [("MODEL", pmml_io.to_string(doc))]
    for iid in items:
        out.append(("UP", json.dumps(
            ["Y", iid, rng.standard_normal(F).tolist()])))
    for uid in users:
        known = [items[k] for k in rng.choice(len(items), 4, replace=False)]
        if uid == "sp ace":
            known = []
        out.append(("UP", json.dumps(
            ["X", uid, rng.standard_normal(F).tolist(), known])))
    return out


def _get(port, path, headers=None, timeout=15):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), json.loads(r.read() or b"null")


def _ids(payload):
    return [d["id"] for d in payload]


def _await(predicate, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _ready(port):
    try:
        return _get(port, "/ready")[0] in (200, 204)
    except (urllib.error.HTTPError, urllib.error.URLError, OSError):
        return False


def _loaded(layer):
    """Every record replayed: all the expected ids are in the store."""
    model = layer.model_manager.get_model()
    return model is not None and model.get_fraction_loaded() >= 1.0


def _replica(shard, of=2, replica_id=None):
    overlay = _overlay("oryx_tpu_torch", **{
        "oryx.cluster.enabled": True, "oryx.cluster.shard": f"{shard}/{of}"})
    if replica_id:
        overlay["oryx.cluster.replica-id"] = replica_id
    layer = ServingLayer(tconfig.from_dict(overlay), port=0, device="cpu")
    layer.start()
    return layer


def _jreplica(shard):
    layer = JLayer(jconfig.from_dict(_overlay("oryx_tpu", **{
        "oryx.cluster.enabled": True, "oryx.cluster.shard": f"{shard}/2"})),
        port=0)
    layer.start()
    return layer


@pytest.fixture(scope="module")
def cluster():
    """The port's 2-shard cluster, a port single node and the port's
    router; the reference's 2-shard cluster and router beside them."""
    tbroker, jbroker = tinproc.get_broker(BROKER), jinproc.get_broker(BROKER)
    for key, msg in _records():
        tbroker.send("RUp", key, msg)
        jbroker.send("RUp", key, msg)
    layers = []
    try:
        replicas = [_replica(s) for s in range(2)]
        layers += replicas
        single = ServingLayer(tconfig.from_dict(_overlay("oryx_tpu_torch")),
                              port=0, device="cpu")
        single.start()
        router = RouterLayer(tconfig.from_dict(_overlay("oryx_tpu_torch")),
                             port=0, device="cpu")
        router.start()
        jreplicas = [_jreplica(s) for s in range(2)]
        jrouter = JRouter(jconfig.from_dict(_overlay("oryx_tpu")), port=0)
        jrouter.start()
        layers += [single, router, *jreplicas, jrouter]
        for layer in (*replicas, single, *jreplicas):
            _await(lambda: _loaded(layer), "the replay")
        for port in (router.port, single.port, jrouter.port):
            _await(lambda: _ready(port), "readiness")
        yield {"replicas": replicas, "single": single, "router": router,
               "jrouter": jrouter, "broker": tbroker, "layers": layers}
    finally:
        for layer in layers:
            try:
                layer.close()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        tinproc.drop_broker(BROKER)
        jinproc.drop_broker(BROKER)


def _assert_scored_alike(got, want, rtol=1e-5, atol=1e-6):
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([d["value"] for d in got],
                               [d["value"] for d in want],
                               rtol=rtol, atol=atol)


def test_router_top_n_equals_single_node_exact(cluster):
    single, router = cluster["single"], cluster["router"]
    users = sorted(single.model_manager.get_model().all_user_ids())
    assert len(users) == N_USERS + 2
    for uid in users:
        for hm in (3, 10):
            path = f"/recommend/{urllib.parse.quote(uid)}?howMany={hm}"
            _, h1, r1 = _get(router.port, path)
            _, _, r2 = _get(single.port, path)
            assert h1.get("X-Oryx-Partial") is None
            _assert_scored_alike(r1, r2)


def test_router_wider_endpoint_surface_matches_single_node(cluster):
    single, router = cluster["single"], cluster["router"]
    uid = "u1"
    i1, i2 = "i3", "i7"
    for path in (f"/similarity/{i1}/{i2}",
                 f"/similarityToItem/{i1}/{i2}",
                 f"/estimate/{uid}/{i1}/{i2}",
                 f"/because/{uid}/{i1}",
                 f"/mostSurprising/{uid}",
                 "/mostPopularItems", "/mostActiveUsers",
                 "/allUserIDs", f"/knownItems/{uid}",
                 "/popularRepresentativeItems"):
        _, _, r1 = _get(router.port, path)
        _, _, r2 = _get(single.port, path)
        if isinstance(r2, list) and r2 and isinstance(r2[0], dict) \
                and "value" in r2[0]:
            _assert_scored_alike(r1, r2)
        else:
            assert r1 == r2, path
    _, _, r1 = _get(router.port, f"/recommendToMany/{uid}/u2")
    _, _, r2 = _get(single.port, f"/recommendToMany/{uid}/u2")
    _assert_scored_alike(r1, r2)
    _, _, r1 = _get(router.port, "/allItemIDs")
    _, _, r2 = _get(single.port, "/allItemIDs")
    assert sorted(r1) == sorted(r2)
    # the fold-in routes: the router solves against the summed shard
    # Gramians
    for path in (f"/recommendToAnonymous/{i1}=2.0/{i2}",
                 f"/recommendWithContext/{uid}/{i1}=1.5"):
        _, _, r1 = _get(router.port, path)
        _, _, r2 = _get(single.port, path)
        _assert_scored_alike(r1, r2, rtol=1e-4, atol=1e-5)
    _, _, v1 = _get(router.port, f"/estimateForAnonymous/{i1}/{i2}")
    _, _, v2 = _get(single.port, f"/estimateForAnonymous/{i1}/{i2}")
    assert v1 == pytest.approx(v2, rel=1e-4, abs=1e-5)
    for path in ("/recommend/nosuchuser", f"/estimate/nosuchuser/{i1}",
                 f"/similarity/nosuchitem/{i1}"):
        with pytest.raises(urllib.error.HTTPError) as e1:
            _get(router.port, path)
        with pytest.raises(urllib.error.HTTPError) as e2:
            _get(single.port, path)
        assert e1.value.code == e2.value.code == 404, path


def test_estimate_with_user_item_id_collision(cluster):
    """"dual" names a user and an item: the router pairs the user
    vector with the item vector."""
    single, router = cluster["single"], cluster["router"]
    for path in ("/estimate/dual/dual", "/estimate/dual/dual/i0",
                 "/recommend/dual?howMany=5"):
        _, _, r1 = _get(router.port, path)
        _, _, r2 = _get(single.port, path)
        _assert_scored_alike(r1, r2)
    _, _, known = _get(router.port, "/knownItems/sp%20ace")
    assert known == []


@pytest.mark.parametrize("path,rtol,atol", [
    ("/recommend/u0?howMany=8", 1e-5, 1e-6),
    ("/recommend/dual?howMany=20", 1e-5, 1e-6),
    ("/recommend/u5?howMany=4&offset=3&considerKnownItems=true", 1e-5,
     1e-6),
    ("/recommendToAnonymous/i1=2.0/i2/i9=0.5?howMany=10", 1e-4, 1e-5),
    ("/recommendToAnonymous/dual?howMany=6", 1e-4, 1e-5),
    ("/estimateForAnonymous/i4/i1=2.0/i2", 1e-4, 1e-5),
    ("/estimateForAnonymous/dual/i5/i6=3.0", 1e-4, 1e-5),
])
def test_router_answers_like_the_reference_router(cluster, path, rtol,
                                                  atol):
    _, h1, got = _get(cluster["router"].port, path)
    _, h2, want = _get(cluster["jrouter"].port, path)
    assert h1.get("X-Oryx-Partial") is None
    assert h2.get("X-Oryx-Partial") is None
    if isinstance(want, list):
        _assert_scored_alike(got, want, rtol=rtol, atol=atol)
    else:
        assert got == pytest.approx(want, rel=rtol, abs=atol)


def test_kill_replica_partial_then_rejoin_exact(cluster):
    single, router = cluster["single"], cluster["router"]
    _, _, full = _get(single.port, "/recommend/u0?howMany=6")
    victim = cluster["replicas"][1]
    victim.close()
    try:
        def partial_seen():
            _, h, _ = _get(router.port, "/recommend/u0?howMany=6",
                           headers={"X-Deadline-Ms": "10000"})
            return h.get("X-Oryx-Partial") == "shards=1/2"
        _await(partial_seen, "a partial answer after the kill")
        t0 = time.monotonic()
        status, headers, partial = _get(router.port,
                                        "/recommend/u0?howMany=6",
                                        headers={"X-Deadline-Ms": "10000"})
        assert status == 200 and time.monotonic() - t0 < 10.0
        assert headers.get("X-Oryx-Partial") == "shards=1/2"
        # exact over the surviving catalog
        _, _, deep = _get(single.port, "/recommend/u0?howMany=100")
        survivors = [i for i in _ids(deep) if shard_of(i, 2) == 0]
        assert _ids(partial) == survivors[:len(partial)]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(router.port, "/ready")
        assert e.value.code == 503
        _, _, m = _get(router.port, "/metrics")
        assert m["counters"]["partial_answers"] >= 1
        assert m["cluster"]["covered_shards"] == [0]
    finally:
        cluster["replicas"][1] = _replica(1)
        cluster["layers"].append(cluster["replicas"][1])
    _await(lambda: _loaded(cluster["replicas"][1]), "the rejoin's replay")
    _await(lambda: _ready(router.port), "readiness after the rejoin")

    def exact_again():
        _, h, got = _get(router.port, "/recommend/u0?howMany=6")
        return h.get("X-Oryx-Partial") is None and _ids(got) == _ids(full)
    _await(exact_again, "exact answers after the rejoin")


def test_router_shard_timeout_fault_degrades_to_partial(cluster):
    router = cluster["router"]
    _, _, before = _get(router.port, "/metrics")
    faults.inject("router-shard-timeout", mode="delay", times=1,
                  delay_sec=2.0)
    t0 = time.monotonic()
    status, headers, _ = _get(router.port, "/recommend/u0?howMany=6",
                              headers={"X-Deadline-Ms": "900"})
    assert status == 200 and time.monotonic() - t0 < 2.0
    assert headers.get("X-Oryx-Partial") == "shards=1/2"
    assert faults.fired("router-shard-timeout") == 1
    _, _, after = _get(router.port, "/metrics")
    assert after["counters"]["partial_answers"] > \
        before["counters"].get("partial_answers", 0)


def test_heartbeat_drop_ages_replica_out_and_back(cluster):
    router = cluster["router"]
    faults.inject("replica-heartbeat-drop", mode="drop", times=None)

    def all_aged_out():
        try:
            _get(router.port, "/recommend/u0?howMany=4",
                 headers={"X-Deadline-Ms": "3000"})
            return False
        except urllib.error.HTTPError as e:
            return e.code == 503
    _await(all_aged_out, "silent replicas aged out")
    assert faults.fired("replica-heartbeat-drop") > 0
    faults.clear("replica-heartbeat-drop")

    def recovered():
        try:
            _, h, _ = _get(router.port, "/recommend/u0?howMany=4")
            return h.get("X-Oryx-Partial") is None
        except urllib.error.HTTPError:
            return False
    _await(recovered, "heartbeats resumed")


def test_hedged_failover_within_replica_ttl(cluster):
    single, router = cluster["single"], cluster["router"]
    extra = _replica(0, replica_id="shard0-sibling")
    try:
        _await(lambda: len(_get(router.port, "/metrics")[2]["cluster"]
                           ["membership"]["replicas"]) >= 3,
               "the sibling registered")
        _await(lambda: _ready(router.port), "readiness")
        extra.close()  # dead, but inside its TTL window
        _, _, expected = _get(single.port, "/recommend/u0?howMany=5")
        for _ in range(6):
            status, h, got = _get(router.port, "/recommend/u0?howMany=5",
                                  headers={"X-Deadline-Ms": "8000"})
            assert status == 200 and h.get("X-Oryx-Partial") is None
            assert _ids(got) == _ids(expected)
    finally:
        extra.close()


def test_write_path_flows_through_router_to_input_topic(cluster):
    router, broker = cluster["router"], cluster["broker"]
    before = sum(broker.latest_offsets("RIn"))
    req = urllib.request.Request(
        f"http://127.0.0.1:{router.port}/pref/u0/i1", data=b"2.5",
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status in (200, 204)
    req = urllib.request.Request(
        f"http://127.0.0.1:{router.port}/ingest",
        data=b"u1,i2,1.0\nu2,i3,0.5\n", method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
    assert sum(broker.latest_offsets("RIn")) == before + 3


def test_router_metrics_surface(cluster):
    router = cluster["router"]
    _, _, m = _get(router.port, "/metrics")
    assert m["cluster"]["membership"]["shards"] == 2
    assert any(r["shard"] == 0 and r["live"]
               for r in m["cluster"]["membership"]["replicas"].values())
    assert "GET /recommend/{userID}" in m["routes"]
    assert "scatter" in m["cluster"]
    assert any(k.startswith("router-replica[") for k in m["resilience"])
    # the cluster-wide Prometheus merge scrapes both live replicas
    with urllib.request.urlopen(
            f"http://127.0.0.1:{router.port}/metrics?format=prometheus",
            timeout=15) as r:
        text = r.read().decode()
    assert 'tier="router"' in text and 'tier="replica"' in text
    _, _, topo = _get(router.port, "/admin/topology")
    assert topo["merged_of"] == 2
