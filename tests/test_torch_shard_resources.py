"""Two port replicas (shards ``0/2`` and ``1/2``, on the CPU) and two
reference replicas serve the same published model: a MODEL-REF whose
manifest names eight slices, then UP records that move a few items, add
new ones and add users.  Every ``/shard/*`` route answers alike: the
same ids in the same order and the same ordinals, scores within rtol
1e-5 and atol 1e-6 (float32 dots summed in another order), each
shard's ``/shard/yty`` within rtol 1e-5 of the reference's both from
the manifest's Gramians and from the store after a Y write, and the two
shards' Gramians summing to the whole catalog's within rtol 1e-5.  Each
package has its own ``memory://`` broker with the same records, so
neither reader sees the other's heartbeats land mid-read."""

from __future__ import annotations

import http.client
import json
import os
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.app.als import slices as tslices
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer

N_ITEMS, N_USERS, F, RING = 400, 16, 8, 8
WAIT_S = 60.0
BROKER = "shard-resources"
TOPIC = "ShardUp"


def _overlay(pkg, shard):
    return {
        "oryx.serving.model-manager-class":
            f"{pkg}.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": f"{pkg}.serving.als",
        "oryx.input-topic.broker": None,
        "oryx.update-topic.broker": f"memory://{BROKER}",
        "oryx.update-topic.message.topic": TOPIC,
        "oryx.cluster.enabled": True,
        "oryx.cluster.shard": f"{shard}/2",
        "oryx.cluster.heartbeat-interval-ms": 100,
    }


def _get(port, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Accept": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status >= 300:
            return resp.status, raw
        return resp.status, json.loads(raw or b"null")
    finally:
        conn.close()


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _catalog():
    rng = np.random.default_rng(14)
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    x_ids = [f"u{j}" for j in range(N_USERS)]
    Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
    X = rng.standard_normal((N_USERS, F)).astype(np.float32)
    known = {u: sorted(y_ids[k] for k in rng.choice(N_ITEMS, 6,
                                                     replace=False))
             for u in x_ids}
    # UP records after the load: moved items, new items, new users
    ups = [["Y", y_ids[k], rng.standard_normal(F).tolist()]
           for k in rng.choice(N_ITEMS, 10, replace=False)]
    ups += [["Y", f"new{j}", rng.standard_normal(F).tolist()]
            for j in range(12)]
    ups += [["X", f"nu{j}", rng.standard_normal(F).tolist(),
             [f"new{j}", y_ids[j]]] for j in range(3)]
    ups += [["X", "zlast", rng.standard_normal(F).tolist(), []]]
    return y_ids, Y, x_ids, X, known, ups


def _publish(model_dir, catalog):
    y_ids, Y, x_ids, X, known, _ = catalog
    os.makedirs(model_dir, exist_ok=True)
    pmml_path = os.path.join(model_dir, "model.pmml.xml")
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    with open(pmml_path, "w", encoding="utf-8") as f:
        f.write(pmml_io.to_string(doc))
    slim = tslices.publish_sliced(model_dir, y_ids, Y, x_ids, X, known,
                                  RING)
    return tslices.model_ref_message(pmml_path, model_dir, slim)


def _send_all(brokers, key, message):
    for b in brokers:
        b.send(TOPIC, key, message)


def _loaded_with(layer, last_user):
    mgr = layer.model_manager
    model = mgr.get_model()
    return (model is not None and mgr.slice_loads > 0
            and model.get_user_vector(last_user) is not None)


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard-resources")
    catalog = _catalog()
    ref_msg = _publish(str(tmp / "model"), catalog)
    brokers = (jinproc.get_broker(BROKER), tinproc.get_broker(BROKER))
    layers = []
    try:
        for shard in (0, 1):
            layers.append((
                JaxLayer(jconfig.from_dict(_overlay("oryx_tpu", shard)),
                         port=0),
                TorchLayer(tconfig.from_dict(_overlay("oryx_tpu_torch",
                                                      shard)),
                           port=0, device="cpu")))
        for pair in layers:
            for layer in pair:
                layer.start()
        _send_all(brokers, "MODEL-REF", ref_msg)
        # the last user of the artifact marks the slice load's end
        for pair in layers:
            for layer in pair:
                _wait(lambda: _loaded_with(layer, f"u{N_USERS - 1}"),
                      "the slice load")
        yield {"layers": layers, "catalog": catalog, "brokers": brokers}
    finally:
        for pair in layers:
            for layer in pair:
                layer.close()
        jinproc.drop_broker(BROKER)
        tinproc.drop_broker(BROKER)


def _strip(envelope):
    """An envelope without the replica's own queue-wait reading."""
    return {k: v for k, v in envelope.items() if k != "queue_wait_ms"}


def _assert_rows_alike(got, want):
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-5, atol=1e-6)


def _full_gramian(rows):
    m = np.asarray(rows, dtype=np.float64)
    return m.T @ m


def _yty(port):
    status, env = _get(port, "/shard/yty")
    assert status == 200
    return np.asarray(env["yty"], dtype=np.float64), env


def test_manifest_load_gives_the_reference_shards_and_gramians(replicas):
    y_ids, Y, *_ = replicas["catalog"]
    total = np.zeros((F, F))
    for jl, tl in replicas["layers"]:
        jm, tm = jl.model_manager, tl.model_manager
        assert tm.item_ordinals == jm.item_ordinals
        assert tm._ordinal_next == jm._ordinal_next == N_ITEMS
        assert sorted(tm.model.all_item_ids()) == \
            sorted(jm.model.all_item_ids())
        assert tm.slice_loads == jm.slice_loads == RING // 2
        (jy, jenv), (ty, tenv) = _yty(jl.port), _yty(tl.port)
        np.testing.assert_allclose(ty, jy, rtol=1e-5)
        assert {k: tenv[k] for k in ("shard", "of", "generation",
                                     "features", "implicit")} == \
            {k: jenv[k] for k in ("shard", "of", "generation",
                                  "features", "implicit")}
        total += ty
    held = np.round(Y.astype(np.float64), 8).astype(np.float32)
    np.testing.assert_allclose(total, _full_gramian(held), rtol=1e-5)


@pytest.fixture(scope="module")
def updated(replicas):
    """The UP records after the load: each replica applies them."""
    *_, ups = replicas["catalog"]
    for up in ups:
        _send_all(replicas["brokers"], "UP", json.dumps(up))
    for pair in replicas["layers"]:
        for layer in pair:
            _wait(lambda: _loaded_with(layer, "zlast"), "the UP records")
    return replicas


def test_up_records_give_the_reference_ordinals_and_store_gramians(updated):
    y_ids, Y, *_, ups = updated["catalog"]
    rows = {i: np.round(Y[j].astype(np.float64), 8).astype(np.float32)
            for j, i in enumerate(y_ids)}
    for up in ups:
        if up[0] == "Y":
            rows[up[1]] = np.asarray(up[2], dtype=np.float32)
    total = np.zeros((F, F))
    for jl, tl in updated["layers"]:
        jm, tm = jl.model_manager, tl.model_manager
        assert tm.item_ordinals == jm.item_ordinals
        assert tm.skipped_remote_items == jm.skipped_remote_items
        assert tm.partial_yty() is None and jm.partial_yty() is None
        (jy, _), (ty, _) = _yty(jl.port), _yty(tl.port)
        np.testing.assert_allclose(ty, jy, rtol=1e-5)
        total += ty
    np.testing.assert_allclose(total, _full_gramian(list(rows.values())),
                               rtol=1e-5)


def test_shard_meta_answers_alike(updated):
    for jl, tl in updated["layers"]:
        (js, jenv), (ts, tenv) = (_get(p, "/shard/meta")
                                  for p in (jl.port, tl.port))
        assert js == ts == 200
        assert _strip(tenv) == _strip(jenv)
        assert tenv["ready"] and tenv["of"] == 2


def _users():
    return [f"u{j}" for j in range(0, N_USERS, 3)] + ["nu1", "zlast"]


@pytest.mark.parametrize("query", ["howMany=5", "howMany=12",
                                   "howMany=7&considerKnownItems=true"])
def test_shard_recommend_answers_alike(updated, query):
    for jl, tl in updated["layers"]:
        for uid in _users():
            path = f"/shard/recommend/{uid}?{query}"
            (js, jenv), (ts, tenv) = (_get(p, path)
                                      for p in (jl.port, tl.port))
            assert js == ts == 200, (path, ts, tenv)
            _assert_rows_alike(tenv["rows"], jenv["rows"])
            assert _strip({**tenv, "rows": None}) == \
                _strip({**jenv, "rows": None})
        for bad in ("/shard/recommend/nobody", "/shard/recommend/u0?howMany=0"):
            assert _get(jl.port, bad)[0] == _get(tl.port, bad)[0]


def _queries(catalog):
    y_ids, Y, x_ids, X, known, _ = catalog
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(F).tolist() for _ in range(3)]
    return [
        {"kind": "recommend", "userID": "u2", "howMany": 9},
        {"kind": "recommend", "userID": "u5", "howMany": 4,
         "considerKnownItems": True},
        {"kind": "recommendToMany", "userIDs": ["u1", "u7", "nobody"],
         "howMany": 8},
        {"kind": "byVector", "vectors": vecs, "howMany": 6,
         "exclude": ["i1", "i2"]},
        {"kind": "byVector", "vectors": vecs[:1], "howMany": 6,
         "lowest": True, "excludeKnownOf": "u3"},
        {"kind": "byVector", "vectors": vecs[:2], "howMany": 5,
         "cosine": True},
        {"kind": "because", "userID": "u4", "vector": vecs[0],
         "howMany": 4},
        {"kind": "mostSurprising", "userID": "u6", "howMany": 3},
    ]


@pytest.mark.parametrize("index", range(8))
def test_shard_query_kinds_answer_alike(updated, index):
    q = _queries(updated["catalog"])[index]
    body = json.dumps(q).encode()
    for jl, tl in updated["layers"]:
        (js, jenv), (ts, tenv) = (_get(p, "/shard/query", "POST", body)
                                  for p in (jl.port, tl.port))
        assert js == ts == 200, (q, ts, tenv)
        if "multi" in jenv:
            assert len(tenv["multi"]) == len(jenv["multi"])
            for got, want in zip(tenv["multi"], jenv["multi"]):
                _assert_rows_alike(got, want)
        else:
            _assert_rows_alike(tenv["rows"], jenv["rows"])
        rest = ("rows", "multi", "queue_wait_ms")
        assert {k: v for k, v in tenv.items() if k not in rest} == \
            {k: v for k, v in jenv.items() if k not in rest}


def test_shard_query_all_item_ids_and_errors_answer_alike(updated):
    for jl, tl in updated["layers"]:
        body = json.dumps({"kind": "allItemIDs"}).encode()
        (js, jenv), (ts, tenv) = (_get(p, "/shard/query", "POST", body)
                                  for p in (jl.port, tl.port))
        assert js == ts == 200
        assert sorted(tenv["ids"]) == sorted(jenv["ids"])
        for bad in (b"not json", b'{"kind": "nope"}',
                    b'{"kind": "recommend", "userID": "nobody", '
                    b'"howMany": 3}'):
            assert _get(jl.port, "/shard/query", "POST", bad)[0] == \
                _get(tl.port, "/shard/query", "POST", bad)[0]


def test_shard_vectors_answer_alike(updated):
    y_ids = updated["catalog"][0]
    body = json.dumps({"users": ["u0", "nu2", "nobody"],
                       "items": y_ids[:20] + ["new3", "nothing"]}).encode()
    for jl, tl in updated["layers"]:
        (js, jenv), (ts, tenv) = (_get(p, "/shard/vectors", "POST", body)
                                  for p in (jl.port, tl.port))
        assert js == ts == 200
        for side in ("users", "items"):
            assert tenv[side].keys() == jenv[side].keys()
            for k, v in jenv[side].items():
                if v is None:
                    assert tenv[side][k] is None, k
                else:
                    np.testing.assert_array_equal(tenv[side][k], v)
        # items answer only where local; users everywhere
        assert tenv["users"]["u0"] is not None
