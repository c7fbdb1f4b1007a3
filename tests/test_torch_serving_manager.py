"""The port's ALS serving model manager against the reference's: fed
the same update-topic messages (inline MODEL + UP, MODEL-REF with a
slice manifest, a corrupt slice, a second generation, a feature-count
change), both reach equal model states, counters and answers, and the
port installs its measured route once per store capacity."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from oryx_tpu.app.als import slices as jslices
from oryx_tpu.app.als import update as jupdate
from oryx_tpu.app.als.serving_manager import \
    ALSServingModelManager as JaxManager
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als import kernel_router
from oryx_tpu_torch.app.als.serving_manager import \
    ALSServingModelManager as TorchManager
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from oryx_tpu_torch.resilience import faults as tfaults

RING = 8
OVERLAY = {"oryx.serving.model-manager-class": "unused",
           "oryx.input-topic.broker": None,
           "oryx.update-topic.broker": None}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


@pytest.fixture
def routes(monkeypatch):
    """Every route the port measures, as (capacity, route)."""
    seen = []
    real = kernel_router.measure_routes

    def spy(model, *a, **kw):
        r = real(model, *a, **kw)
        seen.append((len(model.Y.row_ids()), r))
        return r

    monkeypatch.setattr(kernel_router, "measure_routes", spy)
    return seen


def _managers():
    return (JaxManager(jconfig.from_dict(OVERLAY)),
            TorchManager(tconfig.from_dict(OVERLAY), device="cpu"))


def _catalog(seed, n_items=300, n_users=12, features=6, prefix="i"):
    rng = np.random.default_rng(seed)
    y_ids = [f"{prefix}{j}" for j in range(n_items)]
    x_ids = [f"u{j}" for j in range(n_users)]
    Y = rng.standard_normal((n_items, features)).astype(np.float32)
    X = rng.standard_normal((n_users, features)).astype(np.float32)
    known = {u: sorted(y_ids[k] for k in rng.choice(n_items, 5,
                                                     replace=False))
             for u in x_ids}
    return y_ids, Y, x_ids, X, known


def _pmml(features, x_ids, y_ids) -> str:
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", features)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    return pmml_io.to_string(doc)


def _up_stream(y_ids, Y, x_ids, X, known) -> list[tuple[str, str]]:
    msgs = [(KEY_UP, json.dumps(["Y", i, [float(v) for v in row]]))
            for i, row in zip(y_ids, Y)]
    msgs += [(KEY_UP, json.dumps(["X", u, [float(v) for v in row],
                                  known.get(u, [])]))
             for u, row in zip(x_ids, X)]
    return msgs


def _publish(tmp_path, name, y_ids, Y, x_ids, X, known, monolithic=False):
    model_dir = str(tmp_path / name)
    os.makedirs(model_dir, exist_ok=True)
    pmml_path = model_dir + "/model.pmml.xml"
    with open(pmml_path, "w", encoding="utf-8") as f:
        f.write(_pmml(Y.shape[1], x_ids, y_ids))
    slim = jslices.publish_sliced(model_dir, y_ids, Y, x_ids, X, known,
                                  RING)
    if monolithic:
        jupdate.save_features(model_dir + "/Y", y_ids, Y)
        jupdate.save_features(model_dir + "/X", x_ids, X)
    return jslices.model_ref_message(pmml_path, model_dir, slim)


def _feed(managers, msgs):
    for key, msg in msgs:
        for m in managers:
            m.consume_key_message(key, msg)


def _assert_same(jm, tm, queries_seed=0):
    j, t = jm.model, tm.model
    assert t.features == j.features
    for store in ("X", "Y"):
        js, ts = getattr(j, store), getattr(t, store)
        assert sorted(ts.all_ids()) == sorted(js.all_ids())
        for id_ in js.all_ids():
            assert np.array_equal(ts.get_vector(id_), js.get_vector(id_)), \
                (store, id_)
        assert ts.row_ids() == js.row_ids()
    for u in j.X.all_ids():
        assert t.get_known_items(u) == j.get_known_items(u)
    assert t.get_fraction_loaded() == j.get_fraction_loaded()
    for name in ("rejected_updates", "rejected_models", "slice_loads",
                 "slice_load_fallbacks", "generation"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.model_load_s > 0) == (jm.model_load_s > 0)
    if len(j.Y) and len(j.X):
        users = sorted(j.X.all_ids())[:6]
        Q = np.asarray([j.get_user_vector(u) for u in users])
        excl = [j.get_known_items(u) for u in users]
        want = j.top_n_batch(10, Q, excl)
        got = t.top_n_batch(10, Q, excl)
        for w, g in zip(want, got):
            assert [i for i, _ in g] == [i for i, _ in w]
            np.testing.assert_allclose([v for _, v in g],
                                       [v for _, v in w], rtol=1e-5)


def _once_per_capacity(routes):
    measured = [cap for cap, r in routes if r is not None]
    assert measured and len(measured) == len(set(measured)), routes


def test_inline_model_then_up_replay(routes):
    jm, tm = _managers()
    y_ids, Y, x_ids, X, known = _catalog(1)
    _feed((jm, tm), [(KEY_MODEL, _pmml(6, x_ids, y_ids))])
    assert tm.model.get_fraction_loaded() == jm.model.get_fraction_loaded()
    _feed((jm, tm), _up_stream(y_ids, Y, x_ids, X, known))
    # poison records are refused and counted alike
    _feed((jm, tm), [(KEY_UP, '["Y","bad",[1.0]]'),
                     (KEY_UP, '["X","u0",[NaN,1,1,1,1,1]]'),
                     (KEY_UP, "not json")])
    _assert_same(jm, tm)
    assert tm.rejected_updates == 3 and tm.model_load_s > 0
    _once_per_capacity(routes)
    route = tm.model.metrics()["kernel_route"]
    assert route["capacity"] == len(tm.model.Y.row_ids())
    assert "errors" not in route


def test_up_before_any_model_is_ignored():
    jm, tm = _managers()
    _feed((jm, tm), [(KEY_UP, '["Y","i0",[1.0,2.0]]')])
    assert jm.model is None and tm.model is None


def test_model_ref_with_manifest(tmp_path, routes):
    jm, tm = _managers()
    y_ids, Y, x_ids, X, known = _catalog(2)
    _feed((jm, tm), [(KEY_MODEL_REF,
                      _publish(tmp_path, "g1", y_ids, Y, x_ids, X, known))])
    assert tm.slice_loads == RING and tm.slice_load_fallbacks == 0
    assert tm.model.get_fraction_loaded() == 1.0
    _assert_same(jm, tm)
    _once_per_capacity(routes)


def test_corrupt_slice_falls_back_to_the_monolithic_artifacts(tmp_path):
    jm, tm = _managers()
    y_ids, Y, x_ids, X, known = _catalog(3)
    msg = _publish(tmp_path, "g1", y_ids, Y, x_ids, X, known,
                   monolithic=True)
    jfaults.inject("store-slice-missing", mode="error", times=1)
    tfaults.inject("store-slice-missing", mode="error", times=1)
    _feed((jm, tm), [(KEY_MODEL_REF, msg)])
    assert tm.slice_load_fallbacks == jm.slice_load_fallbacks == 1
    assert tfaults.fired("store-slice-missing") == 1
    assert len(tm.model.Y) == len(y_ids)
    _assert_same(jm, tm)


def test_missing_model_document_is_counted(tmp_path):
    jm, tm = _managers()
    _feed((jm, tm), [(KEY_MODEL_REF, str(tmp_path / "none.pmml.xml")),
                     (KEY_MODEL, "<PMML unclosed"),
                     (KEY_MODEL, "<PMML/>")])
    assert tm.rejected_models == jm.rejected_models == 3
    assert tm.model is None


def test_second_generation_retains_part_of_the_catalog(tmp_path, routes):
    jm, tm = _managers()
    y_ids, Y, x_ids, X, known = _catalog(4)
    _feed((jm, tm), [(KEY_MODEL_REF,
                      _publish(tmp_path, "g1", y_ids, Y, x_ids, X, known))])
    # generation 2 keeps two thirds of the items and adds new ones; the
    # retain drops the rest once the UP tail is replayed
    keep = y_ids[:200]
    new_ids, NewY, _, _, _ = _catalog(5, n_items=50, prefix="n")
    y2 = keep + new_ids
    _feed((jm, tm), [(KEY_MODEL, _pmml(6, x_ids, y2))])
    _feed((jm, tm), _up_stream(new_ids, NewY, x_ids[:3], X[:3] + 1.0,
                               {u: new_ids[:2] for u in x_ids[:3]}))
    _feed((jm, tm), [(KEY_MODEL, _pmml(6, x_ids, y2))])
    _assert_same(jm, tm)
    assert set(tm.model.Y.all_ids()) == set(y2)
    assert tm.generation == 3
    _once_per_capacity(routes)


def test_feature_count_change_makes_a_new_model(tmp_path):
    jm, tm = _managers()
    y_ids, Y, x_ids, X, known = _catalog(6)
    _feed((jm, tm), [(KEY_MODEL_REF,
                      _publish(tmp_path, "g1", y_ids, Y, x_ids, X, known))])
    first = tm.model
    y2, Y2, x2, X2, k2 = _catalog(7, features=4)
    _feed((jm, tm), [(KEY_MODEL_REF,
                      _publish(tmp_path, "g2", y2, Y2, x2, X2, k2))])
    assert tm.model is not first and tm.model.features == 4
    _assert_same(jm, tm)


def test_unsupported_settings_are_refused():
    # the IVF index is supported now; an invalid ANN setting is refused
    for key, val in (("oryx.als.ann.nprobe", 0),
                     ("oryx.serving.api.item-shards", 3),
                     ("oryx.als.rescorer-provider-class", "x.Y"),
                     ("oryx.serving.api.int8-selection", "maybe")):
        with pytest.raises(ValueError):
            TorchManager(tconfig.from_dict({**OVERLAY, key: val}),
                         device="cpu")
