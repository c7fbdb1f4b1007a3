"""The port's k-means app (``oryx_tpu_torch/app/kmeans``) against the
reference's (``oryx_tpu/app/kmeans``) on the same seeded inputs, the port
on the CPU:

- ``ClusterInfo.update`` and the batch assignment against
  ``closest_cluster``;
- ``random``-initialized training: the same centers within rtol 1e-5 and
  the same counts on separated blobs; ``k-means||`` (its oversampling on a
  torch generator, so not the reference's bits) recovers the blobs and
  survives large-magnitude features;
- the four evaluation metrics within rtol 1e-5 for the same clusters and
  points; the PMML bytes identical;
- ``KMeansUpdate`` builds and evaluates, and refuses what it must; the
  speed manager's UP messages identical; the serving manager handles
  MODEL and UP; the cluster conversion round-trips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.app.kmeans import common as jcommon
from oryx_tpu.app.kmeans import evaluation as jeval
from oryx_tpu.app.kmeans import pmml as jpmml
from oryx_tpu.app.kmeans import trainer as jtrainer
from oryx_tpu.app.kmeans.serving import \
    KMeansServingModelManager as JaxServing
from oryx_tpu.app.kmeans.speed import KMeansSpeedModelManager as JaxSpeed
from oryx_tpu.app.schema import InputSchema as JaxSchema
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml_io
from oryx_tpu_torch import convert
from oryx_tpu_torch.app.kmeans import common as tcommon
from oryx_tpu_torch.app.kmeans import evaluation as teval
from oryx_tpu_torch.app.kmeans import pmml as tpmml
from oryx_tpu_torch.app.kmeans import trainer as ttrainer
from oryx_tpu_torch.app.kmeans.serving import \
    KMeansServingModelManager as TorchServing
from oryx_tpu_torch.app.kmeans.speed import \
    KMeansSpeedModelManager as TorchSpeed
from oryx_tpu_torch.app.kmeans.update import KMeansUpdate
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka.api import KEY_MODEL, KEY_UP, KeyMessage

RTOL = 1e-5


def _conf(n=2, **extra):
    conf = {"oryx.input-schema.num-features": n,
            "oryx.input-schema.numeric-features": [str(i) for i in range(n)],
            "oryx.serving.model-manager-class": "unused"}
    conf.update(extra)
    return conf


def _blobs(n_per=50, seed=0, dims=2, k=3, scale=10.0):
    rng = np.random.default_rng(seed)
    cs = scale * rng.standard_normal((k, dims))
    if dims == 2 and k == 3:
        cs = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    pts = np.concatenate([c + rng.standard_normal((n_per, dims)) * 0.5
                          for c in cs]).astype(np.float32)
    return pts, cs


def _pair_clusters(centers, counts=None):
    counts = counts or [1] * len(centers)
    return ([jcommon.ClusterInfo(i, c, n)
             for i, (c, n) in enumerate(zip(centers, counts))],
            [tcommon.ClusterInfo(i, c, n)
             for i, (c, n) in enumerate(zip(centers, counts))])


def test_cluster_info_update_matches_reference():
    j = jcommon.ClusterInfo(0, [1.0, 1.0], 2)
    t = tcommon.ClusterInfo(0, [1.0, 1.0], 2)
    for p, n in (([4.0, 4.0], 1), ([-2.5, 0.125], 7), ([1e3, -1e3], 3)):
        j.update(p, n)
        t.update(p, n)
        np.testing.assert_array_equal(t.center, j.center)
        assert t.count == j.count
    assert repr(t) == repr(j)
    with pytest.raises(ValueError):
        tcommon.ClusterInfo(0, [], 1)
    with pytest.raises(ValueError):
        tcommon.ClusterInfo(0, [1.0], 0)


def test_assign_points_against_closest_cluster_and_reference():
    pts, _ = _blobs(n_per=200, dims=5, k=7, seed=3)
    rng = np.random.default_rng(4)
    cs = (pts[rng.choice(len(pts), 7, replace=False)]
          + 0.1).astype(np.float32)
    _, tclusters = _pair_clusters(cs)
    idx, dist = tcommon.assign_points(pts, cs, device="cpu")
    jidx, jdist = jcommon.assign_points(pts, cs)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, jidx)
    # both expand ||p||^2 - 2 p.c + ||c||^2 in float32, summed in other
    # orders: the squared distances agree to a few ulps of ||p||^2
    scale = float((pts.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(dist.astype(np.float64) ** 2,
                               jdist.astype(np.float64) ** 2,
                               rtol=0, atol=8 * 2.0 ** -23 * scale)
    for p, i, d in zip(pts[::37], idx[::37], dist[::37]):
        ci, cd = tcommon.closest_cluster(tclusters, p)
        assert ci.id == i
        np.testing.assert_allclose(cd, d, rtol=1e-4)


def test_features_from_tokens_and_parse_to_matrix():
    conf = {"oryx.input-schema.feature-names": ["id", "a", "b"],
            "oryx.input-schema.id-features": ["id"],
            "oryx.input-schema.numeric-features": ["a", "b"]}
    js = JaxSchema(jconfig.from_dict(conf))
    ts = InputSchema(tconfig.from_dict(conf))
    assert ts.num_predictors == js.num_predictors == 2
    rows = [["x1", "2.0", "3.0"], ["x2", "-1", "0.5"]]
    np.testing.assert_array_equal(tcommon.parse_to_matrix(rows, ts),
                                  jcommon.parse_to_matrix(rows, js))
    np.testing.assert_array_equal(
        tcommon.features_from_tokens(rows[0], ts), [2.0, 3.0])


@pytest.mark.parametrize("dims,k,iterations", [(2, 3, 20), (6, 8, 10)])
def test_random_init_training_matches_reference(dims, k, iterations):
    pts, _ = _blobs(n_per=300, dims=dims, k=k, seed=dims)
    want = jtrainer.train_kmeans(pts, k, iterations, runs=2,
                                 initialization="random", seed=42)
    got = ttrainer.train_kmeans(pts, k, iterations, runs=2,
                                initialization="random", seed=42,
                                device="cpu")
    assert [c.id for c in got] == [c.id for c in want]
    np.testing.assert_allclose(np.stack([c.center for c in got]),
                               np.stack([c.center for c in want]),
                               rtol=RTOL, atol=RTOL)
    assert [c.count for c in got] == [c.count for c in want]


@pytest.mark.parametrize("init", ["k-means||", "random"])
def test_train_kmeans_recovers_blobs(init):
    pts, cs = _blobs()
    clusters = ttrainer.train_kmeans(pts, k=3, iterations=20, runs=2,
                                     initialization=init, seed=42,
                                     device="cpu")
    matched = set()
    for want in cs:
        dists = [float(np.linalg.norm(c.center - want)) for c in clusters]
        j = int(np.argmin(dists))
        assert dists[j] < 0.5 and j not in matched
        matched.add(j)
    assert sum(c.count for c in clusters) == len(pts)


def test_kmeans_parallel_large_magnitude_features():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    pts[:, 0] += 1.7e9
    clusters = ttrainer.train_kmeans(pts, k=3, iterations=3, seed=4,
                                     device="cpu")
    assert len(clusters) == 3
    assert all(np.isfinite(c.center).all() for c in clusters)


def test_trainer_refuses_bad_arguments():
    pts, _ = _blobs(n_per=2)
    with pytest.raises(ValueError):
        ttrainer.train_kmeans(pts, 1, 3, device="cpu")
    with pytest.raises(ValueError):
        ttrainer.train_kmeans(pts[:2], 3, 3, device="cpu")
    with pytest.raises(ValueError):
        ttrainer.train_kmeans(pts, 2, 3, initialization="nope",
                              device="cpu")


@pytest.mark.parametrize("strategy", jeval.EVAL_STRATEGIES)
@pytest.mark.parametrize("quality", ["good", "bad"])
def test_evaluation_metrics_match_reference(strategy, quality):
    pts, cs = _blobs(n_per=120, seed=9)
    if quality == "bad":
        cs = np.array([[5.0, 5.0], [5.2, 5.0], [4.8, 5.2]])
    jc, tc = _pair_clusters(cs)
    want = jeval.evaluate(strategy, jc, pts)
    got = teval.evaluate(strategy, tc, pts, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_silhouette_sample_and_singletons_match_reference(monkeypatch):
    pts, cs = _blobs(n_per=40, seed=11)
    cs = np.concatenate([cs, [[30.0, 30.0]]])   # an empty cluster
    pts = np.concatenate([pts, [[-20.0, -20.0]]]).astype(np.float32)
    cs = np.concatenate([cs, [[-20.0, -20.0]]])  # a singleton
    jc, tc = _pair_clusters(cs)
    np.testing.assert_allclose(
        teval.silhouette_coefficient(tc, pts, device="cpu"),
        jeval.silhouette_coefficient(jc, pts), rtol=RTOL)
    monkeypatch.setattr(teval, "_CHUNK", 7)
    # the sample's seed: the same on both sides
    from oryx_tpu.common.rand import RandomManager as JaxRandom
    from oryx_tpu_torch.common.rand import RandomManager as TorchRandom
    for cls in (JaxRandom, TorchRandom):
        monkeypatch.setattr(cls, "random_seed", classmethod(lambda c: 99))
    np.testing.assert_allclose(
        teval.silhouette_coefficient(tc, pts, max_sample=50, device="cpu"),
        jeval.silhouette_coefficient(jc, pts, max_sample=50), rtol=RTOL)


def test_pmml_bytes_match_reference():
    jschema = JaxSchema(jconfig.from_dict(_conf(3)))
    tschema = InputSchema(tconfig.from_dict(_conf(3)))
    centers = [[1.0, 2.0, -0.1], [3.5, -1.25, 1e-9], [0.1 + 0.2, 7.0, 0.0]]
    jc, tc = _pair_clusters(centers, [10, 4, 1])
    want = jpmml_io.to_string(jpmml.clusters_to_pmml(jc, jschema))
    got = pmml_io.to_string(tpmml.clusters_to_pmml(tc, tschema))
    assert got == want
    back = tpmml.read_clusters(pmml_io.from_string(got))
    assert [(c.id, c.count) for c in back] == [(0, 10), (1, 4), (2, 1)]
    np.testing.assert_array_equal(back[2].center, centers[2])
    tpmml.validate_pmml_vs_schema(pmml_io.from_string(got), tschema)
    with pytest.raises(ValueError):
        tpmml.validate_pmml_vs_schema(
            pmml_io.from_string(got),
            InputSchema(tconfig.from_dict(_conf(2))))


def _lines(pts):
    return [KeyMessage(None, ",".join(repr(float(v)) for v in p))
            for p in pts]


def test_kmeans_update_builds_and_evaluates():
    pts, _ = _blobs(n_per=60, seed=5)
    conf = _conf(2, **{"oryx.kmeans.hyperparams.k": 3,
                       "oryx.kmeans.evaluation-strategy": "SSE"})
    upd = KMeansUpdate(tconfig.from_dict(conf), device="cpu")
    model = upd.build_model(_lines(pts), [3], "unused")
    clusters = tpmml.read_clusters(model)
    assert len(clusters) == 3 and sum(c.count for c in clusters) == 180
    score = upd.evaluate(model, "unused", _lines(pts[:20]), _lines(pts[20:]))
    want = -jeval.sum_squared_error(
        [jcommon.ClusterInfo(c.id, c.center, c.count) for c in clusters],
        pts)
    np.testing.assert_allclose(score, want, rtol=RTOL)
    assert upd.build_model(_lines(pts[:2]), [3], "unused") is None


@pytest.mark.parametrize("extra,key", [
    ({"oryx.input-schema.categorical-features": ["1"],
      "oryx.input-schema.numeric-features": ["0"]}, "numeric"),
    ({"oryx.input-schema.target-feature": "1"}, "target"),
    # the mesh is ported; an oryx.distributed group without its process
    # count and id is refused by name
    ({"oryx.distributed.coordinator-address": "localhost:1234"},
     "oryx.distributed.coordinator-address"),
    ({"oryx.kmeans.initialization-strategy": "kmeans++"},
     "initialization"),
    ({"oryx.kmeans.evaluation-strategy": "nope"}, "evaluation"),
])
def test_kmeans_update_refuses(extra, key):
    with pytest.raises(ValueError, match=key):
        KMeansUpdate(tconfig.from_dict(_conf(2, **extra)), device="cpu")


def _model_message(schema, centers, counts):
    clusters = [tcommon.ClusterInfo(i, c, n)
                for i, (c, n) in enumerate(zip(centers, counts))]
    return pmml_io.to_string(tpmml.clusters_to_pmml(clusters, schema))


def test_speed_manager_up_messages_match_reference():
    conf = _conf(2)
    jmgr = JaxSpeed(jconfig.from_dict(conf))
    tmgr = TorchSpeed(tconfig.from_dict(conf), device="cpu")
    schema = InputSchema(tconfig.from_dict(conf))
    msg = _model_message(schema, [[0.0, 0.0], [10.0, 0.0],
                                        [0.0, 10.0]], [50, 60, 70])
    for mgr in (jmgr, tmgr):
        assert list(mgr.build_updates(_lines([[1.0, 1.0]]))) == []
        mgr.consume_key_message(KEY_MODEL, msg)
        mgr.consume_key_message(KEY_UP, "[0,[1.0,1.0],3]")  # ignored
    pts, _ = _blobs(n_per=7, seed=8)
    for batch in (pts[:5], pts[5:]):
        want = list(jmgr.build_updates(_lines(batch)))
        got = list(tmgr.build_updates(_lines(batch)))
        assert got == want and got
    with pytest.raises(ValueError):
        tmgr.consume_key_message("NOPE", "x")


def test_serving_manager_handles_model_and_up():
    conf = _conf(2)
    jmgr = JaxServing(jconfig.from_dict(conf))
    tmgr = TorchServing(tconfig.from_dict(conf), device="cpu")
    schema = InputSchema(tconfig.from_dict(conf))
    msg = _model_message(schema, [[0.0, 0.0], [10.0, 0.0]], [5, 6])
    for mgr in (jmgr, tmgr):
        mgr.consume_key_message(KEY_UP, "[0,[1.0,1.0],3]")  # no model yet
        assert mgr.get_model() is None
        mgr.consume_key_message(KEY_MODEL, msg)
        mgr.consume_key_message(KEY_UP, "[1,[20.0,0.0],9]")
    jm, tm = jmgr.get_model(), tmgr.get_model()
    assert tm.num_clusters == jm.num_clusters == 2
    assert repr(tm.get_cluster(1)) == repr(jm.get_cluster(1))
    rows = [["1", "1"], ["16", "0"], ["9", "1"], ["0", "-3"]]
    assert tm.nearest_cluster_ids(rows) == jm.nearest_cluster_ids(rows)
    for r in rows:
        assert tm.nearest_cluster_id(r) == jm.nearest_cluster_id(r)
    with pytest.raises(ValueError):
        tm.nearest_cluster_id(["1"])
    assert tm.get_fraction_loaded() == 1.0


def test_cluster_conversion_round_trip():
    pts, cs = _blobs(n_per=30, seed=12)
    ref = jtrainer.train_kmeans(pts, 3, 5, initialization="random", seed=1)
    got = convert.clusters_from_reference(ref)
    assert [(c.id, c.count) for c in got] == [(c.id, c.count) for c in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.center, b.center)
        assert isinstance(a, tcommon.ClusterInfo)
    schema = InputSchema(tconfig.from_dict(_conf(2)))
    jschema = JaxSchema(jconfig.from_dict(_conf(2)))
    assert pmml_io.to_string(tpmml.clusters_to_pmml(got, schema)) == \
        jpmml_io.to_string(jpmml.clusters_to_pmml(ref, jschema))


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = tconfig.from_dict(_conf(2))
    for make in (lambda: TorchServing(conf), lambda: TorchSpeed(conf),
                 lambda: KMeansUpdate(conf),
                 lambda: tcommon.assign_points(np.ones((2, 2)),
                                               np.ones((1, 2)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
