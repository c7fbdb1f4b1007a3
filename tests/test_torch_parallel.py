"""The port's several-device path (``oryx_tpu_torch/parallel/``) held
against the reference's (``oryx_tpu/parallel/``, on its 8 virtual CPU
devices, tests/conftest.py) on the same seeded NumPy inputs; the port
runs on a mesh of CPU entries.

- ``block_ratings`` and ``block_ratings_ring`` give equal arrays at mesh
  sizes 1, 2, 4 and 8;
- ``train_als_distributed`` matches the reference's at mesh size 8 in
  both modes, implicit and explicit (rtol 1e-3, atol 1e-4), and the
  port's single trainer (rtol 2e-3, atol 2e-3, ``tests/test_parallel.py``'s
  tolerance);
- k-means on the mesh from the same initial centers (``random``
  initialization draws the same rows in both packages) gives centers
  within rtol 1e-4; assignments that differ are counted near-ties;
- the RDF trainer with a mesh builds the same classification forest as
  without one; regression is held on RMSE;
- ``mesh_from_config`` for ``cpu``, ``auto`` and ``mesh``, and
  ``initialize_multihost``'s no-op;
- the three batch updates train over the mesh of ``master = "mesh"``.
"""

import numpy as np
import pytest

from oryx_tpu.app.als.common import ParsedRatings as JRatings
from oryx_tpu.parallel import block_ratings as jblock
from oryx_tpu.parallel import block_ratings_ring as jblock_ring
from oryx_tpu.parallel import build_mesh as jbuild_mesh
from oryx_tpu.parallel import train_als_distributed as jtrain_dist
from oryx_tpu_torch.app.als.common import ParsedRatings
from oryx_tpu_torch.app.als.trainer import train_als
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.parallel import (block_ratings, block_ratings_ring,
                                     build_mesh, make_train_step,
                                     train_als_distributed)
from oryx_tpu_torch.parallel import mesh as mesh_mod

DEV = "cpu"


def _synthetic(n_users=40, n_items=30, nnz=400, implicit=True, seed=7):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < nnz:
        pairs.add((int(rng.integers(n_users)), int(rng.integers(n_items))))
    users, items = np.array(sorted(pairs), dtype=np.int32).T
    lo, hi = (0.5, 3.0) if implicit else (1.0, 5.0)
    vals = rng.uniform(lo, hi, size=len(users)).astype(np.float32)
    uids = [f"u{i}" for i in range(n_users)]
    iids = [f"i{i}" for i in range(n_items)]
    return (ParsedRatings(uids, iids, users, items, vals),
            JRatings(uids, iids, users, items, vals))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("ring", [False, True])
def test_blocked_layouts_equal_the_reference(n_dev, ring):
    port, ref = _synthetic(n_users=13, n_items=21, nnz=90)
    a = (block_ratings_ring if ring else block_ratings)(port, n_dev)
    b = (jblock_ring if ring else jblock)(ref, n_dev)
    assert (a.n_users, a.n_items) == (b.n_users, b.n_items)
    for x, y in zip(a[2:], b[2:]):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_distributed_als_matches_the_reference(implicit, mode):
    port, ref = _synthetic(implicit=implicit)
    kw = dict(features=6, lam=0.01, alpha=1.0, implicit=implicit,
              iterations=4, seed=123)
    got = train_als_distributed(port, mesh=build_mesh(8, DEV), mode=mode,
                                **kw)
    want = jtrain_dist(ref, mesh=jbuild_mesh(8), mode=mode, **kw)
    np.testing.assert_allclose(got.X, want.X, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.Y, want.Y, rtol=1e-3, atol=1e-4)
    assert got.user_ids == want.user_ids and got.item_ids == want.item_ids


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_als_matches_the_single_trainer(implicit, n_dev):
    port, _ = _synthetic(implicit=implicit)
    kw = dict(features=6, lam=0.01, alpha=1.0, implicit=implicit,
              iterations=4, seed=123)
    single = train_als(port, device=DEV, **kw)
    for mode in ("gather", "ring"):
        dist = train_als_distributed(port, mesh=build_mesh(n_dev, DEV),
                                     mode=mode, **kw)
        np.testing.assert_allclose(dist.X, single.X, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(dist.Y, single.Y, rtol=2e-3, atol=2e-3)


def test_a_repeated_device_is_a_mesh_of_its_own():
    """Two entries of one device run the two-entry code path: the same
    factors as two distinct entries (here both the CPU)."""
    port, _ = _synthetic()
    kw = dict(features=5, lam=0.02, alpha=1.0, implicit=True,
              iterations=3, seed=11)
    two = train_als_distributed(port, mesh=mesh_mod.Mesh(["cpu", "cpu"]),
                                mode="ring", **kw)
    built = train_als_distributed(port, mesh=build_mesh(2, DEV),
                                  mode="ring", **kw)
    np.testing.assert_array_equal(two.X, built.X)


def test_train_step_is_finite():
    port, _ = _synthetic(n_users=16, n_items=16, nnz=80)
    mesh = build_mesh(8, DEV)
    blocks = block_ratings(port, 8)
    step = make_train_step(mesh, lam=0.01, alpha=1.0, implicit=True)
    X = mesh_mod.shard_rows(
        mesh, np.zeros((blocks.u_cols.shape[0], 4), np.float32))
    Y = mesh_mod.shard_rows(
        mesh, np.full((blocks.i_cols.shape[0], 4), 0.1, np.float32))
    args = [mesh_mod.shard_rows(mesh, a) for a in blocks[2:]]
    X2, Y2 = step(X, Y, *args)
    assert all(np.isfinite(t.numpy()).all() for t in X2 + Y2)


def test_collectives():
    mesh = build_mesh(4, DEV)
    import torch
    blocks = [torch.full((2, 3), float(i)) for i in range(4)]
    full = mesh_mod.all_gather(mesh, blocks)
    assert len(full) == 4 and full[0].shape == (8, 3)
    assert full[3][:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert mesh_mod.psum(mesh, blocks)[2][0, 0].item() == 6.0
    shifted = mesh_mod.ppermute(mesh, blocks)
    assert [b[0, 0].item() for b in shifted] == [3.0, 0.0, 1.0, 2.0]


# -- k-means -------------------------------------------------------------------

def test_distributed_kmeans_matches_the_reference():
    from oryx_tpu.parallel.kmeans_dist import train_kmeans_distributed as jkm
    from oryx_tpu_torch.app.kmeans.common import assign_points
    from oryx_tpu_torch.parallel.kmeans_dist import train_kmeans_distributed

    rng = np.random.default_rng(21)
    k, d = 6, 4
    true_c = rng.standard_normal((k, d)).astype(np.float32) * 6
    pts = (true_c[rng.integers(0, k, 3001)]
           + rng.standard_normal((3001, d)).astype(np.float32))
    kw = dict(k=k, iterations=8, initialization="random", seed=6)
    got = train_kmeans_distributed(pts, mesh=build_mesh(8, DEV), **kw)
    want = jkm(pts, mesh=jbuild_mesh(8), **kw)
    gc = np.stack([c.center for c in got])
    wc = np.stack([np.asarray(c.center) for c in want])
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-5)
    # assignments that differ between the two center sets are near-ties
    ga, _ = assign_points(pts, gc, device=DEV)
    wa, _ = assign_points(pts, wc, device=DEV)
    differ = np.nonzero(ga != wa)[0]
    for i in differ:
        dg = np.sum((pts[i] - gc[ga[i]]) ** 2)
        dw = np.sum((pts[i] - gc[wa[i]]) ** 2)
        assert abs(dg - dw) <= 1e-4 * max(dg, dw, 1.0)
    assert len(differ) <= 3
    assert sum(c.count for c in got) == 3001


def test_distributed_kmeans_agrees_with_the_single_trainer():
    from oryx_tpu_torch.app.kmeans.trainer import train_kmeans
    from oryx_tpu_torch.parallel.kmeans_dist import train_kmeans_distributed

    rng = np.random.default_rng(5)
    true_c = rng.standard_normal((5, 3)).astype(np.float32) * 8
    pts = (true_c[rng.integers(0, 5, 2000)]
           + rng.standard_normal((2000, 3)).astype(np.float32))
    kw = dict(k=5, iterations=10, initialization="random", seed=2)
    dist = train_kmeans_distributed(pts, mesh=build_mesh(4, DEV), **kw)
    single = train_kmeans(pts, device=DEV, **kw)
    np.testing.assert_allclose(np.stack([c.center for c in dist]),
                               np.stack([c.center for c in single]),
                               rtol=1e-4, atol=1e-5)


# -- RDF -----------------------------------------------------------------------

def _rdf_schema(classification=True):
    from oryx_tpu_torch.app.schema import InputSchema
    if classification:
        names, num, target = ["a", "b", "label"], ["a", "b"], "label"
    else:
        names, num, target = ["a", "b", "y"], ["a", "b", "y"], "y"
    return InputSchema(from_dict({
        "oryx.input-schema.feature-names": names,
        "oryx.input-schema.numeric-features": num,
        "oryx.input-schema.target-feature": target}))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_forest_equals_the_single_forest(n_dev):
    """Classification histograms are integer sums, exact in any order:
    the forest on a mesh is the forest without one, split for split
    (``tests/test_parallel.py::test_distributed_forest_matches_single_
    device``)."""
    from oryx_tpu_torch.app.classreg import Example
    from oryx_tpu_torch.app.rdf.trainer import train_forest

    rng = np.random.default_rng(3)
    n = 501
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    y = ((x[:, 0] + 0.3 * x[:, 1]) > 0.1).astype(np.int32)
    kw = dict(category_counts={}, num_trees=3, max_depth=4,
              max_split_candidates=16, impurity="gini", seed=99,
              num_classes=2, device=DEV)
    single = train_forest(x, y, _rdf_schema(), **kw)
    dist = train_forest(x, y, _rdf_schema(), mesh=build_mesh(n_dev, DEV),
                        **kw)
    np.testing.assert_array_equal(dist.feature_importances,
                                  single.feature_importances)
    probes = [Example(None, [float(rng.uniform(-1, 1)),
                             float(rng.uniform(-1, 1)), None])
              for _ in range(200)]
    for ts, td in zip(single.trees, dist.trees):
        for ex in probes:
            a, b = ts.find_terminal(ex), td.find_terminal(ex)
            assert a.id == b.id and a.count == b.count


def test_distributed_forest_regression_quality():
    from oryx_tpu_torch.app.classreg import Example
    from oryx_tpu_torch.app.rdf.trainer import train_forest

    rng = np.random.default_rng(4)
    x = rng.uniform(0, 4, (600, 2)).astype(np.float32)
    y = np.where(x[:, 0] < 2, 1.0, 5.0).astype(np.float32)
    forest = train_forest(x, y, _rdf_schema(False), category_counts={},
                          num_trees=3, max_depth=3, max_split_candidates=32,
                          impurity="variance", seed=7, device=DEV,
                          mesh=build_mesh(8, DEV))
    preds = np.array([np.mean([t.find_terminal(
        Example(None, [float(a), float(b), None])).prediction.prediction
        for t in forest.trees]) for a, b in x])
    assert np.sqrt(np.mean((preds - y) ** 2)) < 0.5


# -- configuration -------------------------------------------------------------

@pytest.mark.parametrize("master,n", [("cpu", None), ("auto", None),
                                      ("mesh", 8)])
def test_mesh_from_config(master, n):
    cfg = from_dict({"oryx.batch.streaming.master": master})
    m = mesh_mod.mesh_from_config(cfg, device=DEV)
    assert (m.size if m is not None else None) == n


def test_mesh_from_config_sizes_by_the_executors():
    cfg = from_dict({"oryx.batch.streaming.master": "mesh",
                     "oryx.batch.streaming.num-executors": 1,
                     "oryx.batch.streaming.executor-cores": 4})
    assert mesh_mod.mesh_from_config(cfg, device=DEV).size == 4
    one = from_dict({"oryx.batch.streaming.master": "mesh",
                     "oryx.batch.streaming.num-executors": 1,
                     "oryx.batch.streaming.executor-cores": 1})
    assert mesh_mod.mesh_from_config(one, device=DEV) is None


def test_initialize_multihost_noop_without_config():
    from oryx_tpu_torch.common.config import get_default
    assert mesh_mod.initialize_multihost(None) is False
    assert mesh_mod.initialize_multihost(from_dict({})) is False
    assert get_default().get_optional_string(
        "oryx.distributed.coordinator-address") is None
    with pytest.raises(ValueError, match="process-id"):
        mesh_mod.initialize_multihost(from_dict(
            {"oryx.distributed.coordinator-address": "127.0.0.1:1"}),
            device=DEV)


def _update_lines(n_users=30, n_items=20, seed=3):
    rng = np.random.default_rng(seed)
    return [f"u{rng.integers(n_users)},i{rng.integers(n_items)},"
            f"{rng.uniform(1, 3):.3f},{1000 + j}" for j in range(400)]


def test_updates_train_over_the_mesh(tmp_path):
    """``master = "mesh"`` gives each update a mesh of CPU entries, and
    its candidates train over it."""
    from oryx_tpu_torch.app.als.update import ALSUpdate
    from oryx_tpu_torch.app.kmeans.update import KMeansUpdate
    from oryx_tpu_torch.app.rdf.update import RDFUpdate
    from oryx_tpu_torch.kafka.api import KeyMessage

    mesh_keys = {"oryx.batch.streaming.master": "mesh",
                 "oryx.batch.streaming.num-executors": 1,
                 "oryx.batch.streaming.executor-cores": 4}
    als = ALSUpdate(from_dict({**mesh_keys, "oryx.als.iterations": 2}),
                    device=DEV)
    assert als.mesh.size == 4
    data = [KeyMessage(None, ln) for ln in _update_lines()]
    doc = als.build_model(data, [4, 0.01, 1.0], str(tmp_path / "als"))
    assert doc is not None

    km = KMeansUpdate(from_dict({
        **mesh_keys, "oryx.input-schema.num-features": 2,
        "oryx.input-schema.numeric-features": ["0", "1"]}), device=DEV)
    assert km.mesh.size == 4
    rng = np.random.default_rng(1)
    pts = [KeyMessage(None, f"{a:.4f},{b:.4f}")
           for a, b in rng.standard_normal((300, 2))]
    assert km.build_model(pts, [3], str(tmp_path / "km")) is not None

    rdf = RDFUpdate(from_dict({
        **mesh_keys, "oryx.rdf.num-trees": 2,
        "oryx.input-schema.feature-names": ["a", "b", "c"],
        "oryx.input-schema.numeric-features": ["a", "b"],
        "oryx.input-schema.target-feature": "c"}), device=DEV)
    assert rdf.mesh.size == 4
    rows = [KeyMessage(None, f"{a:.3f},{b:.3f},{'x' if a > 0 else 'y'}")
            for a, b in rng.standard_normal((200, 2))]
    assert rdf.build_model(rows, [8, 3, "gini"],
                           str(tmp_path / "rdf")) is not None
