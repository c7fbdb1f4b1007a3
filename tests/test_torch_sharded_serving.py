"""Sharded serving on the port (``oryx.serving.api.item-shards``): the
item store row-sharded over a mesh of CPU entries, the batch scored per
shard and merged, held against the reference's sharded model on its 8
virtual CPU devices (``tests/test_sharded_serving.py``) on the same
seeded inputs: the same ids in the same order, ties included (lowest
store row first), scores within rtol 1e-5 (float32) and 1e-4 (bfloat16),
at item shards 2, 4 and 8.  Also: ties built on purpose, a ``how_many``
larger than a shard, an UP after the load, LSH ignored, the manager from
its config (a shard count that is not a power of two raises the
reference's message), and ``/recommend`` and ``/similarity`` over HTTP.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from oryx_tpu.app.als.serving_model import ALSServingModel as JModel
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.common.config import from_dict

SHARDS = [2, 4, 8]


def _vectors(items, users, features, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((items, features)).astype(np.float32),
            rng.standard_normal((users, features)).astype(np.float32))


def _pair(item_shards, features=6, items=200, users=12, seed=0,
          dtype="float32", Y=None):
    """(reference model, port model) loaded with the same vectors."""
    if Y is None:
        Y, X = _vectors(items, users, features, seed)
    else:
        _, X = _vectors(len(Y), users, features, seed)
    y_ids = [f"i{j}" for j in range(len(Y))]
    x_ids = [f"u{j}" for j in range(len(X))]
    ref = JModel(features=features, implicit=True, item_shards=item_shards,
                 dtype=dtype)
    port = ALSServingModel(features=features, implicit=True,
                           item_shards=item_shards, dtype=dtype,
                           device="cpu")
    for m in (ref, port):
        m.Y.bulk_load(y_ids, Y)
        m.X.bulk_load(x_ids, X)
    return ref, port


def _same(a, b, rtol):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [i for i, _ in ra] == [i for i, _ in rb]
        np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb],
                                   rtol=rtol)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-4)])
def test_sharded_top_n_matches_the_reference(shards, dtype, rtol):
    ref, port = _pair(shards, items=301, dtype=dtype)
    Q = np.random.default_rng(3).standard_normal((5, 6)).astype(np.float32)
    _same(ref.top_n_batch(10, Q), port.top_n_batch(10, Q), rtol)
    # and the port's sharded answer is its own one-card answer
    _, single = _pair(1, items=301, dtype=dtype)
    _same(single.top_n_batch(10, Q, use_lsh=False),
          port.top_n_batch(10, Q), rtol)


@pytest.mark.parametrize("shards", SHARDS)
def test_ties_go_to_the_lowest_row(shards):
    """Rows built to tie across shards: the merge keeps lax.top_k's
    order, the lowest global row first."""
    base, _ = _vectors(64, 1, 6, 5)
    Y = np.repeat(base[:8], 8, axis=0)   # 8 copies of each of 8 rows
    Y = Y[np.random.default_rng(9).permutation(len(Y))]
    ref, port = _pair(shards, Y=Y)
    Q = np.random.default_rng(4).standard_normal((4, 6)).astype(np.float32)
    _same(ref.top_n_batch(20, Q), port.top_n_batch(20, Q), 1e-5)


@pytest.mark.parametrize("shards", SHARDS)
def test_how_many_larger_than_a_shard(shards):
    ref, port = _pair(shards, items=40, features=4)
    Q = np.random.default_rng(33).standard_normal((1, 4)).astype(np.float32)
    got = port.top_n_batch(30, Q)
    assert len(got[0]) == 30
    _same(ref.top_n_batch(30, Q), got, 1e-5)


@pytest.mark.parametrize("shards", SHARDS)
def test_exclusions_and_per_request_how_many(shards):
    ref, port = _pair(shards)
    Q = np.random.default_rng(4).standard_normal((3, 6)).astype(np.float32)
    plain = port.top_n_batch([4, 2, 6], Q)
    excl = [{plain[0][0][0], plain[0][1][0]}, set(), {plain[2][0][0]}]
    got = port.top_n_batch([4, 2, 6], Q, exclude=excl)
    assert [len(r) for r in got] == [4, 2, 6]
    _same(ref.top_n_batch([4, 2, 6], Q, exclude=excl), got, 1e-5)


@pytest.mark.parametrize("shards", SHARDS)
def test_an_up_after_load(shards):
    ref, port = _pair(shards, items=64)
    for m in (ref, port):
        m.set_item_vector("hot", np.full(6, 10.0, np.float32))
        m.set_item_vector("i3", np.full(6, -1.0, np.float32))
    Q = np.ones((2, 6), np.float32)
    got = port.top_n_batch(3, Q)
    assert got[0][0][0] == "hot"
    _same(ref.top_n_batch(3, Q), got, 1e-5)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-4)])
def test_sharded_item_scorer_matches_the_reference(dtype, rtol):
    """``ShardedItemScorer`` (rows not a multiple of the mesh size, a
    ``how_many`` above one shard's rows) against the reference's."""
    from oryx_tpu.parallel import build_mesh as jbuild_mesh
    from oryx_tpu.parallel.serving_dist import ShardedItemScorer as JScorer
    from oryx_tpu_torch.parallel import build_mesh
    from oryx_tpu_torch.parallel.serving_dist import ShardedItemScorer

    Y, _ = _vectors(4003, 1, 12, 31)
    ids = [f"i{j}" for j in range(len(Y))]
    port = ShardedItemScorer(build_mesh(8, "cpu"), ids, Y, dtype=dtype)
    ref = JScorer(jbuild_mesh(8), ids, Y, dtype=dtype)
    Q = np.random.default_rng(5).standard_normal((5, 12)).astype(np.float32)
    for how_many in (7, 600):
        _same(ref.top_n_batch(how_many, Q), port.top_n_batch(how_many, Q),
              rtol)
    assert port.memory_bytes_per_device() == \
        (4008 // 8) * 32 * (4 if dtype == "float32" else 2) + 4008 // 8


def test_sharded_model_ignores_lsh():
    from oryx_tpu_torch.app.als.lsh import LocalitySensitiveHash
    _, port = _pair(8)
    port.lsh = LocalitySensitiveHash(0.3, 6, device="cpu")
    assert not port._lsh_active()
    assert port.top_n_batch(5, np.ones((1, 6), np.float32))[0]
    assert port.refresh_route() is None


@pytest.mark.parametrize("shards", SHARDS)
def test_single_request_paths_match_the_reference(shards):
    """``top_n`` (dot and cosine) score each shard and join the scores."""
    ref, port = _pair(shards, items=257)
    q = np.random.default_rng(8).standard_normal(6).astype(np.float32)
    V = np.random.default_rng(9).standard_normal((6, 3)).astype(np.float32)
    _same([ref.top_n(7, user_vector=q)], [port.top_n(7, user_vector=q)],
          1e-5)
    _same([ref.top_n(7, cosine_to=V, exclude={"i1"})],
          [port.top_n(7, cosine_to=V, exclude={"i1"})], 1e-5)
    np.testing.assert_allclose(port.Y.vtv(), ref.Y.vtv(), rtol=1e-5,
                               atol=1e-5)


def test_store_capacity_splits_evenly():
    """An exact-fit load rounds the capacity to a multiple of the mesh
    size, so every shard has the same rows."""
    _, port = _pair(8, items=3001)
    blocks, actives, _ = port.Y.shard_arrays_versioned()
    assert len({int(b.shape[0]) for b in blocks}) == 1
    assert sum(int(a.sum()) for a in actives) == 3001
    got = port.top_n_batch(5, np.ones((2, 6), np.float32))
    assert all(len(r) == 5 for r in got)
    with pytest.raises(TypeError):
        port.Y.device_arrays()


def test_manager_builds_sharded_model_from_config():
    from oryx_tpu_torch.app.als.serving_manager import ALSServingModelManager
    from oryx_tpu_torch.common import pmml as pmml_io

    mgr = ALSServingModelManager(
        from_dict({"oryx.serving.api.item-shards": 8}), device="cpu")
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", 6)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", ["u0"])
    pmml_io.add_extension_content(doc, "YIDs", ["i0", "i1"])
    mgr.consume_key_message("MODEL", pmml_io.to_string(doc))
    assert mgr.get_model()._item_shards == 8
    mgr.consume_key_message("UP", json.dumps(["Y", "i0", [1, 0, 0, 0, 0, 0]]))
    mgr.consume_key_message("UP", json.dumps(["Y", "i1", [0, 1, 0, 0, 0, 0]]))
    mgr.consume_key_message("UP", json.dumps(["X", "u0", [1, 1, 0, 0, 0, 0]]))
    got = mgr.get_model().top_n_batch(
        2, np.asarray([[1, 0, 0, 0, 0, 0]], np.float32))[0]
    assert got[0][0] == "i0"


@pytest.mark.parametrize("shards", [0, 3, 6])
def test_manager_rejects_non_pow2_shards(shards):
    from oryx_tpu.app.als.serving_manager import ALSServingModelManager as J
    from oryx_tpu.common.config import from_dict as jfrom_dict
    from oryx_tpu_torch.app.als.serving_manager import ALSServingModelManager

    with pytest.raises(ValueError) as want:
        J(jfrom_dict({"oryx.serving.api.item-shards": shards}))
    with pytest.raises(ValueError) as got:
        ALSServingModelManager(from_dict(
            {"oryx.serving.api.item-shards": shards}), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def sharded_server():
    from oryx_tpu_torch.bench.load import StaticModelManager
    from oryx_tpu_torch.lambda_rt.http import HttpApp, make_server
    from oryx_tpu_torch.serving import als as als_resources
    from oryx_tpu_torch.serving import framework as framework_resources
    from oryx_tpu_torch.serving.batcher import TopNBatcher

    ref, model = _pair(8, items=500, users=20)
    for m in (ref, model):
        m.add_known_items("u0", ["i1", "i2"])

    class Manager(StaticModelManager):
        pass

    Manager.model = model
    batcher = TopNBatcher(pipeline=2)
    app = HttpApp(
        framework_resources.ROUTES + als_resources.ROUTES,
        context={"model_manager": Manager(), "input_producer": None,
                 "config": None, "min_model_load_fraction": 0.0,
                 "top_n_batcher": batcher},
        read_only=True)
    server = make_server(app, 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield port, ref
    server.shutdown()
    batcher.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_http_recommend_over_sharded_model(sharded_server):
    port, ref = sharded_server
    recs = _get(port, "/recommend/u0?howMany=5")
    assert not ({r["id"] for r in recs} & {"i1", "i2"})
    want = ref.top_n(5, user_vector=ref.get_user_vector("u0"),
                     exclude={"i1", "i2"})
    assert [r["id"] for r in recs] == [i for i, _ in want]
    np.testing.assert_allclose([r["value"] for r in recs],
                               [s for _, s in want], rtol=1e-5)
    results = []

    def hit(u):
        results.append(_get(port, f"/recommend/u{u}?howMany=3"))

    threads = [threading.Thread(target=hit, args=(u,)) for u in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 8 and all(len(r) == 3 for r in results)


def test_http_similarity_and_estimate_over_sharded_model(sharded_server):
    port, ref = sharded_server
    sims = _get(port, "/similarity/i3?howMany=4")
    want = ref.top_n(4, cosine_to=ref.get_item_vector("i3"),
                     exclude={"i3"})
    assert [r["id"] for r in sims] == [i for i, _ in want]
    est = _get(port, "/estimate/u1/i5")
    assert est and est[0]["id"] == "i5" \
        and isinstance(est[0]["value"], float)
