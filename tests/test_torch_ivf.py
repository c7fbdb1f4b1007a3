"""The port's IVF index (``oryx_tpu_torch/app/als/ivf.py``) against the
reference's (``oryx_tpu/app/als/ivf.py``) on the same seeded inputs.

- The mirror, built from the same cells, has the same layout and bytes:
  ``perm``, ``activep`` and ``cell_blocks`` identical, ``y8p`` identical
  on the features' columns (both packages zero-pad further columns: the
  port to 32 columns, the reference to 128), and ``sy_b``, ``l1y_b`` and
  ``pen_i`` bit for bit.
- The probe's integer block maxima are bit-identical; rows both
  certify have the same ids in order, scores within rtol 1e-5 (the
  bounds differ by the 0.25·W·sy·sq term's width, a known divergence).
- ``nprobe == cells`` gives the exact kernel's answers; recall is
  monotone in ``nprobe``; on oracle-trained factors the certificate
  reaches 0.95 and is within 0.01 of the reference's.
- The artifacts are the reference's bytes and round-trip; the serving
  manager builds from them, and fails closed with the counter on a
  corrupt artifact; a certificate flip moves "ivf" in and out of the
  kind chain and re-keys the route.
"""

from __future__ import annotations

import datetime
import json
import os
import types

import numpy as np
import pytest
import torch

from oryx_tpu.app.als import ivf as jivf
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.app.als import slices as jslices
from oryx_tpu.app.als.serving_manager import \
    ALSServingModelManager as JaxManager
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml_io
from oryx_tpu.ops import ann as jann
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch import convert
from oryx_tpu_torch.app.als import ivf as tivf
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als import slices as tslices
from oryx_tpu_torch.app.als.feature_vectors import device_width
from oryx_tpu_torch.app.als.serving_manager import \
    ALSServingModelManager as TorchManager
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from oryx_tpu_torch.ops import ann as tann
from oryx_tpu_torch.resilience import faults as tfaults

BS = 128
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _cfgs(cells, nprobe, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("min_recall", 0.95)
    kw.setdefault("recall_at", 50)
    kw.setdefault("recall_queries", 64)
    kw.setdefault("train_sample", max(cells, 1024))
    kw.setdefault("train_iterations", 8)
    return (jivf.AnnConfig(cells=cells, nprobe=nprobe, **kw),
            tivf.AnnConfig(cells=cells, nprobe=nprobe, **kw))


def _mixture(rng, n, features, ncomp, spread=0.25):
    comp = rng.standard_normal((ncomp, features))
    pick = rng.integers(0, ncomp, size=n)
    return (comp[pick] + spread * rng.standard_normal((n, features))
            ).astype(np.float32)


def _padded(y, width):
    out = np.zeros((len(y), width), np.float32)
    out[:, :y.shape[1]] = y
    return out


def _pair(y, active, cells, nprobe, cells_assign=None):
    """(reference mirror, port mirror, reference vecs, port vecs) of the
    same catalog and the same cells."""
    import jax.numpy as jnp

    f = y.shape[1]
    jcfg, tcfg = _cfgs(cells, nprobe)
    cents = jivf.train_generation_centroids(y, jcfg)
    if cells_assign is None:
        cells_assign = jann.assign_cells(_padded(y, 128), cents)
    jv = jnp.asarray(_padded(y, 128))
    tv = torch.from_numpy(_padded(y, device_width(f)))
    jm = jivf.build_mirror(jv, jnp.asarray(active),
                           jivf.AnnState(jcfg, cents), BS,
                           cells=cells_assign)
    tm = tivf.build_mirror(tv, torch.from_numpy(active),
                           tivf.AnnState(tcfg, cents), BS,
                           cells=cells_assign)
    return jm, tm, jv, tv


def _catalog(seed, n=4096, f=16, cells=8, retired=True):
    rng = np.random.default_rng(seed)
    y = _mixture(rng, n, f, cells // 2)
    active = np.ones(n, bool)
    if retired:
        active[3::29] = False
    return rng, y, active


def test_mirror_matches_reference_for_the_same_cells():
    _, y, active = _catalog(1)
    f = y.shape[1]
    jm, tm, _, _ = _pair(y, active, 8, 2)
    for name in ("perm", "activep", "cell_blocks", "sy_b", "l1y_b",
                 "pen_i"):
        want = np.asarray(getattr(jm, name))
        got = getattr(tm, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    jy8 = np.asarray(jm.y8p)
    ty8 = tm.y8p.numpy()
    np.testing.assert_array_equal(ty8[:, :f], jy8[:, :f])
    assert not ty8[:, f:].any() and not jy8[:, f:].any()
    np.testing.assert_array_equal(tm.cents.numpy()[:, :f],
                                  np.asarray(jm.cents)[:, :f])
    assert tm.index_bytes > 0


def test_mirror_is_a_partition_and_deterministic():
    _, y, active = _catalog(2, retired=False)
    _, tcfg = _cfgs(8, 2)
    cents = tivf.train_generation_centroids(y, tcfg, device="cpu")
    vecs = torch.from_numpy(_padded(y, 32))
    state = tivf.AnnState(tcfg, cents)
    m1 = tivf.build_mirror(vecs, torch.ones(len(y), dtype=torch.bool),
                           state, BS)
    m2 = tivf.build_mirror(vecs, torch.ones(len(y), dtype=torch.bool),
                           tivf.AnnState(tcfg, cents), BS)
    assign = tann.assign_cells(vecs, cents)
    perm, valid = m1.perm.numpy(), m1.activep.numpy()
    sentinel = tivf.mirror_shapes(len(y), 8, BS)["blocks"] - 1
    seen = []
    for c, blocks in enumerate(m1.cell_blocks.numpy()):
        for blk in blocks[blocks != sentinel]:
            slots = np.arange(blk * BS, (blk + 1) * BS)
            rows = perm[slots][valid[slots]]
            assert (assign[rows] == c).all()
            seen.extend(rows.tolist())
    assert sorted(seen) == list(range(len(y)))
    for name in ("y8p", "perm", "cell_blocks", "sy_b"):
        assert torch.equal(getattr(m1, name), getattr(m2, name)), name


def _ref_probe_maxima(jm, vecs, Q, nprobe):
    """The reference kernel's phase A (``_ivf_top_n_kernel`` up to its
    ``m_int``, oryx_tpu/app/als/ivf.py:280-317), run on its mirror."""
    import jax
    import jax.numpy as jnp

    Qc = jsm._q_cast(jnp.asarray(Q), vecs)
    Qf = Qc.astype(jnp.float32)
    sq = jnp.maximum(jnp.max(jnp.abs(Qf), axis=1), 1e-30) / 127.0
    q8 = jnp.clip(jnp.round(Qf / sq[:, None]), -127, 127).astype(jnp.int8)
    _, probe = jax.lax.top_k(Qf @ jm.cents.T, nprobe)
    b = Q.shape[0]
    bi = jnp.take(jm.cell_blocks, probe, axis=0).reshape(b, -1)
    w = int(jm.y8p.shape[1])
    blk = jnp.take(jm.y8p.reshape(-1, BS, w), bi, axis=0)
    s = jnp.einsum("bw,bpcw->bpc", q8, blk,
                   preferred_element_type=jnp.int32)
    s = s + jnp.take(jm.pen_i, bi, axis=0)
    return np.asarray(s.max(-1)), np.asarray(bi)


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_probe_integer_maxima_bit_identical(nprobe):
    rng, y, active = _catalog(3)
    jm, tm, jv, tv = _pair(y, active, 8, nprobe)
    Q = rng.standard_normal((16, y.shape[1])).astype(np.float32)
    want_m, want_bi = _ref_probe_maxima(jm, jv, Q, nprobe)

    Qc = tsm._q_cast(torch.from_numpy(Q), tv)
    Qf = Qc.to(torch.float32)
    sq = Qf.abs().amax(1).clamp_min(1e-30) * tsm._INV_127
    q8 = torch.clamp(torch.round(Qf / sq[:, None]), -127, 127).to(
        torch.int8)
    _, probe = tsm._top_k(Qf @ tm.cents.T, nprobe)
    bi = tm.cell_blocks[probe].reshape(16, -1).to(torch.int64)
    np.testing.assert_array_equal(bi.numpy(), want_bi)
    n_blocks = tm.y8p.shape[0] // BS
    got = tivf._probe_maxima(q8, tm.y8p, tm.pen_i, bi, BS, n_blocks - 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_certified_rows_match_reference(dtype, monkeypatch):
    import jax
    import jax.numpy as jnp

    rng, y, active = _catalog(4, n=8192, f=24, cells=16)
    if dtype == "bfloat16":
        y = torch.from_numpy(y).to(torch.bfloat16).to(torch.float32).numpy()
    jm, tm, jv, tv = _pair(y, active, 16, 4)
    if dtype == "bfloat16":
        jv = jv.astype(jnp.bfloat16)
        tv = tv.to(torch.bfloat16)
    Q = rng.standard_normal((32, y.shape[1])).astype(np.float32)
    k, ksel = 10, 32
    j_s, j_i, j_c = jax.device_get(jivf.batch_top_n_ivf(
        jm, jv, jnp.asarray(Q), k, BS, ksel, 4))
    t_s, t_i, t_c = (a.numpy() for a in tivf.batch_top_n_ivf(
        tm, tv, torch.from_numpy(Q), k, BS, ksel, 4))
    both = j_c & t_c
    assert both.sum() >= len(Q) // 2, (j_c.sum(), t_c.sum())
    np.testing.assert_array_equal(t_i[both], j_i[both])
    np.testing.assert_allclose(t_s[both], j_s[both], rtol=RTOL)


def test_nprobe_equals_cells_gives_the_exact_answers():
    """All cells probed: the candidate universe is the catalog, and on
    exactly representable, pairwise distinct scores the answers are the
    exact kernel's bit for bit."""
    rng = np.random.default_rng(31)
    n, cells, k = 512, 4, 10
    y = np.zeros((n, 4), np.float32)
    y[:, 0] = np.arange(n) - n // 2
    y[:, 1:4] = rng.integers(-8, 9, (n, 3)) / 4.0
    active = np.ones(n, bool)
    active[5::37] = False
    _, tcfg = _cfgs(cells, cells, train_iterations=4)
    cents = tivf.train_generation_centroids(y, tcfg, device="cpu")
    vecs = torch.from_numpy(_padded(y, 32))
    act = torch.from_numpy(active)
    mirror = tivf.build_mirror(vecs, act, tivf.AnnState(tcfg, cents), BS)
    Q = np.zeros((8, 4), np.float32)
    Q[:, 0] = 64.0
    Q[:, 1:4] = rng.integers(-8, 9, (8, 3)) / 4.0
    an_s, an_i, cert = tivf.batch_top_n_ivf(
        mirror, vecs, torch.from_numpy(Q), k, BS, 10_000, cells)
    ex_s, ex_i = tsm._batch_top_n_kernel(vecs, torch.from_numpy(Q), act, k)
    assert bool(cert.all())
    assert torch.equal(an_s, ex_s) and torch.equal(an_i, ex_i)


def test_recall_monotone_in_nprobe():
    rng = np.random.default_rng(7)
    n, f, cells, k = 2048, 16, 8, 50
    y = _mixture(rng, n, f, cells // 2)
    _, tcfg = _cfgs(cells, 1)
    cents = tivf.train_generation_centroids(y, tcfg, device="cpu")
    vecs = torch.from_numpy(_padded(y, 32))
    act = torch.ones(n, dtype=torch.bool)
    mirror = tivf.build_mirror(vecs, act, tivf.AnnState(tcfg, cents), BS)
    Q = torch.from_numpy(rng.standard_normal((16, f)).astype(np.float32))
    _, ex_i = tsm._batch_top_n_kernel(vecs, Q, act, k)
    recalls = []
    for nprobe in (1, 2, 4, 8):
        _, an_i, _ = tivf.batch_top_n_ivf(mirror, vecs, Q, k, BS, 10_000,
                                          nprobe)
        hits = sum(len(set(a.tolist()) & set(e.tolist()))
                   for a, e in zip(an_i, ex_i))
        recalls.append(hits / (k * len(Q)))
    assert recalls == sorted(recalls), recalls
    assert recalls[-1] == 1.0


def test_probe_set_too_small_refuses():
    _, y, active = _catalog(5, n=1024)
    _, tm, _, tv = _pair(y, active, 8, 1)
    with pytest.raises(tivf.AnnIndexError):
        tivf.batch_top_n_ivf(tm, tv, torch.zeros((8, y.shape[1])),
                             100_000, BS, 4, 1)


# -- the load path ------------------------------------------------------------

def _oracle_catalog(seed=17, n_users=192, n_items=1024, groups=8,
                    features=16):
    """Community-structured implicit ratings trained by the reference's
    quality oracle (as tests/test_ivf.py draws them)."""
    from oryx_tpu.ml.oracle import train_als_oracle

    rng = np.random.default_rng(seed)
    users, items, vals = [], [], []
    for u in range(n_users):
        own = np.arange(u % groups, n_items, groups)
        for i in list(rng.choice(own, size=24, replace=False)) + \
                list(rng.choice(n_items, size=3, replace=False)):
            users.append(u)
            items.append(int(i))
            vals.append(1.0)
    X, Y = train_als_oracle(np.array(users), np.array(items),
                            np.array(vals), n_users, n_items, features,
                            0.01, 1.0, True, 8, seed=0)
    return X.astype(np.float32), Y.astype(np.float32)


ANN_CONF = {
    "oryx.serving.model-manager-class": "unused",
    "oryx.input-topic.broker": None,
    "oryx.update-topic.broker": None,
    "oryx.als.ann.enabled": True,
    "oryx.als.ann.cells": 8,
    "oryx.als.ann.nprobe": 6,
    "oryx.als.ann.train-sample": 1024,
}


def _managers(extra=None):
    conf = dict(ANN_CONF, **(extra or {}))
    return (JaxManager(jconfig.from_dict(conf)),
            TorchManager(tconfig.from_dict(conf), device="cpu"))


def _replay(mgr, X, Y, features):
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", features)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(
        doc, "XIDs", [f"u{j}" for j in range(len(X))])
    pmml_io.add_extension_content(
        doc, "YIDs", [f"i{j}" for j in range(len(Y))])
    mgr.consume_key_message(KEY_MODEL, pmml_io.to_string(doc))
    for j, row in enumerate(Y):
        mgr.consume_key_message(KEY_UP, json.dumps(
            ["Y", f"i{j}", [float(v) for v in row]]))
    for j, row in enumerate(X):
        mgr.consume_key_message(KEY_UP, json.dumps(
            ["X", f"u{j}", [float(v) for v in row], []]))


@pytest.mark.numerics
def test_recall_certificate_on_oracle_factors():
    X, Y = _oracle_catalog()
    jmgr, tmgr = _managers()
    _replay(jmgr, X, Y, 16)
    _replay(tmgr, X, Y, 16)
    ja, ta = jmgr.model._ann, tmgr.model._ann
    assert ta is not None and ta.recall is not None
    assert ta.recall >= 0.95, ta.recall
    assert abs(ta.recall - ja.recall) <= 0.01, (ta.recall, ja.recall)
    np.testing.assert_allclose(ta.centroids, ja.centroids, rtol=RTOL,
                               atol=RTOL)
    assert tmgr.ann_index_fallbacks == 0 and tmgr.ann_index_bytes > 0
    model = tmgr.model
    n_rows = len(model.Y.row_ids())
    assert model._ann_routable(n_rows)
    kinds, _ = model._phase_a_kinds(n_rows, 32, BS)
    assert kinds[0] == "ivf"
    ann_m = model.metrics()["kernel_route"]["ann"]
    assert ann_m == {"recall": ta.recall, "min_recall": 0.95,
                     "recall_at": 50, "cells": 8, "nprobe": 6,
                     "routable": True,
                     "index_bytes": tmgr.ann_index_bytes}


def _publish(tmp_path, pkg, Y, X, features, cents, cells, ring=24):
    """A sliced generation with the IVF index, published by one
    package's ``publish_sliced``: (model dir, slim manifest, MODEL-REF)."""
    slices = jslices if pkg == "jax" else tslices
    model_dir = str(tmp_path / pkg)
    os.makedirs(model_dir, exist_ok=True)
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", features)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs",
                                  [f"u{j}" for j in range(len(X))])
    pmml_io.add_extension_content(doc, "YIDs",
                                  [f"i{j}" for j in range(len(Y))])
    pmml_path = model_dir + "/model.pmml.xml"
    pmml_io.write(doc, pmml_path)
    slim = slices.publish_sliced(
        model_dir, [f"i{j}" for j in range(len(Y))], Y,
        [f"u{j}" for j in range(len(X))], X, None, ring,
        ann=(cents, cells))
    return model_dir, slim, slices.model_ref_message(pmml_path, model_dir,
                                                     slim)


def _published(tmp_path, n_users=192, n_items=1024):
    X, Y = _oracle_catalog(n_users=n_users, n_items=n_items)
    jcfg, _ = _cfgs(8, 4)
    cents = jivf.train_generation_centroids(Y, jcfg)
    cells = jann.assign_cells(Y, cents)
    return X, Y, cents, cells


class _FrozenClock(datetime.datetime):
    """The PMML header's wall clock, pinned: documents written a second
    apart would otherwise differ in their <Timestamp> alone."""

    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 1, 1, tzinfo=tz)


def test_artifacts_match_reference_bytes_and_round_trip(tmp_path,
                                                        monkeypatch):
    frozen = types.SimpleNamespace(datetime=_FrozenClock,
                                   timezone=datetime.timezone)
    monkeypatch.setattr(jpmml_io, "datetime", frozen)
    monkeypatch.setattr(pmml_io, "datetime", frozen)
    X, Y, cents, cells = _published(tmp_path, 32, 512)
    jdir, jslim, _ = _publish(tmp_path, "jax", Y, X, 16, cents, cells)
    tdir, tslim, _ = _publish(tmp_path, "torch", Y, X, 16, cents, cells)
    assert tslim == jslim and "ann" in tslim
    names = sorted(os.path.relpath(os.path.join(r, f), tdir)
                   for r, _, fs in os.walk(tdir) for f in fs)
    assert tivf.CENTROIDS_FILE in names
    assert any(n.startswith("Y-slices/ann-") for n in names)
    for name in names:
        with open(os.path.join(tdir, name), "rb") as a, \
                open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name
    back = tivf.read_centroids(tdir, tslim["ann"])
    np.testing.assert_allclose(back, cents, atol=1e-6)
    got = []
    for entry in tslim["slices"]:
        sc = tivf.read_slice_cells(tdir, entry["ann"])
        assert sc == jivf.read_slice_cells(jdir, entry["ann"])
        got.extend(sc)
    assert sorted(got) == sorted(int(c) for c in cells)
    # the publish refuses a misaligned assignment
    with pytest.raises(ValueError):
        tslices.publish_sliced(str(tmp_path / "bad"), ["i0"],
                               Y[:1], [], X[:0], None, 2,
                               ann=(cents, cells[:2]))


def test_manager_builds_from_published_artifacts(tmp_path, monkeypatch):
    X, Y, cents, cells = _published(tmp_path)
    _, _, msg = _publish(tmp_path, "torch", Y, X, 16, cents, cells)

    def no_training(*a, **kw):
        raise AssertionError("the published index must skip the k-means")

    monkeypatch.setattr(tivf, "train_generation_centroids", no_training)
    _, tmgr = _managers()
    tmgr.consume_key_message(KEY_MODEL_REF, msg)
    a = tmgr.model._ann
    assert tmgr.slice_loads == 24 and tmgr.ann_index_fallbacks == 0
    assert a is not None and a.recall >= 0.95, a and a.recall
    np.testing.assert_allclose(a.centroids, cents, atol=1e-6)
    assert tmgr.ann_index_bytes > 0
    assert tmgr.model._ann_routable(len(tmgr.model.Y.row_ids()))


@pytest.mark.parametrize("how", ["chaos", "bitrot"])
def test_corrupt_index_fails_closed_to_exact(tmp_path, how):
    X, Y, cents, cells = _published(tmp_path, 32, 512)
    tdir, _, msg = _publish(tmp_path, "torch", Y, X, 16, cents, cells)
    if how == "chaos":
        tfaults.inject("ann-index-corrupt", mode="error", times=1)
    else:
        path = os.path.join(tdir, tivf.CENTROIDS_FILE)
        payload = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(payload[:len(payload) // 2])
    _, tmgr = _managers()
    tmgr.consume_key_message(KEY_MODEL_REF, msg)
    if how == "chaos":
        assert tfaults.fired("ann-index-corrupt") == 1
    model = tmgr.model
    assert model is not None and tmgr.slice_loads == 24
    assert tmgr.ann_index_fallbacks == 1 and tmgr.ann_index_bytes == 0
    assert model._ann is None
    kinds, _ = model._phase_a_kinds(len(model.Y.row_ids()), 32, BS)
    assert "ivf" not in kinds
    assert model.top_n(5, user_vector=X[0])


@pytest.fixture
def streaming(monkeypatch):
    monkeypatch.setattr(tsm, "_FLAT_SCORES_LIMIT", 1)
    monkeypatch.setattr(tsm, "_MAX_CHUNK_ROWS", 1024)
    monkeypatch.setattr(tsm, "_BLOCK_KSEL", 4)
    monkeypatch.setattr(tsm, "_PA_TILE", 1024)


def test_certificate_flip_gates_the_kind_and_rekeys_the_route(streaming):
    rng = np.random.default_rng(50)
    n, f, cells = 4096, 6, 8
    model = ALSServingModel(f, implicit=True, device="cpu")
    model.Y.bulk_load([f"i{j}" for j in range(n)],
                      rng.standard_normal((n, f)).astype(np.float32))
    model.X.bulk_load(["u0"], rng.standard_normal((1, f)).astype(
        np.float32))
    n_rows = len(model.Y.row_ids())
    _, tcfg = _cfgs(cells, cells)
    cents = tivf.train_generation_centroids(
        model.Y.host_arrays()[0][:n], tcfg, device="cpu")
    state = tivf.AnnState(tcfg, cents)
    model.attach_ann(state)
    assert not model._ann_routable(n_rows)  # no certificate yet
    state.recall = 1.0
    assert model._ann_routable(n_rows)
    kinds, _ = model._phase_a_kinds(n_rows, 32, BS)
    assert kinds[0] == "ivf"
    q = rng.standard_normal((8, f)).astype(np.float32)
    route = model.refresh_route(force=True)
    assert route["costs_exact_ms"].get("ivf") is not None, route
    assert route["ann_key"] == tcfg.route_key() + (True,)
    assert route["ann"]["routable"] is True
    exact = [[i for i, _ in r] for r in model.top_n_batch(5, q,
                                                          use_lsh=False)]
    # nprobe == cells: every row "ivf" certifies is the exact answer
    ctx: dict = {}
    vecs, active, version = model.Y.device_arrays_versioned()
    ts, ti, cert = model._dispatch_kind(
        "ivf", torch.from_numpy(np.pad(q, ((0, 0), (0, 26)))), vecs,
        active, version, None, None, 8, BS, 4, 0, 1, ctx)
    row_ids = model.Y.row_ids()
    got = [[row_ids[i] for i in row[:5]] for row in ti.tolist()]
    assert cert.any()
    for ok, g, e in zip(cert.tolist(), got, exact):
        if ok:
            assert g == e
    # the served path, with its certificate fallback, is exact
    assert [[i for i, _ in r] for r in model.top_n_batch(5, q)] == exact
    state.recall = 0.2
    assert model._route_current(n_rows) is None
    route2 = model.refresh_route()
    assert route2 is not route
    assert route2["ann_key"] == tcfg.route_key() + (False,)
    assert "ivf" not in route2["costs_exact_ms"]
    kinds2, _ = model._phase_a_kinds(n_rows, 32, BS)
    assert "ivf" not in kinds2
    assert [[i for i, _ in r] for r in model.top_n_batch(5, q)] == exact
    model.attach_ann(None)
    assert model._ann_route_key() is None


@pytest.mark.parametrize("kw", [
    {"cells": 1}, {"nprobe": 0}, {"nprobe": 9}, {"min_recall": 1.5},
    {"recall_at": 0}, {"recall_queries": 0}, {"train_sample": 4},
    {"train_iterations": 0}])
def test_ann_config_refuses_what_the_reference_refuses(kw):
    args = dict(enabled=True, cells=8, nprobe=4, min_recall=0.9,
                recall_at=10, recall_queries=8, train_sample=64,
                train_iterations=2)
    args.update(kw)
    with pytest.raises(ValueError) as want:
        jivf.AnnConfig(**args)
    with pytest.raises(ValueError) as got:
        tivf.AnnConfig(**args)
    assert str(got.value) == str(want.value)


def test_ann_config_from_config_matches_reference():
    j = jivf.AnnConfig.from_config(jconfig.from_dict(ANN_CONF))
    t = tivf.AnnConfig.from_config(tconfig.from_dict(ANN_CONF))
    assert vars(t) == vars(j) and t.route_key() == j.route_key()


def test_ann_state_conversion_round_trip():
    import jax.numpy as jnp

    _, y, active = _catalog(6, n=2048)
    jcfg, _ = _cfgs(8, 3)
    cents = jivf.train_generation_centroids(y, jcfg)
    cells = jann.assign_cells(_padded(y, 128), cents)
    jstate = jivf.AnnState(jcfg, cents, cells=cells)
    jstate.recall = 0.97
    jstate.index_bytes = 1234
    tstate = convert.ann_state_from_reference(jstate)
    assert vars(tstate.cfg) == vars(jcfg)
    np.testing.assert_array_equal(tstate.centroids, cents)
    np.testing.assert_array_equal(tstate.cells, cells)
    assert (tstate.recall, tstate.index_bytes) == (0.97, 1234)
    jm = jivf.build_mirror(jnp.asarray(_padded(y, 128)),
                           jnp.asarray(active), jstate, BS, cells=cells)
    tm = tivf.build_mirror(torch.from_numpy(_padded(y, 32)),
                           torch.from_numpy(active), tstate, BS,
                           cells=tstate.cells)
    np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(jm.perm))


def test_als_update_publishes_the_index(tmp_path):
    """``oryx.als.ann.publish-index`` no longer refuses: ALSUpdate trains
    the coarse quantizer and ships centroids and per-slice cells, which
    a serving manager then builds from."""
    from oryx_tpu_torch.app.als import update as tupdate

    X, Y = _oracle_catalog(n_users=64, n_items=1024)
    model_dir = str(tmp_path / "gen")
    tupdate.save_features(model_dir + "/Y", [f"i{j}" for j in range(1024)],
                          Y)
    tupdate.save_features(model_dir + "/X", [f"u{j}" for j in range(64)],
                          X)
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", 16)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension(doc, "X", "X/")
    pmml_io.add_extension(doc, "Y", "Y/")
    pmml_io.add_extension_content(doc, "XIDs",
                                  [f"u{j}" for j in range(64)])
    pmml_io.add_extension_content(doc, "YIDs",
                                  [f"i{j}" for j in range(1024)])
    pmml_path = model_dir + "/model.pmml.xml"
    pmml_io.write(doc, pmml_path)
    cfg = tconfig.from_dict({
        "oryx.als.ann.publish-index": True, "oryx.als.ann.cells": 8,
        "oryx.als.ann.nprobe": 6, "oryx.als.ann.train-sample": 1024,
        "oryx.als.publish.slices": 4, "oryx.als.no-known-items": True})
    upd = tupdate.ALSUpdate(cfg, device="cpu")
    msg = upd.prepare_model_ref_payload(doc, pmml_path, [], [])
    _, _, slim = tslices.parse_model_ref(msg)
    assert slim["ann"]["cells"] == 8
    assert all("ann" in e for e in slim["slices"])
    _, tmgr = _managers()
    tmgr.consume_key_message(KEY_MODEL_REF, msg)
    a = tmgr.model._ann
    assert tmgr.ann_index_fallbacks == 0 and a.recall >= 0.95, a.recall
    # centroids within the 8-decimal rounding of the artifact
    want = tivf.train_generation_centroids(Y, upd.ann_config, device="cpu")
    np.testing.assert_allclose(a.centroids, want, atol=1e-7)
