"""The port's forest trainer (``oryx_tpu_torch/app/rdf/trainer.py``)
against the reference's (``oryx_tpu/app/rdf/trainer.py``) on the same
seeded inputs, the port on the CPU:

- the binning bit for bit; classification histograms, slot counts and
  the advance bit for bit (the advance also at a frontier of 512 slots,
  child ids past 256, against a NumPy walk); regression histograms
  within rtol 1e-5; the best splits equal, except at counted near-ties
  (the reference's gains at both candidates within rtol 1e-6);
- whole ``train_forest`` runs for gini, entropy and variance with a
  categorical predictor, the reference's random draws injected through
  ``_bootstrap_weights``/``_feature_uniforms``: the same trees,
  thresholds, category sets, counts and importances, except below a
  counted near-tie;
- runs on the port's own generator, held to the reference tests' bars
  for accuracy and regression error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.app.rdf import trainer as jtr
from oryx_tpu.app.schema import InputSchema as JaxSchema
from oryx_tpu.common import config as jconfig
from oryx_tpu_torch.app.classreg import Example
from oryx_tpu_torch.app.rdf import trainer as ttr
from oryx_tpu_torch.app.rdf.forest_arrays import ForestArrays
from oryx_tpu_torch.app.schema import InputSchema
from oryx_tpu_torch.common import config as tconfig

HIST_RTOL = 1e-5
# a gain is a difference of impurities, so it carries the rounding of
# its parent's impurity: gains compare, and near-ties are judged, within
# TIE_RTOL of the parent node's impurity
TIE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One torch thread per test: under the suite's parallel workers the
    products would otherwise take every core from the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _level_inputs(seed, T=3, B=700, P=4, S=8, M=8, classes=3,
                  regression=False):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, S, (B, P)).astype(np.int32)
    if regression:
        y = rng.normal(2.0, 3.0, B).astype(np.float32)
        ychan = np.stack([np.ones_like(y), y, y * y], 1).astype(np.float32)
    else:
        ychan = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]
    w = rng.poisson(1.0, (T, B)).astype(np.float32)
    slot_of = rng.integers(-1, M, (T, B)).astype(np.int32)
    return binned, ychan, w, slot_of


def _ref_gains(hist, is_cat_p, feat_mask, impurity, k_features):
    """The reference's gain of every (tree, slot, candidate) and the
    parent impurity of every (tree, slot), from its own ``_impurity``:
    ``_best_splits`` (reference :204-231) up to its argmax, as float64."""
    num_bins = hist.shape[3]
    totals = hist[:, :, 0].sum(2)
    parent_n, parent_imp = jtr._impurity(totals, impurity)
    if impurity == "variance":
        score = hist[..., 1] / jnp.maximum(hist[..., 0], 1e-12)
    else:
        score = hist[..., 0] / jnp.maximum(hist.sum(-1), 1e-12)
    order = jnp.argsort(score, axis=3)
    order = jnp.where(is_cat_p[None, None, :, None], order,
                      jnp.arange(num_bins)[None, None, None, :])
    cum = jnp.cumsum(jnp.take_along_axis(hist, order[..., None], axis=3),
                     axis=3)
    left = cum[:, :, :, :-1]
    right = totals[:, :, None, None] - left
    n_left, imp_left = jtr._impurity(left, impurity)
    n_right, imp_right = jtr._impurity(right, impurity)
    n = jnp.maximum(parent_n[:, :, None, None], 1e-12)
    gain = parent_imp[:, :, None, None] - \
        (n_left * imp_left + n_right * imp_right) / n
    gain = jnp.where((n_left > 0) & (n_right > 0), gain, -jnp.inf)
    kth = jnp.sort(feat_mask, axis=2)[:, :, k_features - 1]
    gain = jnp.where((feat_mask <= kth[:, :, None])[..., None], gain,
                     -jnp.inf)
    return (np.asarray(gain, np.float64).reshape(
        gain.shape[0], gain.shape[1], -1),
            np.asarray(parent_imp, np.float64))


def _near_tie(gains, parent_imp, i, j) -> bool:
    """Whether candidates ``i`` and ``j`` of one (tree, slot) gain the
    same within TIE_RTOL of the parent's impurity, in the reference's
    numbers (None: no split, gain 0)."""
    gi = 0.0 if i is None else gains[i]
    gj = 0.0 if j is None else gains[j]
    return bool(np.isfinite(gi) and np.isfinite(gj)
                and abs(gi - gj) <= TIE_RTOL * max(parent_imp, 1e-12))


# -- the level functions ------------------------------------------------------

def test_bin_features_bit_identical():
    rng = np.random.default_rng(3)
    x = np.stack([rng.normal(size=2000), rng.integers(0, 7, 2000),
                  np.round(rng.uniform(0, 5, 2000), 1),
                  rng.exponential(size=2000)], 1).astype(np.float32)
    is_cat = np.array([False, True, False, False])
    for bins in (2, 16, 100):
        got = ttr._bin_features(x, is_cat, bins)
        want = jtr._bin_features(x, is_cat, bins)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("M,chunk", [(1, 1 << 16), (8, 64), (32, 100)])
def test_classification_histograms_bit_identical(monkeypatch, M, chunk):
    """Chunked over examples (the port's chunk forced small) or not."""
    monkeypatch.setattr(ttr, "_HIST_CHUNK", chunk)
    binned, ychan, w, slot_of = _level_inputs(5 + M, M=M)
    want = np.asarray(jtr._histograms(
        jnp.asarray(binned), jnp.asarray(ychan), jnp.asarray(w),
        jnp.asarray(slot_of), M, 8, True))
    got = ttr._histograms(_t(binned), _t(ychan), _t(w),
                          _t(slot_of).long(), M, 8, True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # exact integers: an int64 recount of the same slots
    T, B = w.shape
    recount = np.zeros(want.shape, np.int64)
    for t in range(T):
        for b in range(B):
            if slot_of[t, b] >= 0:
                c = int(np.argmax(ychan[b]))
                for p in range(binned.shape[1]):
                    recount[t, slot_of[t, b], p, binned[b, p], c] += \
                        int(w[t, b])
    np.testing.assert_array_equal(got.numpy().astype(np.int64), recount)


def test_regression_histograms_within_rtol(monkeypatch):
    monkeypatch.setattr(ttr, "_HIST_CHUNK", 128)
    binned, ychan, w, slot_of = _level_inputs(11, M=4, regression=True)
    want = np.asarray(jtr._histograms(
        jnp.asarray(binned), jnp.asarray(ychan), jnp.asarray(w),
        jnp.asarray(slot_of), 4, 8, False))
    got = ttr._histograms(_t(binned), _t(ychan), _t(w),
                          _t(slot_of).long(), 4, 8, False).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=HIST_RTOL,
                               atol=HIST_RTOL * scale)


@pytest.mark.parametrize("M", [1, 64])
def test_slot_counts_bit_identical(M):
    rng = np.random.default_rng(45 + M)
    slot_of = rng.integers(-1, M, (4, 3000)).astype(np.int32)
    want = np.asarray(jtr._slot_counts(jnp.asarray(slot_of), M))
    got = ttr._slot_counts(_t(slot_of).long(), M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
def test_best_splits_match(impurity):
    """Same histograms in, the same split decisions out; a differing
    choice must be a near-tie in the reference's own gains."""
    regression = impurity == "variance"
    T, M, P, S = 3, 16, 4, 12
    rng = np.random.default_rng({"gini": 1, "entropy": 2, "variance": 3}[
        impurity])
    binned, ychan, w, slot_of = _level_inputs(
        7, T=T, B=3000, P=P, S=S, M=M, regression=regression)
    # predictor 1 categorical with empty bins (ties of score 0 to sort)
    binned[:, 1] = rng.integers(0, S // 2, len(binned)) * 2
    hist = np.asarray(jtr._histograms(
        jnp.asarray(binned), jnp.asarray(ychan), jnp.asarray(w),
        jnp.asarray(slot_of), M, S, not regression))
    is_cat = np.array([False, True, False, False])
    feat_u = rng.random((T, M, P), dtype=np.float32)
    k = 2
    want = [np.asarray(a) for a in jtr._best_splits(
        jnp.asarray(hist), jnp.asarray(is_cat), jnp.asarray(feat_u),
        impurity, k)]
    got = [a.numpy() for a in ttr._best_splits(
        _t(hist), _t(is_cat), _t(feat_u), impurity, k)]
    gains, parent_imp = _ref_gains(jnp.asarray(hist), jnp.asarray(is_cat),
                                   jnp.asarray(feat_u), impurity, k)
    if regression:                                          # totals
        np.testing.assert_allclose(got[5], want[5], rtol=TIE_RTOL)
    else:
        np.testing.assert_array_equal(got[5], want[5])
    ties = 0
    for t in range(T):
        for m in range(M):
            i = int(want[1][t, m] * (S - 1) + want[2][t, m])
            j = int(got[1][t, m] * (S - 1) + got[2][t, m])
            if i != j:
                assert _near_tie(gains[t, m], parent_imp[t, m], i, j), \
                    (t, m, i, j)
                ties += 1
                continue
            assert abs(float(got[0][t, m]) - float(want[0][t, m])) <= \
                TIE_RTOL * parent_imp[t, m]
            assert got[3][t, m] == want[3][t, m]
            np.testing.assert_array_equal(got[4][t, m], want[4][t, m])
    # classification statistics are exact integers: no tie can differ
    assert ties == 0 or regression or impurity == "entropy"
    assert ties <= 2


def test_advance_matches_reference_and_numpy_at_wide_frontier():
    """Child slot ids past 256 route exactly (the reference guards them
    with exact float32 product passes; the port's gathers are integer
    work)."""
    rng = np.random.default_rng(44)
    T, B, P, M, S = 3, 5000, 6, 512, 16
    slot_of = rng.integers(-1, M, (T, B)).astype(np.int32)
    binned = rng.integers(0, S, (B, P)).astype(np.int32)
    split = rng.random((T, M)) < 0.8
    best_p = rng.integers(0, P, (T, M)).astype(np.int32)
    best_b = rng.integers(0, S - 1, (T, M)).astype(np.int32)
    is_cat = rng.random((T, M)) < 0.3
    rmask = rng.random((T, M, S)) < 0.5
    child = rng.integers(0, 2 * M, (T, M, 2)).astype(np.int32)
    got = ttr._advance(_t(slot_of).long(), _t(binned.T.copy()).long(),
                       _t(split), _t(best_p).long(), _t(best_b).long(),
                       _t(is_cat), _t(rmask), _t(child).long()).numpy()
    ref = np.asarray(jtr._advance(
        jnp.asarray(slot_of), jnp.asarray(binned), jnp.asarray(split),
        jnp.asarray(best_p), jnp.asarray(best_b), jnp.asarray(is_cat),
        jnp.asarray(rmask), jnp.asarray(child)))
    np.testing.assert_array_equal(got, ref)
    want = np.full((T, B), -1, np.int64)
    for t in range(T):
        for b in range(B):
            s = slot_of[t, b]
            if s < 0 or not split[t, s]:
                continue
            v = binned[b, best_p[t, s]]
            right = rmask[t, s, v] if is_cat[t, s] else v > best_b[t, s]
            want[t, b] = child[t, s, 1 if right else 0]
    np.testing.assert_array_equal(got, want)
    assert got.max() > 256


# -- whole training runs ------------------------------------------------------

def _entries(regression: bool):
    return {"oryx.input-schema.feature-names": ["a", "b", "c", "d", "y"],
            "oryx.input-schema.categorical-features":
                ["c"] if regression else ["c", "y"],
            "oryx.input-schema.target-feature": "y"}


def _problem(seed: int, regression: bool, n: int = 500):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, n)
    b = rng.normal(size=n)
    c = rng.integers(0, 5, n)
    d = rng.uniform(0, 3, n)
    if regression:
        y = (2 * a + np.array([0.0, 1.5, -1.0, 3.0, 0.5])[c]
             + 0.1 * rng.normal(size=n)).astype(np.float32)
    else:
        y = (((a + 0.3 * b > 0) ^ (c == 3)).astype(np.int32)
             + (c == 4) * (d > 1.5)).astype(np.int32)
    return np.stack([a, b, c, d], 1).astype(np.float32), y


def _frontiers(tree):
    """Per depth, the frontier's node IDs in slot order."""
    out, level = [], [tree.root]
    while level:
        out.append([n.id for n in level])
        level = [c for n in level if not n.is_terminal
                 for c in (n.left, n.right)]
    return out


def _decision_key(node):
    if node.is_terminal:
        return None
    d = node.decision
    return (d.feature_number, d.default_decision,
            getattr(d, "threshold", None),
            frozenset(getattr(d, "active_category_encodings", ())))


def _compare_forests(jforest, tforest, ref_levels, port_levels, num_bins):
    """Node by node from the root; the first depth at which any tree
    differs must hold only near-ties of the reference's gains, and is
    the last depth compared.  Returns the count of ties."""
    by_depth = {}
    for t, (jt, tt) in enumerate(zip(jforest.trees, tforest.trees)):
        jnodes = {n.id: n for n in jt.nodes()}
        tnodes = {n.id: n for n in tt.nodes()}
        for depth, ids in enumerate(_frontiers(jt)):
            for slot, node_id in enumerate(ids):
                a, b = jnodes[node_id], tnodes.get(node_id)
                if b is None or _decision_key(a) != _decision_key(b):
                    by_depth.setdefault(depth, []).append((t, slot, node_id))
    stop = min(by_depth, default=None)
    for t, (jt, tt) in enumerate(zip(jforest.trees, tforest.trees)):
        tnodes = {n.id: n for n in tt.nodes()}
        for n in jt.nodes():
            depth = len(n.id) - 1
            if stop is not None and depth >= stop:
                continue
            m = tnodes[n.id]
            assert m.count == n.count, n.id
            if n.is_terminal:
                pa, pb = n.prediction, m.prediction
                if hasattr(pa, "category_counts"):
                    np.testing.assert_allclose(
                        pb.category_counts, pa.category_counts, rtol=1e-12)
                else:
                    np.testing.assert_allclose(pb.prediction, pa.prediction,
                                               rtol=HIST_RTOL)
    if stop is None:
        np.testing.assert_allclose(tforest.feature_importances,
                                   jforest.feature_importances, rtol=1e-12)
        return 0
    hist, is_cat, feat_u, impurity, k, ref_out = ref_levels[stop]
    gains, parent_imp = _ref_gains(hist, is_cat, feat_u, impurity, k)
    port_out = port_levels[stop]
    for t, slot, node_id in by_depth[stop]:
        def pick(out):
            g, p, b = (np.asarray(out[i])[t, slot] for i in range(3))
            return None if not (g > 0 and np.isfinite(g)) else \
                int(p) * (num_bins - 1) + int(b)
        assert _near_tie(gains[t, slot], parent_imp[t, slot],
                         pick(ref_out), pick(port_out)), (t, node_id)
    return len(by_depth[stop])


@pytest.mark.parametrize("impurity,seed", [("gini", 3), ("entropy", 4),
                                           ("variance", 5)])
def test_train_forest_matches_reference_with_its_draws(monkeypatch,
                                                       impurity, seed):
    regression = impurity == "variance"
    x, y = _problem(seed, regression)
    key = jax.random.PRNGKey(seed)
    monkeypatch.setattr(
        ttr, "_bootstrap_weights", lambda gen, shape, device: _t(
            np.asarray(jax.random.poisson(key, 1.0, shape),
                       np.float32)).to(device))
    monkeypatch.setattr(
        ttr, "_feature_uniforms", lambda gen, depth, shape, device: _t(
            np.asarray(jax.random.uniform(jax.random.fold_in(
                key, depth + 1), shape))).to(device))
    ref_levels, port_levels = [], []
    ref_best, port_best = jtr._best_splits, ttr._best_splits

    def ref_capture(hist, is_cat, feat_u, imp, k):
        out = ref_best(hist, is_cat, feat_u, imp, k)
        ref_levels.append((hist, is_cat, feat_u, imp, k, out))
        return out

    def port_capture(*args):
        out = port_best(*args)
        port_levels.append([a.numpy() for a in out])
        return out

    monkeypatch.setattr(jtr, "_best_splits", ref_capture)
    monkeypatch.setattr(ttr, "_best_splits", port_capture)
    entries = _entries(regression)
    num_classes = None if regression else 3
    bins = 16
    jforest = jtr.train_forest(
        x, y, JaxSchema(jconfig.from_dict(entries)), {2: 5}, 4, 5, bins,
        impurity, seed=seed, num_classes=num_classes)
    tforest = ttr.train_forest(
        x, y, InputSchema(tconfig.from_dict(entries)), {2: 5}, 4, 5, bins,
        impurity, seed=seed, num_classes=num_classes, device="cpu")
    ties = _compare_forests(jforest, tforest, ref_levels, port_levels, bins)
    # on these inputs every split agrees: a tie would show up here first
    assert ties == 0
    # the categorical predictor was split on
    assert any(not n.is_terminal
               and hasattr(n.decision, "active_category_encodings")
               for t in tforest.trees for n in t.nodes())


def _classification_schema():
    return InputSchema(tconfig.from_dict({
        "oryx.input-schema.feature-names": ["a", "b", "color", "label"],
        "oryx.input-schema.categorical-features": ["color", "label"],
        "oryx.input-schema.target-feature": "label"}))


def test_classification_forest_learns_on_its_generator():
    """The reference's test_classification_forest_learns, on the port."""
    rng = np.random.default_rng(7)
    n = 600
    a = rng.uniform(-1, 1, n)
    b = rng.uniform(-1, 1, n)
    color = rng.integers(0, 3, n)
    y = np.where(a >= 0.2, 1, np.where(color == 2, 1, 0))
    x = np.stack([a, b, color.astype(float)], axis=1).astype(np.float32)
    schema = _classification_schema()
    forest = ttr.train_forest(x, y, schema, category_counts={2: 3},
                              num_trees=5, max_depth=4,
                              max_split_candidates=16, impurity="gini",
                              seed=123, num_classes=2, device="cpu")
    assert len(forest.trees) == 5
    arrays = ForestArrays(forest, schema.num_features, 2, device="cpu")
    full = np.full((n, 4), np.nan, dtype=np.float32)
    full[:, 0], full[:, 1], full[:, 2] = a, b, color
    assert (arrays.predict_proba(full).argmax(axis=1) == y).mean() > 0.95
    imp = forest.feature_importances
    assert imp[0] > imp[1]
    assert imp.sum() == pytest.approx(1.0)
    assert imp[3] == 0.0
    for tree in forest.trees:
        assert tree.root.count == n or tree.root.is_terminal
    # the host walk agrees with the arrays
    probs = arrays.predict_proba(full)
    for i in range(0, n, 37):
        ex = Example(None, [float(a[i]), float(b[i]), int(color[i]), None])
        np.testing.assert_allclose(
            probs[i], forest.predict(ex).category_probabilities, atol=1e-6)


def test_regression_forest_learns_on_its_generator():
    rng = np.random.default_rng(3)
    n = 500
    a = rng.uniform(0, 4, n)
    y = np.where(a < 2.0, 1.0, 5.0) + rng.normal(0, 0.05, n)
    schema = InputSchema(tconfig.from_dict({
        "oryx.input-schema.feature-names": ["a", "y"],
        "oryx.input-schema.numeric-features": ["a", "y"],
        "oryx.input-schema.target-feature": "y"}))
    forest = ttr.train_forest(a[:, None].astype(np.float32), y, schema, {},
                              3, 3, 32, "variance", seed=5, device="cpu")
    out = ForestArrays(forest, 2, 0, device="cpu").predict_value(
        np.array([[0.5, np.nan], [3.5, np.nan]], dtype=np.float32))
    assert abs(out[0] - 1.0) < 0.3
    assert abs(out[1] - 5.0) < 0.3


def test_trainer_determinism_and_validation():
    x = np.array([[0.0], [1.0], [2.0], [3.0]] * 10, dtype=np.float32)
    y = np.array([0, 0, 1, 1] * 10)
    schema = InputSchema(tconfig.from_dict({
        "oryx.input-schema.feature-names": ["a", "label"],
        "oryx.input-schema.categorical-features": ["label"],
        "oryx.input-schema.target-feature": "label"}))
    f1 = ttr.train_forest(x, y, schema, {}, 2, 3, 8, "entropy", seed=9,
                          num_classes=2, device="cpu")
    f2 = ttr.train_forest(x, y, schema, {}, 2, 3, 8, "entropy", seed=9,
                          num_classes=2, device="cpu")
    for t1, t2 in zip(f1.trees, f2.trees):
        assert [n.id for n in t1.nodes()] == [n.id for n in t2.nodes()]
    timings: dict = {}
    ttr.train_forest(x, y, schema, {}, 2, 3, 8, "gini", seed=9,
                     num_classes=2, device="cpu", timings=timings)
    assert set(timings) == {"bin_features", "init_upload", "level_dispatch",
                            "level_fetch", "level_host_partition",
                            "level_advance_dispatch", "build_forest"}
    for bad in (dict(impurity="variance"), dict(category_counts={0: 100}),
                dict(max_split_candidates=1), dict(max_depth=0),
                dict(impurity="misclassification")):
        args = dict(category_counts={}, num_trees=2, max_depth=3,
                    max_split_candidates=8, impurity="gini")
        args.update(bad)
        with pytest.raises(ValueError):
            ttr.train_forest(x, y, schema, seed=9, device="cpu", **args)
