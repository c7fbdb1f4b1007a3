"""The port's RDF common tier (``oryx_tpu_torch/app/{classreg,schema}``,
``app/rdf/{tree,pmml,forest_arrays}``) against the reference's on the
same seeded inputs, the port on the CPU:

- predictions, votes, examples, encodings and the host tree walk give
  the same values;
- ``forest_to_pmml`` writes the reference's bytes for the same forest
  (carried across with ``convert.forest_from_reference``), and
  ``read_forest`` round-trips it;
- ``ForestArrays`` routes every example to the reference's terminal
  indices bit for bit and predicts within rtol 1e-6, with NaN features
  and categorical encodings past the mask width, and agrees with the
  host walk.
"""

from __future__ import annotations

import datetime
import types

import numpy as np
import pytest

from oryx_tpu.app import classreg as jclassreg
from oryx_tpu.app import schema as jschema
from oryx_tpu.app.rdf import forest_arrays as jarrays
from oryx_tpu.app.rdf import pmml as jpmml
from oryx_tpu.app.rdf import tree as jtree
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml_io
from oryx_tpu_torch import convert
from oryx_tpu_torch.app import classreg as tclassreg
from oryx_tpu_torch.app import schema as tschema
from oryx_tpu_torch.app.rdf import forest_arrays as tarrays
from oryx_tpu_torch.app.rdf import pmml as tpmml
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as tpmml_io

RTOL = 1e-6
# a = numeric, color = categorical (4 values), size = numeric,
# shape = categorical (6 values); the target is categorical or numeric
CATS = {1: 4, 3: 6}
VALUES = {1: ["red", "green", "blue", "grey"],
          3: ["o", "x", "t", "s", "c", "h"]}


def _entries(classification: bool):
    names = ["a", "color", "size", "shape", "target"]
    cats = ["color", "shape"] + (["target"] if classification else [])
    return {"oryx.input-schema.feature-names": names,
            "oryx.input-schema.categorical-features": cats,
            "oryx.input-schema.target-feature": "target"}


def _schemas(classification: bool):
    entries = _entries(classification)
    return (jschema.InputSchema(jconfig.from_dict(entries)),
            tschema.InputSchema(tconfig.from_dict(entries)))


def _encodings(classification: bool):
    values = dict(VALUES)
    if classification:
        values[4] = ["yes", "no", "maybe"]
    return (jschema.CategoricalValueEncodings(values),
            tschema.CategoricalValueEncodings(values))


def _random_node(rng, node_id: str, depth: int, classification: bool):
    """A reference node: a random decision down to ``depth``, leaves with
    random predictions; thresholds exact in float32."""
    if depth == 0 or rng.random() < 0.15:
        if classification:
            counts = rng.integers(0, 6, 3).astype(float)
            counts[rng.integers(0, 3)] += 1.0
            pred = jclassreg.CategoricalPrediction(counts)
        else:
            pred = jclassreg.NumericPrediction(
                float(np.float32(rng.normal())), int(rng.integers(1, 50)))
        return jtree.TerminalNode(node_id, pred)
    feature = int(rng.choice([0, 1, 2, 3]))
    default = bool(rng.random() < 0.5)
    if feature in CATS:
        k = int(rng.integers(1, CATS[feature]))
        active = rng.choice(CATS[feature], k, replace=False).tolist()
        decision = jtree.CategoricalDecision(feature, active, default)
    else:
        decision = jtree.NumericDecision(
            feature, float(np.float32(rng.uniform(-1, 1))), default)
    return jtree.DecisionNode(
        node_id, decision,
        _random_node(rng, node_id + "-", depth - 1, classification),
        _random_node(rng, node_id + "+", depth - 1, classification),
        count=int(rng.integers(1, 1000)))


def _random_forest(seed: int, classification: bool, trees: int = 4,
                   depth: int = 5):
    rng = np.random.default_rng(seed)
    return jtree.DecisionForest(
        [jtree.DecisionTree(_random_node(rng, "r", depth, classification))
         for _ in range(trees)],
        rng.uniform(0.5, 2.0, trees),
        rng.dirichlet(np.ones(5)) * np.array([1, 1, 1, 1, 0]))


def _random_matrix(seed: int, n: int = 300):
    """[n, 5] float32 features: numeric uniforms, categorical encodings
    including some past every mask width, 15 % NaN; the target NaN."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, 5), np.float32)
    x[:, 0] = rng.uniform(-1.2, 1.2, n)
    x[:, 2] = rng.uniform(-1.2, 1.2, n)
    x[:, 1] = rng.integers(0, 6, n)      # 4 and 5 are out of range
    x[:, 3] = rng.integers(0, 9, n)      # 6-8 are out of range
    x[rng.random((n, 5)) < 0.15] = np.nan
    x[:, 4] = np.nan
    return x


def _example(module, row):
    features = []
    for f, v in enumerate(row):
        if np.isnan(v):
            features.append(None)
        elif f in CATS:
            features.append(int(v))
        else:
            features.append(float(v))
    return module.Example(None, features)


def _same_nodes(a, b):
    assert a.id == b.id
    assert a.is_terminal == b.is_terminal
    if a.is_terminal:
        pa, pb = a.prediction, b.prediction
        assert pa.count == pb.count
        if hasattr(pa, "category_counts"):
            np.testing.assert_array_equal(pa.category_counts,
                                          pb.category_counts)
        else:
            assert pa.prediction == pb.prediction
        return
    assert a.count == b.count
    da, db = a.decision, b.decision
    assert type(da).__name__ == type(db).__name__
    assert da.feature_number == db.feature_number
    assert da.default_decision == db.default_decision
    if hasattr(da, "threshold"):
        assert da.threshold == db.threshold
    else:
        assert set(da.active_category_encodings) == \
            set(db.active_category_encodings)
    _same_nodes(a.left, b.left)
    _same_nodes(a.right, b.right)


# -- classreg and schema ------------------------------------------------------

def test_predictions_and_votes_match():
    rng = np.random.default_rng(1)
    for _ in range(20):
        counts = rng.integers(0, 9, 4).astype(float)
        counts[0] += 1
        j = jclassreg.CategoricalPrediction(counts.copy())
        t = tclassreg.CategoricalPrediction(counts.copy())
        for enc, n in zip(rng.integers(0, 4, 5), rng.integers(1, 7, 5)):
            j.update(int(enc), int(n))
            t.update(int(enc), int(n))
        np.testing.assert_array_equal(t.category_probabilities,
                                      j.category_probabilities)
        assert (t.count, t.get_most_probable_category_encoding()) == \
            (j.count, j.get_most_probable_category_encoding())
        jn = jclassreg.NumericPrediction(float(rng.normal()), 3)
        tn = tclassreg.NumericPrediction(jn.prediction, 3)
        for v, n in zip(rng.normal(size=4), rng.integers(1, 5, 4)):
            jn.update(float(v), int(n))
            tn.update(float(v), int(n))
        assert (tn.prediction, tn.count) == (jn.prediction, jn.count)
    weights = rng.uniform(0.5, 2, 3).tolist()
    probs = [rng.integers(1, 9, 3).astype(float) for _ in range(3)]
    jv = jclassreg.vote_on_feature(
        [jclassreg.CategoricalPrediction(p) for p in probs], weights)
    tv = tclassreg.vote_on_feature(
        [tclassreg.CategoricalPrediction(p) for p in probs], weights)
    np.testing.assert_array_equal(tv.category_probabilities,
                                  jv.category_probabilities)
    vals = rng.normal(size=3).tolist()
    assert tclassreg.vote_on_feature(
        [tclassreg.NumericPrediction(v, 1) for v in vals], weights
    ).prediction == jclassreg.vote_on_feature(
        [jclassreg.NumericPrediction(v, 1) for v in vals], weights).prediction
    with pytest.raises(ValueError):
        tclassreg.vote_on_feature([], [])


@pytest.mark.parametrize("classification", [True, False])
def test_examples_and_encodings_match(classification):
    js, ts = _schemas(classification)
    je, te = _encodings(classification)
    assert ts.is_classification() == js.is_classification() == \
        classification
    for f in (1, 3):
        assert te.get_value_encoding_map(f) == je.get_value_encoding_map(f)
        assert te.get_encoding_value_map(f) == je.get_encoding_value_map(f)
        assert te.get_value_count(f) == je.get_value_count(f)
    assert te.get_category_counts() == je.get_category_counts()
    assert te.try_encode(1, "purple") is None
    assert te.try_encode(0, "1.0") is None
    rng = np.random.default_rng(2)
    target = ["yes", "no", "maybe", ""] if classification else \
        ["1.5", "-2", ""]
    for _ in range(30):
        tokens = [f"{rng.uniform(-1, 1):.3f}",
                  str(rng.choice(VALUES[1] + ["purple"])),
                  f"{rng.uniform(-1, 1):.3f}", str(rng.choice(VALUES[3])),
                  str(rng.choice(target))]
        je_ = jclassreg.example_from_tokens(tokens, js, je)
        te_ = tclassreg.example_from_tokens(tokens, ts, te)
        assert te_.features == je_.features
        assert te_.target == je_.target


def test_tree_walk_and_find_by_id_match():
    jforest = _random_forest(3, True)
    tforest = convert.forest_from_reference(jforest)
    x = _random_matrix(4)
    for row in x:
        jex, tex = _example(jclassreg, row), _example(tclassreg, row)
        for jt, tt in zip(jforest.trees, tforest.trees):
            leaf = jt.find_terminal(jex)
            assert tt.find_terminal(tex).id == leaf.id
            assert tt.find_by_id(leaf.id).id == leaf.id
        np.testing.assert_array_equal(
            tforest.predict(tex).category_probabilities,
            jforest.predict(jex).category_probabilities)
    node_ids = [n.id for n in jforest.trees[0].nodes()]
    assert [n.id for n in tforest.trees[0].nodes()] == node_ids
    with pytest.raises(ValueError):
        tforest.trees[0].find_by_id(node_ids[-1] + "+")


# -- PMML ---------------------------------------------------------------------

class _FrozenClock(datetime.datetime):
    """The PMML header's wall clock, pinned: documents written a second
    apart would otherwise differ in their <Timestamp> alone."""

    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 1, 1, tzinfo=tz)


@pytest.mark.parametrize("classification,trees,extensions", [
    (True, 4, True), (True, 1, False), (False, 3, True), (False, 1, True)])
def test_forest_to_pmml_bytes_match(monkeypatch, classification, trees,
                                    extensions):
    frozen = types.SimpleNamespace(datetime=_FrozenClock,
                                   timezone=datetime.timezone)
    monkeypatch.setattr(jpmml_io, "datetime", frozen)
    monkeypatch.setattr(tpmml_io, "datetime", frozen)
    js, ts = _schemas(classification)
    je, te = _encodings(classification)
    jforest = _random_forest(10 + trees, classification, trees=trees)
    tforest = convert.forest_from_reference(jforest)
    kw = dict(max_depth=5, max_split_candidates=32,
              impurity="gini" if classification else "variance") \
        if extensions else {}
    jdoc = jpmml_io.to_string(jpmml.forest_to_pmml(jforest, js, je, **kw))
    tdoc = tpmml_io.to_string(tpmml.forest_to_pmml(tforest, ts, te, **kw))
    assert tdoc == jdoc
    # the port reads the document back to the same forest and encodings
    tpmml.validate_pmml_vs_schema(tpmml_io.from_string(tdoc), ts)
    back, enc = tpmml.read_forest(tpmml_io.from_string(tdoc))
    jback, jenc = jpmml.read_forest(jpmml_io.from_string(jdoc))
    for f in enc.get_category_counts():
        assert enc.get_value_encoding_map(f) == \
            jenc.get_value_encoding_map(f)
    np.testing.assert_array_equal(back.weights, jback.weights)
    np.testing.assert_array_equal(back.feature_importances,
                                  jback.feature_importances)
    for a, b in zip(back.trees, jback.trees):
        _same_nodes(a.root, b.root)
    # and writes it again byte for byte
    assert tpmml_io.to_string(tpmml.forest_to_pmml(
        back, ts, enc, **kw)) == tdoc


def test_validate_pmml_vs_schema_refusals_match():
    js, ts = _schemas(True)
    je, te = _encodings(True)
    doc = jpmml_io.to_string(jpmml.forest_to_pmml(
        _random_forest(5, True, trees=2), js, je))
    for entries in (_entries(False),
                    {**_entries(True), "oryx.input-schema.feature-names":
                     ["a", "colour", "size", "shape", "target"],
                     "oryx.input-schema.categorical-features":
                     ["colour", "shape", "target"]},
                    {**_entries(True), "oryx.input-schema.target-feature":
                     "shape"}):
        with pytest.raises(ValueError) as jerr:
            jpmml.validate_pmml_vs_schema(
                jpmml_io.from_string(doc),
                jschema.InputSchema(jconfig.from_dict(entries)))
        with pytest.raises(ValueError) as terr:
            tpmml.validate_pmml_vs_schema(
                tpmml_io.from_string(doc),
                tschema.InputSchema(tconfig.from_dict(entries)))
        assert str(terr.value) == str(jerr.value)


# -- the forest walk ----------------------------------------------------------

@pytest.mark.parametrize("classification", [True, False])
def test_forest_arrays_match_reference_and_host_walk(classification):
    jforest = _random_forest(20, classification, trees=5, depth=6)
    tforest = convert.forest_from_reference(jforest)
    k = 3 if classification else 0
    jarr = jarrays.ForestArrays(jforest, 5, k)
    tarr = tarrays.ForestArrays(tforest, 5, k, device="cpu")
    assert tarr.max_depth == jarr.max_depth
    assert tarr.node_ids == jarr.node_ids
    x = _random_matrix(21, 400)
    got = tarr.route(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jarr.route(x))
    assert tarr.route_ids(x) == jarr.route_ids(x)
    if classification:
        got_p, want_p = tarr.predict_proba(x), jarr.predict_proba(x)
        with pytest.raises(ValueError):
            tarr.predict_value(x)
    else:
        got_p, want_p = tarr.predict_value(x), jarr.predict_value(x)
        with pytest.raises(ValueError):
            tarr.predict_proba(x)
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=RTOL)
    # the host walk of the same forest
    ids = tarr.route_ids(x)
    for i, row in enumerate(x):
        ex = _example(tclassreg, row)
        for t, tree in enumerate(tforest.trees):
            assert ids[t][i] == tree.find_terminal(ex).id
        host = tforest.predict(ex)
        want = host.category_probabilities if classification \
            else host.prediction
        np.testing.assert_allclose(got_p[i], want, rtol=RTOL, atol=RTOL)


def test_examples_to_matrix_matches():
    rng = np.random.default_rng(7)
    rows = [[None if rng.random() < 0.2 else float(rng.normal()),
             None if rng.random() < 0.2 else int(rng.integers(0, 4)),
             float(rng.normal()), None, None] for _ in range(40)]
    want = jarrays.examples_to_matrix(
        [jclassreg.Example(None, r) for r in rows], 5)
    got = tarrays.examples_to_matrix(
        [tclassreg.Example(None, r) for r in rows], 5)
    np.testing.assert_array_equal(got, want)
