"""The port's cluster merge (``cluster/merge.py``) against the
reference's: ``canon_sort`` and ``merge_top_n`` on the same seeded rows,
ties included, and ``exact_local_top_n`` on a port and a reference
manager that replayed the same simulated update topic, per shard and
merged.  Factor values are multiples of 1/4 at 4 features, so every dot
product is exact in float32: the tolerance is zero — the same ids in
the same order, the same scores and the same ordinals.  Retired rows
recycle store rows in each process's own order, the divergence the
canonical (score, ordinal, id) order neutralizes."""

from __future__ import annotations

import json

import numpy as np
import pytest

from oryx_tpu.app.als.rescorer import Rescorer as JRescorer
from oryx_tpu.app.als.rescorer import RescorerProvider as JProvider
from oryx_tpu.app.als.serving_manager import \
    ALSServingModelManager as JManager
from oryx_tpu.app.als.serving_model import ALSServingModel as JModel
from oryx_tpu.cluster import merge as jmerge
from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu_torch.app.als.rescorer import Rescorer as TRescorer
from oryx_tpu_torch.app.als.rescorer import RescorerProvider as TProvider
from oryx_tpu_torch.app.als.serving_manager import \
    ALSServingModelManager as TManager
from oryx_tpu_torch.app.als.serving_model import ALSServingModel as TModel
from oryx_tpu_torch.cluster import merge as tmerge
from oryx_tpu_torch.cluster.sharding import shard_of
from oryx_tpu_torch.common.config import from_dict as tfrom_dict

FEATURES = 4
NO_ORDINAL = 1 << 62


def _rows(rng, n, n_scores=6):
    """Seeded (id, score, ordinal) rows with many exact score ties and
    some ordinal ties (the id then decides)."""
    scores = rng.integers(-n_scores, n_scores, n) / 4.0
    ordinals = rng.integers(0, n // 2 + 1, n)
    return [(f"x{j}", float(s), int(o))
            for j, (s, o) in enumerate(zip(scores, ordinals))]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("lowest", [False, True])
def test_canon_sort_matches_reference(seed, lowest):
    rows = _rows(np.random.default_rng(seed), 80)
    assert tmerge.canon_sort(rows, lowest) == \
        jmerge.canon_sort(rows, lowest)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("how_many,offset", [(1, 0), (7, 0), (10, 5),
                                             (200, 0)])
def test_merge_top_n_matches_reference(seed, how_many, offset):
    rng = np.random.default_rng(100 + seed)
    rows = _rows(rng, 90)
    cut = sorted(rng.choice(np.arange(1, 90), 2, replace=False))
    shards = [rows[:cut[0]], rows[cut[0]:cut[1]], rows[cut[1]:]]
    for lowest in (False, True):
        want = jmerge.merge_top_n(shards, how_many, offset, lowest=lowest)
        got = tmerge.merge_top_n(shards, how_many, offset, lowest=lowest)
        assert got == want


# -- exact_local_top_n on replayed managers ----------------------------------

class _JRescorer(JRescorer):
    def rescore(self, item_id, score):
        return -score / 2.0 if int(item_id[1:]) % 2 == 0 else score

    def is_filtered(self, item_id):
        return item_id.endswith("3")


class _TRescorer(TRescorer):
    def rescore(self, item_id, score):
        return -score / 2.0 if int(item_id[1:]) % 2 == 0 else score

    def is_filtered(self, item_id):
        return item_id.endswith("3")


class _JProvider(JProvider):
    def get_recommend_rescorer(self, user_id, args):
        return _JRescorer()


class _TProvider(TProvider):
    def get_recommend_rescorer(self, user_id, args):
        return _TRescorer()


def _jmanager(spec, provider=None):
    mgr = JManager(jfrom_dict({
        "oryx.serving.model-manager-class": "unused",
        "oryx.cluster.enabled": True, "oryx.cluster.shard": spec,
        "oryx.input-topic.broker": None, "oryx.update-topic.broker": None}))
    mgr.model = JModel(FEATURES, implicit=True, sample_rate=1.0,
                       rescorer_provider=provider)
    return mgr


def _tmanager(spec, provider=None):
    mgr = TManager(tfrom_dict({
        "oryx.serving.model-manager-class": "unused",
        "oryx.cluster.enabled": True, "oryx.cluster.shard": spec,
        "oryx.input-topic.broker": None, "oryx.update-topic.broker": None}),
        device="cpu")
    mgr.model = TModel(FEATURES, implicit=True, sample_rate=1.0,
                       rescorer_provider=provider, device="cpu")
    return mgr


def _grid_vec(rng):
    return [float(x) / 4.0 for x in rng.integers(-8, 9, FEATURES)]


def _replay(rng, managers, n_items=60, n_users=8, pool_size=14,
            retire_fraction=0.4):
    """One simulated update topic, consumed identically by every
    manager: Y vectors from a small pool (exact ties), users, a retire
    wave, then a second wave that recycles freed rows."""
    def feed(key, msg):
        for m in managers:
            m.consume_key_message(key, msg)

    pool = [_grid_vec(rng) for _ in range(pool_size)]
    items = [f"i{j}" for j in range(n_items)]
    for iid in items:
        feed("UP", json.dumps(["Y", iid, pool[int(rng.integers(0, pool_size))]]))
    for u in range(n_users):
        known = [items[k] for k in rng.choice(n_items, 5, replace=False)]
        feed("UP", json.dumps(["X", f"u{u}", _grid_vec(rng), known]))
    retired = [i for i in items if rng.random() < retire_fraction]
    for m in managers:
        for iid in retired:
            m.model.Y.remove(iid)
    for iid in [f"j{j}" for j in range(n_items // 2)] + retired[::2]:
        feed("UP", json.dumps(["Y", iid, pool[int(rng.integers(0, pool_size))]]))


def _ordinal(mgr):
    return lambda i: mgr.item_ordinals.get(i, NO_ORDINAL)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_exact_local_top_n_and_merge_match_reference(shards):
    rng = np.random.default_rng(200 + shards)
    specs = [f"{s}/{shards}" for s in range(shards)] + ["0/1"]
    jm = [_jmanager(s) for s in specs]
    tm = [_tmanager(s) for s in specs]
    _replay(rng, jm + tm)
    for j, t in zip(jm, tm):
        assert t.item_ordinals == j.item_ordinals
        assert t.skipped_remote_items == j.skipped_remote_items
        assert sorted(t.model.all_item_ids()) == \
            sorted(j.model.all_item_ids())
    jfull, tfull = jm[-1], tm[-1]
    for u in range(8):
        uid = f"u{u}"
        xu = tfull.model.get_user_vector(uid)
        exclude = tfull.model.get_known_items(uid)
        assert exclude == jfull.model.get_known_items(uid)
        for how_many in (1, 3, 10, 25):
            for lowest in (False, True):
                tparts = [tmerge.exact_local_top_n(
                    m.model, _ordinal(m), how_many, user_vector=xu,
                    exclude=exclude, lowest=lowest) for m in tm[:-1]]
                jparts = [jmerge.exact_local_top_n(
                    m.model, _ordinal(m), how_many, user_vector=xu,
                    exclude=exclude, lowest=lowest) for m in jm[:-1]]
                assert tparts == jparts, (uid, how_many, lowest)
                merged = tmerge.merge_top_n(tparts, how_many,
                                            lowest=lowest)
                single = tmerge.exact_local_top_n(
                    tfull.model, _ordinal(tfull), how_many,
                    user_vector=xu, exclude=exclude, lowest=lowest)
                assert merged == single[:how_many]
                assert merged == jmerge.merge_top_n(jparts, how_many,
                                                    lowest=lowest)


def test_boundary_tie_group_is_widened_like_the_reference():
    """One winner, 30 exactly tied items and 10 losers: the tie group
    straddling k resolves by ordinal on both packages."""
    specs = ["0/2", "1/2", "0/1"]
    jm = [_jmanager(s) for s in specs]
    tm = [_tmanager(s) for s in specs]
    msgs = [["Y", "top", [2.0] * FEATURES]]
    msgs += [["Y", f"t{j:02d}", [1.0] * FEATURES] for j in range(30)]
    msgs += [["Y", f"z{j}", [0.25] * FEATURES] for j in range(10)]
    msgs += [["X", "u0", [1.0] * FEATURES, []]]
    for m in jm + tm:
        for msg in msgs:
            m.consume_key_message("UP", json.dumps(msg))
    xu = tm[-1].model.get_user_vector("u0")
    for how_many in (2, 5, 17, 30, 31, 41):
        tparts = [tmerge.exact_local_top_n(m.model, _ordinal(m), how_many,
                                           user_vector=xu) for m in tm[:2]]
        jparts = [jmerge.exact_local_top_n(m.model, _ordinal(m), how_many,
                                           user_vector=xu) for m in jm[:2]]
        assert tparts == jparts, how_many
        assert tmerge.merge_top_n(tparts, how_many) == \
            jmerge.merge_top_n(jparts, how_many)
    ids = [i for i, _, _ in tmerge.merge_top_n(tparts, 11)]
    assert ids == ["top"] + [f"t{j:02d}" for j in range(10)]


@pytest.mark.parametrize("shards", [2, 3])
def test_rescorer_and_cosine_paths_match_reference(shards):
    rng = np.random.default_rng(40 + shards)
    specs = [f"{s}/{shards}" for s in range(shards)]
    jm = [_jmanager(s, _JProvider()) for s in specs]
    tm = [_tmanager(s, _TProvider()) for s in specs]
    _replay(rng, jm + tm, n_items=40, retire_fraction=0.3)
    for u in range(4):
        uid = f"u{u}"
        xu = tm[0].model.get_user_vector(uid)
        exclude = tm[0].model.get_known_items(uid)
        for how_many in (3, 12):
            tparts = [tmerge.exact_local_top_n(
                m.model, _ordinal(m), how_many, user_vector=xu,
                exclude=exclude, rescorer=_TRescorer()) for m in tm]
            jparts = [jmerge.exact_local_top_n(
                m.model, _ordinal(m), how_many, user_vector=xu,
                exclude=exclude, rescorer=_JRescorer()) for m in jm]
            assert tparts == jparts, (uid, how_many)
    # mean-cosine queries against two item vectors (the /similarity
    # scatter): cosines are not exact in float32, so the scores are held
    # at rtol 1e-6 and the ids must agree in order
    targets = np.stack([np.asarray(_grid_vec(rng), np.float32)
                        for _ in range(2)], axis=1)
    for how_many in (4, 9):
        tparts = [tmerge.exact_local_top_n(m.model, _ordinal(m), how_many,
                                           cosine_to=targets) for m in tm]
        jparts = [jmerge.exact_local_top_n(m.model, _ordinal(m), how_many,
                                           cosine_to=targets) for m in jm]
        for tp, jp in zip(tparts, jparts):
            assert [(i, o) for i, _, o in tp] == [(i, o) for i, _, o in jp]
            np.testing.assert_allclose([s for _, s, _ in tp],
                                       [s for _, s, _ in jp], rtol=1e-6)


def test_sharded_manager_skips_remote_items_and_keeps_ordinals():
    jm, tm = _jmanager("0/2"), _tmanager("0/2")
    for j in range(30):
        msg = json.dumps(["Y", f"i{j}", [1.0] * FEATURES])
        jm.consume_key_message("UP", msg)
        tm.consume_key_message("UP", msg)
    local = [f"i{j}" for j in range(30) if shard_of(f"i{j}", 2) == 0]
    assert sorted(tm.model.all_item_ids()) == sorted(local)
    assert tm.skipped_remote_items == jm.skipped_remote_items == 30 - len(local)
    assert tm.item_ordinals == jm.item_ordinals == \
        {f"i{j}": j for j in range(30)}
    # the heartbeat key is control plane: ignored by both managers
    hb = '{"replica":"r","shard":0,"of":2,"url":"http://h:1",' \
         '"generation":1,"ready":true}'
    jm.consume_key_message("HB", hb)
    tm.consume_key_message("HB", hb)
    assert tm.generation == jm.generation == 0


def test_a_fresh_model_is_published_only_with_its_expected_ids(monkeypatch):
    """A fresh replica must not read as ready while a MODEL's ids are
    being parsed: an empty model's load fraction is 1.0, and the
    heartbeat would advertise it ready.  The port builds the new model
    and its expected ids before it publishes it; the reference publishes
    it first (its fraction reads 1.0 while the ids are parsed)."""
    from oryx_tpu.app.als import serving_manager as jsm
    from oryx_tpu_torch.app.als import serving_manager as tsm
    from oryx_tpu_torch.common import pmml as tpmml
    doc = tpmml.build_skeleton_pmml()
    tpmml.add_extension(doc, "features", FEATURES)
    tpmml.add_extension(doc, "implicit", True)
    tpmml.add_extension_content(doc, "XIDs", ["u0", "u1"])
    tpmml.add_extension_content(doc, "YIDs", [f"i{j}" for j in range(8)])
    message = tpmml.to_string(doc)
    seen = {}
    for name, mod, mgr in (("port", tsm, _tmanager("0/2")),
                           ("reference", jsm, _jmanager("0/2"))):
        mgr.model = None
        seen[name] = []
        real = mod.pmml_io.get_extension_content

        def spy(pmml, key, _mgr=mgr, _out=seen[name], _real=real):
            model = _mgr.get_model()
            _out.append(None if model is None
                        else model.get_fraction_loaded())
            return _real(pmml, key)

        monkeypatch.setattr(mod.pmml_io, "get_extension_content", spy)
        mgr.consume_key_message("MODEL", message)
        assert mgr.get_model().get_fraction_loaded() == 0.0
    assert seen["port"] == [None, None]
    assert seen["reference"] == [1.0, 1.0]
