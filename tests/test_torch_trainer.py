"""The port's ALS trainer (``oryx_tpu_torch/app/als/trainer.py``) and
evaluation against the reference's (``oryx_tpu/app/als/trainer.py``,
``evaluation.py``) on seeded NumPy inputs, on the CPU.

Tolerances: the packing plans and the initial item factors are
bit-identical; one sweep's factors agree within rtol 1e-4, atol 1e-6
(float32 products and LU solves in another summation order); the
float64 rescue agrees within rtol 1e-5, atol 1e-7 (both host float64
over the same plan); predictions within rtol 1e-5, atol 1e-6; and after
5 sweeps the quality bars of ``tests/test_numerics.py`` hold against
the reference's float64 oracle (RMSE at most 1.05x the oracle's, AUC
at least the oracle's - 0.03)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.app.als import trainer as jtrainer
from oryx_tpu.app.als.common import ParsedRatings as JRatings
from oryx_tpu.ml.oracle import train_als_oracle
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als import evaluation as tevaluation
from oryx_tpu_torch.app.als import trainer as ttrainer
from oryx_tpu_torch.app.als.common import ParsedRatings as TRatings
from oryx_tpu_torch.bench.train import synthesize_movielens
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.resilience import faults as tfaults

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _seeded_and_clear():
    TorchRandomManager.use_test_seed()
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _coo(n_u=60, n_i=40, nnz=900, seed=3, explicit=False, skew=False):
    """Deduplicated COO interactions; ``skew`` gives a few users many
    interactions, so the plan has several widths."""
    rng = np.random.default_rng(seed)
    if skew:
        p = 1.0 / np.arange(1, n_u + 1) ** 1.2
        users = rng.choice(n_u, nnz, p=p / p.sum()).astype(np.int32)
    else:
        users = rng.integers(0, n_u, nnz).astype(np.int32)
    items = rng.integers(0, n_i, nnz).astype(np.int32)
    _, keep = np.unique(users.astype(np.int64) * n_i + items,
                        return_index=True)
    users, items = users[keep], items[keep]
    vals = (np.clip(rng.normal(3.0, 1.0, len(users)), 0.5, 5.0) if explicit
            else rng.exponential(1.0, len(users))).astype(np.float32)
    return users, items, vals, n_u, n_i


def _both(users, items, vals, n_u, n_i):
    u_ids = [f"u{u}" for u in range(n_u)]
    i_ids = [f"i{i}" for i in range(n_i)]
    return (JRatings(u_ids, i_ids, users, items, vals),
            TRatings(u_ids, i_ids, users, items, vals))


@pytest.mark.parametrize("budget,max_b", [(1 << 19, 4096), (64, 16),
                                          (32, 5)])
def test_plans_are_identical(monkeypatch, budget, max_b):
    """The degree-bucketed batches, their widths, the dummy padding rows
    and every packed slot are the reference's (small budgets force many
    batches and padded tails)."""
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod, "_BATCH_SLOT_BUDGET", budget)
        monkeypatch.setattr(mod, "_MAX_B", max_b)
    users, items, vals, n_u, n_i = _coo(skew=True, nnz=1500)
    counts = np.bincount(users, minlength=n_u)
    want = jtrainer._plan_batches(counts)
    got = ttrainer._plan_batches(counts)
    assert [p for _, p in got] == [p for _, p in want]
    assert all(np.array_equal(g, w) for (g, _), (w, _) in zip(got, want))
    assert len(want) > 1 or budget == 1 << 19
    for rows, cols, n in ((users, items, n_u), (items, users, n_i)):
        jplan = jtrainer._pack_side(rows, cols, vals, n)
        tplan = ttrainer._pack_side(rows, cols, vals, n,
                                    torch.device("cpu"))
        assert tplan.n_rows == jplan.n_rows == n
        assert len(tplan.host) == len(tplan.device) == len(jplan.batches)
        for tb, db, jb in zip(tplan.host, tplan.device, jplan.batches):
            for t, d, j in zip(tb, db, jb):
                j = np.asarray(j)
                assert t.shape == j.shape
                assert np.array_equal(t, j)
                assert np.array_equal(d.numpy(), j)


def test_initial_item_factors_are_bit_identical():
    """With no sweep, both trainers return their initial factors: Y
    drawn from NumPy with the same seed, bit for bit, and X zero."""
    j, t = _both(*_coo())
    jm = jtrainer.train_als(j, 7, 0.01, 1.0, True, 0, seed=42)
    tm = ttrainer.train_als(t, 7, 0.01, 1.0, True, 0, seed=42, device="cpu")
    assert tm.Y.dtype == np.float32
    assert np.array_equal(tm.Y, np.asarray(jm.Y))
    assert np.array_equal(tm.X, np.asarray(jm.X))
    # the default seed is RandomManager's, the reference's in test mode
    jd = jtrainer.train_als(j, 7, 0.01, 1.0, True, 0)
    td = ttrainer.train_als(t, 7, 0.01, 1.0, True, 0, device="cpu")
    assert np.array_equal(td.Y, np.asarray(jd.Y))


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("budget", [1 << 19, 64])
def test_one_sweep_matches_the_reference(monkeypatch, implicit, budget):
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod, "_BATCH_SLOT_BUDGET", budget)
    j, t = _both(*_coo(explicit=not implicit, skew=True, nnz=1200))
    lam = 0.01 if implicit else 0.05
    jm = jtrainer.train_als(j, 6, lam, 1.0, implicit, 1, seed=5)
    tm = ttrainer.train_als(t, 6, lam, 1.0, implicit, 1, seed=5,
                            device="cpu")
    assert tm.rescue is None and jm.rescue is None
    assert tm.user_ids == jm.user_ids and tm.item_ids == jm.item_ids
    np.testing.assert_allclose(tm.X, np.asarray(jm.X), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.Y, np.asarray(jm.Y), rtol=RTOL, atol=ATOL)


def test_sweep_callback_and_timings():
    """``on_iteration`` sees each sweep's host factors; ``timings``
    holds the packing, sweep, half-sweep, product and solve seconds."""
    _, t = _both(*_coo())
    seen = []
    timings = {}
    model = ttrainer.train_als(
        t, 5, 0.01, 1.0, True, 3, seed=1, device="cpu", timings=timings,
        on_iteration=lambda i, X, Y: seen.append((i, X.shape, Y.shape)))
    assert seen == [(i, model.X.shape, model.Y.shape) for i in range(3)]
    assert timings["pack_s"] >= 0.0
    for key in ("sweep_s", "half_sweep_s", "products_s", "solve_s"):
        assert len(timings[key]) == 3
    for half, prod, solve in zip(timings["half_sweep_s"],
                                 timings["products_s"], timings["solve_s"]):
        assert len(half) == len(prod) == len(solve) == 2
        for h, p, s in zip(half, prod, solve):
            assert 0.0 <= p + s <= h + 1e-3


def _synthetic_100k(implicit: bool):
    """The oracle-parity data of ``tests/test_numerics.py``, from the
    port's own synthesizer (which draws the reference's arrays)."""
    users, items, imp_vals, exp_vals, _ = synthesize_movielens(
        n_users=1500, n_items=800, n_ratings=100_000, seed=7)
    vals = (imp_vals if implicit else exp_vals).astype(np.float32)
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1
    rng = np.random.default_rng(13)
    test_mask = rng.random(len(users)) < 0.1
    return users, items, vals, n_users, n_items, test_mask


@pytest.mark.parametrize("implicit", [False, True])
def test_quality_bars_against_the_float64_oracle(implicit):
    users, items, vals, n_users, n_items, test_mask = \
        _synthetic_100k(implicit)
    k, lam, iters = 12, (0.01 if implicit else 0.05), 5
    tr = ~test_mask
    ratings = TRatings([str(u) for u in range(n_users)],
                       [str(i) for i in range(n_items)],
                       users[tr], items[tr], vals[tr])
    model = ttrainer.train_als(ratings, k, lam, 1.0, implicit, iters,
                               seed=5, device="cpu")
    assert model.rescue is None
    oracle = train_als_oracle(users[tr], items[tr], vals[tr], n_users,
                              n_items, k, lam, 1.0, implicit, iters, seed=5)
    te_u = users[test_mask].astype(np.int32)
    te_i = items[test_mask].astype(np.int32)
    ox, oy = oracle.X.astype(np.float32), oracle.Y.astype(np.float32)
    if implicit:
        got = tevaluation.area_under_curve(model.X, model.Y, te_u, te_i,
                                           device="cpu")
        want = tevaluation.area_under_curve(ox, oy, te_u, te_i, device="cpu")
        assert want > 0.6, f"the oracle itself failed to learn ({want})"
        assert got >= want - 0.03, (got, want)
    else:
        got = tevaluation.rmse(model.X, model.Y, te_u, te_i,
                               vals[test_mask], device="cpu")
        want = tevaluation.rmse(ox, oy, te_u, te_i, vals[test_mask],
                                device="cpu")
        assert got <= want * 1.05, (got, want)


@pytest.mark.parametrize("implicit", [True, False])
def test_poisoned_sweep_gives_the_reference_rescue(implicit):
    """``trainer-f32-poison`` drives both ladders to the same float64
    rung, the same record and the same factors."""
    j, t = _both(*_coo(explicit=not implicit))
    lam = 0.01 if implicit else 0.05
    jfaults.inject("trainer-f32-poison", mode="drop", times=1)
    tfaults.inject("trainer-f32-poison", mode="drop", times=1)
    jm = jtrainer.train_als(j, 4, lam, 1.0, implicit, 3, seed=11)
    tm = ttrainer.train_als(t, 4, lam, 1.0, implicit, 3, seed=11,
                            device="cpu")
    assert tfaults.fired("trainer-f32-poison") == 1
    assert tm.rescue == jm.rescue == {"precision": "float64",
                                      "trigger_iteration": 0,
                                      "escalated_lambda": None}
    np.testing.assert_allclose(tm.X, jm.X, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.Y, jm.Y, rtol=1e-5, atol=1e-7)


def test_standalone_rescue_matches_the_reference():
    j, t = _both(*_coo())
    jm = jtrainer.rescue_retrain_f64(j, 4, 0.01, 1.0, True, 2, seed=3)
    tm = ttrainer.rescue_retrain_f64(t, 4, 0.01, 1.0, True, 2, seed=3)
    assert tm.rescue == jm.rescue
    np.testing.assert_allclose(tm.X, jm.X, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.Y, jm.Y, rtol=1e-5, atol=1e-7)


def test_predictions_and_scores_match_the_reference():
    rng = np.random.default_rng(9)
    X = rng.standard_normal((30, 8)).astype(np.float32)
    Y = rng.standard_normal((50, 8)).astype(np.float32)
    u = rng.integers(0, 30, 200).astype(np.int32)
    i = rng.integers(0, 50, 200).astype(np.int32)
    np.testing.assert_allclose(
        ttrainer.predict_pairs(X, Y, u, i, device="cpu"),
        np.asarray(jtrainer.predict_pairs(X, Y, u, i)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ttrainer.score_all_items(X[:3], Y, device="cpu"),
        np.asarray(jtrainer.score_all_items(X[:3], Y)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        ttrainer.score_all_items(X[0], Y, device="cpu"),
        np.asarray(jtrainer.score_all_items(X[0], Y)), rtol=1e-5, atol=1e-6)


def test_evaluation_matches_the_reference():
    """The same AUC sampling (RandomManager's test stream) and RMSE."""
    from oryx_tpu.app.als import evaluation as jevaluation
    from oryx_tpu.common.rand import RandomManager as JaxRandomManager
    JaxRandomManager.use_test_seed()
    rng = np.random.default_rng(2)
    X = rng.standard_normal((40, 6)).astype(np.float32)
    Y = rng.standard_normal((30, 6)).astype(np.float32)
    u = rng.integers(0, 40, 300).astype(np.int32)
    i = rng.integers(0, 30, 300).astype(np.int32)
    v = rng.uniform(1, 5, 300).astype(np.float32)
    assert tevaluation.area_under_curve(X, Y, u, i, device="cpu") == \
        pytest.approx(jevaluation.area_under_curve(X, Y, u, i), abs=1e-12)
    assert tevaluation.rmse(X, Y, u, i, v, device="cpu") == pytest.approx(
        jevaluation.rmse(X, Y, u, i, v), rel=1e-5)
    empty = np.zeros(0, np.int32)
    assert tevaluation.area_under_curve(X, Y, empty, empty,
                                        device="cpu") == 0.0


def test_empty_ratings():
    empty = np.zeros(0, np.int32)
    for user_ids, item_ids in (([], []), (["u0"], []), ([], ["i0"])):
        ratings = TRatings(user_ids, item_ids, empty, empty,
                           np.zeros(0, np.float32))
        model = ttrainer.train_als(ratings, 3, 0.1, 1.0, True, 2,
                                   device="cpu")
        ref = jtrainer.train_als(JRatings(*ratings), 3, 0.1, 1.0, True, 2)
        assert model.X.shape == np.asarray(ref.X).shape == (0, 3)
        assert model.Y.shape == np.asarray(ref.Y).shape == (0, 3)
        assert model.rescue is None


def test_train_als_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = _both(*_coo())
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.train_als(t, 3, 0.1, 1.0, True, 1, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.predict_pairs(np.zeros((1, 3)), np.zeros((1, 3)),
                                   [0], [0], device=device)
