"""The port's float64 ALS oracle (``oryx_tpu_torch/ml/oracle.py``) and
weighted mean (``oryx_tpu_torch/common/stats.py``) held bit for bit
against the reference's, and the port's trainer held against the oracle
at 100,000 ratings: explicit RMSE equal or better within 5 %, implicit
AUC within 0.03, as ``tests/test_numerics.py`` holds the reference's."""

import numpy as np
import pytest

from oryx_tpu.common.stats import DoubleWeightedMean as JMean
from oryx_tpu.ml.oracle import train_als_oracle as joracle
from oryx_tpu_torch.app.als.common import ParsedRatings
from oryx_tpu_torch.app.als.evaluation import area_under_curve, rmse
from oryx_tpu_torch.app.als.trainer import train_als
from oryx_tpu_torch.bench.train import synthesize_movielens
from oryx_tpu_torch.common.stats import DoubleWeightedMean
from oryx_tpu_torch.ml.oracle import OracleModel, train_als_oracle


def test_weighted_mean_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(2)
    a, b = DoubleWeightedMean(), JMean()
    assert np.isnan(a.result) and np.isnan(b.result)
    for v, w in zip(rng.normal(size=500), rng.uniform(0, 3, 500)):
        a.increment(float(v), float(w))
        b.increment(float(v), float(w))
        assert a.result == b.result and a.count == b.count
    a.increment(4.0)
    b.increment(4.0)
    assert a.result == b.result
    a.clear()
    assert a.count == 0 and np.isnan(a.result)


@pytest.mark.parametrize("implicit", [True, False])
def test_oracle_is_the_reference_bit_for_bit(implicit):
    rng = np.random.default_rng(5)
    n_users, n_items, nnz = 60, 40, 700
    users = rng.integers(0, n_users, nnz)
    items = rng.integers(0, n_items, nnz)
    vals = rng.uniform(0.5, 4.0, nnz)
    args = (users, items, vals, n_users, n_items, 5, 0.05, 2.0, implicit,
            3)
    got = train_als_oracle(*args, seed=9)
    want = joracle(*args, seed=9)
    assert isinstance(got, OracleModel)
    assert got.X.dtype == np.float64
    assert np.array_equal(got.X, want.X) and np.array_equal(got.Y, want.Y)


def _synthetic_100k(implicit: bool):
    users, items, imp_vals, exp_vals, _ = synthesize_movielens(
        n_users=1500, n_items=800, n_ratings=100_000, seed=7)
    vals = (imp_vals if implicit else exp_vals).astype(np.float32)
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1
    rng = np.random.default_rng(13)
    test_mask = rng.random(len(users)) < 0.1
    return users, items, vals, n_users, n_items, test_mask


def _trainer_factors(users, items, vals, n_users, n_items, k, lam, alpha,
                     implicit, iterations, seed):
    ratings = ParsedRatings([str(u) for u in range(n_users)],
                            [str(i) for i in range(n_items)],
                            users.astype(np.int32), items.astype(np.int32),
                            vals)
    model = train_als(ratings, k, lam, alpha, implicit, iterations,
                      seed=seed, device="cpu")
    assert model.rescue is None
    return model.X, model.Y


def test_trainer_reaches_the_oracle_rmse_100k():
    users, items, vals, n_users, n_items, test_mask = _synthetic_100k(False)
    k, lam, alpha, iters = 12, 0.05, 1.0, 5
    tr = users[~test_mask], items[~test_mask], vals[~test_mask]
    te_u, te_i, te_v = users[test_mask], items[test_mask], vals[test_mask]
    X, Y = _trainer_factors(*tr, n_users, n_items, k, lam, alpha, False,
                            iters, seed=5)
    oracle = train_als_oracle(*tr, n_users, n_items, k, lam, alpha, False,
                              iters, seed=5)
    got = rmse(X, Y, te_u, te_i, te_v, device="cpu")
    want = rmse(oracle.X.astype(np.float32), oracle.Y.astype(np.float32),
                te_u, te_i, te_v, device="cpu")
    assert got <= want * 1.05, (got, want)


def test_trainer_reaches_the_oracle_auc_100k():
    users, items, vals, n_users, n_items, test_mask = _synthetic_100k(True)
    k, lam, alpha, iters = 12, 0.01, 1.0, 5
    tr = users[~test_mask], items[~test_mask], vals[~test_mask]
    te_u = users[test_mask].astype(np.int32)
    te_i = items[test_mask].astype(np.int32)
    X, Y = _trainer_factors(*tr, n_users, n_items, k, lam, alpha, True,
                            iters, seed=5)
    oracle = train_als_oracle(*tr, n_users, n_items, k, lam, alpha, True,
                              iters, seed=5)
    got = area_under_curve(X, Y, te_u, te_i, device="cpu")
    want = area_under_curve(oracle.X.astype(np.float32),
                            oracle.Y.astype(np.float32), te_u, te_i,
                            device="cpu")
    assert want > 0.6, f"the oracle itself failed to learn (AUC {want})"
    assert got >= want - 0.03, (got, want)
