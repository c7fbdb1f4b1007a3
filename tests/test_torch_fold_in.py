"""The port's fold-in (``oryx_tpu_torch/ops/als_fold_in.py``) and vector
math (``ops/vectors.py``) against the reference's
(``oryx_tpu/ops/{als_fold_in,vectors}.py``) on seeded NumPy inputs, on
the CPU: implicit and explicit, with and without a starting vector,
items with no vector, NaN targets, and a solver in float64 rescue mode
(the ``solver-f32-discard`` fault).  The two libraries' triangular
solves may order their sums differently, so vectors agree within
rtol 1e-4, atol 1e-5 in float32; the masks of events that updated
agree exactly."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from oryx_tpu.ops import als_fold_in as jfold
from oryx_tpu.ops import solver as jsolver
from oryx_tpu.ops import vectors as jvectors
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.ops import als_fold_in as tfold
from oryx_tpu_torch.ops import solver as tsolver
from oryx_tpu_torch.ops import vectors as tvectors
from oryx_tpu_torch.resilience import faults as tfaults

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _solvers(k: int, seed: int, rescue: bool):
    """The reference's and the port's solver over one Y^T Y; in rescue
    mode both discard their float32 factorization."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((max(30, 4 * k), k)).astype(np.float32)
    yty = (y.T @ y).astype(np.float64)
    if rescue:
        jfaults.inject("solver-f32-discard", mode="drop", times=1)
        tfaults.inject("solver-f32-discard", mode="drop", times=1)
    js = jsolver.get_solver(yty)
    ts = tsolver.get_solver(yty, device="cpu")
    want = "float64" if rescue else "float32"
    assert js.precision == ts.precision == want
    return js, ts, rng


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- vectors -----------------------------------------------------------------

def test_vectors_match_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(12).astype(np.float32)
    y = rng.standard_normal(12).astype(np.float32)
    v = rng.standard_normal((40, 12)).astype(np.float32)
    for got, want in (
            (tvectors.dot(x, y), jvectors.dot(x, y)),
            (tvectors.norm(x), jvectors.norm(x)),
            (tvectors.cosine_similarity(x, y),
             jvectors.cosine_similarity(x, y)),
            (tvectors.cosine_similarity(x, y, np.float32(3.0)),
             jvectors.cosine_similarity(x, y, np.float32(3.0))),
            (tvectors.transpose_times_self(v),
             jvectors.transpose_times_self(v))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    a = tvectors.random_vector_f(9, np.random.default_rng(3))
    b = jvectors.random_vector_f(9, np.random.default_rng(3))
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


# -- the target strength -----------------------------------------------------

@pytest.mark.parametrize("implicit", [True, False])
def test_compute_target_qui_matches_the_reference(implicit):
    values = np.array([1.0, 2.5, 0.5, -1.0, -0.5, 0.0, 3.0, -2.0],
                      np.float32)
    current = np.array([0.3, -0.2, 1.5, 0.7, -0.1, 0.5, 1.0, 0.0],
                       np.float32)
    got = tfold.compute_target_qui(implicit, values, current).numpy()
    want = np.asarray(jfold.compute_target_qui(implicit, values, current))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if implicit:
        assert np.isnan(got).any()  # the "no change" cases are covered
    _close(got, want)


# -- one batch ---------------------------------------------------------------

@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize("implicit", [True, False])
def test_fold_in_batch_matches_the_reference(implicit, rescue):
    js, ts, rng = _solvers(6, 11, rescue)
    n = 20
    values = rng.standard_normal(n).astype(np.float32) * 2
    xu = rng.standard_normal((n, 6)).astype(np.float32) * 0.2
    yi = rng.standard_normal((n, 6)).astype(np.float32)
    xu[3] = np.nan  # no vector yet
    xu[7] = np.nan
    yi[5] = np.nan  # an item with no vector: no update
    # an implicit positive strength at a current strength >= 1: NaN target
    xu[9] = 2.0 * yi[9] / float(yi[9] @ yi[9])
    values[9] = 1.0
    got, got_valid = tfold.fold_in_batch(ts, values, xu, yi, implicit)
    want, want_valid = jfold.fold_in_batch(js, values, xu, yi, implicit)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert not got_valid[5]
    assert got_valid[9] == (not implicit)
    assert got.shape == (n, 6) and got_valid.shape == (n,)
    _close(got, want)


@pytest.mark.parametrize("n", [1, 8, 9, 33])
def test_fold_in_batch_pads_like_the_reference(n):
    """The reference pads these sizes to its power-of-two buckets with
    no-op rows; the port solves each batch at its own size, and the
    answers agree, NaN rows (the padding's kind of row) included."""
    js, ts, rng = _solvers(5, 2, False)
    values = rng.standard_normal(n).astype(np.float32)
    xu = rng.standard_normal((n, 5)).astype(np.float32) * 0.1
    yi = rng.standard_normal((n, 5)).astype(np.float32)
    yi[n - 1] = np.nan
    xu[0] = np.nan
    got, got_valid = tfold.fold_in_batch(ts, values, xu, yi, True)
    want, want_valid = jfold.fold_in_batch(js, values, xu, yi, True)
    assert got.shape == (n, 5) and len(got_valid) == n
    np.testing.assert_array_equal(got_valid, want_valid)
    assert not got_valid[n - 1]
    _close(got, want)


# -- one event ---------------------------------------------------------------

@pytest.mark.parametrize("rescue", [False, True])
def test_compute_updated_xu_matches_the_reference(rescue):
    js, ts, rng = _solvers(5, 7, rescue)
    xu = rng.standard_normal(5).astype(np.float32) * 0.1
    yi = rng.standard_normal(5).astype(np.float32)
    for implicit in (True, False):
        for value in (1.0, -0.5, 4.0):
            for start in (xu, None):
                got = tfold.compute_updated_xu(ts, value, start, yi, implicit)
                want = jfold.compute_updated_xu(js, value, start, yi,
                                                implicit)
                assert (got is None) == (want is None)
                if want is not None:
                    _close(got, want)
    assert tfold.compute_updated_xu(ts, 1.0, xu, None, True) is None
    nan_target = 2.0 * yi / float(yi @ yi)
    assert tfold.compute_updated_xu(ts, 1.0, nan_target, yi, True) is None
    assert jfold.compute_updated_xu(js, 1.0, nan_target, yi, True) is None


# -- an ordered context ------------------------------------------------------

@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize("start_with_xu", [True, False])
@pytest.mark.parametrize("implicit", [True, False])
def test_fold_in_sequential_matches_the_reference(implicit, start_with_xu,
                                                  rescue):
    js, ts, rng = _solvers(6, 23, rescue)
    item_vecs = {f"i{j}": rng.standard_normal(6).astype(np.float32) * 0.5
                 for j in range(8)}
    item_values = [("i0", 1.0), ("missing", 2.0), ("i1", -0.5),
                   ("i2", 3.0), ("i3", 0.0), ("i4", 1.5), ("i2", 2.0),
                   ("i5", -1.0)]
    xu0 = (rng.standard_normal(6).astype(np.float32) * 0.1
           if start_with_xu else None)
    got = tfold.fold_in_sequential(ts, item_values, item_vecs.get, xu0,
                                   implicit, 6)
    want = jfold.fold_in_sequential(js, item_values, item_vecs.get, xu0,
                                    implicit, 6)
    assert want is not None and got is not None
    assert got.dtype == np.float32 and got.shape == (6,)
    _close(got, want)


def test_fold_in_sequential_follows_the_per_event_loop():
    """The context fold-in equals compute_updated_xu applied event by
    event, the running vector carried between events."""
    _, ts, rng = _solvers(6, 29, False)
    item_vecs = {f"i{j}": rng.standard_normal(6).astype(np.float32) * 0.5
                 for j in range(5)}
    item_values = [("i0", 1.0), ("nope", 1.0), ("i1", 2.0), ("i2", -0.5),
                   ("i3", 0.5)]
    expected = None
    for iid, value in item_values:
        yi = item_vecs.get(iid)
        if yi is None:
            continue
        new = tfold.compute_updated_xu(ts, value, expected, yi, True)
        if new is not None:
            expected = new
    got = tfold.fold_in_sequential(ts, item_values, item_vecs.get, None,
                                   True, 6)
    _close(got, expected)


def test_fold_in_sequential_without_any_update_returns_the_start():
    js, ts, rng = _solvers(6, 24, False)
    for fold, solver in ((tfold, ts), (jfold, js)):
        assert fold.fold_in_sequential(
            solver, [("nope", 1.0)], lambda _: None, None, True, 6) is None
    xu = rng.standard_normal(6).astype(np.float32)
    got = tfold.fold_in_sequential(ts, [("nope", 1.0)], lambda _: None, xu,
                                   True, 6)
    np.testing.assert_array_equal(got, xu)
    # every event's target is NaN (implicit, strength 0): no vector
    y = {"a": rng.standard_normal(6).astype(np.float32)}
    got = tfold.fold_in_sequential(ts, [("a", 0.0)], y.get, None, True, 6)
    want = jfold.fold_in_sequential(js, [("a", 0.0)], y.get, None, True, 6)
    assert got is None and want is None


def test_rescue_factor_is_the_float64_factor_in_float32():
    """In rescue mode ``cholesky`` — what the fold-in solves against — is
    the float64 factor cast to float32, on the solver's device, as the
    reference keeps it."""
    js, ts, _ = _solvers(7, 31, True)
    assert ts.cholesky.dtype == torch.float32
    assert js.cholesky.dtype == np.float32
    assert ts.cholesky.device.type == "cpu"
    np.testing.assert_array_equal(ts.cholesky.numpy(),
                                  ts._chol64.astype(np.float32))
    np.testing.assert_array_equal(ts.cholesky.numpy(),
                                  np.asarray(js.cholesky))
    b = np.arange(7, dtype=np.float32)
    _close(ts.solve_f_to_f(b), js.solve_f_to_f(b))
    assert ts.solve_f_to_f(b).dtype == np.float32


def test_largest_fold_in_error_is_within_the_stated_tolerance():
    """Many seeded contexts, implicit, at 50 features: the largest
    element error against the reference stays inside rtol 1e-4,
    atol 1e-5."""
    worst = 0.0
    for seed in range(6):
        js, ts, rng = _solvers(50, 100 + seed, seed % 2 == 1)
        items = {f"i{j}": rng.standard_normal(50).astype(np.float32) * 0.3
                 for j in range(8)}
        ctx = [(f"i{j}", float(rng.uniform(0.5, 3.0)))
               for j in rng.integers(0, 8, 8)]
        got = tfold.fold_in_sequential(ts, ctx, items.get, None, True, 50)
        want = jfold.fold_in_sequential(js, ctx, items.get, None, True, 50)
        _close(got, want)
        worst = max(worst, float(np.max(np.abs(got - want))))
    print(f"largest fold-in error against the reference: {worst:.3e}")
    assert math.isfinite(worst)
