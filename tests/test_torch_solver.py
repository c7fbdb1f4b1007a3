"""The port's Cholesky solver and solver cache against the
reference's: the same solutions within float32 round-off on
well-conditioned Gramians, the same singularity verdicts, and the same
float64 rescue."""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest

from oryx_tpu.ops import solver as jsolver
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als.factor_model import SolverCache
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.ops import solver as tsolver
from oryx_tpu_torch.resilience import faults as tfaults

# float32 factor and solve: relative error of a few ulps times the
# condition number (below 1e3 here)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _gramian(seed: int, k: int, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, k)).astype(np.float32)
    return (V.T @ V).astype(np.float64)


@pytest.mark.parametrize("k", [2, 10, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_solutions_match_the_reference(k, seed):
    a = _gramian(seed, k)
    rng = np.random.default_rng(100 + seed)
    b1 = rng.standard_normal(k).astype(np.float32)
    bn = rng.standard_normal((7, k)).astype(np.float32)
    js = jsolver.get_solver(a)
    ts = tsolver.get_solver(a, device="cpu")
    assert ts.precision == js.precision == "float32"
    for b in (b1, bn):
        want_exact = np.linalg.solve(a, b.astype(np.float64).T).T
        got, want = ts.solve(b), js.solve(b)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(
            want).max())
        np.testing.assert_allclose(got, want_exact, rtol=RTOL,
                                   atol=RTOL * np.abs(want_exact).max())
    np.testing.assert_allclose(ts.solve_d_to_d(b1), js.solve_d_to_d(b1),
                               rtol=RTOL)
    np.testing.assert_allclose(ts.cholesky.numpy(),
                               np.asarray(js.cholesky), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["rank_deficient", "tiny_eigenvalue",
                                  "non_finite", "zero"])
def test_near_singular_gramians_raise_alike(case):
    k = 6
    a = _gramian(3, k)
    if case == "rank_deficient":
        rng = np.random.default_rng(4)
        V = rng.standard_normal((50, k - 2))
        a = (np.hstack([V, V[:, :2]]).T @ np.hstack([V, V[:, :2]]))
    elif case == "tiny_eigenvalue":
        w, q = np.linalg.eigh(a)
        w[0] = w[-1] * 1e-7
        a = (q * w) @ q.T
    elif case == "non_finite":
        a[1, 2] = np.nan
    else:
        a = np.zeros((k, k))
    with pytest.raises(jsolver.SingularMatrixSolverException) as want:
        jsolver.get_solver(a)
    with pytest.raises(tsolver.SingularMatrixSolverException) as got:
        tsolver.get_solver(a, device="cpu")
    assert got.value.apparent_rank == want.value.apparent_rank
    assert str(got.value) == str(want.value)


def test_float64_rescue_matches_the_reference():
    a = _gramian(5, 8)
    jfaults.inject("solver-f32-discard", mode="drop", times=1)
    tfaults.inject("solver-f32-discard", mode="drop", times=1)
    js = jsolver.get_solver(a)
    ts = tsolver.get_solver(a, device="cpu")
    assert js.precision == ts.precision == "float64"
    b = np.random.default_rng(6).standard_normal((3, 8))
    np.testing.assert_allclose(ts.solve_d_to_d(b), js.solve_d_to_d(b),
                               rtol=1e-12)
    np.testing.assert_allclose(ts.solve(b[0]), js.solve(b[0]), rtol=1e-6)


def test_indefinite_matrix_is_refused_after_the_rescue():
    """Symmetric, well away from singular, but not positive definite:
    both float32 and float64 factorizations fail."""
    a = np.diag([4.0, 3.0, -2.0, 5.0])
    for mod, kw in ((jsolver, {}), (tsolver, {"device": "cpu"})):
        with pytest.raises(mod.SingularMatrixSolverException,
                           match="not positive definite"):
            mod.get_solver(a, **kw)


def test_solver_cache_recomputes_once_per_dirty_flag():
    calls = []
    a = _gramian(7, 4)

    def supplier():
        calls.append(1)
        return a

    cache = SolverCache(supplier, device="cpu")
    s1 = cache.get()
    assert s1 is not None and len(calls) == 1
    assert cache.get() is s1 and len(calls) == 1
    cache.set_dirty()
    cache.set_dirty()
    s2 = cache.get()
    assert s2 is not s1 and len(calls) == 2
    # concurrent getters on one dirty flag share one recompute
    cache.set_dirty()
    threads = [threading.Thread(target=cache.get) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 3


def test_solver_cache_stays_dirty_after_an_unexpected_error():
    a = _gramian(9, 4)
    fail = [True]

    def supplier():
        if fail.pop() if fail else False:
            raise RuntimeError("supplier failed")
        return a

    cache = SolverCache(supplier, device="cpu")
    with pytest.raises(RuntimeError, match="supplier failed"):
        cache.get()
    solver = cache.get()
    assert solver is not None
    np.testing.assert_allclose(
        solver.solve(np.ones(4)), np.linalg.solve(a, np.ones(4)), rtol=RTOL)


def test_first_cuda_factorization_is_serialized(monkeypatch):
    """torch's first CUDA linear-algebra call loads a library and fails
    when two threads make it at once; the solver serializes it."""
    overlap = []
    loading = threading.Lock()
    loaded = []

    def fake_cholesky_ex(a):
        if not loaded:
            if not loading.acquire(blocking=False):
                overlap.append(1)
                raise RuntimeError("lazy wrapper should be called at "
                                   "most once")
            time.sleep(0.05)
            loaded.append(1)
            loading.release()
        return a, 0

    monkeypatch.setattr(tsolver, "_cuda_linalg_loaded", False)
    monkeypatch.setattr(tsolver.torch.linalg, "cholesky_ex",
                        fake_cholesky_ex)
    fake = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
    start = threading.Barrier(4)

    def first_call():
        start.wait(10)
        tsolver._cholesky_ex(fake)

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not overlap and loaded == [1]
    assert tsolver._cuda_linalg_loaded


def test_solver_cache_keeps_none_while_singular():
    cache = SolverCache(lambda: np.zeros((3, 3)), device="cpu")
    assert cache.get() is None
    assert cache.get(blocking=False) is None


def test_model_solvers_follow_the_stores():
    rng = np.random.default_rng(8)
    model = ALSServingModel(5, True, device="cpu")
    Y = rng.standard_normal((64, 5)).astype(np.float32)
    X = rng.standard_normal((16, 5)).astype(np.float32)
    model.bulk_load_items([f"i{j}" for j in range(64)], Y)
    model.bulk_load_users([f"u{j}" for j in range(16)], X)
    np.testing.assert_allclose(model.Y.vtv(), Y.T @ Y, rtol=1e-5)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        model.get_yty_solver().solve(b),
        np.linalg.solve((Y.T @ Y).astype(np.float64), b), rtol=1e-4)
    s = model.get_xtx_solver()
    model.set_user_vector("u0", np.ones(5, np.float32))
    assert model.get_xtx_solver() is not s
