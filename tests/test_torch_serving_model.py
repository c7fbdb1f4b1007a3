"""The port's ALSServingModel, built by ``serving_model_from_arrays``
from a reference model's arrays, answers ``top_n_batch`` and ``top_n``
like the reference model: same ids in the same order (ties included),
same certificate fallbacks, scores within the stated tolerances — on the
flat path and on the two-phase streaming path, exact and LSH, float32
and bfloat16."""

import numpy as np
import pytest

from oryx_tpu.app.als import rescorer as jrescorer
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu_torch.app.als import rescorer as trescorer
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.convert import serving_model_from_arrays


@pytest.fixture(autouse=True)
def _port_test_seed():
    TorchRandomManager.use_test_seed()
    yield


@pytest.fixture
def streaming(monkeypatch):
    """Force the two-phase streaming path at toy size, on both sides."""
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "_FLAT_SCORES_LIMIT", 1)
        monkeypatch.setattr(mod, "_MAX_CHUNK_ROWS", 1024)
        monkeypatch.setattr(mod, "_BLOCK_ROWS", 64)
        monkeypatch.setattr(mod, "_BLOCK_KSEL", 8)
        monkeypatch.setattr(mod, "_PA_TILE", 2048)


def _pair(Y, X, dtype="float32", sample_rate=1.0, known=None, **port_kw):
    f = Y.shape[1]
    jm = jsm.ALSServingModel(f, implicit=True, sample_rate=sample_rate,
                             dtype=dtype)
    jm.Y.bulk_load([f"i{j}" for j in range(len(Y))], Y)
    jm.X.bulk_load([f"u{j}" for j in range(len(X))], X)
    for u, items in (known or {}).items():
        jm.add_known_items(u, items)
    yh, _, yr = jm.Y.host_arrays()
    xh, _, xr = jm.X.host_arrays()
    tm = serving_model_from_arrays(
        f, True, x_ids=xr, X=np.asarray(xh, np.float32), y_ids=yr,
        Y=np.asarray(yh, np.float32), known_items=known or {},
        lsh_hyperplanes=jm.lsh.hyperplanes if jm.lsh else None,
        sample_rate=sample_rate, dtype=dtype, device="cpu", **port_kw)
    return jm, tm


def _assert_same(want, got, rtol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=rtol)


def _tol(dtype):
    # f32: summation order only; bf16: the certificate's own margin
    return 1e-4 if dtype == "bfloat16" else 1e-5


def _data(ni, f, nq, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ni, f)).astype(np.float32),
            rng.standard_normal((nq, f)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [1.0, 0.3], ids=["exact", "lsh"])
def test_flat_path_matches_reference(dtype, rate):
    Y, Q = _data(3000, 8, 6, seed=1)
    jm, tm = _pair(Y, Q, dtype, rate)
    _assert_same(jm.top_n_batch(7, Q), tm.top_n_batch(7, Q), _tol(dtype))
    for b in range(2):
        _assert_same([jm.top_n(5, user_vector=Q[b])],
                     [tm.top_n(5, user_vector=Q[b])], _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [1.0, 0.3], ids=["exact", "lsh"])
def test_streaming_path_matches_reference(streaming, dtype, rate):
    Y, Q = _data(4096, 8, 11, seed=2)
    # on the CPU the reference serves its float32 "scan" kind (its Pallas
    # kernels cannot lower there); the port's float32 kernel kind selects
    # blocks on the same maxima, so the certificates fail alike.  The
    # int8 and folded kinds are held to the reference in
    # test_torch_serving_model_i8.py
    jm, tm = _pair(Y, Q, dtype, rate, int8_selection="false",
                   fold_scan="false")
    _assert_same(jm.top_n_batch(6, Q), tm.top_n_batch(6, Q), _tol(dtype))
    # a drain wider than one full window: [256, 8]
    Qw = np.random.default_rng(3).standard_normal((260, 8)).astype(
        np.float32)
    _assert_same(jm.top_n_batch(3, Qw), tm.top_n_batch(3, Qw), _tol(dtype))
    assert tm.twophase_fallbacks == jm.twophase_fallbacks


def test_streaming_exclusions_and_per_request_how_many(streaming):
    Y, Q = _data(4096, 8, 5, seed=4)
    jm, tm = _pair(Y, Q)
    first = jm.top_n_batch(4, Q)
    excl = [{i for i, _ in r[:2]} for r in first]
    excl[3] = set()
    hm = [1, 4, 9, 2, 5]
    _assert_same(jm.top_n_batch(hm, Q, excl), tm.top_n_batch(hm, Q, excl),
                 1e-5)
    _assert_same(jm.top_n_batch(3, Q, excl, use_lsh=False),
                 tm.top_n_batch(3, Q, excl, use_lsh=False), 1e-5)


def test_streaming_certificate_failure_falls_back_alike(streaming,
                                                        monkeypatch):
    """A failed certificate recomputes the window on the exact scan and
    counts the same fallbacks on both sides."""
    Y, Q = _data(4096, 8, 3, seed=5)
    jm, tm = _pair(Y, Q)
    want = jm.top_n_batch(5, Q)

    def sabotage(real):
        def run(*args, **kw):
            ts, ti, cert = real(*args, **kw)
            return ts, ti, cert & False
        return run

    # on the CPU the reference serves the "scan" kind (its Pallas kernel
    # cannot lower there); the port serves one of its kernel kinds
    monkeypatch.setattr(jsm, "_batch_top_n_twophase_kernel",
                        sabotage(jsm._batch_top_n_twophase_kernel))
    for name in ("_batch_top_n_twophase_cuda",
                 "_batch_top_n_twophase_cuda_fold",
                 "_batch_top_n_twophase_cuda_i8",
                 "_batch_top_n_twophase_cuda_i8_fold"):
        monkeypatch.setattr(tsm, name, sabotage(getattr(tsm, name)))
    j_got, t_got = jm.top_n_batch(5, Q), tm.top_n_batch(5, Q)
    _assert_same(want, j_got, 1e-5)
    _assert_same(j_got, t_got, 1e-5)
    assert jm.twophase_fallbacks >= 1
    assert tm.twophase_fallbacks == jm.twophase_fallbacks
    assert tm.metrics()["twophase_fallbacks"] == tm.twophase_fallbacks


def test_streaming_uses_kernel_kind_and_scan_off_tile(streaming):
    Y, Q = _data(4096, 8, 2, seed=6)
    jm, tm = _pair(Y, Q)
    width, bs = tm.Y.device_features, tsm._BLOCK_ROWS
    # 8 features in 32 columns: int8 on ("auto"), fold 4
    assert tm._phase_a_kinds(4096, width, bs) == \
        (["i8_fold", "fold", "i8", "pallas", "scan"], 4) == \
        jm._phase_a_kinds(4096, width, bs)
    assert tm._phase_a_kinds(4096 + 1024, width, bs) == (["scan"], 4)
    _, off = _pair(Y, Q, int8_selection="false", fold_scan="false")
    assert off._phase_a_kinds(4096, width, bs) == (["pallas", "scan"], 1)
    assert tm.kernel_route_label is None


@pytest.mark.parametrize("path", ["flat", "streaming"])
def test_ties_come_out_in_reference_order(request, path):
    """Integer-valued factors make every dot product exact in f32 and
    tie often: the order among equal scores must be the reference's."""
    if path == "streaming":
        request.getfixturevalue("streaming")
    rng = np.random.default_rng(8)
    Y = rng.integers(-2, 3, (4096, 4)).astype(np.float32)
    Q = rng.integers(-2, 3, (6, 4)).astype(np.float32)
    Q[0] = 0.0  # every item ties
    jm, tm = _pair(Y, Q)
    want = jm.top_n_batch(12, Q)
    got = tm.top_n_batch(12, Q)
    assert want == got
    assert len({s for _, s in want[1]}) < len(want[1])  # ties present
    excl = [{f"i{j}" for j in range(0, 4096, 3)}] * 6
    assert jm.top_n_batch(12, Q, excl) == tm.top_n_batch(12, Q, excl)


def test_single_request_paths_match_reference():
    Y, Q = _data(2000, 8, 3, seed=9)
    jm, tm = _pair(Y, Q)

    class JHalf(jrescorer.Rescorer):
        def rescore(self, item_id, score):
            return score / 2 if item_id.endswith("7") else score

        def is_filtered(self, item_id):
            return item_id.endswith("3")

    class THalf(trescorer.Rescorer):
        rescore = JHalf.rescore
        is_filtered = JHalf.is_filtered

    excl = {f"i{j}" for j in range(0, 2000, 7)}
    _assert_same([jm.top_n(9, user_vector=Q[0], exclude=excl)],
                 [tm.top_n(9, user_vector=Q[0], exclude=excl)], 1e-5)
    _assert_same([jm.top_n(9, user_vector=Q[1], rescorer=JHalf())],
                 [tm.top_n(9, user_vector=Q[1], rescorer=THalf())], 1e-5)
    allowed = lambda i: int(i[1:]) % 2 == 0  # noqa: E731
    _assert_same([jm.top_n(6, user_vector=Q[2], allowed=allowed,
                           lowest=True)],
                 [tm.top_n(6, user_vector=Q[2], allowed=allowed,
                           lowest=True)], 1e-5)


def test_known_items_and_fraction_loaded():
    Y, Q = _data(100, 4, 3, seed=10)
    known = {"u0": ["i1", "i5"], "u2": ["i9"]}
    jm, tm = _pair(Y, Q, known=known)
    for u in ("u0", "u1", "u2"):
        assert tm.get_known_items(u) == jm.get_known_items(u)
    assert tm.get_fraction_loaded() == jm.get_fraction_loaded() == 1.0
    np.testing.assert_array_equal(tm.get_user_vector("u1"),
                                  jm.get_user_vector("u1"))
    assert tm.metrics() == {"users": 3, "items": 100,
                            "twophase_fallbacks": 0}


def test_model_swap_bookkeeping_matches_reference():
    """Expected-id accounting and the retain pass of a MODEL swap
    (FactorModelBase) leave both models in the same state."""
    f = 4
    jm = jsm.ALSServingModel(f, implicit=True)
    tm = tsm.ALSServingModel(f, implicit=True, device="cpu")
    rng = np.random.default_rng(12)
    for m in (jm, tm):
        m.set_expected_ids([f"u{j}" for j in range(4)],
                           [f"i{j}" for j in range(6)])
    assert tm.get_fraction_loaded() == jm.get_fraction_loaded() == 0.0
    vecs = rng.standard_normal((10, f)).astype(np.float32)
    for m in (jm, tm):
        for j in range(3):
            m.set_user_vector(f"u{j}", vecs[j])
        for j in range(5):
            m.set_item_vector(f"i{j}", vecs[4 + j])
    assert tm.get_fraction_loaded() == jm.get_fraction_loaded()
    for m in (jm, tm):
        m.retain_recent_and_user_ids(["u0"])
        m.retain_recent_and_item_ids(["i1"])  # recent ids survive this one
        m.retain_recent_and_item_ids(["i1"])  # ...but not the next
    assert sorted(tm.X.all_ids()) == sorted(jm.X.all_ids())
    assert sorted(tm.Y.all_ids()) == sorted(jm.Y.all_ids()) == ["i1"]
    assert (tm.user_count(), tm.item_count()) == \
        (jm.user_count(), jm.item_count())
