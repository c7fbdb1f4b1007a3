"""The port's ALSServingModel with the int8 and folded phase-A kinds:
the ``int8_selection``/``fold_scan`` settings, the kind chain against the
reference model's, and ``top_n_batch`` at 10 and 50 features on the
streaming path against the reference model's answers, with the kind the
dispatch takes."""

import numpy as np
import pytest

from oryx_tpu.app.als import serving_model as jsm
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


def _pair(Y, X, dtype="float32", sample_rate=1.0, **settings):
    f = Y.shape[1]
    jm = jsm.ALSServingModel(f, implicit=True, sample_rate=sample_rate,
                             dtype=dtype, **settings)
    jm.Y.bulk_load([f"i{j}" for j in range(len(Y))], Y)
    jm.X.bulk_load([f"u{j}" for j in range(len(X))], X)
    yh, _, yr = jm.Y.host_arrays()
    xh, _, xr = jm.X.host_arrays()
    tm = serving_model_from_arrays(
        f, True, x_ids=xr, X=np.asarray(xh, np.float32), y_ids=yr,
        Y=np.asarray(yh, np.float32), known_items={},
        lsh_hyperplanes=jm.lsh.hyperplanes if jm.lsh else None,
        sample_rate=sample_rate, dtype=dtype, device="cpu", **settings)
    return jm, tm


# F = 32 and 64 are left out: there the port pads nothing, so "auto"
# keeps int8 off, while the reference pads them to 128 and turns it on
FEATURES = [4, 8, 10, 16, 20, 50, 100, 250]


@pytest.mark.parametrize("features", FEATURES)
def test_kind_chain_matches_reference(features):
    for int8 in ("auto", "true", "false", True, False):
        for fold_scan in ("auto", "true", "false"):
            jm = jsm.ALSServingModel(features, implicit=True,
                                     int8_selection=int8,
                                     fold_scan=fold_scan)
            tm = tsm.ALSServingModel(features, implicit=True, device="cpu",
                                     int8_selection=int8,
                                     fold_scan=fold_scan)
            width = tm.Y.device_features
            for n_rows in (4096, 8192, 8192 + 1024, 20_054_016):
                want_kinds, want_fold = jm._phase_a_kinds(n_rows, width, 128)
                got = tm._phase_a_kinds(n_rows, width, 128)
                assert got == ([k for k in want_kinds if k != "ivf"],
                               want_fold), (int8, fold_scan, n_rows)


def test_kind_chain_at_the_served_widths():
    def kinds(features, **settings):
        tm = tsm.ALSServingModel(features, implicit=True, device="cpu",
                                 **settings)
        return tm._phase_a_kinds(20_054_016, tm.Y.device_features, 128)

    assert kinds(10) == (["i8_fold", "fold", "i8", "pallas", "scan"], 2)
    assert kinds(10, int8_selection="false") == \
        (["fold", "pallas", "scan"], 2)
    assert kinds(50) == (["i8", "pallas", "scan"], 1)
    assert kinds(250) == (["pallas", "scan"], 1)
    assert kinds(250, int8_selection="true") == (["i8", "pallas", "scan"], 1)
    assert kinds(8) == (["i8_fold", "fold", "i8", "pallas", "scan"], 4)
    # the port pads 32 and 64 features nothing: "auto" keeps int8 off
    assert kinds(32) == (["pallas", "scan"], 1)
    assert kinds(64) == (["pallas", "scan"], 1)


def test_int8_selection_bool_normalises():
    on = tsm.ALSServingModel(6, implicit=True, device="cpu",
                             int8_selection=True)
    assert on._int8_selection == "true" and on._int8_enabled()
    off = tsm.ALSServingModel(6, implicit=True, device="cpu",
                              int8_selection=False)
    assert off._int8_selection == "false" and not off._int8_enabled()
    assert tsm.ALSServingModel(6, implicit=True, device="cpu")._int8_enabled()
    assert not tsm.ALSServingModel(100, implicit=True,
                                   device="cpu")._int8_enabled()
    assert not tsm.ALSServingModel(6, implicit=True, device="cpu",
                                   fold_scan="false")._fold_enabled()
    m = serving_model_from_arrays(
        6, True, x_ids=[], X=np.zeros((0, 6), np.float32), y_ids=[],
        Y=np.zeros((0, 6), np.float32), known_items={}, device="cpu",
        int8_selection=True, fold_scan="false")
    assert m._int8_selection == "true" and m._fold_scan == "false"


EXPECTED_KIND = {(10, "auto"): "i8_fold", (10, "false"): "fold",
                 (50, "auto"): "i8", (50, "false"): "pallas"}


@pytest.mark.parametrize("features", [10, 50])
@pytest.mark.parametrize("int8", ["auto", "false"])
@pytest.mark.parametrize("rate", [1.0, 0.3], ids=["exact", "lsh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_top_n_matches_reference(streaming, monkeypatch, features,
                                           int8, rate, dtype):
    rng = np.random.default_rng(features + (int8 == "auto"))
    Y = rng.standard_normal((4096, features)).astype(np.float32)
    Q = rng.standard_normal((11, features)).astype(np.float32)
    jm, tm = _pair(Y, Q, dtype, rate, int8_selection=int8)
    kinds = []
    dispatch = tm._dispatch_kind

    def recording(kind, *args, **kw):
        kinds.append(kind)
        return dispatch(kind, *args, **kw)

    monkeypatch.setattr(tm, "_dispatch_kind", recording)
    rtol = 1e-4 if dtype == "bfloat16" else 1e-5
    for hm, q in ((6, Q), (3, rng.standard_normal((260, features)).astype(
            np.float32))):
        want, got = jm.top_n_batch(hm, q), tm.top_n_batch(hm, q)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert [i for i, _ in g] == [i for i, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=rtol)
    # one window of 11 queries, then a [256, 8] drain of 260
    assert kinds == [EXPECTED_KIND[features, int8]] * 3


def test_streaming_mirrors_rebuild_per_version(streaming):
    """A changed item moves the snapshot version: the folded int8 mirror
    is rebuilt and the new vector is served; the unfolded int8 mirror is
    never kept for the folded kind."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((4096, 10)).astype(np.float32)
    Q = rng.standard_normal((4, 10)).astype(np.float32)
    jm, tm = _pair(Y, Q)
    tm.top_n_batch(5, Q)
    first = tm._i8_fold
    assert first is not None and tm._i8 is None and tm._fold is None
    for m in (jm, tm):
        m.set_item_vector("i7", 40 * Q[0])
    want, got = jm.top_n_batch(5, Q), tm.top_n_batch(5, Q)
    assert tm._i8_fold is not first
    assert got[0][0][0] == want[0][0][0] == "i7"
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r]
                                                for r in want]
