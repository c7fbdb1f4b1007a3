"""The port's FeatureVectorStore against the reference's: the same
sequence of operations leaves the same id <-> row tables, active mask,
version bumps and capacities, and the device snapshot holds the host
data with zero pad columns."""

import numpy as np
import pytest
import torch

from oryx_tpu.app.als import feature_vectors as jfv
from oryx_tpu_torch.app.als import feature_vectors as tfv


def _state(store):
    host, active, row_ids = store.host_arrays()
    return host, active, row_ids, {i: store.row_of(i) for i in store.all_ids()}


def _assert_same(js, ts, recent=True):
    jh, ja, jr, jmap = _state(js)
    th, ta, tr, tmap = _state(ts)
    assert jr == tr
    assert jmap == tmap
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(np.asarray(jh, np.float32), th)
    if recent:
        assert js.recent_ids() == ts.recent_ids()
    assert len(js) == len(ts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operation_sequence_matches_reference(dtype):
    rng = np.random.default_rng(7)
    f = 5
    js = jfv.FeatureVectorStore(f, initial_capacity=16, dtype=dtype)
    ts = tfv.FeatureVectorStore(f, initial_capacity=16, dtype=dtype,
                                device="cpu")
    versions = []

    def sync():
        _, _, jv = js.device_arrays_versioned()
        _, _, tv = ts.device_arrays_versioned()
        versions.append((jv, tv))

    ids = [f"i{j}" for j in range(40)]
    m = rng.standard_normal((40, f)).astype(np.float32)
    js.bulk_load(ids, m)
    ts.bulk_load(ids, m)
    _assert_same(js, ts)
    sync()
    sync()  # no writes: no bump
    for j in (3, 17, 39):
        v = rng.standard_normal(f).astype(np.float32)
        js.set_vector(ids[j], v)
        ts.set_vector(ids[j], v)
    sync()  # few dirty rows: scatter
    for j in (5, 6, 30):
        js.remove(ids[j])
        ts.remove(ids[j])
    new = rng.standard_normal(f).astype(np.float32)
    js.set_vector("fresh", new)  # recycles a freed row
    ts.set_vector("fresh", new)
    _assert_same(js, ts)
    sync()
    keep = ids[:20]
    js.retain_recent_and_ids(keep)
    ts.retain_recent_and_ids(keep)
    _assert_same(js, ts)
    js.retain_recent_and_ids(keep[:10])  # recent set now empty: prunes
    ts.retain_recent_and_ids(keep[:10])
    _assert_same(js, ts)
    sync()
    # growth past capacity by single sets
    for j in range(60):
        v = rng.standard_normal(f).astype(np.float32)
        js.set_vector(f"g{j}", v)
        ts.set_vector(f"g{j}", v)
    _assert_same(js, ts)
    sync()
    assert [j for j, _ in versions] == [t for _, t in versions]
    assert len(js.row_ids()) == len(ts.row_ids())


@pytest.mark.parametrize("n", [0, 10, 1024, 1025, 70_000, 131_073,
                               1_000_000, 5_000_000])
def test_planned_capacity_matches_reference(n):
    assert tfv.planned_capacity(n) == jfv.planned_capacity(n)


def test_planned_capacity_is_what_bulk_load_reaches():
    n = 3000
    store = tfv.FeatureVectorStore(3, device="cpu")
    store.bulk_load([str(i) for i in range(n)], np.zeros((n, 3), np.float32))
    assert len(store.row_ids()) == tfv.planned_capacity(n)


@pytest.mark.parametrize("features,width", [(4, 32), (32, 32), (50, 64),
                                            (250, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_snapshot_is_host_data_with_zero_pad(features, width, dtype):
    rng = np.random.default_rng(features)
    store = tfv.FeatureVectorStore(features, dtype=dtype, device="cpu")
    m = rng.standard_normal((100, features)).astype(np.float32)
    store.bulk_load([str(i) for i in range(100)], m)
    store.remove("7")
    vecs, active = store.device_arrays()
    assert store.device_features == width
    assert vecs.shape == (len(store.row_ids()), width)
    assert vecs.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    host, act, _ = store.host_arrays()
    np.testing.assert_array_equal(vecs[:, :features].float().numpy(), host)
    assert not vecs[:, features:].any()
    np.testing.assert_array_equal(active.numpy(), act)
    assert not act[7] and not vecs[7].any()


def test_bf16_host_mirror_rounds_like_ml_dtypes():
    """The host mirror keeps float32 values rounded through
    torch.bfloat16; ml_dtypes rounds the same way (nearest even)."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    m = rng.standard_normal((64, 9)).astype(np.float32)
    # halfway cases between two bf16 values: round-to-even decides them
    m[0] = np.frombuffer(np.arange(0x3F808000, 0x3F808000 + 9 * 0x10000,
                                   0x10000, dtype=np.uint32).tobytes(),
                         dtype=np.float32)
    store = tfv.FeatureVectorStore(9, dtype="bfloat16", device="cpu")
    store.bulk_load([str(i) for i in range(64)], m)
    want = m.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(store.host_arrays()[0][:64], want)


def test_load_rows_keeps_row_positions():
    rng = np.random.default_rng(5)
    js = jfv.FeatureVectorStore(3)
    ids = [f"i{j}" for j in range(30)]
    js.bulk_load(ids, rng.standard_normal((30, 3)).astype(np.float32))
    js.remove("i4")
    js.remove("i11")
    host, _, row_ids = js.host_arrays()
    ts = tfv.FeatureVectorStore(3, device="cpu")
    ts.load_rows(row_ids, host)
    _assert_same(js, ts, recent=False)
    # a loaded store hands out its lowest free row first
    ts.set_vector("new", np.ones(3, np.float32))
    assert ts.row_of("new") == 4


def test_load_rows_zeroes_free_rows():
    """A free row (None) is zero and inactive whatever ``matrix`` holds
    there, as the reference's store keeps its free rows."""
    m = np.arange(12, dtype=np.float32).reshape(4, 3) + 1.0
    ts = tfv.FeatureVectorStore(3, device="cpu")
    ts.load_rows(["a", None, "c", None], m)
    host, active, row_ids = ts.host_arrays()
    np.testing.assert_array_equal(host[:4], m * np.array([[1], [0], [1],
                                                          [0]], np.float32))
    assert active[:4].tolist() == [True, False, True, False]
    assert row_ids[:4] == ["a", None, "c", None]
    assert ts.row_of("c") == 2 and len(ts) == 2
