"""The port's nearest-centroid primitives (``oryx_tpu_torch/ops/ann.py``)
against the reference's (``oryx_tpu/ops/ann.py``) on the same seeded
inputs: Lloyd steps and centroid training within rtol 1e-5, and the
catalog assignment equal to the reference's except on rows whose two
best distances are within rtol 1e-5 of each other (near ties, where the
two libraries' differently ordered sums may pick either; counted)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.ops import ann as jann
from oryx_tpu_torch.ops import ann as tann

RTOL = 1e-5


def _mixture(rng, n, features, ncomp, spread=0.25):
    comp = rng.standard_normal((ncomp, features))
    pick = rng.integers(0, ncomp, size=n)
    return (comp[pick] + spread * rng.standard_normal((n, features))
            ).astype(np.float32)


def _near_tied(points, centers):
    """Rows whose two smallest distances are within RTOL of each other
    (float64)."""
    p = points.astype(np.float64)
    c = centers.astype(np.float64)
    d = ((p[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return np.abs(two[:, 1] - two[:, 0]) <= RTOL * np.abs(two[:, 1])


@pytest.mark.parametrize("ncells", [4, 16])
def test_lloyd_step_matches_reference(ncells):
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + ncells)
    pts = _mixture(rng, 2048, 12, ncells)
    init = pts[rng.permutation(len(pts))[:ncells]]
    want = np.asarray(jann.lloyd_step(jnp.asarray(pts), jnp.asarray(init),
                                      ncells))
    got = tann.lloyd_step(torch.from_numpy(pts), torch.from_numpy(init),
                          ncells).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_lloyd_step_keeps_an_empty_cell():
    pts = np.zeros((256, 4), np.float32)
    pts[:, 0] = np.linspace(-1, 1, 256)
    init = np.array([[0, 0, 0, 0], [100, 0, 0, 0]], np.float32)
    got = tann.lloyd_step(torch.from_numpy(pts), torch.from_numpy(init),
                          2).numpy()
    np.testing.assert_array_equal(got[1], init[1])


@pytest.mark.parametrize("ncells,iterations", [(8, 4), (32, 8)])
def test_train_centroids_matches_reference(ncells, iterations):
    rng = np.random.default_rng(7 * ncells)
    pts = _mixture(rng, 4096, 16, ncells // 2)
    want = jann.train_centroids(pts, ncells, iterations, 13)
    got = tann.train_centroids(pts, ncells, iterations, 13, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    # a tensor input gives the same centroids
    again = tann.train_centroids(torch.from_numpy(pts), ncells,
                                 iterations, 13)
    np.testing.assert_array_equal(again, got)


def test_train_centroids_small_and_empty():
    one = np.ones((3, 4), np.float32)
    np.testing.assert_array_equal(
        tann.train_centroids(one, 1, 3, 13, device="cpu"),
        jann.train_centroids(one, 1, 3, 13))
    with pytest.raises(ValueError):
        tann.train_centroids(np.zeros((0, 4), np.float32), 4, 3, 13,
                             device="cpu")


@pytest.mark.parametrize("width", [16, 32])
def test_assign_cells_chunked_and_against_reference(width, monkeypatch):
    rng = np.random.default_rng(width)
    n, features, cells = 6000, 10, 24
    pts = np.zeros((n, width), np.float32)
    pts[:, :features] = _mixture(rng, n, features, cells)
    cents = jann.train_centroids(pts[:, :features], cells, 4, 13)
    want = jann.assign_cells(pts, cents)
    whole = tann.assign_cells(torch.from_numpy(pts), cents)
    monkeypatch.setattr(tann, "_ASSIGN_CHUNK_ELEMS", 1000 * cells)
    chunked = tann.assign_cells(pts, cents, device="cpu")
    assert chunked.dtype == np.int32
    np.testing.assert_array_equal(chunked, whole)
    differ = whole != want
    tied = _near_tied(pts[:, :features], cents)
    assert not (differ & ~tied).any(), np.flatnonzero(differ & ~tied)
    # near ties are rare: a handful of rows at most
    assert differ.sum() <= max(3, n // 1000), int(differ.sum())


def test_assign_cells_bf16_store_widens_exactly():
    rng = np.random.default_rng(3)
    pts = _mixture(rng, 1024, 8, 6)
    cents = tann.train_centroids(pts, 6, 3, 13, device="cpu")
    bf = torch.from_numpy(pts).to(torch.bfloat16)
    want = tann.assign_cells(bf.to(torch.float32), cents)
    np.testing.assert_array_equal(tann.assign_cells(bf, cents), want)


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tann.train_centroids(np.ones((8, 2), np.float32), 2, 1, 13)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tann.assign_cells(np.ones((8, 2), np.float32),
                          np.ones((2, 2), np.float32))
