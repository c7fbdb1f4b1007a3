"""The int8 phase A at the shapes the tensor-core kernel
(``csrc/phase_a_i8.cu``) is laid out for: int8 widths 32, 96 and 256 (its
32-, 32- and 128-byte stage rows) and a 300-query window (two query
tiles, the second in the other wgmma orientation).  The port's plain
version is held against the reference's Pallas kernel
(``_batch_top_n_twophase_pallas_i8``, interpret mode): its integer block
maxima bit for bit, and the two-phase top-k it serves.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against this plain version bit for bit at the same widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.ops import phase_a_i8 as pi8
from tests.test_torch_phase_a_i8 import (_inputs, _jax_i8, _port_i8,
                                         assert_same_top_k)

N, BS = 8192, 128
# static arguments no other test traces the reference kernel with, so
# the patched trace below is this test's own
K_MAXIMA, KSEL_MAXIMA = 24, 3


def _maxima_inputs(width, b, lsh, seed):
    """int8 rows, integer queries whose largest magnitude is 127 (so the
    query scale is exactly 1 and q8 equals the query), a zero query row,
    retired rows and a fully retired block, and LSH buckets."""
    rng = np.random.default_rng(seed)
    y8 = rng.integers(-127, 128, (N, width)).astype(np.int8)
    q = rng.integers(-127, 128, (b, width)).astype(np.float32)
    q[:, 0] = 127.0
    q[-1] = 0.0
    act = rng.random(N) > 0.2
    act[BS * 5:BS * 6] = False
    hp = buckets = None
    max_bits = 0
    if lsh:
        hp = rng.standard_normal((6, width)).astype(np.float32)
        assert (np.abs(q[:-1] @ hp.T) > 1e-3).all()
        buckets = rng.integers(0, 1 << 6, N).astype(np.int32)
        max_bits = 2
    return y8, q, act, hp, buckets, max_bits


def _pallas_maxima(monkeypatch, y8, q, act, hp, buckets, max_bits):
    """The reference Pallas kernel's integer block maxima (B, N / 128),
    read back from the bounds it hands phase B: with item scales 1, item
    L1 norms 0 and a query scale of exactly 1 the bound is
    M + l1(q) / 2 + W / 4, every term an integer or a quarter below 2^24,
    so exact in float32.  Masked entries come back as -inf."""
    monkeypatch.setattr(jsm, "_PA_TILE", 2048)
    monkeypatch.setattr(
        jsm, "_phase_b",
        lambda Y, Qc, active, buckets, target, bound, *rest: bound)
    width = y8.shape[1]
    bound = np.asarray(jsm._batch_top_n_twophase_pallas_i8(
        jnp.asarray(y8.astype(np.float32)), jnp.asarray(y8),
        jnp.ones(N // BS, jnp.float32), jnp.zeros(N // BS, jnp.float32),
        jnp.asarray(q), jsm._penalty_kernel_i32(jnp.asarray(act), BS),
        jnp.asarray(act), None if buckets is None else jnp.asarray(buckets),
        None if hp is None else jnp.asarray(hp), K_MAXIMA, BS, KSEL_MAXIMA,
        max_bits, interpret=True), np.float64)
    l1q = np.abs(q).sum(1).astype(np.float64)
    return bound - (0.5 * l1q[:, None] + 0.25 * width)


def _plain_maxima(y8, q, act, hp, buckets, max_bits):
    target = None
    if buckets is not None:
        target = tsm._query_buckets(torch.from_numpy(q), torch.from_numpy(hp))
    return pi8.phase_a_i8(
        torch.from_numpy(q.astype(np.int8)), torch.from_numpy(y8),
        tsm._penalty_kernel_i32(torch.from_numpy(act), BS),
        None if buckets is None else torch.from_numpy(buckets), target,
        max_bits).numpy()


@pytest.mark.parametrize("width,b", [(32, 8), (96, 8), (96, 256),
                                     (256, 8), (256, 300)])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_plain_block_maxima_equal_pallas_interpret(monkeypatch, width, b,
                                                   lsh):
    args = _maxima_inputs(width, b, lsh, seed=width * 7 + b + lsh)
    want = _pallas_maxima(monkeypatch, *args)
    got = _plain_maxima(*args)
    assert got.shape == want.shape == (b, N // BS)
    live = got[:-1] > pi8.I8_PENALTY // 2
    # the reference masks retired blocks, rows outside the ball and the
    # zero query to -inf; the plain version keeps I8_PENALTY there
    np.testing.assert_array_equal(np.isfinite(want[:-1]), live)
    np.testing.assert_array_equal(got[:-1][live], want[:-1][live])
    assert np.isneginf(want[-1]).all()
    assert ((got[-1] == 0) | (got[-1] <= pi8.I8_PENALTY // 2)).all()
    assert (got[:, 5] <= pi8.I8_PENALTY // 2).all()  # the retired block
    if lsh:  # rows outside the balls change maxima
        y8, q, act = args[:3]
        assert (got != _plain_maxima(y8, q, act, None, None, 0)).any()


@pytest.mark.parametrize("f,b", [(80, 8), (250, 8), (250, 300)])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_twophase_i8_at_wide_widths_matches_pallas_interpret(f, b, lsh):
    args = _inputs(f, b, False, lsh, False, seed=f + b + lsh)
    port = _port_i8(*args, False)
    assert_same_top_k(port, _jax_i8(*args, False), False)
    assert port[2][-1]  # the zero query row certifies
