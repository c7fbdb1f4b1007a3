"""The folded phase-A kinds ("fold" and "i8_fold"): fold eligibility and
the fold mirrors against the reference's, the layout the folded kernels
read, and ``_batch_top_n_twophase_cuda_fold`` /
``_batch_top_n_twophase_cuda_i8_fold`` against the reference's Pallas
kernels in interpret mode.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are held against them on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.ops.phase_a import phase_a
from oryx_tpu_torch.ops import phase_a_i8 as pi8
from oryx_tpu_torch.ops import phase_a_i8_fold as pi8f
from oryx_tpu_torch.ops import phase_a_fold as pf

from tests.test_torch_phase_a_i8 import (BS, K, KSEL, _inputs,
                                         assert_same_top_k)


@pytest.mark.parametrize("bs", [64, 128, 96])
def test_fold_eligibility_matches_reference(bs):
    for width in (8, 16, 24, 32, 64, 96, 128, 256):
        for features in range(1, width + 1):
            assert tsm._fold_factor(width, features) == \
                jsm._fold_factor(width, features), (width, features)
            assert tsm._fold_eligible(width, features, bs) == \
                jsm._fold_eligible(width, features, bs), (width, features)
    # at the store's 32-column padding: fold 2 up to 16 features, fold 4
    # up to 8, none from 17 on
    assert [tsm._fold_factor(32, f) for f in (8, 9, 10, 16, 17)] == \
        [4, 2, 2, 2, 1]
    assert tsm._fold_factor(64, 50) == tsm._fold_factor(256, 250) == 1


@pytest.mark.parametrize("fold", [2, 4])
def test_fold_mirrors_identical(fold):
    rng = np.random.default_rng(fold)
    n, width = 2048, 32
    y = np.zeros((n, width), np.float32)
    y[:, :32 // fold] = rng.standard_normal((n, 32 // fold))
    act = rng.random(n) > 0.2
    bkt = rng.integers(0, 1 << 12, n).astype(np.int32)
    jy, ja = jnp.asarray(y), jnp.asarray(act)
    ty, ta = torch.from_numpy(y), torch.from_numpy(act)
    for want, got in (
            (jsm._fold_items_kernel(jy, ja, fold, BS),
             tsm._fold_items_kernel(ty, ta, fold, BS)),
            ((jsm._fold_buckets_kernel(jnp.asarray(bkt), fold, BS),),
             (tsm._fold_buckets_kernel(torch.from_numpy(bkt), fold, BS),))):
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.is_contiguous() and g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    y8, _, _ = jsm._quantize_items_kernel(jy, BS)
    want = jsm._fold_items_i8_kernel(y8, ja, fold, BS)
    got = tsm._fold_items_i8_kernel(torch.from_numpy(np.array(y8)), ta,
                                    fold, BS)
    for w, g in zip(want, got):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fold", [2, 4])
def test_folded_layout_is_what_the_kernels_read(fold):
    """The folded kernels read the mirror as N logical rows of w columns
    and the side inputs at [t % fold, blk, t // fold] for block row t:
    check that mapping on the mirror builders' output."""
    rng = np.random.default_rng(10 + fold)
    n, width = 1024, 32
    w = width // fold
    vecs = torch.zeros((n, width))
    vecs[:, :w] = torch.from_numpy(rng.standard_normal((n, w)).astype(
        np.float32))
    act = torch.from_numpy(rng.random(n) > 0.3)
    yf, pen_f = tsm._fold_items_kernel(vecs, act, fold, BS)
    assert torch.equal(yf.view(n, w), vecs[:, :w])
    pen = torch.where(act, 0.0, float("-inf"))
    t = torch.arange(n) % BS
    blk = torch.arange(n) // BS
    assert torch.equal(pen_f[t % fold, blk, t // fold], pen)


def _fold_args(f, bf16, lsh, seed):
    y, q, act, hp, buckets, max_bits = _inputs(f, 8, bf16, lsh, False, seed)
    fold = tsm._fold_factor(y.shape[1], f)
    assert fold == jsm._fold_factor(y.shape[1], f) > 1
    return y, q, act, hp, buckets, max_bits, fold


def _jax_fold(y, q, act, hp, buckets, max_bits, fold, bf16, i8):
    Y = jnp.asarray(y, jnp.bfloat16 if bf16 else jnp.float32)
    active = jnp.asarray(act)
    bkt = None if buckets is None else jnp.asarray(buckets)
    bkt_f = None if bkt is None else jsm._fold_buckets_kernel(bkt, fold, BS)
    hyp = None if hp is None else jnp.asarray(hp)
    old_tile = jsm._PA_TILE
    jsm._PA_TILE = 2048
    try:
        if i8:
            y8, sy, l1y = jsm._quantize_items_kernel(Y, BS)
            y8f, pen_f = jsm._fold_items_i8_kernel(y8, active, fold, BS)
            out = jsm._batch_top_n_twophase_pallas_i8_fold(
                Y, y8f, sy, l1y, jnp.asarray(q), pen_f, active, bkt_f, bkt,
                hyp, K, BS, KSEL, max_bits, fold, interpret=True)
        else:
            yf, pen_f = jsm._fold_items_kernel(Y, active, fold, BS)
            out = jsm._batch_top_n_twophase_pallas_fold(
                Y, yf, jnp.asarray(q), pen_f, active, bkt_f, bkt, hyp, K,
                BS, KSEL, max_bits, fold, interpret=True)
    finally:
        jsm._PA_TILE = old_tile
    return [np.asarray(a) for a in jax.device_get(out)]


def _port_fold(y, q, act, hp, buckets, max_bits, fold, bf16, i8):
    Y = torch.from_numpy(y).to(torch.bfloat16 if bf16 else torch.float32)
    active = torch.from_numpy(act)
    bkt = None if buckets is None else torch.from_numpy(buckets)
    bkt_f = None if bkt is None else tsm._fold_buckets_kernel(bkt, fold, BS)
    hyp = None if hp is None else torch.from_numpy(hp)
    Q = torch.from_numpy(q)
    if i8:
        y8, sy, l1y = tsm._quantize_items_kernel(Y, BS)
        y8f, pen_f = tsm._fold_items_i8_kernel(y8, active, fold, BS)
        out = tsm._batch_top_n_twophase_cuda_i8_fold(
            Y, y8f, sy, l1y, Q, pen_f, active, bkt_f, bkt, hyp, K, BS, KSEL,
            max_bits, fold)
    else:
        yf, pen_f = tsm._fold_items_kernel(Y, active, fold, BS)
        out = tsm._batch_top_n_twophase_cuda_fold(
            Y, yf, Q, pen_f, active, bkt_f, bkt, hyp, K, BS, KSEL, max_bits,
            fold)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("f", [8, 10])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("i8", [False, True], ids=["fold", "i8_fold"])
def test_twophase_fold_matches_pallas_interpret(f, lsh, bf16, i8):
    args = _fold_args(f, bf16, lsh, seed=f * 10 + lsh + 2 * bf16 + 4 * i8)
    port = _port_fold(*args, bf16, i8)
    assert_same_top_k(port, _jax_fold(*args, bf16, i8), bf16)
    assert port[2][-1]  # the zero query row certifies


@pytest.mark.parametrize("f", [8, 10])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_i8_fold_maxima_equal_i8_maxima(f, lsh):
    """The folded integer maxima are the unfolded ones, bit for bit, and
    the folded float maxima the unfolded ones within summation order."""
    y, q, act, hp, buckets, max_bits, fold = _fold_args(f, False, lsh, 40)
    Y = torch.from_numpy(y)
    active = torch.from_numpy(act)
    Qc = tsm._q_cast(torch.from_numpy(q), Y).contiguous()
    q8, _, _ = tsm._quantize_queries(Qc)
    bkt = bkt_f = target = None
    if lsh:
        bkt = torch.from_numpy(buckets)
        bkt_f = tsm._fold_buckets_kernel(bkt, fold, BS)
        target = tsm._query_buckets(torch.from_numpy(q), torch.from_numpy(hp))
    y8, _, _ = tsm._quantize_items_kernel(Y, BS)
    y8f, pen_i_f = tsm._fold_items_i8_kernel(y8, active, fold, BS)
    folded = pi8f.phase_a_i8_fold(q8, y8f, pen_i_f, bkt_f, target, max_bits,
                                  fold)
    unfolded = pi8.phase_a_i8(q8, y8, tsm._penalty_kernel_i32(active, BS),
                              bkt, target, max_bits)
    assert folded.dtype == torch.int32
    assert torch.equal(folded, unfolded)
    yf, pen_f = tsm._fold_items_kernel(Y, active, fold, BS)
    mf = pf.phase_a_fold(Qc, yf, pen_f, bkt_f, target, max_bits, fold)
    mu = phase_a(Qc, Y, tsm._penalty_kernel(active, BS), bkt, target,
                 max_bits)
    assert torch.equal(torch.isfinite(mf), torch.isfinite(mu))
    fin = torch.isfinite(mu)
    torch.testing.assert_close(mf[fin], mu[fin], rtol=1e-5, atol=1e-5)


def test_fold_wrappers_plain_version_only_on_cpu():
    before = (pf.LAUNCHES, pi8f.LAUNCHES)
    out = pf.phase_a_fold(torch.zeros((8, 32)), torch.zeros((128, 32)),
                          torch.zeros((2, 2, 64)), fold=2)
    assert out.shape == (8, 2) and out.dtype == torch.float32
    out = pi8f.phase_a_i8_fold(torch.zeros((8, 32), dtype=torch.int8),
                               torch.zeros((64, 32), dtype=torch.int8),
                               torch.zeros((4, 2, 32), dtype=torch.int32),
                               fold=4)
    assert out.shape == (8, 2) and out.dtype == torch.int32
    assert (pf.LAUNCHES, pi8f.LAUNCHES) == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pf.phase_a_fold(torch.zeros((8, 32), **meta),
                        torch.zeros((128, 32), **meta),
                        torch.zeros((2, 2, 64), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        pi8f.phase_a_i8_fold(torch.zeros((8, 32), dtype=torch.int8, **meta),
                             torch.zeros((128, 32), dtype=torch.int8, **meta),
                             torch.zeros((2, 2, 64), dtype=torch.int32,
                                         **meta))


def test_slot_queries_shift_each_slot():
    q = torch.arange(1, 33, dtype=torch.float32)[None, :].repeat(2, 1)
    qs = pf.slot_queries(q, 4)
    assert qs.shape == (4, 2, 32)
    for j in range(4):
        assert torch.equal(qs[j, :, j * 8:(j + 1) * 8], q[:, :8])
        assert qs[j].abs().sum() == q[:, :8].abs().sum()
