"""Phase A: the port's counterpart of ``_batch_top_n_twophase_pallas``
against the reference's Pallas kernel run in interpret mode, and the
kernel's plain version against an independent NumPy block max.

On the CPU the port's wrapper takes its plain version
(``phase_a_reference``); the CUDA kernel itself is held against that
plain version on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from oryx_tpu.app.als import lsh as jlsh
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als.feature_vectors import device_width
from oryx_tpu_torch.ops import phase_a as pa

N, BS, KSEL, K = 8192, 128, 8, 8


def _inputs(f, b, bf16, lsh, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, f)).astype(np.float32)
    q = rng.standard_normal((b, f)).astype(np.float32)
    act = np.ones(N, bool)
    act[::5] = False
    y[~act] = 0.0  # a store zeroes retired rows
    if bf16:
        y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
    hp = buckets = None
    max_bits = 0
    if lsh:
        h = jlsh.LocalitySensitiveHash(0.3, f)
        hp, max_bits = h.hyperplanes, h.max_bits_differing
        buckets = np.array(h.device_buckets(jnp.asarray(y)))
        # bucket parity is tested in test_torch_lsh.py; here both sides
        # must see the same target buckets, so no query sits on a plane
        assert (np.abs(q @ hp.T) > 1e-4).all()
    return y, q, act, hp, buckets, max_bits


def _jax_side(y, q, act, hp, buckets, max_bits, bf16):
    Y = jnp.asarray(y, jnp.bfloat16 if bf16 else jnp.float32)
    active = jnp.asarray(act)
    penalty = jsm._penalty_kernel(active, BS)
    old_tile = jsm._PA_TILE
    jsm._PA_TILE = 2048
    try:
        out = jsm._batch_top_n_twophase_pallas(
            Y, jnp.asarray(q), penalty, active,
            None if buckets is None else jnp.asarray(buckets),
            None if hp is None else jnp.asarray(hp), K, BS, KSEL, max_bits,
            interpret=True)
    finally:
        jsm._PA_TILE = old_tile
    return [np.asarray(a) for a in jax.device_get(out)]


def _port_side(y, q, act, hp, buckets, max_bits, bf16):
    f = y.shape[1]
    Y = torch.zeros((N, device_width(f)),
                    dtype=torch.bfloat16 if bf16 else torch.float32)
    Y[:, :f] = torch.from_numpy(y)
    active = torch.from_numpy(act)
    penalty = tsm._penalty_kernel(active, BS)
    ts, ti, cert = tsm._batch_top_n_twophase_cuda(
        Y, torch.from_numpy(q), penalty, active,
        None if buckets is None else torch.from_numpy(buckets),
        None if hp is None else torch.from_numpy(hp), K, BS, KSEL, max_bits)
    return ts.numpy(), ti.numpy(), cert.numpy()


@pytest.mark.parametrize("f", [16, 250])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_twophase_matches_pallas_interpret(f, b, lsh, bf16):
    args = _inputs(f, b, bf16, lsh, seed=f * 100 + b)
    ts_j, ti_j, cert_j = _jax_side(*args, bf16)
    ts_t, ti_t, cert_t = _port_side(*args, bf16)
    np.testing.assert_array_equal(ti_t, ti_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    np.testing.assert_array_equal(np.isfinite(ts_t), np.isfinite(ts_j))
    fin = np.isfinite(ts_j)
    # f32: summation order only; bf16: the certificate's own margin
    np.testing.assert_allclose(ts_t[fin], ts_j[fin],
                               rtol=1e-4 if bf16 else 1e-5)


def _numpy_block_max(q, y, act, buckets, target, max_bits):
    s = q.astype(np.float64) @ y.astype(np.float64).T
    ok = np.broadcast_to(act[None, :], s.shape)
    if buckets is not None:
        x = (buckets[None, :] ^ target[:, None]).view(np.uint32)
        ok = ok & (np.bitwise_count(x) <= max_bits)
    s = np.where(ok, s, -np.inf)
    return s.reshape(q.shape[0], -1, BS).max(-1)


@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_matches_numpy_block_max(lsh, bf16):
    rng = np.random.default_rng(21)
    f, b = 40, 5
    y = rng.standard_normal((N, f)).astype(np.float32)
    q = rng.standard_normal((b, f)).astype(np.float32)
    q[-1] = 0.0  # a zero-padded query row
    act = rng.random(N) > 0.2
    act[BS * 3:BS * 4] = False  # a fully retired block
    if bf16:
        y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    buckets = target = None
    if lsh:
        buckets = rng.integers(0, 1 << 10, N).astype(np.int32)
        target = rng.integers(0, 1 << 10, b).astype(np.int32)
    dt = torch.bfloat16 if bf16 else torch.float32
    pen = tsm._penalty_kernel(torch.from_numpy(act), BS)
    got = pa.phase_a(torch.from_numpy(q).to(dt), torch.from_numpy(y).to(dt),
                     pen,
                     None if buckets is None else torch.from_numpy(buckets),
                     None if target is None else torch.from_numpy(target),
                     3).numpy()
    want = _numpy_block_max(q, y, act, buckets, target, 3)
    assert got.shape == (b, N // BS) and got.dtype == np.float32
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[:, 3]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)
    # the zero query scores exactly 0 on every block with a live row
    assert (got[-1][np.isfinite(got[-1])] == 0.0).all()


def test_wrapper_plain_version_only_on_cpu():
    """A CPU tensor takes the plain version and never touches the
    kernel's build; any other device launches the kernel or raises."""
    before = pa.LAUNCHES
    y = torch.zeros((256, 32))
    out = pa.phase_a(torch.zeros((8, 32)), y, torch.zeros((2, 128)))
    assert out.shape == (8, 2) and pa.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        pa.phase_a(torch.zeros((8, 32), device="meta"),
                   torch.zeros((256, 32), device="meta"),
                   torch.zeros((2, 128), device="meta"))


def test_store_wider_than_the_kernel_serves_on_the_scan():
    """The kernel keeps a whole-width query tile in shared memory, up to
    ``MAX_WIDTH`` columns; a wider store is served by the scan kind."""
    def kinds(features):
        tm = tsm.ALSServingModel(features, implicit=True, device="cpu",
                                 int8_selection="false", fold_scan="false")
        return tm._phase_a_kinds(8192, tm.Y.device_features, BS)

    assert device_width(250) <= pa.MAX_WIDTH < device_width(300)
    assert kinds(250) == (["pallas", "scan"], 1)
    assert kinds(300) == (["scan"], 1)
