"""The int8 phase A (kind "i8"): the port's quantizer, penalty and
``_batch_top_n_twophase_cuda_i8`` against the reference's
``_quantize_items_kernel``, ``_penalty_kernel_i32`` and
``_batch_top_n_twophase_pallas_i8`` (Pallas in interpret mode), and the
kernel's plain version against a NumPy int32 oracle.

On the CPU the port's wrapper takes its plain version
(``phase_a_i8_reference``); the CUDA kernel itself is held against that
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
from oryx_tpu_torch.ops import phase_a_i8 as pi8

N, BS, KSEL, K = 8192, 128, 8, 8


def _heavy_tailed(rng, n, f, width):
    """Rows with lognormal norms, so block scales vary a lot, in a
    ``width``-column zero-padded matrix as a store snapshot holds them."""
    y = np.zeros((n, width), np.float32)
    y[:, :f] = (rng.standard_normal((n, f))
                * rng.lognormal(0, 1.5, (n, 1))).astype(np.float32)
    return y


def _half_way(rng, width):
    """Two 128-row blocks whose values divide by their scale to exactly
    m + 0.5: each block's largest magnitude is 127 * 2^e, so its scale
    is 2^e, and round-half-to-even decides every other element."""
    y = np.zeros((2 * BS, width), np.float32)
    for blk, e in enumerate((-3, 2)):
        m = rng.integers(-126, 126, (BS, width)).astype(np.float32)
        vals = (m + 0.5) * np.float32(2.0 ** e)
        vals[0, 0] = 127 * 2.0 ** e
        y[blk * BS:(blk + 1) * BS] = vals
    return y


def _quantize_both(y, bs, bf16=False):
    jy = jnp.asarray(y, jnp.bfloat16 if bf16 else jnp.float32)
    ty = torch.from_numpy(y).to(torch.bfloat16 if bf16 else torch.float32)
    want = [np.asarray(a) for a in jsm._quantize_items_kernel(jy, bs)]
    got = [a.numpy() for a in tsm._quantize_items_kernel(ty, bs)]
    return want, got


@pytest.mark.parametrize("f,width", [(10, 32), (16, 32), (50, 64),
                                     (250, 256)])
@pytest.mark.parametrize("bs", [64, 128])
def test_quantizer_bit_identical(f, width, bs):
    rng = np.random.default_rng(f * 7 + bs)
    y = _heavy_tailed(rng, 4096, f, width)
    y[bs:2 * bs] = 0.0  # a fully zero (retired) block
    want, got = _quantize_both(y, bs)
    for w, g, name in zip(want, got, ("y8", "scale", "l1")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[0][:, f:] == 0).all()  # padding lanes quantize to 0


@pytest.mark.parametrize("width", [32, 64])
def test_quantizer_rounds_half_to_even_like_reference(width):
    rng = np.random.default_rng(width)
    y = _half_way(rng, width)
    q = y.reshape(2, BS, width) / np.float32([2.0 ** -3, 2.0 ** 2])[
        :, None, None]
    assert (np.abs(q - np.trunc(q)) == 0.5).sum() > 1000
    want, got = _quantize_both(y, BS)
    for w, g, name in zip(want, got, ("y8", "scale", "l1")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    np.testing.assert_array_equal(got[0].reshape(2, BS, width),
                                  np.round(q).astype(np.int8))


def test_quantizer_bf16_store_bit_identical():
    rng = np.random.default_rng(5)
    y = _heavy_tailed(rng, 2048, 50, 64)
    y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
    want, got = _quantize_both(y, BS, bf16=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_query_quantization_matches_reference_bound():
    """The port's query quantization and bound epilogue give the
    reference's certificate inputs: the same q8 and the same bounds on
    arrays of one width."""
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((8, 64))
         * rng.lognormal(0, 1, (8, 1))).astype(np.float32)
    q[:, 50:] = 0.0
    q[-1] = 0.0
    q8, sq, l1q = tsm._quantize_queries(torch.from_numpy(q))
    jq = jnp.asarray(q)
    jsq = jnp.maximum(jnp.max(jnp.abs(jq), axis=1), 1e-30) / 127.0
    jq8 = jnp.clip(jnp.round(jq / jsq[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(
        l1q.numpy(), np.asarray(jnp.sum(jnp.abs(jq), axis=1)))
    # the reference's bound epilogue (serving_model.py:879-888), on block
    # maxima that include masked and zero-query entries
    y = _heavy_tailed(rng, 1024, 50, 64)
    _, sy, l1y = jsm._quantize_items_kernel(jnp.asarray(y), BS)
    m = rng.integers(-40000, 40000, (8, 1024 // BS)).astype(np.int32)
    m[0, 2] = jsm._I8_PENALTY - 5
    mt = jnp.asarray(m.T)
    jl1q = jnp.sum(jnp.abs(jq), axis=1)
    want = (mt.astype(jnp.float32) * sy[:, None] * jsq[None, :]
            + 0.5 * jsq[None, :] * l1y[:, None]
            + 0.5 * sy[:, None] * jl1q[None, :]
            + 0.25 * 64 * sy[:, None] * jsq[None, :])
    want = jnp.where((mt <= jsm._I8_PENALTY // 2) | (jl1q[None, :] == 0.0),
                     -jnp.inf, want)
    got = tsm._i8_bounds(torch.from_numpy(m), torch.from_numpy(np.array(sy)),
                         torch.from_numpy(np.array(l1y)), sq, l1q, 64).numpy()
    np.testing.assert_allclose(got, np.asarray(want).T, rtol=1e-6)
    assert np.isneginf(got[0, 2]) and np.isneginf(got[-1]).all()


def test_penalty_i32_identical():
    act = np.random.default_rng(7).random(4096) > 0.3
    want = np.asarray(jsm._penalty_kernel_i32(jnp.asarray(act), BS))
    got = tsm._penalty_kernel_i32(torch.from_numpy(act), BS).numpy()
    assert got.dtype == np.int32 and got.shape == (4096 // BS, BS)
    np.testing.assert_array_equal(got, want)
    assert tsm._I8_PENALTY == jsm._I8_PENALTY == pi8.I8_PENALTY


def _oracle(q8, y8, act, buckets, target, max_bits, bs):
    s = q8.astype(np.int32) @ y8.astype(np.int32).T
    s = s + np.where(act, 0, pi8.I8_PENALTY).astype(np.int32)[None, :]
    if buckets is not None:
        x = (buckets[None, :] ^ target[:, None]).view(np.uint32)
        s = np.where(np.bitwise_count(x) <= max_bits, s, pi8.I8_PENALTY)
    return s.reshape(q8.shape[0], -1, bs).max(-1)


@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
@pytest.mark.parametrize("width", [32, 256])
def test_reference_matches_numpy_int32_oracle(lsh, width):
    rng = np.random.default_rng(width + lsh)
    y8 = rng.integers(-127, 128, (N, width)).astype(np.int8)
    q8 = rng.integers(-127, 128, (5, width)).astype(np.int8)
    q8[-1] = 0  # a zero query row
    act = rng.random(N) > 0.2
    act[BS * 3:BS * 4] = False  # a fully retired block
    buckets = target = None
    if lsh:
        buckets = rng.integers(0, 1 << 10, N).astype(np.int32)
        target = rng.integers(0, 1 << 10, 5).astype(np.int32)
    pen = tsm._penalty_kernel_i32(torch.from_numpy(act), BS)
    got = pi8.phase_a_i8(
        torch.from_numpy(q8), torch.from_numpy(y8), pen,
        None if buckets is None else torch.from_numpy(buckets),
        None if target is None else torch.from_numpy(target), 3).numpy()
    want = _oracle(q8, y8, act, buckets, target, 3, BS)
    assert got.dtype == np.int32 and got.shape == (5, N // BS)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 3] <= pi8.I8_PENALTY // 2).all()


def test_lsh_replaces_rather_than_adds_penalty():
    """A row both retired and outside the Hamming ball scores
    I8_PENALTY, not twice it: the block's max is I8_PENALTY exactly."""
    y8 = torch.ones((BS, 32), dtype=torch.int8)
    q8 = torch.ones((1, 32), dtype=torch.int8)
    act = torch.zeros(BS, dtype=torch.bool)
    pen = tsm._penalty_kernel_i32(act, BS)
    got = pi8.phase_a_i8(q8, y8, pen, torch.full((BS,), 7, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 0)
    assert int(got) == pi8.I8_PENALTY


def _inputs(f, b, bf16, lsh, ties, seed):
    rng = np.random.default_rng(seed)
    width = device_width(f)
    y = np.zeros((N, width), np.float32)
    q = rng.standard_normal((b, f)).astype(np.float32)
    if ties:
        y[:, :f] = rng.integers(-2, 3, (N, f))
        q = rng.integers(-2, 3, (b, f)).astype(np.float32)
    else:
        y[:, :f] = rng.standard_normal((N, f))
    q[-1] = 0.0  # a zero-padded query row
    act = np.ones(N, bool)
    act[::5] = False
    act[BS * 7:BS * 8] = False  # a fully retired block
    y[~act] = 0.0  # a store zeroes retired rows
    if bf16:
        y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
    hp = buckets = None
    max_bits = 0
    if lsh:
        h = jlsh.LocalitySensitiveHash(0.3, f)
        hp, max_bits = h.hyperplanes, h.max_bits_differing
        buckets = np.array(h.device_buckets(jnp.asarray(y[:, :f])))
        # bucket parity is tested in test_torch_lsh.py; here both sides
        # must see the same target buckets, so no query sits on a plane
        assert (np.abs(q[:-1] @ hp.T) > 1e-4).all()
    return y, q, act, hp, buckets, max_bits


def _jax_i8(y, q, act, hp, buckets, max_bits, bf16):
    Y = jnp.asarray(y, jnp.bfloat16 if bf16 else jnp.float32)
    active = jnp.asarray(act)
    y8, sy, l1y = jsm._quantize_items_kernel(Y, BS)
    pen_i = jsm._penalty_kernel_i32(active, BS)
    old_tile = jsm._PA_TILE
    jsm._PA_TILE = 2048
    try:
        out = jsm._batch_top_n_twophase_pallas_i8(
            Y, y8, sy, l1y, jnp.asarray(q), pen_i, active,
            None if buckets is None else jnp.asarray(buckets),
            None if hp is None else jnp.asarray(hp), K, BS, KSEL, max_bits,
            interpret=True)
    finally:
        jsm._PA_TILE = old_tile
    return [np.asarray(a) for a in jax.device_get(out)]


def _port_i8(y, q, act, hp, buckets, max_bits, bf16):
    Y = torch.from_numpy(y).to(torch.bfloat16 if bf16 else torch.float32)
    active = torch.from_numpy(act)
    y8, sy, l1y = tsm._quantize_items_kernel(Y, BS)
    pen_i = tsm._penalty_kernel_i32(active, BS)
    ts, ti, cert = tsm._batch_top_n_twophase_cuda_i8(
        Y, y8, sy, l1y, torch.from_numpy(q), pen_i, active,
        None if buckets is None else torch.from_numpy(buckets),
        None if hp is None else torch.from_numpy(hp), K, BS, KSEL, max_bits)
    return ts.numpy(), ti.numpy(), cert.numpy()


def assert_same_top_k(port, ref, bf16):
    ts_t, ti_t, cert_t = port
    ts_j, ti_j, cert_j = ref
    np.testing.assert_array_equal(ti_t, ti_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    np.testing.assert_array_equal(np.isfinite(ts_t), np.isfinite(ts_j))
    fin = np.isfinite(ts_j)
    # f32: summation order only; bf16: the certificate's own margin
    np.testing.assert_allclose(ts_t[fin], ts_j[fin],
                               rtol=1e-4 if bf16 else 1e-5)


@pytest.mark.parametrize("f", [10, 50])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_twophase_i8_matches_pallas_interpret(f, lsh, bf16):
    args = _inputs(f, 8, bf16, lsh, False, seed=f * 10 + lsh + 2 * bf16)
    port = _port_i8(*args, bf16)
    assert_same_top_k(port, _jax_i8(*args, bf16), bf16)
    assert port[2][-1]  # the zero query row certifies


@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_twophase_i8_integer_ties_match_pallas_interpret(lsh):
    args = _inputs(10, 8, False, lsh, True, seed=30 + lsh)
    port = _port_i8(*args, False)
    assert_same_top_k(port, _jax_i8(*args, False), False)
    assert len(set(port[0][0].tolist())) < K  # ties present


def test_wrapper_plain_version_only_on_cpu():
    """A CPU tensor takes the plain version and never touches the
    kernel's build; any other device launches the kernel or raises."""
    before = pi8.LAUNCHES
    out = pi8.phase_a_i8(torch.zeros((8, 32), dtype=torch.int8),
                         torch.zeros((256, 32), dtype=torch.int8),
                         torch.zeros((2, 128), dtype=torch.int32))
    assert out.shape == (8, 2) and out.dtype == torch.int32
    assert pi8.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        pi8.phase_a_i8(torch.zeros((8, 32), dtype=torch.int8, device="meta"),
                       torch.zeros((256, 32), dtype=torch.int8,
                                   device="meta"),
                       torch.zeros((2, 128), dtype=torch.int32,
                                   device="meta"))
