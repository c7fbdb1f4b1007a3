"""Phase A's bf16 body sums on the tensor cores, in another order than
the plain version: does the two-phase top-k stay right?

``tensor_core_block_max`` forms the bf16 block maxima the way ``wgmma``
sums them: float32 partial sums over 16-column k-steps, added to the
accumulator in order, the 16 products inside a k-step summed in a seeded
shuffled order.  At the shapes and seeds of ``test_torch_phase_a.py``
these maxima stay within ``chip_smoke.py``'s bf16 tolerance of the plain
version, and with them in place of phase A every row that
``_batch_top_n_twophase_cuda`` certifies has the reference's top-N ids,
in the reference's order (``_batch_top_n_twophase_pallas`` run in
interpret mode).  The kernel itself is held against the plain version on
the card by ``chip_smoke.py``."""

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
K_STEP = 16  # columns per wgmma k-step (bf16)
RTOL = 1e-4  # chip_smoke.RTOL["bfloat16"], also its absolute floor


def tensor_core_block_max(Qc: torch.Tensor, Y: torch.Tensor,
                          penalty: torch.Tensor, buckets=None, target=None,
                          max_bits: int = 0, seed: int = 0) -> torch.Tensor:
    """(B, N // 128) float32 block maxima of ``Qc @ Yᵀ + penalty`` (and
    the LSH mask), each dot product summed as the tensor cores sum it:
    per 16-column k-step, the exact bf16 x bf16 products added in float32
    in a shuffled order, then the k-step's sum added to the running sum,
    k-steps in column order."""
    rng = np.random.default_rng(seed)
    q = Qc.to(torch.float32).numpy()
    y = Y.to(torch.float32).numpy()
    b, width = q.shape
    acc = np.zeros((b, y.shape[0]), np.float32)
    for k0 in range(0, width, K_STEP):
        prods = q[:, None, k0:k0 + K_STEP] * y[None, :, k0:k0 + K_STEP]
        order = rng.permutation(K_STEP)
        part = prods[:, :, order[0]]
        for c in order[1:]:
            part = part + prods[:, :, c]
        acc = acc + part
    s = acc + penalty.reshape(-1).numpy()[None, :]
    if buckets is not None:
        x = (buckets.numpy()[None, :] ^ target.numpy()[:, None]).view(
            np.uint32)
        s = np.where(np.bitwise_count(x) <= max_bits, s, -np.inf)
    return torch.from_numpy(s.reshape(b, -1, BS).max(-1))


def _inputs(f, b, lsh, seed):
    """The bf16 inputs of ``test_torch_phase_a.py`` at this seed."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, f)).astype(np.float32)
    q = rng.standard_normal((b, f)).astype(np.float32)
    act = np.ones(N, bool)
    act[::5] = False
    y[~act] = 0.0
    y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
    hp = buckets = None
    max_bits = 0
    if lsh:
        h = jlsh.LocalitySensitiveHash(0.3, f)
        hp, max_bits = h.hyperplanes, h.max_bits_differing
        buckets = np.array(h.device_buckets(jnp.asarray(y)))
        assert (np.abs(q @ hp.T) > 1e-4).all()
    return y, q, act, hp, buckets, max_bits


def _jax_top_n(y, q, act, hp, buckets, max_bits):
    penalty = jsm._penalty_kernel(jnp.asarray(act), BS)
    old_tile = jsm._PA_TILE
    jsm._PA_TILE = 2048
    try:
        out = jsm._batch_top_n_twophase_pallas(
            jnp.asarray(y, jnp.bfloat16), jnp.asarray(q), penalty,
            jnp.asarray(act),
            None if buckets is None else jnp.asarray(buckets),
            None if hp is None else jnp.asarray(hp), K, BS, KSEL, max_bits,
            interpret=True)
    finally:
        jsm._PA_TILE = old_tile
    return [np.asarray(a) for a in jax.device_get(out)]


def _port_operands(y, q, act, hp, buckets):
    f = y.shape[1]
    Y = torch.zeros((N, device_width(f)), dtype=torch.bfloat16)
    Y[:, :f] = torch.from_numpy(y)
    active = torch.from_numpy(act)
    Q = torch.from_numpy(q)
    bkt = None if buckets is None else torch.from_numpy(buckets)
    hpt = None if hp is None else torch.from_numpy(hp)
    return Y, Q, active, tsm._penalty_kernel(active, BS), bkt, hpt


@pytest.mark.parametrize("f", [16, 50, 250], ids=["w32", "w64", "w256"])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_tensor_core_order_within_tolerance(f, b, lsh):
    y, q, act, hp, buckets, max_bits = _inputs(f, b, lsh, seed=f * 100 + b)
    Y, Q, active, pen, bkt, hpt = _port_operands(y, q, act, hp, buckets)
    Qc = tsm._q_cast(Q, Y).contiguous()
    tgt = tsm._query_buckets(Q, hpt) if lsh else None
    got = tensor_core_block_max(Qc, Y, pen, bkt, tgt, max_bits, seed=f + b)
    want = pa.phase_a_reference(Qc, Y, pen, bkt, tgt, max_bits)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    assert bool((diff <= RTOL * want[fin].abs() + RTOL).all()), \
        float(diff.max())
    # the order changes the sums: the emulation is not the plain version
    if f > K_STEP:
        assert bool((diff > 0).any())


@pytest.mark.parametrize("f", [16, 50, 250], ids=["w32", "w64", "w256"])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_certified_rows_match_reference_in_tensor_core_order(
        f, b, lsh, monkeypatch):
    args = _inputs(f, b, lsh, seed=f * 100 + b)
    y, q, act, hp, buckets, max_bits = args
    ts_j, ti_j, _ = _jax_top_n(*args)
    Y, Q, active, pen, bkt, hpt = _port_operands(y, q, act, hp, buckets)
    calls = []

    def tc_phase_a(Qc, Yd, penalty, buckets=None, target=None, max_bits=0,
                   bs=BS):
        calls.append(Qc.shape)
        return tensor_core_block_max(Qc, Yd, penalty, buckets, target,
                                     max_bits, seed=f + b)

    monkeypatch.setattr(tsm, "phase_a", tc_phase_a)
    ts_t, ti_t, cert_t = [a.numpy() for a in tsm._batch_top_n_twophase_cuda(
        Y, Q, pen, active, bkt, hpt, K, BS, KSEL, max_bits)]
    assert calls == [(b, Y.shape[1])]
    rows = np.flatnonzero(cert_t)
    assert rows.size > 0
    np.testing.assert_array_equal(ti_t[rows], ti_j[rows])
    fin = np.isfinite(ts_j[rows])
    np.testing.assert_array_equal(np.isfinite(ts_t[rows]), fin)
    np.testing.assert_allclose(ts_t[rows][fin], ts_j[rows][fin], rtol=RTOL)
