"""Kernel 6 (``ops/phase_a_qm``, the queries as the tensor cores' M side)
against the reference's ``variant_b`` of ``docs/bench_diag/lsh_mask_probe.py``
(and its exact body against ``variant_exact``), which run here in
interpret mode, at the shapes the kernel splits on: one and two query
tiles and the 64-query tile edge (B 64, 65, 256, 300), widths 96 (32-column
stages), 128 and 256 (64-column stages).  Every case holds a fully retired
block, a block whose every row fails the ball test, and zero queries.  On
the CPU the port's wrapper runs its plain version and launches nothing;
the kernel itself is held against that plain version on the card by
``chip_smoke.py``.  The reference's (N / 128, B) maxima are transposed
against the port's (B, N / 128): -inf in the same places, no NaN, finite
values within rtol 1e-5 and atol 1e-4 (the two sum the bf16 products in
float32 in other orders), zero queries exactly 0."""

import importlib.util
import os
from functools import partial

import jax  # noqa: F401  (the reference probe runs on JAX's CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oryx_tpu_torch.bench.diag import lsh_mask_probe as tlp
from oryx_tpu_torch.ops import phase_a_qm as qm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BS, MB = 8192, 128, 1
RETIRED, FAILING = 3, 50  # a fully retired block, a block failing the test


def _reference(monkeypatch):
    """The reference probe module, its pallas_call in interpret mode for
    this test only."""
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "_ref_lsh_mask_probe",
        os.path.join(REPO, "docs", "bench_diag", "lsh_mask_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed: int, batch: int, width: int):
    """bf16-exact rows and queries, the last eighth of the queries zero;
    every 11th row and block RETIRED retired; buckets 0-127, block FAILING
    all bucket 0 and every target at least two bits from 0."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, width)).astype(np.float32)
    q = rng.standard_normal((batch, width)).astype(np.float32)
    q[batch - batch // 8:] = 0
    y = torch.from_numpy(y).to(torch.bfloat16).float().numpy()
    q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    pen = np.zeros((N // BS, BS), np.float32)
    pen.reshape(-1)[::11] = -np.inf
    pen[RETIRED] = -np.inf
    bkt = rng.integers(0, 128, (N // BS, BS)).astype(np.int32)
    bkt[FAILING] = 0
    tgt = rng.integers(0, 128, (1, batch)).astype(np.int32)
    near_zero = np.array([bin(int(t)).count("1") <= MB for t in tgt[0]])
    tgt[0, near_zero] |= 0b110
    return y, q, pen, bkt, tgt


@pytest.mark.parametrize("lsh", [True, False], ids=["lsh", "exact"])
@pytest.mark.parametrize("width", [96, 128, 256])
@pytest.mark.parametrize("batch", [64, 65, 256, 300])
def test_phase_a_qm_matches_the_reference(monkeypatch, batch, width, lsh):
    ref = _reference(monkeypatch)
    y, q, pen, bkt, tgt = _inputs(batch * 1000 + width, batch, width)
    jy, jq = (jnp.asarray(a).astype(jnp.bfloat16) for a in (y, q))
    Y, Q = (torch.from_numpy(a).to(torch.bfloat16) for a in (y, q))
    P = torch.from_numpy(pen)
    before = qm.LAUNCHES
    if lsh:
        want = ref.variant_b(jy, jq, jnp.asarray(pen), jnp.asarray(bkt),
                             jnp.asarray(tgt), mb=MB)
        got = tlp.variant_b(Y, Q, P, torch.from_numpy(bkt),
                            torch.from_numpy(tgt), MB)
    else:
        want = ref.variant_exact(jy, jq, jnp.asarray(pen))
        got = qm.phase_a_qm(Q, Y, P)
    assert qm.LAUNCHES == before  # the plain version: no launch
    want = np.asarray(want, np.float32).T
    got = got.numpy()
    assert got.shape == want.shape == (batch, N // BS)
    assert not np.isnan(got).any()
    assert (np.isfinite(got) == np.isfinite(want)).all()
    assert not np.isfinite(got[:, RETIRED]).any()
    # the failing block scores -inf in the LSH body only
    assert np.isfinite(got[:, FAILING]).any() != lsh
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)
    zero = got[batch - batch // 8:]
    assert (zero[np.isfinite(zero)] == 0).all()
    assert np.isfinite(zero).any()


def test_qm_time_holds_and_times_each_case_on_the_cpu():
    from oryx_tpu_torch.bench.diag import qm_time

    lines = []
    before = qm.LAUNCHES
    recs = qm_time.run([(1024, 96), (768, 256)], [8, 65], device="cpu",
                       log=lines.append)
    assert qm.LAUNCHES == before
    assert [(r["rows"], r["width"], r["B"], r["lsh"]) for r in recs] == [
        (rows, width, b, lsh) for rows, width in ((1024, 96), (768, 256))
        for b in (8, 65) for lsh in (False, True)]
    assert all(r["ms"] > 0 and r["max_abs_err"] == 0.0
               and r["bound_ms"] is None for r in recs)
    assert len(lines) == len(recs) + 1 and "compiler_notes" in lines[-1]
