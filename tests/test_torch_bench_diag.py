"""The port's probe counterparts (``oryx_tpu_torch/bench/diag/``) against
the reference's Pallas probes (``docs/bench_diag/``), which run here in
interpret mode: ``variant_a`` (kernel 5), ``variant_b`` (kernel 6),
``variant_exact`` (kernel 7) and ``smallf_probe.phase_a`` (kernel 8) on
the same seeded inputs, cast to bf16 on both sides.  On the CPU the port's
wrappers (``phase_a``, ``phase_a_qm``) run their plain version; the
kernels themselves are held against it on the card by ``chip_smoke.py``.
The reference's (N / 128, B) maxima are transposed against the port's
(B, N / 128): -inf in the same places, finite values within rtol 1e-5,
atol 1e-4."""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oryx_tpu_torch.bench.diag import lsh_mask_probe as tlp
from oryx_tpu_torch.bench.diag import smallf_probe as tsp
from oryx_tpu_torch.ops import phase_a as pa
from oryx_tpu_torch.ops import phase_a_qm as qm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, B, BS, MB = 8192, 128, 8, 128, 1


def _load(name, monkeypatch):
    """The reference probe module, its pallas_call in interpret mode for
    this test only."""
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "docs", "bench_diag",
                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, width=W):
    """Rows and queries cast to bf16; every 11th row and block 3 retired
    (-inf penalty), so -inf maxima appear; buckets 0-127."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, width)).astype(np.float32)
    q = rng.standard_normal((B, width)).astype(np.float32)
    pen = np.zeros((N // BS, BS), np.float32)
    pen.reshape(-1)[::11] = -np.inf
    pen[3] = -np.inf
    bkt = rng.integers(0, 128, (N // BS, BS)).astype(np.int32)
    tgt = rng.integers(0, 128, (1, B)).astype(np.int32)
    return y, q, pen, bkt, tgt


def _jax(y, q, pen, bkt=None, tgt=None):
    out = [jnp.asarray(y).astype(jnp.bfloat16),
           jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(pen)]
    if bkt is not None:
        out += [jnp.asarray(bkt), jnp.asarray(tgt)]
    return out


def _torch(y, q, pen, bkt=None, tgt=None):
    out = [torch.from_numpy(y).to(torch.bfloat16),
           torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(pen)]
    if bkt is not None:
        out += [torch.from_numpy(bkt), torch.from_numpy(tgt)]
    return out


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32).T
    got = got.numpy()
    assert got.shape == want.shape
    assert (np.isfinite(got) == np.isfinite(want)).all()
    assert not np.isnan(got).any()
    assert (~np.isfinite(want)).any()  # the -inf path is exercised
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_lsh_variants_match_the_reference(monkeypatch, seed):
    ref = _load("lsh_mask_probe", monkeypatch)
    y, q, pen, bkt, tgt = _inputs(seed)
    before = (pa.LAUNCHES, qm.LAUNCHES)
    a = tlp.variant_a(*_torch(y, q, pen, bkt, tgt), MB)
    b = tlp.variant_b(*_torch(y, q, pen, bkt, tgt), MB)
    _same(a, ref.variant_a(*_jax(y, q, pen, bkt, tgt), mb=MB))
    _same(b, ref.variant_b(*_jax(y, q, pen, bkt, tgt), mb=MB))
    # the port's gate: the two LSH variants agree
    tlp.check_agree(b, a)
    assert (pa.LAUNCHES, qm.LAUNCHES) == before  # plain version: no launch


def test_exact_variant_matches_the_reference(monkeypatch):
    ref = _load("lsh_mask_probe", monkeypatch)
    y, q, pen, _, _ = _inputs(2)
    _same(tlp.variant_exact(*_torch(y, q, pen)),
          ref.variant_exact(*_jax(y, q, pen)))


@pytest.mark.parametrize("features", [50, 250])
def test_smallf_phase_a_matches_the_reference(monkeypatch, features):
    ref = _load("smallf_probe", monkeypatch)
    y, q, pen, _, _ = _inputs(3, features)
    want = ref.phase_a(*_jax(y, q, pen), T=4096, bs=BS)
    Y, Q, P = _torch(y, q, pen)
    got = tsp.phase_a(tsp.stored(Y), tsp.stored(Q), P)
    _same(got, want)


def test_check_agree_gate():
    a = torch.tensor([[1.0, float("-inf"), 3.0]])
    assert tlp.check_agree(a, a.clone()) == 0.0
    with pytest.raises(AssertionError, match="-inf"):
        tlp.check_agree(a, torch.tensor([[1.0, 2.0, 3.0]]))
    with pytest.raises(AssertionError, match="largest difference"):
        tlp.check_agree(a, torch.tensor([[1.0, float("-inf"), 3.1]]))


def test_probes_run_on_the_cpu_at_a_toy_size():
    lines = tlp.run(items_m=N / 1e6, batch=B, device="cpu")
    assert [r["variant"] for r in lines] == \
        ["exact_floor", "mask_3d_current", "mask_2d_transposed"]
    assert [r["kernel"] for r in lines] == ["phase_a", "phase_a",
                                           "phase_a_qm"]
    for r in lines:
        assert r["rows"] == N and r["bound_ms"] is None  # no card, no bound
        assert r["exec_ms"] > 0 and r["plain_ms"] > 0
        assert r["library_ms"] > 0
        assert r["ops"] == 2.0 * N * W * B
    out = tsp.run(items=2 * tsp.ROW_ALIGN / 1e6, f=(50,), batch=B,
                  device="cpu")
    rec = out["results"]["F50"]
    assert rec["stored_width"] == 64 and "plan" not in rec
    assert rec["phase_a"]["gbps_stored"] > rec["phase_a"]["gbps_logical"]
    assert rec["phase_a"]["bound_ms"] is None
    assert rec["phase_a"]["bound_ms_logical"] is None
    assert rec["full_twophase"]["exec_ms"] > 0


def test_qm_wrapper_takes_the_plain_version_only_on_the_cpu():
    y, q, pen, bkt, tgt = _inputs(4)
    Y, Q, P, Bk, T = _torch(y, q, pen, bkt, tgt)
    before = qm.LAUNCHES
    got = qm.phase_a_qm(Q, Y, P, Bk.reshape(-1), T.reshape(-1), MB)
    want = pa.phase_a_reference(Q, Y, P, Bk.reshape(-1), T.reshape(-1), MB)
    assert torch.equal(got, want) and qm.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        qm.phase_a_qm(torch.zeros((8, 32), device="meta"),
                      torch.zeros((256, 32), device="meta"),
                      torch.zeros((2, 128), device="meta"))


class _OnCard:
    """The attributes the wrapper reads before it builds the kernel, of
    a tensor on the card (this CPU build cannot make one)."""

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("y_shape,dtype,q_shape,bs,match", [
    ((256, 32), torch.float32, (8, 32), 128, "bfloat16"),
    ((200, 32), torch.bfloat16, (8, 32), 128, "N % 128"),
    ((256, 40), torch.bfloat16, (8, 40), 128, "F % 32"),
    ((256, 288), torch.bfloat16, (8, 288), 128, "F <= 256"),
    ((256, 32), torch.bfloat16, (0, 32), 128, "B > 0"),
    ((256, 32), torch.bfloat16, (8, 32), 64, "bs == 128"),
])
def test_qm_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch, y_shape, dtype, q_shape, bs, match):
    monkeypatch.setattr(qm, "build", lambda: pytest.fail("built"))
    before = qm.LAUNCHES
    with pytest.raises(ValueError, match=match):
        qm.phase_a_qm(_OnCard(q_shape), _OnCard(y_shape, dtype), None,
                      bs=bs)
    assert qm.LAUNCHES == before
