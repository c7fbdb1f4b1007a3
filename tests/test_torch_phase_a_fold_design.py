"""What the redesigned folded phase-A kernel (``csrc/phase_a_fold.cu``)
rests on, checked on the CPU:

- the zero-lane cut: the kernel multiplies only the first ``features``
  columns of each logical row.  The plain version over those columns
  equals it over all ``w`` columns bit for bit, on stores and queries
  with -0.0 entries and exactly zero query rows; and a column-ordered
  float32 sum from +0, the kernel's, plus the penalty is bit-equal with
  and without the zero lanes;
- the wrapper contract: a ``features`` argument <= 0 or above w raises on
  every device, the CPU included;
- the serving model hands the kernel its feature count.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version (max abs error 0 in float32)."""

import numpy as np
import pytest
import torch

from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.convert import serving_model_from_arrays
from oryx_tpu_torch.ops import phase_a_fold as pf

BS = 128


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _store(rng, n, f, w, fold, dtype):
    """The folded mirror of an n-row store of f features padded to w
    columns per slot (fold slots per physical row), some feature values
    -0.0, and its slot-major penalty: every 7th row and one block
    retired."""
    vecs = torch.zeros((n, w * fold))
    vals = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    vals[torch.from_numpy(rng.random((n, f)) < 0.05)] = -0.0
    vecs[:, :f] = vals
    live = torch.ones(n, dtype=torch.bool)
    live[::7] = False
    live[BS * 3:BS * 4] = False
    vecs = vecs.to(dtype)
    yf, pen_f = tsm._fold_items_kernel(vecs, live, fold, BS)
    return yf, pen_f


def _queries(rng, b, f, width, dtype):
    """(b, width) queries of f features: some entries -0.0, the padding
    lanes -0.0 in every other row, and the last two rows exactly zero."""
    q = torch.zeros((b, width))
    q[:, :f] = torch.from_numpy(rng.standard_normal((b, f))
                                .astype(np.float32))
    q[:, :f][torch.from_numpy(rng.random((b, f)) < 0.05)] = -0.0
    q[::2, f:] = -0.0
    q[-2:] = 0.0
    return q.to(dtype).contiguous()


def _cut(yf, qc, fold, w, f):
    """The mirror and query narrowed to the first f columns of each
    slot: the operands of the kernel's shortened products."""
    cols = torch.cat([torch.arange(j * w, j * w + f) for j in range(fold)])
    return yf[:, cols].contiguous(), qc[:, cols].contiguous()


@pytest.mark.parametrize("fold,f", [(2, 10), (2, 13), (4, 5), (4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_zero_lanes_leave_plain_maxima_bit_equal(fold, f, dtype, lsh):
    rng = np.random.default_rng(fold * 100 + f + 7 * lsh)
    n, w = 8192, 32 // fold
    yf, pen_f = _store(rng, n, f, w, fold, dtype)
    qc = _queries(rng, 16, f, 32, dtype)
    bkt_f = target = None
    if lsh:
        buckets = torch.from_numpy(rng.integers(0, 1 << 8, n)
                                   .astype(np.int32))
        bkt_f = tsm._fold_buckets_kernel(buckets, fold, BS)
        target = torch.from_numpy(rng.integers(0, 1 << 8, 16)
                                  .astype(np.int32))
    full = pf.phase_a_fold_reference(qc, yf, pen_f, bkt_f, target, 3, fold)
    yc, qcc = _cut(yf, qc, fold, w, f)
    cut = pf.phase_a_fold_reference(qcc, yc, pen_f, bkt_f, target, 3, fold)
    assert torch.equal(_bits(full), _bits(cut))
    assert torch.isneginf(full[:, 3]).all()  # the retired block
    assert not torch.isnan(full).any()
    fin = torch.isfinite(full[-2:])
    assert (full[-2:][fin] == 0).all() and fin.any()  # zero queries


def test_column_ordered_sums_ignore_zero_lanes():
    """The kernel's arithmetic, one column at a time in float32 (fmaf in
    the kernel; here a product and a sum, each rounded, which cannot
    differ in the argument): a dot product over `features` columns equals
    the one over every column bit for bit when the rest are +0 or -0,
    including sums that cancel to zero."""
    rng = np.random.default_rng(11)
    n, f, w = 4096, 10, 16
    y = torch.zeros((n, w))
    q = torch.zeros(w)
    y[:, :f] = torch.from_numpy(rng.standard_normal((n, f))
                                .astype(np.float32))
    q[:f] = torch.from_numpy(rng.standard_normal(f).astype(np.float32))
    y[::3, f:] = -0.0
    q[f + 1::2] = -0.0
    y[:64, :f] = 0.0
    y[:32, :f] = -0.0  # products -0.0 into a +0 sum
    y[64:96, 0] = 1.0
    y[64:96, 1] = -1.0  # an exact cancellation
    q[0] = q[1] = 2.0
    pen = torch.where(torch.arange(n) % 5 == 0, float("-inf"), 0.0)

    def ordered(cols):
        acc = torch.zeros(n)
        for c in range(cols):
            acc = acc + y[:, c] * q[c]
        return acc

    assert torch.equal(_bits(ordered(f)), _bits(ordered(w)))
    assert torch.equal(_bits(ordered(f)), _bits(ordered(12)))
    assert torch.equal(_bits(ordered(f) + pen), _bits(ordered(w) + pen))
    zeros = ordered(f)[:96]
    zeros = zeros[zeros == 0]
    assert zeros.numel() and not torch.signbit(zeros).any()  # never -0.0


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("features", [0, -1, 17])
def test_features_out_of_range_raise_on_every_device(device, features):
    qc = torch.zeros((8, 32), device=device)
    yf = torch.zeros((128, 32), device=device)
    pen_f = torch.zeros((2, 2, 64), device=device)
    with pytest.raises(ValueError, match="features must be in 1..16"):
        pf.phase_a_fold(qc, yf, pen_f, fold=2, features=features)


@pytest.mark.parametrize("features", [None, 1, 10, 16])
def test_features_in_range_take_the_plain_version_on_cpu(features):
    rng = np.random.default_rng(3)
    yf, pen_f = _store(rng, 1024, 10, 16, 2, torch.float32)
    qc = _queries(rng, 8, 10, 32, torch.float32)
    before = pf.LAUNCHES
    got = pf.phase_a_fold(qc, yf, pen_f, fold=2, features=features)
    assert pf.LAUNCHES == before
    assert torch.equal(got, pf.phase_a_fold_reference(qc, yf, pen_f,
                                                      fold=2))


def test_serving_model_hands_the_kernel_its_feature_count(monkeypatch):
    for name, value in (("_FLAT_SCORES_LIMIT", 1), ("_MAX_CHUNK_ROWS", 1024),
                        ("_BLOCK_ROWS", 128), ("_BLOCK_KSEL", 8),
                        ("_PA_TILE", 2048)):
        monkeypatch.setattr(tsm, name, value)
    seen = []
    real = tsm.phase_a_fold

    def spy(*args, **kwargs):
        seen.append(kwargs.get("features"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tsm, "phase_a_fold", spy)
    rng = np.random.default_rng(5)
    f = 10
    Y = rng.standard_normal((4096, f)).astype(np.float32)
    X = rng.standard_normal((4, f)).astype(np.float32)
    model = serving_model_from_arrays(
        f, True, x_ids=[f"u{u}" for u in range(4)], X=X,
        y_ids=[f"i{j}" for j in range(4096)], Y=Y, known_items={},
        device="cpu", int8_selection="false")
    vecs, _ = model.Y.device_arrays()
    assert model._phase_a_kinds(int(vecs.shape[0]), int(vecs.shape[1]),
                                128)[0][0] == "fold"
    got = model.top_n_batch(5, X)
    assert seen and all(s == f for s in seen)
    want = np.argsort(-(X @ Y.T), axis=1, kind="stable")[:, :5]
    assert [[int(i[1:]) for i, _ in row] for row in got] == want.tolist()
