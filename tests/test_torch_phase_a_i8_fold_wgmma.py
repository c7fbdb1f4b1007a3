"""The folded int8 phase A as the tensor-core kernel
(``csrc/phase_a_i8_fold.cu``) computes it, emulated in plain PyTorch and
numpy, in both of its orientations (``query_tiles``): the slot copies of
the query tile as the consumers write them (16-byte chunks of a 32-byte
row); products of each 128-row stage of 32-byte physical rows with the
slot copies, as two warpgroups of 64 rows against the slot-major
slot-query columns (small windows) or as four warpgroups of 64 queries,
one product per slot (larger ones); the slot-major penalty and buckets of
the stage; the maxima each thread keeps, the butterflies over lanes, the
cross-warp maxima and the lanes that write.  The emulation is held bit
for bit against the plain version, ``phase_a_i8`` on the unfolded mirror
and the reference's Pallas kernel (``_batch_top_n_twophase_pallas_i8_fold``,
interpret mode).

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version and against ``phase_a_i8`` bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als.lsh import _popcount
from oryx_tpu_torch.ops import phase_a_fold as pf
from oryx_tpu_torch.ops import phase_a_i8 as pi8
from oryx_tpu_torch.ops import phase_a_i8_fold as pi8f

BS = 128
# 63 blocks: the last ring stage of 128 physical rows is partial at both
# folds (64 of 128 rows at fold 2, 96 at fold 4)
N = 63 * BS
W = pi8f.PHYS_WIDTH
INT32_MIN = np.iinfo(np.int32).min
UNSET = np.iinfo(np.int64).min
# static arguments no other test traces the reference kernel with, so the
# patched trace below is this file's own
K_MAXIMA, KSEL_MAXIMA = 40, 5
# persistent thread blocks of the emulated grid
GRID = 3


def _inputs(fold, b, lsh, max_bits, seed):
    """int8 rows of w = 32 / fold features (zeros past them), half of them
    from {-1, 0, 1} so block maxima tie; integer queries whose largest
    magnitude is 127 (query scale exactly 1, q8 equal to the query), the
    last one zero; retired rows and a fully retired block; 6-bit LSH
    buckets."""
    rng = np.random.default_rng(seed)
    w = W // fold
    y8 = np.zeros((N, W), np.int8)
    y8[:, :w] = rng.integers(-127, 128, (N, w))
    y8[::2, :w] = rng.integers(-1, 2, (N // 2, w))
    q = np.zeros((b, W), np.float32)
    q[:, :w] = rng.integers(-127, 128, (b, w))
    q[:, 0] = 127.0
    q[-1] = 0.0
    act = rng.random(N) > 0.2
    act[BS * 5:BS * 6] = False
    hp = buckets = None
    if lsh:
        hp = np.zeros((6, W), np.float32)
        hp[:, :w] = rng.standard_normal((6, w))
        assert (np.abs(q[:-1] @ hp.T) > 1e-3).all()
        buckets = rng.integers(0, 1 << 6, N).astype(np.int32)
    return y8, q, act, hp, buckets, max_bits


def _port_operands(fold, y8, q, act, hp, buckets, max_bits):
    """(q8, Y8f, pen_i_f, bkt_f, target) as the serving model makes them."""
    y8f, pen_f = tsm._fold_items_i8_kernel(torch.from_numpy(y8),
                                           torch.from_numpy(act), fold, BS)
    bkt_f = target = None
    if buckets is not None:
        bkt_f = tsm._fold_buckets_kernel(torch.from_numpy(buckets), fold, BS)
        target = tsm._query_buckets(torch.from_numpy(q), torch.from_numpy(hp))
    return torch.from_numpy(q.astype(np.int8)), y8f, pen_f, bkt_f, target


def _slot_rows(q8, q0, j, fold, rows=256):
    """Slot j's copy of ``rows`` queries from q0, as the consumers write
    it: two 16-byte chunks per row, both zero past B; at fold 2 chunk j
    holds the query's first 16 bytes, at fold 4 half j % 2 of chunk j // 2
    its first 8.  (The 32-byte swizzle places chunk c of row r at c ^ (r /
    4 % 2); the tensor cores read it back in this order.)"""
    out = np.zeros((rows, 2, 16), np.int64)
    for r in range(rows):
        if q0 + r < q8.shape[0]:
            if fold == 2:
                out[r, j] = q8[q0 + r, :16]
            else:
                out[r, j // 2, 8 * (j % 2):8 * (j % 2) + 8] = q8[q0 + r, :8]
    return out.reshape(rows, W)


def _bfly(v, base, mask):
    """hopper.cuh's bfly over the lanes that differ in bit ``mask``: ``v``
    is (..., lanes, CNT), ``base`` (lanes,)."""
    lanes = np.arange(v.shape[-2])
    partner = lanes ^ mask
    hi = (lanes & mask) != 0
    cnt = v.shape[-1]
    if cnt >= 2:
        h = cnt // 2
        hi_ = hi[:, None]
        send = np.where(hi_, v[..., :h], v[..., h:])
        keep = np.where(hi_, v[..., h:], v[..., :h])
        return (np.maximum(keep, send[..., partner, :]),
                base + np.where(hi, h, 0))
    return np.maximum(v, v[..., partner, :]), base


def _stage(y8f, pen, bkt, unit, fold, rng):
    """A ring stage: the unit's 128 physical rows (rows past the mirror
    zero-filled) and per slot their penalty and buckets (stale past it)."""
    n_phys = y8f.shape[0]
    r0 = unit * 128
    rows = min(128, n_phys - r0)
    st = np.zeros((128, W), np.int64)
    st[:rows] = y8f[r0:r0 + rows]
    sp = rng.integers(-5, 5, (fold, 128))
    sp[:, :rows] = pen[:, r0:r0 + rows]
    sb = rng.integers(0, 64, (fold, 128))
    if bkt is not None:
        sb[:, :rows] = bkt[:, r0:r0 + rows]
    return st, sp, sb


def _scores(acc, pen, bkt, tq, max_bits):
    """Accumulator values plus their row's penalty, or the penalty alone
    for a row outside the query's ball (``tq`` None: the exact body)."""
    s = acc + pen
    if tq is None:
        return s
    far = _popcount(torch.from_numpy(bkt ^ tq)).numpy()
    return np.where(far > max_bits, pi8.I8_PENALTY, s)


def _emulate_rows(q8, tgt, max_bits, fold, q0, qn, units, stage, write):
    """phase_a_i8_fold_tc: two warpgroups of 64 rows against fold * qn
    slot-major columns; a thread (warp, lane) holds rows 16 (warp % 4) +
    lane / 4 + 8i and columns 8n + 2t + c, slot (8n + 2t + c) // qn of
    query column 8 (n % (qn / 8)) + 2t + c."""
    b = q8.shape[0]
    cols = np.concatenate([_slot_rows(q8, q0, j, fold, qn)
                           for j in range(fold)])  # (fold * qn, W)
    lanes = np.arange(32)
    # a lane's query columns 8m + 2t + c, as k = 2m + c
    qq = (8 * (np.arange(qn // 4) // 2)[None, :] + 2 * (lanes % 4)[:, None]
          + (np.arange(qn // 4) % 2)[None, :])  # (lane, k)
    tq = None
    if tgt is not None:
        tq = np.where(q0 + qq < b, tgt[np.minimum(q0 + qq, b - 1)], 0)
    for unit in units:
        st, sp, sb = stage(unit)
        red = np.full((8, qn), UNSET, np.int64)
        for wg in range(2):
            acc = st[64 * wg:64 * wg + 64] @ cols.T  # (64 rows, fold * qn)
            for w4 in range(4):
                v = np.full((32, qn // 4), INT32_MIN, np.int64)
                for j in range(fold):
                    for i in range(2):
                        r = 16 * w4 + lanes // 4 + 8 * i  # (lane,)
                        a = acc[r[:, None], j * qn + qq]
                        s = _scores(a, sp[j, 64 * wg + r][:, None],
                                    sb[j, 64 * wg + r][:, None], tq,
                                    max_bits)
                        v = np.maximum(v, s)
                base = np.zeros(32, np.int64)
                for mask in (16, 8, 4):
                    v, base = _bfly(v, base, mask)
                for lane in range(32):
                    for k in range(v.shape[1]):
                        cc = base[lane] + k
                        red[4 * wg + w4, 8 * (cc // 2) + 2 * (lane % 4)
                            + cc % 2] = v[lane, k]
        assert (red != UNSET).all()  # every warp wrote every column
        for blk_in in range(fold):  # warps of a block: 8 / fold
            mx = red[blk_in * 8 // fold:(blk_in + 1) * 8 // fold].max(0)
            for x in range(qn):
                write(q0 + x, unit * fold + blk_in, mx[x])


def _emulate_queries(q8, tgt, max_bits, fold, q0, groups, units, stage,
                     write):
    """phase_a_i8_fold_tq: warpgroup wg multiplies m-tile wg % groups of
    64 queries and takes every (4 / groups)-th stage of its thread block;
    per slot one product with the stage's 128 physical rows."""
    b = q8.shape[0]
    slots = [_slot_rows(q8, q0, j, fold) for j in range(fold)]
    step = 4 // groups
    for wg in range(4):
        qg = wg % groups
        for unit in units[wg // groups::step]:
            st, sp, sb = stage(unit)
            # lanes t of each of the 64 query rows: maxima per
            # (block of the stage, column parity)
            m = np.full((64, 4, fold, 2), INT32_MIN, np.int64)
            qrows = q0 + 64 * qg + np.arange(64)
            tq = None if tgt is None else np.array(
                [tgt[q] if q < b else 0 for q in qrows])[:, None]
            for j in range(fold):
                acc = slots[j][64 * qg:64 * qg + 64] @ st.T
                s = _scores(acc, sp[j], sb[j][None, :], tq, max_bits)
                # column 8n + 2t + c: physical row of the stage, in block
                # n // (16 / fold) of it
                s = s.reshape(64, 16, 4, 2)
                for n in range(16):
                    blk = n // (16 // fold)
                    m[:, :, blk, :] = np.maximum(m[:, :, blk, :], s[:, n])
            v = m.max(-1)  # (64 query rows, 4 lanes, fold)
            base = np.zeros(4, np.int64)
            v, base = _bfly(v, base, 2)
            v, base = _bfly(v, base, 1)
            for t in range(4):
                if fold == 2 and t % 2:
                    continue
                for r, q in enumerate(qrows):
                    write(q, unit * fold + base[t], v[r, t, 0])


def emulate(q8, y8f, pen_f, bkt_f, target, max_bits, fold):
    """The kernel's block maxima, computed the kernel's way on a grid of
    GRID persistent thread blocks (block g takes units g, g + GRID, ...);
    every output is written exactly once."""
    q8 = q8.numpy().astype(np.int64)
    y8f = y8f.numpy().astype(np.int64)
    pen = pen_f.numpy().reshape(fold, -1).astype(np.int64)
    bkt = None if bkt_f is None else bkt_f.numpy().reshape(fold, -1)
    tgt = None if target is None else target.numpy()
    b = q8.shape[0]
    n_blocks = y8f.shape[0] * fold // BS
    n_units = -(-y8f.shape[0] // 128)
    out = np.zeros((b, n_blocks), np.int64)
    writes = np.zeros((b, n_blocks), np.int64)
    rng = np.random.default_rng(0)

    def stage(unit):
        return _stage(y8f, pen, bkt, unit, fold, rng)

    def write(q, blk, value):
        if q < b and blk < n_blocks:
            out[q, blk] = value
            writes[q, blk] += 1

    for q0, nq, orient, size in pi8f.query_tiles(fold, b):
        for g in range(GRID):
            units = list(range(g, n_units, GRID))
            if orient == "rows":
                _emulate_rows(q8, tgt, max_bits, fold, q0, size, units,
                              stage, write)
            else:
                _emulate_queries(q8, tgt, max_bits, fold, q0, size, units,
                                 stage, write)
    assert (writes == 1).all()
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("fold", [2, 4])
def test_written_slot_copies_are_the_reference_slot_queries(fold):
    """The consumers' chunks make the reference's slot-shifted copies
    (``q8s``), and read only the first w bytes of a query row."""
    rng = np.random.default_rng(fold)
    q8 = rng.integers(-127, 128, (300, W)).astype(np.int8)
    w = W // fold
    masked = q8.copy()
    masked[:, w:] = 0
    want = pf.slot_queries(torch.from_numpy(masked), fold).numpy()
    for b in (8, 300):
        for q0, nq, orient, size in pi8f.query_tiles(fold, b):
            rows = size if orient == "rows" else 256
            for j in range(fold):
                got = _slot_rows(q8[:b].astype(np.int64), q0, j, fold, rows)
                np.testing.assert_array_equal(got[:nq], want[j, q0:q0 + nq])
                assert not got[nq:].any()  # queries past B


@pytest.mark.parametrize("fold", [2, 4])
@pytest.mark.parametrize("lsh", [False, True], ids=["exact", "lsh"])
def test_plan_and_query_tiles(fold, lsh):
    flag = "true" if lsh else "false"
    stage = 128 * W + fold * 128 * 4 * (2 if lsh else 1)
    for b in (1, 8, 16, 17, 32, 33, 64, 65, 128, 129, 192, 255, 256, 257,
              300, 600):
        tiles = pi8f.query_tiles(fold, b)
        assert [t[0] for t in tiles] == list(range(0, b, 256))
        assert sum(t[1] for t in tiles) == b
        for _, nq, orient, size in tiles:
            assert 0 < nq <= 256
            qn = next(x for x in (8, 16, 32, 64, 128, 256) if x >= nq)
            # the rows are the M side while fold * QN fits 64 columns
            assert orient == ("rows" if fold * qn <= 64 else "queries")
            if orient == "rows":
                assert size == qn
            else:  # enough m-tiles of 64, and no more than needed
                assert size in (1, 2, 4)
                assert 64 * size >= nq > 64 * (size // 2) or size == 1
        design = pi8f.plan(fold, b, lsh)
        assert design["tiles"] == len(tiles)
        _, _, orient, size = tiles[0]
        if orient == "rows":
            assert design["variant"] == \
                f"phase_a_i8_fold_tc<{fold}, {size}, {flag}>"
            assert design["tile"] == size
            # two thread blocks share an SM: as many stages as fit half
            budget = 232448 // 2 - 1024
            fixed = 1024 + fold * size * W + 2 * 8 * size * 4
        else:
            assert design["variant"] == f"phase_a_i8_fold_tq<{fold}, {flag}>"
            assert design["tile"] == 64 * size
            budget = 232448
            fixed = 1024 + fold * 256 * W
        stages = design["stages"]
        assert design["smem_bytes"] == fixed + stages * (stage + 16) \
            <= budget
        assert stages == 24 or fixed + (stages + 1) * (stage + 16) > budget
    # the served windows of the 10-feature model (fold 2) and fold 4's
    assert pi8f.plan(2, 8)["variant"] == "phase_a_i8_fold_tc<2, 8, false>"
    assert pi8f.plan(2, 32)["variant"] == "phase_a_i8_fold_tc<2, 32, false>"
    assert pi8f.plan(2, 256)["variant"] == "phase_a_i8_fold_tq<2, false>"
    assert pi8f.plan(4, 16)["variant"] == "phase_a_i8_fold_tc<4, 16, false>"
    assert pi8f.plan(4, 17)["variant"] == "phase_a_i8_fold_tq<4, false>"
    with pytest.raises(ValueError):
        pi8f.plan(fold, 0)
    with pytest.raises(ValueError):
        pi8f.plan(1, 8)


@pytest.mark.parametrize("fold", [2, 4])
@pytest.mark.parametrize("b", [1, 8, 16, 32, 64, 65, 300])
@pytest.mark.parametrize("lsh,max_bits", [(False, 0), (True, 0), (True, 2)],
                         ids=["exact", "lsh0", "lsh2"])
def test_emulation_equals_plain_and_unfolded(fold, b, lsh, max_bits):
    args = _inputs(fold, b, lsh, max_bits, seed=100 * fold + b + max_bits)
    ops = _port_operands(fold, *args)
    got = emulate(*ops, max_bits, fold)
    want = pi8f.phase_a_i8_fold_reference(*ops, max_bits, fold)
    assert torch.equal(got, want)
    y8, q, act, hp, buckets = args[:5]
    unfolded = pi8.phase_a_i8_reference(
        ops[0], torch.from_numpy(y8),
        tsm._penalty_kernel_i32(torch.from_numpy(act), BS),
        None if buckets is None else torch.from_numpy(buckets), ops[4],
        max_bits)
    assert torch.equal(got, unfolded)
    # the zero query: 0 where a row is live (in the ball), else the penalty
    assert bool(((got[-1] == 0) | (got[-1] <= pi8.I8_PENALTY // 2)).all())
    assert bool((got[:, 5] <= pi8.I8_PENALTY // 2).all())  # retired block
    if lsh and max_bits == 0:  # rows outside the balls change maxima
        assert not torch.equal(got, emulate(*ops[:3], None, None, 0, fold))


def _pallas_maxima(monkeypatch, fold, y8, q, act, hp, buckets, max_bits):
    """The reference kernel's integer block maxima (B, N / 128), read back
    from the bounds it hands phase B: with item scales 1, item L1 norms 0
    and a query scale of exactly 1 the bound is M + l1(q) / 2 + W / 4,
    exact in float32.  Masked entries come back as -inf."""
    monkeypatch.setattr(jsm, "_PA_TILE", 9 * BS)
    monkeypatch.setattr(
        jsm, "_phase_b",
        lambda Y, Qc, active, buckets, target, bound, *rest: bound)
    y8f, pen_f = jsm._fold_items_i8_kernel(jnp.asarray(y8), jnp.asarray(act),
                                           fold, BS)
    bkt_f = None
    if buckets is not None:
        bkt_f = jsm._fold_buckets_kernel(jnp.asarray(buckets), fold, BS)
    bound = np.asarray(jsm._batch_top_n_twophase_pallas_i8_fold(
        jnp.asarray(y8.astype(np.float32)), y8f,
        jnp.ones(N // BS, jnp.float32), jnp.zeros(N // BS, jnp.float32),
        jnp.asarray(q), pen_f, jnp.asarray(act), bkt_f,
        None if buckets is None else jnp.asarray(buckets),
        None if hp is None else jnp.asarray(hp), K_MAXIMA, BS, KSEL_MAXIMA,
        max_bits, fold, interpret=True), np.float64)
    l1q = np.abs(q).sum(1).astype(np.float64)
    return bound - (0.5 * l1q[:, None] + 0.25 * W)


@pytest.mark.parametrize("fold", [2, 4])
@pytest.mark.parametrize("b", [1, 65, 300])
@pytest.mark.parametrize("lsh,max_bits", [(False, 0), (True, 2)],
                         ids=["exact", "lsh2"])
def test_emulation_equals_pallas_interpret(monkeypatch, fold, b, lsh,
                                           max_bits):
    args = _inputs(fold, b, lsh, max_bits, seed=7 * fold + b + lsh)
    got = emulate(*_port_operands(fold, *args), max_bits, fold).numpy()
    want = _pallas_maxima(monkeypatch, fold, *args)
    assert got.shape == want.shape == (b, N // BS)
    live = got[:-1] > pi8.I8_PENALTY // 2
    # the reference masks retired blocks, rows outside the ball and the
    # zero query to -inf; the kernel keeps I8_PENALTY there
    np.testing.assert_array_equal(np.isfinite(want[:-1]), live)
    np.testing.assert_array_equal(got[:-1][live], want[:-1][live])
    assert np.isneginf(want[-1]).all()


@pytest.mark.parametrize("fold,width", [(2, 64), (4, 64), (2, 128)])
def test_wrapper_refuses_other_physical_widths(fold, width):
    """The kernel takes the 32-byte physical rows every store of the port
    folds to; a wider folded mirror is refused, not served."""
    nf = 2 * BS // fold
    q8 = torch.zeros((8, width), dtype=torch.int8)
    y8f = torch.zeros((nf, width), dtype=torch.int8)
    pen = torch.zeros((fold, 2, BS // fold), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-byte physical rows"):
        pi8f.check_operands(q8, y8f, pen, None, None, fold, BS)
    assert pi8f.check_operands(q8[:, :W].contiguous(),
                               y8f[:, :W].contiguous(), pen, None, None,
                               fold, BS) == W // fold
