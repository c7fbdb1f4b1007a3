"""Random decision forest trainer: level-synchronous histogram splits
on the card.

Counterpart of ``oryx_tpu/app/rdf/trainer.py`` (reference:
RDFUpdate.java:141-163, which delegates to Spark MLlib's
``RandomForest.trainClassifier/trainRegressor`` with maxBins =
max-split-candidates, impurity gini/entropy/variance, per-tree bootstrap
and "auto" feature subsets: sqrt(P) for classification, P/3 for
regression).  All trees grow together, level by level.  Per level:

* weighted histograms over (tree, slot, predictor, bin, channel): one
  product of the one-hot slot matrix with the one-hot bin x channel
  matrix per chunk of examples, all trees in one matrix.  Classification
  channels (0/1 one-hots, small integer Poisson weights) are exact in
  bfloat16 with float32 accumulation; regression channels (1, y, y^2)
  take full float32 products, TF32 refused;
* the best split of every (tree, slot): cumulative histograms, gains,
  the per-node random feature subset, the first maximum;
* unweighted example counts per (tree, slot), integer sums;
* one host fetch of every output of the level, the host's split/leaf
  decisions and child slot numbering, one upload of them;
* the advance of every example to its child slot: gathers from each
  tree's per-slot split table.

Numeric features are pre-binned once into ``max_split_candidates``
quantile bins (a NumPy copy of the reference's, so bins and thresholds
are bit-identical); categorical features use their encodings as bins
and are split by the ordered-category trick (categories sorted by
class-0 probability or mean target, prefixes scanned).  The bootstrap
is Poisson(1) example weights per tree.  Both random draws come from a
``torch.Generator`` on the card (``_bootstrap_weights``,
``_feature_uniforms``), so a forest trained from a seed differs from the
reference's, which draws from ``jax.random``.

With a ``mesh`` (``parallel/mesh.Mesh``; reference :155, :371, :384,
:485-593) the examples are row-sharded over its entries, padded to a
multiple of the mesh size with rows of weight 0 that settle at once;
each entry builds its histograms and counts, one ``psum`` sums them (the
collective that replaces MLlib's node-stats shuffle), the split scan
runs once on the first entry, and each entry advances its own examples.
The draws are the same as without a mesh, so a classification forest
(integer histograms, exact sums) is the same forest.

The output is host ``DecisionTree``s (tree.py) with PMML record counts
and feature importances collected per level from the frontier occupancy
(RDFUpdate.treeNodeExampleCounts / predictorExampleCounts).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ...common.device import check_f32_matmul, device_context, resolve_device
from ...common.rand import RandomManager
from ..classreg import CategoricalPrediction, NumericPrediction
from ..schema import InputSchema
from .tree import (CategoricalDecision, DecisionForest, DecisionNode,
                   DecisionTree, NumericDecision, TerminalNode)

__all__ = ["train_forest", "IMPURITIES"]

IMPURITIES = ("gini", "entropy", "variance")

# examples per histogram product: at most this many rows, and at most
# _HIST_ELEMS elements in the one-hot slot matrix [chunk, T * M]
_HIST_CHUNK = 1 << 16
_HIST_ELEMS = 1 << 27


# -- random draws -------------------------------------------------------------

def _bootstrap_weights(gen: torch.Generator, shape: tuple,
                       device: torch.device) -> torch.Tensor:
    """[T, B] float32 Poisson(1) bootstrap weights."""
    return torch.poisson(torch.ones(shape, device=device), generator=gen)


def _feature_uniforms(gen: torch.Generator, depth: int, shape: tuple,
                      device: torch.device) -> torch.Tensor:
    """[T, M, P] float32 uniforms choosing each node's feature subset at
    level ``depth``."""
    return torch.rand(shape, generator=gen, device=device)


# -- level functions ----------------------------------------------------------

def _histograms(binned: torch.Tensor, ychan: torch.Tensor, w: torch.Tensor,
                slot_of: torch.Tensor, num_slots: int, num_bins: int,
                exact_lowp: bool) -> torch.Tensor:
    """Weighted per-(tree, slot, predictor, bin, channel) stats.

    binned:  [B, P] int    pre-binned predictor values
    ychan:   [B, C] f32    per-class one-hot, or (1, y, y^2) channels
    w:       [T, B] f32    bootstrap weights
    slot_of: [T, B] int    frontier slot per example, -1 = settled
    returns  [T, M, P, S, C] float32

    hist[t,m,p,s,c] = sum_b w[t,b] [slot=m] [bin(p)=s] y[b,c], as the
    product of the weighted one-hot slot matrix [T*M, chunk] with the
    bin x channel one-hots [chunk, P*S*C], chunked over examples.
    ``exact_lowp``: the operands are exact in bfloat16 (classification),
    so on the card they are bfloat16 with float32 accumulation and
    output; otherwise, and on the CPU, the product is float32."""
    num_b, num_p = binned.shape
    num_c = ychan.shape[1]
    num_t = w.shape[0]
    rows = num_t * num_slots
    width = num_p * num_bins * num_c
    lowp = exact_lowp and w.is_cuda
    dtype = torch.bfloat16 if lowp else torch.float32
    chunk = max(1, min(_HIST_CHUNK, _HIST_ELEMS // rows,
                       1 << max(0, (num_b - 1).bit_length())))
    acc = torch.zeros((rows, width), dtype=torch.float32, device=w.device)
    base = (torch.arange(num_t, device=w.device) * num_slots)[:, None]
    for lo in range(0, num_b, chunk):
        hi = min(num_b, lo + chunk)
        e = torch.nn.functional.one_hot(binned[lo:hi].long(), num_bins).to(
            dtype)                                            # [CH, P, S]
        ey = (e[:, :, :, None] * ychan[lo:hi, None, None, :].to(dtype)
              ).reshape(hi - lo, width)
        s_c = slot_of[:, lo:hi]
        alive = s_c >= 0
        onehot = torch.zeros((rows, hi - lo), dtype=dtype, device=w.device)
        onehot.scatter_(0, base + torch.where(alive, s_c, 0).long(),
                        torch.where(alive, w[:, lo:hi], 0.0).to(dtype))
        if lowp:
            acc += torch.mm(onehot, ey, out_dtype=torch.float32)
        else:
            acc += torch.mm(onehot, ey)
    return acc.reshape(num_t, num_slots, num_p, num_bins, num_c)


def _impurity(stats: torch.Tensor, kind: str):
    """stats [..., C] -> (count, impurity) with the channel convention
    above."""
    if kind == "variance":
        n = stats[..., 0]
        safe = torch.clamp(n, min=1e-12)
        mean = stats[..., 1] / safe
        imp = stats[..., 2] / safe - mean * mean
    else:
        n = stats.sum(-1)
        p = stats / torch.clamp(n[..., None], min=1e-12)
        if kind == "gini":
            imp = 1.0 - (p * p).sum(-1)
        else:  # entropy (nats)
            imp = -(p * torch.where(p > 0, torch.log(torch.clamp(
                p, min=1e-12)), 0.0)).sum(-1)
    return n, torch.clamp(imp, min=0.0)


def _best_splits(hist: torch.Tensor, is_cat_p: torch.Tensor,
                 feat_mask: torch.Tensor, impurity: str, k_features: int):
    """Scan every (predictor, split point) for every (tree, slot).

    hist:      [T, M, P, S, C]
    is_cat_p:  [P] bool
    feat_mask: [T, M, P] f32 uniforms for per-node feature subsetting
    returns (gain, best_p, best_b, default_right, right_mask [T,M,S],
             totals [T,M,C])
    """
    num_t, num_m, num_p, num_bins, num_c = hist.shape
    totals = hist[:, :, 0].sum(2)                       # [T, M, C]
    parent_n, parent_imp = _impurity(totals, impurity)  # [T, M]

    # order bins: identity for numeric; score-sorted (stable, as
    # jnp.argsort) for categorical, whose empty bins all score 0
    if impurity == "variance":
        score = hist[..., 1] / torch.clamp(hist[..., 0], min=1e-12)
    else:
        score = hist[..., 0] / torch.clamp(hist.sum(-1), min=1e-12)
    order = torch.argsort(score, dim=3, stable=True)    # [T, M, P, S]
    identity = torch.arange(num_bins, device=hist.device)
    order = torch.where(is_cat_p[None, None, :, None], order, identity)
    sorted_hist = torch.gather(hist, 3, order[..., None].expand(
        -1, -1, -1, -1, num_c))

    cum = torch.cumsum(sorted_hist, dim=3)              # [T, M, P, S, C]
    left = cum[:, :, :, :-1]                            # prefixes
    right = totals[:, :, None, None] - left
    n_left, imp_left = _impurity(left, impurity)
    n_right, imp_right = _impurity(right, impurity)
    n = torch.clamp(parent_n[:, :, None, None], min=1e-12)
    gain = parent_imp[:, :, None, None] - \
        (n_left * imp_left + n_right * imp_right) / n   # [T, M, P, S-1]
    neg_inf = torch.tensor(-math.inf, device=hist.device)
    gain = torch.where((n_left > 0) & (n_right > 0), gain, neg_inf)

    # per-(tree, slot) random feature subset of size k ("auto" strategy)
    kth = torch.sort(feat_mask, dim=2).values[:, :, k_features - 1]
    selected = feat_mask <= kth[:, :, None]             # [T, M, P]
    gain = torch.where(selected[..., None], gain, neg_inf)

    flat = gain.reshape(num_t, num_m, -1)
    best = torch.argmax(flat, dim=2)                    # the first maximum
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    best_p = best // (num_bins - 1)
    best_b = best % (num_bins - 1)

    def at_best(arr):  # [T, M, P, S-1] -> [T, M] at (best_p, best_b)
        flat_arr = arr.reshape(num_t, num_m, -1)
        return torch.gather(flat_arr, 2, best[..., None])[..., 0]

    default_right = at_best(n_right) > at_best(n_left)

    order_best = torch.gather(order, 2, best_p[:, :, None, None].expand(
        -1, -1, 1, num_bins))[:, :, 0]                  # [T, M, S]
    rank = torch.argsort(order_best, dim=2, stable=True)  # the inverse
    right_mask = rank > best_b[:, :, None]              # [T, M, S]
    return best_gain, best_p, best_b, default_right, right_mask, totals


def _advance(slot_of: torch.Tensor, binned_t: torch.Tensor,
             split: torch.Tensor, best_p: torch.Tensor, best_b: torch.Tensor,
             is_cat_slot: torch.Tensor, right_mask: torch.Tensor,
             child_slots: torch.Tensor) -> torch.Tensor:
    """Route examples to child slots (or settle them at leaves).

    slot_of [T, B] int64, binned_t [P, B], split/best_p/best_b/is_cat_slot
    [T, M], right_mask [T, M, S], child_slots [T, M, 2] -> new [T, B]
    int64.  Each example gathers its slot's row of the split tables,
    then its bin of the slot's predictor; exact integer work."""
    num_t, num_m, num_s = right_mask.shape
    alive = slot_of >= 0
    s = torch.where(alive, slot_of, 0)
    bin_val = torch.gather(binned_t, 0, torch.gather(best_p, 1, s))
    numeric_right = bin_val > torch.gather(best_b, 1, s)
    cat_right = torch.gather(right_mask.reshape(num_t, num_m * num_s), 1,
                             s * num_s + bin_val)
    went_right = torch.where(torch.gather(is_cat_slot, 1, s), cat_right,
                             numeric_right)
    child = torch.gather(child_slots.reshape(num_t, num_m * 2), 1,
                         s * 2 + went_right.long())
    return torch.where(alive & torch.gather(split, 1, s), child, -1)


def _slot_counts(slot_of: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Unweighted examples per (tree, slot), int32: the node example
    counts the reference derives by routing the full training set
    (RDFUpdate.treeNodeExampleCounts).  Integer sums, so their order
    does not matter."""
    alive = slot_of >= 0
    counts = torch.zeros((slot_of.shape[0], num_slots), dtype=torch.int32,
                         device=slot_of.device)
    return counts.scatter_add_(1, torch.where(alive, slot_of, 0),
                               alive.to(torch.int32))


class _Shard:
    """One mesh entry's examples: [B_e, P] bins, [P, B_e] transposed,
    [B_e, C] channels, [T, B_e] weights and slots."""

    def __init__(self, device, binned, ychan, w, slot_of):
        self.device = device
        self.binned = binned
        self.binned_t = binned.t().long().contiguous()
        self.ychan = ychan
        self.w = w
        self.slot_of = slot_of


def _shard_sum(mesh, shards: list[_Shard], fn) -> torch.Tensor:
    """``fn(shard)`` summed over the shards (one psum over a mesh), on
    the first entry."""
    parts = []
    for s in shards:
        with device_context(s.device):
            parts.append(fn(s))
    if mesh is None:
        return parts[0]
    from ...parallel.mesh import psum
    return psum(mesh, parts)[0]


# -- binning ------------------------------------------------------------------

def _bin_features(x: np.ndarray, is_cat: np.ndarray, num_bins: int):
    """Pre-bin predictors: quantile cut points for numeric features
    (MLlib's findSplits role), identity encodings for categorical."""
    binned = np.zeros_like(x, dtype=np.int32)
    thresholds = np.zeros((x.shape[1], num_bins - 1), dtype=np.float64)
    for p in range(x.shape[1]):
        col = x[:, p]
        if is_cat[p]:
            binned[:, p] = col.astype(np.int32)
            continue
        qs = np.quantile(col, np.linspace(0.0, 1.0, num_bins + 1)[1:-1])
        thresholds[p] = qs
        binned[:, p] = np.searchsorted(qs, col, side="right")
    return binned, thresholds


# -- the training loop --------------------------------------------------------

def train_forest(x: np.ndarray, y: np.ndarray, schema: InputSchema,
                 category_counts: dict[int, int], num_trees: int,
                 max_depth: int, max_split_candidates: int,
                 impurity: str, seed: int | None = None,
                 num_classes: int | None = None,
                 timings: dict | None = None, device=None,
                 mesh=None) -> DecisionForest:
    """Train a forest on predictors ``x`` [B, P] (categorical values as
    encodings) and targets ``y`` (class encodings or regression values)
    on ``device`` (None means ``cuda``), or over the entries of
    ``mesh``.

    ``category_counts`` maps predictor index -> number of categories.
    ``timings``, when given, gathers seconds by stage under the
    reference's names; work on the card is asynchronous, so each level's
    fetch absorbs the pending kernel time into ``level_fetch``."""
    if impurity not in IMPURITIES:
        raise ValueError(f"bad impurity: {impurity}")
    classification = schema.is_classification()
    if classification == (impurity == "variance"):
        raise ValueError(f"impurity {impurity} does not match problem type")
    if max_split_candidates < 2:
        raise ValueError("max-split-candidates must be at least 2")
    if max_depth < 1:
        raise ValueError("max-depth must be at least 1")
    batch, num_p = x.shape
    if batch == 0:
        raise ValueError("no training data")
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if not classification:
        for d in (mesh.devices if mesh is not None else (dev,)):
            check_f32_matmul(d)

    def _mark(stage: str, t0: float) -> float:
        now = time.perf_counter()
        if timings is not None:
            timings[stage] = timings.get(stage, 0.0) + (now - t0)
        return now

    t0 = time.perf_counter()

    is_cat = np.zeros(num_p, dtype=bool)
    for p, count in category_counts.items():
        is_cat[p] = True
        if count > max_split_candidates:
            raise ValueError(
                f"categorical predictor {p} has {count} values > "
                f"max-split-candidates {max_split_candidates}")

    num_bins = int(max_split_candidates)
    binned_np, thresholds = _bin_features(x, is_cat, num_bins)
    t0 = _mark("bin_features", t0)

    if classification:
        if num_classes is None:
            num_classes = int(np.max(y)) + 1
        y_np = np.asarray(y, dtype=np.int64)
        k_features = max(1, int(math.ceil(math.sqrt(num_p))))
    else:
        y_np = np.asarray(y, dtype=np.float32)
        k_features = max(1, num_p // 3)

    def channels(yt: torch.Tensor) -> torch.Tensor:
        if classification:
            return torch.nn.functional.one_hot(yt, num_classes).to(
                torch.float32)
        return torch.stack([torch.ones_like(yt), yt, yt * yt], dim=1)

    gen = torch.Generator(device=dev)
    gen.manual_seed(RandomManager.random_seed() if seed is None else seed)
    w = _bootstrap_weights(gen, (num_trees, batch), dev)
    if mesh is None:
        shards = [_Shard(dev, torch.from_numpy(binned_np).to(dev),
                         channels(torch.from_numpy(y_np).to(dev)), w,
                         torch.zeros((num_trees, batch), dtype=torch.int64,
                                     device=dev))]
    else:
        # the examples padded to the mesh size; padding rows weigh 0
        # and start settled (slot -1), so they never contribute
        from ...parallel.mesh import pad_rows
        n_pad = pad_rows(batch, mesh.size)
        rows = n_pad // mesh.size
        w = torch.nn.functional.pad(w, (0, n_pad - batch))
        binned_p = np.zeros((n_pad, num_p), dtype=binned_np.dtype)
        binned_p[:batch] = binned_np
        y_p = np.zeros(n_pad, dtype=y_np.dtype)
        y_p[:batch] = y_np
        slots = torch.zeros((num_trees, n_pad), dtype=torch.int64)
        slots[:, batch:] = -1
        shards = []
        for e, d in enumerate(mesh.devices):
            lo = (mesh.first_entry + e) * rows
            hi = lo + rows
            with device_context(d):
                shards.append(_Shard(
                    d, torch.from_numpy(binned_p[lo:hi]).to(d),
                    channels(torch.from_numpy(y_p[lo:hi]).to(d)),
                    w[:, lo:hi].to(d), slots[:, lo:hi].to(d)))
    is_cat_t = torch.from_numpy(is_cat).to(dev)
    t0 = _mark("init_upload", t0)

    # per-(tree, slot) node-ID strings for the current frontier
    frontier_ids = [["r"] for _ in range(num_trees)]
    # per-tree accumulated node records: id -> dict
    records: list[dict[str, dict]] = [dict() for _ in range(num_trees)]

    for depth in range(max_depth + 1):
        real_slots = max(len(ids) for ids in frontier_ids)
        if real_slots == 0:
            break
        # the frontier padded to a power of two, as the reference pads
        # it for its compile cache; padding slots hold no examples, and
        # their split decisions are never read on the host
        num_slots = 1 << (real_slots - 1).bit_length()
        last = depth == max_depth
        if not last:
            hist = _shard_sum(mesh, shards, lambda s: _histograms(
                s.binned, s.ychan, s.w, s.slot_of, num_slots, num_bins,
                classification))
            feat_u = _feature_uniforms(gen, depth,
                                       (num_trees, num_slots, num_p), dev)
            gain, best_p, best_b, default_right, right_mask, totals = \
                _best_splits(hist, is_cat_t, feat_u, impurity, k_features)
        else:
            # the last level only settles leaves, which need their
            # totals: one predictor's histogram, summed over its bins
            totals = _shard_sum(mesh, shards, lambda s: _histograms(
                s.binned[:, :1], s.ychan, s.w, s.slot_of, num_slots,
                num_bins, classification))[:, :, 0].sum(2)
        counts = _shard_sum(mesh, shards,
                            lambda s: _slot_counts(s.slot_of, num_slots))
        t0 = _mark("level_dispatch", t0)

        # ONE synchronising fetch of every output of the level, packed
        # into one float64 table (each value is exact in float64)
        num_c = totals.shape[2]
        parts = [counts[..., None].double(), totals.double()]
        if not last:
            parts += [gain[..., None].double(), best_p[..., None].double(),
                      best_b[..., None].double(),
                      default_right[..., None].double(),
                      right_mask.double()]
        packed = torch.cat(parts, dim=2).cpu().numpy()
        counts_np = packed[:, :, 0].astype(np.int64)
        totals_np = packed[:, :, 1:1 + num_c]
        if not last:
            gain_np = packed[:, :, 1 + num_c]
            best_p_np = packed[:, :, 2 + num_c].astype(np.int64)
            best_b_np = packed[:, :, 3 + num_c].astype(np.int64)
            default_np = packed[:, :, 4 + num_c] > 0.5
            right_np = packed[:, :, 5 + num_c:] > 0.5
        t0 = _mark("level_fetch", t0)

        # decide split vs leaf per (tree, slot) on host; assign child slots
        tables = np.zeros((num_trees, num_slots, 4), dtype=np.int64)
        tables[:, :, 2:] = -1        # split, is_cat_slot, child slots
        next_ids: list[list[str]] = [[] for _ in range(num_trees)]
        for t in range(num_trees):
            for m, node_id in enumerate(frontier_ids[t]):
                do_split = not last and gain_np[t, m] > 0.0 and \
                    np.isfinite(gain_np[t, m])
                if not do_split:
                    records[t][node_id] = {"leaf": True,
                                           "stats": totals_np[t, m],
                                           "count": int(counts_np[t, m])}
                    continue
                p = int(best_p_np[t, m])
                tables[t, m, 0] = 1
                tables[t, m, 1] = is_cat[p]
                if is_cat[p]:
                    n_vals = category_counts[p]
                    right_set = [c for c in range(n_vals)
                                 if right_np[t, m, c]]
                    decision = ("cat", p, right_set)
                else:
                    decision = ("num", p,
                                float(thresholds[p, int(best_b_np[t, m])]))
                records[t][node_id] = {
                    "leaf": False, "decision": decision,
                    "default_right": bool(default_np[t, m]),
                    "count": int(counts_np[t, m])}
                tables[t, m, 2] = len(next_ids[t])
                next_ids[t].append(node_id + "-")
                tables[t, m, 3] = len(next_ids[t])
                next_ids[t].append(node_id + "+")

        t0 = _mark("level_host_partition", t0)
        if not any(next_ids[t] for t in range(num_trees)):
            break
        tables_t = torch.from_numpy(tables)
        for s in shards:
            with device_context(s.device):
                tables_dev = tables_t.to(s.device)   # one upload each
                s.slot_of = _advance(
                    s.slot_of, s.binned_t, tables_dev[:, :, 0] > 0,
                    best_p.to(s.device), best_b.to(s.device),
                    tables_dev[:, :, 1] > 0, right_mask.to(s.device),
                    tables_dev[:, :, 2:])
        frontier_ids = next_ids
        t0 = _mark("level_advance_dispatch", t0)

    forest = _build_forest(records, schema, classification,
                           num_classes if classification else 0)
    _mark("build_forest", t0)
    return forest


def _build_forest(records, schema: InputSchema, classification: bool,
                  num_classes: int) -> DecisionForest:
    """Reconstruct host trees from per-node training records, carrying
    the full-set example counts collected per level into PMML record
    counts and feature importances (reference:
    RDFUpdate.treeNodeExampleCounts / predictorExampleCounts — counts
    come from routing EVERY example, not the bootstrap sample; leaf
    distributions stay the bootstrap-weighted stats, rescaled)."""
    trees = []
    importance_counts = np.zeros(schema.num_features, dtype=np.float64)
    for tree_records in records:

        def build(node_id: str):
            rec = tree_records[node_id]
            count = rec.get("count", 0)
            if rec["leaf"]:
                stats = rec["stats"]
                if classification:
                    counts = np.maximum(stats, 0.0)
                    if counts.sum() <= 0:
                        counts = np.ones(num_classes)
                    prediction = CategoricalPrediction(counts)
                    probs = prediction.category_probabilities
                    prediction.category_counts = probs * max(1, count)
                    prediction.count = count
                    prediction._recompute()
                else:
                    n = max(stats[0], 1e-12)
                    prediction = NumericPrediction(stats[1] / n, count)
                return TerminalNode(node_id, prediction)
            kind, p, arg = rec["decision"]
            feature_number = schema.predictor_to_feature_index(p)
            if kind == "cat":
                decision = CategoricalDecision(feature_number, arg,
                                               rec["default_right"])
            else:
                decision = NumericDecision(feature_number, arg,
                                           rec["default_right"])
            node = DecisionNode(node_id, decision, build(node_id + "-"),
                                build(node_id + "+"))
            node.count = count
            importance_counts[feature_number] += count
            return node

        trees.append(DecisionTree(build("r")))
    forest = DecisionForest(trees)
    total = importance_counts.sum()
    forest.feature_importances = (importance_counts / total if total > 0
                                  else importance_counts)
    return forest
