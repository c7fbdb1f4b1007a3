"""Device-array forest representation: batched prediction and
terminal-node routing on the card.

Counterpart of ``oryx_tpu/app/rdf/forest_arrays.py`` (reference: the
per-example DecisionTree.findTerminal walk, DecisionTree.java:49-66,
used by Evaluation.java's accuracy/RMSE and by
RDFSpeedModelManager.buildUpdates).  Every tree is flattened into
structure-of-arrays node tables padded to a common size, and a batch of
examples descends all trees at once: ``max_depth`` steps of
``torch.gather`` and select over a ``[T, B]`` node tensor, with no loop
over trees.  Leaves loop to themselves, so extra steps change nothing.

Missing values ride along as NaN and take each node's default branch,
the PMML defaultChild semantics of the host walk.  Thresholds are
float32 on the card, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...common.device import resolve_device
from ..classreg import Example
from .tree import CategoricalDecision, DecisionForest

__all__ = ["ForestArrays", "examples_to_matrix"]


def examples_to_matrix(examples: Sequence[Example],
                       num_features: int) -> np.ndarray:
    """Dense [B, num_features] float32 matrix; missing/inactive = NaN."""
    out = np.full((len(examples), num_features), np.nan, dtype=np.float32)
    for r, ex in enumerate(examples):
        for f, value in enumerate(ex.features):
            if value is not None:
                out[r, f] = float(value)
    return out


class ForestArrays:
    """Flat per-tree node tables [T, N] (+ leaf stats) on ``device``
    (None means ``cuda``), built once per model load and reused for
    every batched predict/route call.

    Node table layout (BFS order per tree, padded to the largest tree):
      feature[t, n]        all-features index tested at n (0 for leaves)
      threshold[t, n]      numeric split threshold (float32)
      is_cat[t, n]         categorical decision?
      cat_mask[t, n, C]    active-category bitmask (categorical nodes)
      default_right[t, n]  branch taken on missing values
      left/right[t, n]     child node indices; leaves self-loop
      leaf_probs[t, n, K]  per-class probabilities at leaves (classification)
      leaf_pred[t, n]      prediction value at leaves (regression)
    ``node_ids[t][n]`` is the node's ID string.
    """

    def __init__(self, forest: DecisionForest, num_features: int,
                 num_classes: int, device=None):
        self.device = resolve_device(device)
        self.num_features = int(num_features)
        self.num_classes = int(num_classes)
        trees = forest.trees
        node_lists = [list(t.nodes()) for t in trees]
        n_max = max(len(nl) for nl in node_lists)
        t_count = len(trees)
        max_cats = 1
        for nl in node_lists:
            for node in nl:
                if not node.is_terminal and \
                        isinstance(node.decision, CategoricalDecision):
                    cats = node.decision.active_category_encodings
                    if cats:
                        max_cats = max(max_cats, max(cats) + 1)

        feature = np.zeros((t_count, n_max), dtype=np.int64)
        threshold = np.zeros((t_count, n_max), dtype=np.float32)
        is_cat = np.zeros((t_count, n_max), dtype=bool)
        cat_mask = np.zeros((t_count, n_max, max_cats), dtype=bool)
        default_right = np.zeros((t_count, n_max), dtype=bool)
        left = np.zeros((t_count, n_max), dtype=np.int64)
        right = np.zeros((t_count, n_max), dtype=np.int64)
        leaf_probs = np.zeros((t_count, n_max, max(1, num_classes)),
                              dtype=np.float32)
        leaf_pred = np.zeros((t_count, n_max), dtype=np.float32)
        self.node_ids: list[list[str]] = []

        for t, nl in enumerate(node_lists):
            index_of = {id(node): i for i, node in enumerate(nl)}
            self.node_ids.append([node.id for node in nl])
            for i, node in enumerate(nl):
                if node.is_terminal:
                    left[t, i] = right[t, i] = i
                    pred = node.prediction
                    if num_classes:
                        probs = pred.category_probabilities
                        leaf_probs[t, i, :len(probs)] = probs
                    else:
                        leaf_pred[t, i] = pred.prediction
                    continue
                decision = node.decision
                feature[t, i] = decision.feature_number
                default_right[t, i] = decision.default_decision
                left[t, i] = index_of[id(node.left)]
                right[t, i] = index_of[id(node.right)]
                if isinstance(decision, CategoricalDecision):
                    is_cat[t, i] = True
                    for c in decision.active_category_encodings:
                        cat_mask[t, i, c] = True
                else:
                    threshold[t, i] = decision.threshold

        # max depth = longest node-ID path, bounds the walk's steps
        self.max_depth = max(
            1, max(len(node.id) - 1 for nl in node_lists for node in nl))

        def up(a):
            return torch.from_numpy(a).to(self.device)

        self._weights = up(np.asarray(forest.weights, dtype=np.float32))
        self._feature = up(feature)
        self._threshold = up(threshold)
        self._is_cat = up(is_cat)
        self._num_cats = max_cats
        self._cat_mask = up(cat_mask.reshape(t_count, n_max * max_cats))
        self._default_right = up(default_right)
        self._left = up(left)
        self._right = up(right)
        self._leaf_probs = up(leaf_probs)
        self._leaf_pred = up(leaf_pred)

    def _matrix(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _terminal_indices(self, x: torch.Tensor) -> torch.Tensor:
        """[T, B] int64 leaf index reached by every example in every
        tree: ``max_depth`` steps of the level-synchronous walk."""
        num_t = self._feature.shape[0]
        xt = x.t().contiguous()                                  # [F, B]
        node = torch.zeros((num_t, x.shape[0]), dtype=torch.int64,
                           device=self.device)
        cats = self._num_cats
        for _ in range(self.max_depth):
            value = torch.gather(xt, 0, torch.gather(self._feature, 1, node))
            missing = torch.isnan(value)
            numeric_pos = value >= torch.gather(self._threshold, 1, node)
            # categorical: look the encoding up in the node's bitmask;
            # encodings at or past the mask width are never active
            enc = torch.where(missing, 0.0, value)
            in_range = enc < cats
            enc = enc.clamp(0, cats - 1).to(torch.int64)
            cat_pos = torch.gather(self._cat_mask, 1, node * cats + enc) \
                & in_range
            positive = torch.where(torch.gather(self._is_cat, 1, node),
                                   cat_pos, numeric_pos)
            positive = torch.where(
                missing, torch.gather(self._default_right, 1, node), positive)
            node = torch.where(positive, torch.gather(self._right, 1, node),
                               torch.gather(self._left, 1, node))
        return node

    def route(self, x) -> np.ndarray:
        """Terminal-node indices [T, B] on the host (the speed layer's
        routing)."""
        return self._terminal_indices(self._matrix(x)).to(
            torch.int32).cpu().numpy()

    def route_ids(self, x) -> list[list[str]]:
        """Terminal-node ID strings per tree for a batch."""
        idx = self.route(x)
        return [[self.node_ids[t][i] for i in row]
                for t, row in enumerate(idx)]

    def predict_proba(self, x) -> np.ndarray:
        """[B, K] forest class probabilities: weighted average of
        per-tree leaf distributions (vote_on_feature semantics)."""
        if not self.num_classes:
            raise ValueError("not a classification forest")
        terminal = self._terminal_indices(self._matrix(x))       # [T, B]
        k = self._leaf_probs.shape[2]
        probs = torch.gather(self._leaf_probs, 1, terminal[:, :, None].expand(
            -1, -1, k))                                          # [T, B, K]
        w = self._weights[:, None, None]
        return ((probs * w).sum(0) / self._weights.sum()).cpu().numpy()

    def predict_value(self, x) -> np.ndarray:
        """[B] forest regression predictions: weighted mean of leaves."""
        if self.num_classes:
            raise ValueError("not a regression forest")
        terminal = self._terminal_indices(self._matrix(x))       # [T, B]
        preds = torch.gather(self._leaf_pred, 1, terminal)
        w = self._weights[:, None]
        return ((preds * w).sum(0) / self._weights.sum()).cpu().numpy()
