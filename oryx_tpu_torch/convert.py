"""Carry a model's state across from the reference package's objects.

``serving_model_from_arrays`` builds this package's ``ALSServingModel``
from what the reference package's stores hand out
(``FeatureVectorStore.host_arrays()``: the factor matrix and the
row -> id table, None for a free row), its known-items map and its LSH
hyperplanes.  Row positions carry over exactly, so tied scores come out
in the same lowest-row-first order on both.  ``clusters_from_reference``
and ``ann_state_from_reference`` carry a k-means model's clusters and a
generation's IVF index state (centroids, published cells, recall
certificate), and ``forest_from_reference`` a decision forest (node
ids, decisions, predictions, counts, weights, importances); each reads
only attributes, so none imports the reference package.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from .app.als.ivf import AnnConfig, AnnState
from .app.als.serving_model import ALSServingModel
from .app.classreg import CategoricalPrediction, NumericPrediction
from .app.kmeans.common import ClusterInfo
from .app.rdf.tree import (CategoricalDecision, DecisionForest,
                           DecisionNode, DecisionTree, NumericDecision,
                           TerminalNode)

__all__ = ["serving_model_from_arrays", "clusters_from_reference",
           "ann_state_from_reference", "forest_from_reference"]


def serving_model_from_arrays(
        features: int, implicit: bool, *,
        x_ids: Sequence[str | None], X: np.ndarray,
        y_ids: Sequence[str | None], Y: np.ndarray,
        known_items: Mapping[str, Iterable[str]],
        lsh_hyperplanes: np.ndarray | None = None,
        sample_rate: float = 1.0, dtype="float32",
        device=None, int8_selection: str | bool = "auto",
        fold_scan: str | bool = "auto") -> ALSServingModel:
    """An ``ALSServingModel`` holding ``X``/``Y`` (one row per entry of
    ``x_ids``/``y_ids``; None marks a free row), ``known_items``
    (user -> items) and, on an LSH model (``sample_rate`` < 1), the
    given hyperplanes in place of freshly drawn ones.  ``int8_selection``
    and ``fold_scan`` choose the phase-A mirrors as on
    ``ALSServingModel``.  ``device=None`` means ``cuda``."""
    model = ALSServingModel(features, implicit, sample_rate=sample_rate,
                            dtype=dtype, device=device,
                            int8_selection=int8_selection,
                            fold_scan=fold_scan)
    if lsh_hyperplanes is not None:
        if model.lsh is None:
            raise ValueError("lsh_hyperplanes given for a model without "
                             "LSH (sample_rate must be below 1)")
        model.lsh.set_hyperplanes(lsh_hyperplanes)
    model.X.load_rows(list(x_ids), X)
    model.Y.load_rows(list(y_ids), Y)
    for user, items in known_items.items():
        model.add_known_items(user, items)
    return model


def clusters_from_reference(clusters) -> list[ClusterInfo]:
    """This package's ``ClusterInfo`` list from the reference's: the same
    ids, float64 centers and counts, in the same order."""
    return [ClusterInfo(int(c.id), np.array(c.center, dtype=np.float64),
                        int(c.count)) for c in clusters]


def ann_state_from_reference(state) -> AnnState:
    """This package's ``AnnState`` from the reference's: its configuration,
    centroids, published cells (if not yet consumed), recall certificate
    and index bytes."""
    c = state.cfg
    cfg = AnnConfig(enabled=c.enabled, cells=c.cells, nprobe=c.nprobe,
                    min_recall=c.min_recall, recall_at=c.recall_at,
                    recall_queries=c.recall_queries,
                    train_sample=c.train_sample,
                    train_iterations=c.train_iterations)
    cells = None if state.cells is None else \
        np.array(state.cells, dtype=np.int32)
    out = AnnState(cfg, np.array(state.centroids, dtype=np.float32),
                   cells=cells)
    out.recall = None if state.recall is None else float(state.recall)
    out.index_bytes = int(state.index_bytes)
    return out


def _node_from_reference(node):
    if node.is_terminal:
        pred = node.prediction
        if hasattr(pred, "category_counts"):
            prediction = CategoricalPrediction(
                np.array(pred.category_counts, dtype=np.float64))
            prediction.count = int(pred.count)
        else:
            prediction = NumericPrediction(float(pred.prediction),
                                           int(pred.count))
        return TerminalNode(str(node.id), prediction)
    d = node.decision
    if hasattr(d, "threshold"):
        decision = NumericDecision(int(d.feature_number), float(d.threshold),
                                   bool(d.default_decision))
    else:
        decision = CategoricalDecision(
            int(d.feature_number), sorted(d.active_category_encodings),
            bool(d.default_decision))
    return DecisionNode(str(node.id), decision,
                        _node_from_reference(node.left),
                        _node_from_reference(node.right), int(node.count))


def forest_from_reference(forest) -> DecisionForest:
    """This package's ``DecisionForest`` from the reference's: the same
    trees (node ids, decisions with their thresholds, category sets and
    default branches, leaf predictions and counts, node record counts),
    tree weights and feature importances."""
    return DecisionForest(
        [DecisionTree(_node_from_reference(t.root)) for t in forest.trees],
        np.array(forest.weights, dtype=np.float64),
        np.array(forest.feature_importances, dtype=np.float64))
