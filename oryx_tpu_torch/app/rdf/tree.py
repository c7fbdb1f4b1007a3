"""Decision tree / forest host structures.

Counterpart of ``oryx_tpu/app/rdf/tree.py`` (reference: app/oryx-app-
common/.../rdf/decision/NumericDecision.java:29 — value >= threshold,
default on missing; CategoricalDecision.java:32 — active-category set;
tree/DecisionTree.java:49-66 — findTerminal, findByID;
tree/DecisionForest.java:30 — weighted vote, feature importances).

Node IDs follow the reference's convention: the root is "r" and a child
appends '-' (negative/left) or '+' (positive/right), so an ID is a full
root-to-node path — findByID replays it.  These host objects are the
mutable, serializable form of the model (speed-layer leaf updates
mutate them in place); batched prediction flattens them into node
tables on the card (forest_arrays.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..classreg import Example, vote_on_feature

__all__ = [
    "NumericDecision", "CategoricalDecision", "DecisionNode",
    "TerminalNode", "DecisionTree", "DecisionForest",
]


class NumericDecision:
    """value >= threshold, with a default for missing values."""

    __slots__ = ("feature_number", "threshold", "default_decision")

    def __init__(self, feature_number: int, threshold: float,
                 default_decision: bool):
        self.feature_number = feature_number
        self.threshold = float(threshold)
        self.default_decision = bool(default_decision)

    def is_positive(self, example: Example) -> bool:
        value = example.get_feature(self.feature_number)
        if value is None:
            return self.default_decision
        return float(value) >= self.threshold

    def __eq__(self, other):
        return isinstance(other, NumericDecision) and \
            self.feature_number == other.feature_number and \
            self.threshold == other.threshold

    def __repr__(self):
        return f"(#{self.feature_number} >= {self.threshold})"


class CategoricalDecision:
    """category encoding in an active set, default for missing/unseen."""

    __slots__ = ("feature_number", "active_category_encodings",
                 "default_decision")

    def __init__(self, feature_number: int,
                 active_category_encodings: Sequence[int],
                 default_decision: bool):
        self.feature_number = feature_number
        self.active_category_encodings = frozenset(
            int(c) for c in active_category_encodings)
        self.default_decision = bool(default_decision)

    def is_positive(self, example: Example) -> bool:
        value = example.get_feature(self.feature_number)
        if value is None:
            return self.default_decision
        return int(value) in self.active_category_encodings

    def __eq__(self, other):
        return isinstance(other, CategoricalDecision) and \
            self.feature_number == other.feature_number and \
            self.active_category_encodings == other.active_category_encodings

    def __repr__(self):
        cats = ",".join(str(c)
                        for c in sorted(self.active_category_encodings))
        return f"(#{self.feature_number} in [{cats}])"


class DecisionNode:
    """Internal node: a decision and two children; negative -> left,
    positive -> right.  ``count`` is the training-example record count
    written into PMML."""

    __slots__ = ("id", "decision", "left", "right", "count")

    def __init__(self, node_id: str, decision, left, right, count: int = 0):
        self.id = node_id
        self.decision = decision
        self.left = left
        self.right = right
        self.count = int(count)

    @property
    def is_terminal(self) -> bool:
        return False

    def __repr__(self):
        return repr(self.decision)


class TerminalNode:
    """Leaf holding an updatable prediction."""

    __slots__ = ("id", "prediction")

    def __init__(self, node_id: str, prediction):
        self.id = node_id
        self.prediction = prediction

    @property
    def is_terminal(self) -> bool:
        return True

    @property
    def count(self) -> int:
        return self.prediction.count

    def update(self, example: Example) -> None:
        self.prediction.update_from_example(example)

    def __repr__(self):
        return f"[ {self.prediction!r} ]"


class DecisionTree:

    def __init__(self, root):
        if root is None:
            raise ValueError("null root")
        self.root = root

    def find_terminal(self, example: Example) -> TerminalNode:
        node = self.root
        while not node.is_terminal:
            node = node.right if node.decision.is_positive(example) \
                else node.left
        return node

    def find_by_id(self, node_id: str):
        """Replay the +/- path encoded in the ID (reference:
        DecisionTree.findByID)."""
        node = self.root
        while node.id != node_id:
            if node.is_terminal:
                raise ValueError(f"No node with ID {node_id}")
            if not node_id.startswith(node.id):
                raise ValueError(
                    f"Node ID {node.id} is not a prefix of {node_id}")
            decision_char = node_id[len(node.id)]
            if decision_char == "+":
                node = node.right
            elif decision_char == "-":
                node = node.left
            else:
                raise ValueError(f"Bad path char {decision_char!r}")
        return node

    def predict(self, example: Example):
        return self.find_terminal(example).prediction

    def update(self, example: Example) -> None:
        self.find_terminal(example).update(example)

    def nodes(self):
        """All nodes, breadth-first."""
        queue = [self.root]
        while queue:
            node = queue.pop(0)
            yield node
            if not node.is_terminal:
                queue.append(node.left)
                queue.append(node.right)


class DecisionForest:
    """Weighted ensemble of trees plus per-feature importances (indexed
    by the all-features index, like the reference's MiningSchema-ordered
    importance array)."""

    def __init__(self, trees: Sequence[DecisionTree],
                 weights: Sequence[float] | None = None,
                 feature_importances: Sequence[float] | None = None):
        self.trees = list(trees)
        if not self.trees:
            raise ValueError("No trees")
        self.weights = np.asarray(
            weights if weights is not None else np.ones(len(self.trees)),
            dtype=np.float64)
        self.feature_importances = np.asarray(
            feature_importances if feature_importances is not None else [],
            dtype=np.float64)

    def predict(self, example: Example):
        return vote_on_feature(
            [tree.predict(example) for tree in self.trees], self.weights)

    def update(self, example: Example) -> None:
        for tree in self.trees:
            tree.update(example)

    def __repr__(self):  # pragma: no cover
        return f"DecisionForest[numTrees:{len(self.trees)}]"
