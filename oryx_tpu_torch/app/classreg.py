"""Classification/regression domain types shared by the RDF app:
examples, features, and online-updatable predictions.

Counterpart of ``oryx_tpu/app/classreg.py`` (reference: app/oryx-app-
common/.../classreg/example/Example.java:32, ExampleUtils.dataToExample,
predict/CategoricalPrediction.java:32, NumericPrediction.java:28,
WeightedPrediction.java:33).  A feature is a plain number — ``float``
for numeric values, ``int`` for categorical encodings, ``None`` for a
missing value — so a batch of examples densifies straight into a matrix
(see rdf/forest_arrays.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .schema import CategoricalValueEncodings, InputSchema

__all__ = [
    "Example", "example_from_tokens", "CategoricalPrediction",
    "NumericPrediction", "vote_on_feature",
]


class Example:
    """One labeled or unlabeled datum: per-feature values indexed by the
    all-features index, plus an optional target (reference:
    Example.java:32).  Numeric features are floats, categorical features
    are encoding ints, and inactive/missing slots are None."""

    __slots__ = ("features", "target")

    def __init__(self, target, features: Sequence):
        self.features = list(features)
        self.target = target

    def get_feature(self, i: int):
        return self.features[i]

    def __repr__(self):  # pragma: no cover
        return (f"{self.features}" if self.target is None
                else f"{self.features} -> {self.target}")


def example_from_tokens(data: Sequence[str], schema: InputSchema,
                        encodings: CategoricalValueEncodings) -> Example:
    """Parse one tokenized input line into an Example (reference:
    ExampleUtils.dataToExample): numeric features parse as floats,
    categorical features map through the value encodings, an empty
    target token means "no target" (a to-be-predicted datum)."""
    features: list = [None] * len(data)
    target = None
    for i, token in enumerate(data):
        is_target = schema.is_target(i)
        value = None
        if is_target and not token:
            value = None
        elif schema.is_numeric(i):
            value = float(token)
        elif schema.is_categorical(i):
            # a value unseen at training time is treated as missing and
            # rides the default branches (the reference NPEs here)
            value = encodings.try_encode(i, token)
        if is_target:
            target = value
        else:
            features[i] = value
    return Example(target, features)


class CategoricalPrediction:
    """Per-category vote counts with derived probabilities; supports the
    speed layer's online count updates (reference:
    CategoricalPrediction.java:32-...)."""

    __slots__ = ("category_counts", "category_probabilities",
                 "max_category", "count")

    def __init__(self, category_counts):
        self.category_counts = np.asarray(category_counts, dtype=np.float64)
        if self.category_counts.ndim != 1 or not len(self.category_counts):
            raise ValueError("category counts must be a non-empty vector")
        self.count = int(round(float(self.category_counts.sum())))
        self._recompute()

    def _recompute(self) -> None:
        total = float(self.category_counts.sum())
        self.category_probabilities = self.category_counts / total
        self.max_category = int(np.argmax(self.category_counts))

    def get_most_probable_category_encoding(self) -> int:
        return self.max_category

    def update(self, encoding: int, count: int = 1) -> None:
        self.category_counts[encoding] += count
        self.count += count
        self._recompute()

    def update_from_example(self, example: Example) -> None:
        self.update(int(example.target), 1)

    def __eq__(self, other):
        return isinstance(other, CategoricalPrediction) and \
            np.array_equal(self.category_counts, other.category_counts)

    def __repr__(self):  # pragma: no cover
        return f":{self.category_probabilities.tolist()}"


class NumericPrediction:
    """A running mean with a count (reference: NumericPrediction.java:28)."""

    __slots__ = ("prediction", "count")

    def __init__(self, prediction: float, initial_count: int):
        self.prediction = float(prediction)
        self.count = int(initial_count)

    def update(self, new_prediction: float, new_count: int) -> None:
        new_total = self.count + new_count
        self.count = new_total
        self.prediction += (new_count / new_total) * \
            (new_prediction - self.prediction)

    def update_from_example(self, example: Example) -> None:
        self.update(float(example.target), 1)

    def __eq__(self, other):
        return isinstance(other, NumericPrediction) and \
            self.prediction == other.prediction

    def __repr__(self):  # pragma: no cover
        return str(self.prediction)


def vote_on_feature(predictions: Sequence, weights: Sequence[float]):
    """Combine per-tree predictions into a forest prediction (reference:
    WeightedPrediction.voteOnFeature): categorical = weighted average of
    probability vectors, numeric = weighted mean."""
    if not predictions:
        raise ValueError("No predictions")
    if len(predictions) != len(weights):
        raise ValueError(f"{len(predictions)} predictions "
                         f"but {len(weights)} weights")
    first = predictions[0]
    if isinstance(first, CategoricalPrediction):
        probs = np.stack([p.category_probabilities for p in predictions])
        w = np.asarray(weights, dtype=np.float64)
        weighted = (w[:, None] * probs).sum(axis=0) / w.sum()
        return CategoricalPrediction(weighted)
    total_w = float(np.sum(weights))
    mean = float(np.sum([p.prediction * w
                         for p, w in zip(predictions, weights)]) / total_w)
    return NumericPrediction(mean, len(predictions))
