"""Carry an ALS serving model's state across from NumPy arrays.

``serving_model_from_arrays`` builds this package's ``ALSServingModel``
from what the reference package's stores hand out
(``FeatureVectorStore.host_arrays()``: the factor matrix and the
row -> id table, None for a free row), its known-items map and its LSH
hyperplanes.  Row positions carry over exactly, so tied scores come out
in the same lowest-row-first order on both.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from .app.als.serving_model import ALSServingModel

__all__ = ["serving_model_from_arrays"]


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
