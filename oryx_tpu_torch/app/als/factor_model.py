"""Shared base for the ALS in-memory models.

Counterpart of ``oryx_tpu/app/als/factor_model.py`` (reference:
ALSSpeedModel.java:40-183 and ALSServingModel.java:57-150): X/Y factor
stores and expected-ID accounting for fraction-loaded gating.  The
cached Gramian solvers come with the solver port of a later slice.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np

from ...common.device import resolve_device
from .feature_vectors import FeatureVectorStore

__all__ = ["FactorModelBase"]


class FactorModelBase:
    """X/Y stores + expected-ID accounting."""

    def __init__(self, features: int, implicit: bool, dtype="float32",
                 device=None):
        self.features = features
        self.implicit = implicit
        self.device = resolve_device(device)
        self.X = FeatureVectorStore(features, dtype=dtype,
                                    device=self.device)
        self.Y = FeatureVectorStore(features, dtype=dtype,
                                    device=self.device)
        self._expected_user_ids: set[str] = set()
        self._expected_item_ids: set[str] = set()
        self._expected_lock = threading.Lock()

    # -- vectors ------------------------------------------------------------

    def get_user_vector(self, user_id: str) -> np.ndarray | None:
        return self.X.get_vector(user_id)

    def get_item_vector(self, item_id: str) -> np.ndarray | None:
        return self.Y.get_vector(item_id)

    def set_user_vector(self, user_id: str, vector: np.ndarray) -> None:
        self.X.set_vector(user_id, vector)
        with self._expected_lock:
            self._expected_user_ids.discard(user_id)

    def set_item_vector(self, item_id: str, vector: np.ndarray) -> None:
        self.Y.set_vector(item_id, vector)
        with self._expected_lock:
            self._expected_item_ids.discard(item_id)

    # -- model swap ---------------------------------------------------------

    def set_expected_ids(self, user_ids: Sequence[str],
                         item_ids: Sequence[str]) -> None:
        """Record the ID universe of an incoming MODEL for fraction-loaded
        accounting (reference expected-ID logic,
        ALSServingModel.java:318-343), and pre-size both stores for it."""
        with self._expected_lock:
            self._expected_user_ids = {u for u in user_ids if u not in self.X}
            self._expected_item_ids = {i for i in item_ids if i not in self.Y}
            self.X.reserve(len(self.X) + len(self._expected_user_ids))
            self.Y.reserve(len(self.Y) + len(self._expected_item_ids))

    def retain_recent_and_user_ids(self, ids: Sequence[str]) -> None:
        self.X.retain_recent_and_ids(ids)

    def retain_recent_and_item_ids(self, ids: Sequence[str]) -> None:
        self.Y.retain_recent_and_ids(ids)

    def get_fraction_loaded(self) -> float:
        with self._expected_lock:
            expected = len(self._expected_user_ids) \
                + len(self._expected_item_ids)
        loaded = len(self.X) + len(self.Y)
        total = loaded + expected
        return 1.0 if total == 0 else loaded / total

    def user_count(self) -> int:
        return len(self.X)

    def item_count(self) -> int:
        return len(self.Y)
