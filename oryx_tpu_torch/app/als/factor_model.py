"""Shared base for the ALS in-memory models.

Counterpart of ``oryx_tpu/app/als/factor_model.py`` (reference:
ALSSpeedModel.java:40-183 and ALSServingModel.java:57-150): X/Y factor
stores, expected-ID accounting for fraction-loaded gating, and cached
Gramian solvers.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np

from ...common.device import resolve_device
from ...ops.solver import Solver, SingularMatrixSolverException, get_solver
from .feature_vectors import FeatureVectorStore

__all__ = ["FactorModelBase", "SolverCache"]


class SolverCache:
    """Cached solver over a Gramian supplier, recomputed when dirty.

    Reference: SolverCache.java:35-150 — dirty flag, single in-flight
    recompute, blocking first get, non-blocking maybe-stale get
    thereafter.  ``device`` is where the solver's factor lives."""

    def __init__(self, vtv_supplier: Callable[[], np.ndarray], device=None):
        self._supplier = vtv_supplier
        self._device = device
        self._solver: Solver | None = None
        self._dirty = True
        self._in_flight = False
        self._cond = threading.Condition()

    def set_dirty(self) -> None:
        with self._cond:
            self._dirty = True

    def compute_now(self) -> None:
        with self._cond:
            if self._in_flight:
                # another thread is computing: wait for that attempt
                while self._in_flight:
                    self._cond.wait(60.0)
                return
            self._in_flight = True
            # cleared BEFORE computing: a set_dirty that lands during
            # the solve re-marks it, so no update is lost
            self._dirty = False
        solver = None
        failed = True
        try:
            try:
                solver = get_solver(self._supplier(), device=self._device)
            except SingularMatrixSolverException:
                solver = None
            failed = False
        finally:
            with self._cond:
                if solver is not None:
                    self._solver = solver
                if failed:
                    # an unexpected error propagates and leaves the cache
                    # dirty, so the next get recomputes
                    self._dirty = True
                self._in_flight = False
                self._cond.notify_all()

    def compute_async(self) -> None:
        with self._cond:
            if self._in_flight or not self._dirty:
                return
        threading.Thread(target=self.compute_now, daemon=True).start()

    def get(self, blocking: bool = True) -> Solver | None:
        """The current solver, recomputed synchronously when dirty and
        ``blocking``; None while the Gramian is singular."""
        with self._cond:
            needs_wait = self._dirty or (self._solver is None
                                         and self._in_flight)
        if needs_wait:
            if blocking:
                self.compute_now()
            else:
                self.compute_async()
        return self._solver


class FactorModelBase:
    """X/Y stores + expected-ID accounting + cached solvers."""

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
        self.cached_xtx_solver = SolverCache(self.X.vtv, self.device)
        self.cached_yty_solver = SolverCache(self.Y.vtv, self.device)

    # -- vectors ------------------------------------------------------------

    def get_user_vector(self, user_id: str) -> np.ndarray | None:
        return self.X.get_vector(user_id)

    def get_item_vector(self, item_id: str) -> np.ndarray | None:
        return self.Y.get_vector(item_id)

    def set_user_vector(self, user_id: str, vector: np.ndarray) -> None:
        self.X.set_vector(user_id, vector)
        self.cached_xtx_solver.set_dirty()
        with self._expected_lock:
            self._expected_user_ids.discard(user_id)

    def set_item_vector(self, item_id: str, vector: np.ndarray) -> None:
        self.Y.set_vector(item_id, vector)
        self.cached_yty_solver.set_dirty()
        with self._expected_lock:
            self._expected_item_ids.discard(item_id)

    # -- bulk artifact loads -------------------------------------------------

    def bulk_load_users(self, ids, matrix: np.ndarray) -> None:
        """set_user_vector for a whole artifact at once: one store
        write, one solver invalidation, one expected-ID sweep."""
        self.X.bulk_load(list(ids), matrix)
        self.cached_xtx_solver.set_dirty()
        with self._expected_lock:
            self._expected_user_ids.difference_update(ids)

    def bulk_load_items(self, ids, matrix: np.ndarray) -> None:
        """set_item_vector for a whole slice at once."""
        self.Y.bulk_load(list(ids), matrix)
        self.cached_yty_solver.set_dirty()
        with self._expected_lock:
            self._expected_item_ids.difference_update(ids)

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
        self.cached_xtx_solver.set_dirty()

    def retain_recent_and_item_ids(self, ids: Sequence[str]) -> None:
        self.Y.retain_recent_and_ids(ids)
        self.cached_yty_solver.set_dirty()

    def get_fraction_loaded(self) -> float:
        with self._expected_lock:
            expected = len(self._expected_user_ids) \
                + len(self._expected_item_ids)
        loaded = len(self.X) + len(self.Y)
        total = loaded + expected
        return 1.0 if total == 0 else loaded / total

    # -- solvers ------------------------------------------------------------

    def precompute_solvers(self) -> None:
        self.cached_xtx_solver.compute_async()
        self.cached_yty_solver.compute_async()

    def get_xtx_solver(self, blocking: bool = True) -> Solver | None:
        return self.cached_xtx_solver.get(blocking)

    def get_yty_solver(self, blocking: bool = True) -> Solver | None:
        return self.cached_yty_solver.get(blocking)

    def user_count(self) -> int:
        return len(self.X)

    def item_count(self) -> int:
        return len(self.Y)
