"""ALS speed layer: the in-memory factor model and the micro-batch
fold-in.

Counterpart of ``oryx_tpu/app/als/speed.py`` (reference: app/oryx-app/
.../speed/als/ALSSpeedModel.java:40-183 — X and Y vectors, expected-ID
accounting, cached X^T X and Y^T Y solvers — and
ALSSpeedModelManager.java:60-231 — consume MODEL and UP; buildUpdates:
timestamp order, delete-aware aggregation, one fold-in per event).
``build_updates`` aggregates the micro-batch on the host, then folds
every user-side update in one batched solve and every item-side update
in another (``ops/als_fold_in.fold_in_batch``), on the card that holds
the Gramian solvers.  With ``oryx.speed.shard = "i/N"`` the model stays
whole (the solvers need the whole catalog, and every UP record is
applied) but ``build_updates`` folds only the events whose item this
worker owns on the murmur2 ring, so N workers split the fold-in by item
slice as serving replicas split scoring.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Sequence

import numpy as np

from ...api.speed import AbstractSpeedModelManager, SpeedModel
from ...cluster.sharding import is_local_item, parse_shard_spec
from ...common import pmml as pmml_io
from ...common import store
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...common.lang import RateLimitCheck
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP, KeyMessage
from ...ops import als_fold_in
from ..pmml_utils import read_pmml_from_update_key_message
from . import common as als_common
from . import slices
from .factor_model import FactorModelBase

_log = logging.getLogger(__name__)

__all__ = ["ALSSpeedModel", "ALSSpeedModelManager"]


class ALSSpeedModel(FactorModelBase, SpeedModel):
    """User and item factor stores with cached Gramian solvers, on
    ``device`` (None means ``cuda``)."""

    def __init__(self, features: int, implicit: bool, log_strength: bool,
                 epsilon: float, device=None):
        super().__init__(features, implicit, device=device)
        self.log_strength = log_strength
        self.epsilon = epsilon

    def __repr__(self):  # pragma: no cover
        return (f"ALSSpeedModel[features:{self.features}, "
                f"X:({len(self.X)} users), Y:({len(self.Y)} items)]")


class ALSSpeedModelManager(AbstractSpeedModelManager):
    """Consumes MODEL, MODEL-REF and UP messages; folds new input into
    factor deltas.  ``device=None`` means ``cuda``: the manager builds
    every model there."""

    def __init__(self, config: Config, device=None):
        self.device = resolve_device(device)
        self.model: ALSSpeedModel | None = None
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.min_model_load_fraction = config.get_double(
            "oryx.speed.min-model-load-fraction")
        if not 0.0 <= self.min_model_load_fraction <= 1.0:
            raise ValueError("min-model-load-fraction must be in [0,1]")
        # ring-sharded fold-in (oryx.speed.shard = "i/N"): events whose
        # item another worker owns are counted and left to it
        shard_spec = config.get_optional_string("oryx.speed.shard")
        self.shard_index, self.shard_count = (
            parse_shard_spec(shard_spec) if shard_spec else (0, 1))
        self.skipped_remote_events = 0
        self._log_rate_limit = RateLimitCheck(60.0)
        # integrity counters (as the serving manager's)
        self.rejected_updates = 0
        self.rejected_models = 0
        # the speed layer folds against the whole catalog, so it
        # bulk-loads every slice a MODEL-REF's manifest names
        self.slice_loads = 0
        self.slice_load_fallbacks = 0
        self.model_load_s = 0.0

    # -- consume -------------------------------------------------------------

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            if self.model is None:
                return  # no model to interpret with yet
            parsed = als_common.parse_up_update(message,
                                                self.model.features)
            if parsed is None:
                # malformed, wrong-dimension or non-finite payload,
                # refused at the trust boundary
                self.rejected_updates += 1
                return
            kind, id_, vector, _extras = parsed
            if kind == "X":
                self.model.set_user_vector(id_, vector)
            elif kind == "Y":
                self.model.set_item_vector(id_, vector)
            else:
                raise ValueError(f"Bad message: {message}")
            if self._log_rate_limit.test():
                _log.info("%s", self.model)
        elif key in (KEY_MODEL, KEY_MODEL_REF):
            self._consume_model(key, message)
        else:
            raise ValueError(f"Bad key: {key}")

    def _consume_model(self, key: str, message: str) -> None:
        _log.info("Loading new model")
        t_model = time.monotonic()
        model_dir = manifest = None
        if key == KEY_MODEL_REF:
            path, model_dir, manifest = slices.parse_model_ref(message)
            if model_dir is None:
                model_dir = path.rsplit("/", 1)[0]
        pmml = read_pmml_from_update_key_message(key, message)
        if pmml is None:
            self.rejected_models += 1
            _log.warning("Model document unavailable or corrupt; "
                         "keeping current model")
            return
        try:
            features = int(pmml_io.get_extension_value(pmml, "features"))
        except (TypeError, ValueError):
            self.rejected_models += 1
            _log.warning("Model document failed validation; keeping "
                         "current model")
            return
        implicit = pmml_io.get_extension_value(pmml, "implicit") == "true"
        log_strength = pmml_io.get_extension_value(
            pmml, "logStrength") == "true"
        epsilon = (float(pmml_io.get_extension_value(pmml, "epsilon"))
                   if log_strength else float("nan"))
        if self.model is None or features != self.model.features:
            _log.warning("No previous model, or # features changed; "
                         "creating new one")
            self.model = ALSSpeedModel(features, implicit, log_strength,
                                       epsilon, device=self.device)
        x_ids = pmml_io.get_extension_content(pmml, "XIDs") or []
        y_ids = pmml_io.get_extension_content(pmml, "YIDs") or []
        self.model.set_expected_ids(x_ids, y_ids)
        self.model.retain_recent_and_user_ids(x_ids)
        self.model.retain_recent_and_item_ids(y_ids)
        if manifest is not None:
            self._load_from_manifest(model_dir, manifest)
            self.model_load_s = round(time.monotonic() - t_model, 6)
        _log.info("Model updated: %s", self.model)

    def _load_from_manifest(self, model_dir: str, manifest: dict) -> None:
        """Bulk-load every slice and the user artifact (the speed model
        is never sharded); a bad slice falls back to the monolithic
        artifacts, as the serving manager does."""
        try:
            features = self.model.features
            for entry in manifest["slices"]:
                ids, matrix, _ordinals = slices.read_slice(
                    model_dir, entry, features)
                if ids:
                    self.model.bulk_load_items(ids, matrix)
            x_ids, X, _known = slices.read_x_known(
                model_dir, manifest["x"], features)
            if x_ids:
                self.model.bulk_load_users(x_ids, X)
            self.slice_loads += len(manifest["slices"])
        except (slices.SliceIntegrityError, OSError, KeyError, IndexError,
                TypeError, ValueError) as e:
            self.slice_load_fallbacks += 1
            _log.warning("Speed slice load failed (%s); falling back to "
                         "the monolithic artifacts", e)
            from .update import load_features
            try:
                y_ids2, Y = load_features(store.join(model_dir, "Y"))
                if y_ids2:
                    self.model.bulk_load_items(y_ids2, Y)
                x_ids2, X2 = load_features(store.join(model_dir, "X"))
                if x_ids2:
                    self.model.bulk_load_users(x_ids2, X2)
            except (OSError, ValueError) as e2:
                _log.error("Monolithic artifact fallback also failed "
                           "(%s); the speed model stays below the fold-in "
                           "gate until the store returns", e2)

    # -- produce -------------------------------------------------------------

    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        model = self.model
        if model is None or \
                model.get_fraction_loaded() < self.min_model_load_fraction:
            return []
        model.precompute_solvers()

        events = als_common.parse_events(new_data)
        if self.shard_count > 1:
            owned = [ev for ev in events
                     if is_local_item(ev[1], self.shard_index,
                                      self.shard_count)]
            self.skipped_remote_events += len(events) - len(owned)
            events = owned
        agg = als_common.aggregate(events, model.implicit,
                                   model.log_strength, model.epsilon)
        if len(agg.values) == 0:
            return []

        # get() returns None while a Gramian is still singular: not
        # enough data yet
        xtx = model.cached_xtx_solver.get(blocking=True)
        yty = model.cached_yty_solver.get(blocking=True)
        if xtx is None or yty is None:
            _log.info("No solver available yet for model; skipping inputs")
            return []

        n = len(agg.values)
        k = model.features
        xu = np.full((n, k), np.nan, dtype=np.float32)
        yi = np.full((n, k), np.nan, dtype=np.float32)
        user_names = [agg.user_ids[u] for u in agg.users]
        item_names = [agg.item_ids[i] for i in agg.items]
        for j, (u_name, i_name) in enumerate(zip(user_names, item_names)):
            xv = model.get_user_vector(u_name)
            if xv is not None:
                xu[j] = xv
            yv = model.get_item_vector(i_name)
            if yv is not None:
                yi[j] = yv

        # each side one batched solve on the solvers' card
        new_xu, x_valid = als_fold_in.fold_in_batch(
            yty, agg.values, xu, yi, model.implicit)
        new_yi, y_valid = als_fold_in.fold_in_batch(
            xtx, agg.values, yi, xu, model.implicit)

        out: list[str] = []
        for j in range(n):
            if x_valid[j]:
                out.append(self._to_update_json(
                    "X", user_names[j], new_xu[j], item_names[j]))
            if y_valid[j]:
                out.append(self._to_update_json(
                    "Y", item_names[j], new_yi[j], user_names[j]))
        return out

    def _to_update_json(self, matrix: str, id_: str, vector: np.ndarray,
                        other_id: str) -> str:
        vec = [float(v) for v in vector]
        if self.no_known_items:
            return text_utils.join_json([matrix, id_, vec])
        return text_utils.join_json([matrix, id_, vec, [other_id]])
