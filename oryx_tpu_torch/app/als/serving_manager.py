"""ALS serving model manager: replays the update topic into the serving
model.

Counterpart of ``oryx_tpu/app/als/serving_manager.py`` (reference:
ALSServingModelManager.java:45-160 — UP handling with known items
:70-105, the solver trigger at the load fraction :96-103, MODEL and
MODEL-REF handling with the retain logic :107-130, the rescorer
providers of ``oryx.als.rescorer-provider-class`` :120-137).  It serves
the catalog shard ``oryx.cluster.shard`` (``i/N``; ``0/1``, the whole
catalog, unless ``oryx.cluster.enabled``): Y vectors whose id hashes to
another shard are skipped, while the user store and the known items stay
whole.  Every Y record advances the cluster's item ordinals (the merge's
tie-break) before the shard filter, from the manifest's total item count
on a slice load, so every replica assigns the same ordinal to the same
id; a slice load keeps its owned slices' manifest Gramians for
``/shard/yty``.  The measured-cost kernel
route is installed when the load fraction crosses
``oryx.serving.min-model-load-fraction`` and re-checked on every MODEL
(a no-op while the store's capacity is unchanged).  With
``oryx.als.ann.enabled`` each generation gets an IVF index
(reference :415-516): built from the trainer's published centroids and
per-slice cells where the manifest names them, else trained here; its
recall certificate is measured before the route, and any failure serves
the exact kinds and counts ``ann_index_fallbacks``.
``oryx.serving.api.item-shards`` (a power of two) row-shards the item
store over that many cards (reference :50-63, :244); a sharded model
builds no IVF index (:448).
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ...api.serving import AbstractServingModelManager
from ...cluster.membership import KEY_HEARTBEAT
from ...cluster.sharding import is_local_item, parse_shard_spec
from ...common import pmml as pmml_io
from ...common import store
from ...common.device import resolve_device
from ...common.lang import RateLimitCheck
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from ..pmml_utils import read_pmml_from_update_key_message
from . import common as als_common
from . import ivf
from . import slices
from .feature_vectors import resolve_dtype
from .rescorer import load_rescorer_providers
from .serving_model import ALSServingModel

_log = logging.getLogger(__name__)

__all__ = ["ALSServingModelManager"]


class ALSServingModelManager(AbstractServingModelManager):
    """``device=None`` means ``cuda``: the manager builds every model on
    it (there is no config key for the device, as the reference has
    none)."""

    def __init__(self, config, device=None):
        super().__init__(config)
        # without a card, fail at boot, not on the consumer thread at
        # the first MODEL
        resolve_device(device)
        self.device = device
        self.model: ALSServingModel | None = None
        self._triggered_solver = False
        self.rescorer_provider = load_rescorer_providers(
            config.get_optional_string("oryx.als.rescorer-provider-class"))
        # parsed and validated at boot, as every serving knob
        self.ann_config = ivf.AnnConfig.from_config(config)
        # the item matrix row-sharded over a mesh of cards (1: one card)
        self.item_shards = config.get_int("oryx.serving.api.item-shards")
        if self.item_shards < 1 or (self.item_shards
                                    & (self.item_shards - 1)):
            raise ValueError("item-shards must be a power of two >= 1")
        self.sample_rate = config.get_double("oryx.als.sample-rate")
        self.factor_dtype = config.get_string("oryx.als.factor-dtype")
        self.int8_selection = config.get_string(
            "oryx.serving.api.int8-selection")
        if self.int8_selection not in ("auto", "true", "false"):
            raise ValueError("int8-selection must be auto/true/false")
        self.fold_scan = config.get_string("oryx.serving.api.fold-scan")
        if self.fold_scan not in ("auto", "true", "false"):
            raise ValueError("fold-scan must be auto/true/false")
        # fail at boot, not on the consumer thread at the first MODEL
        resolve_dtype(self.factor_dtype)
        self.min_model_load_fraction = config.get_double(
            "oryx.serving.min-model-load-fraction")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError("sample-rate must be in (0,1]")
        self._log_rate_limit = RateLimitCheck(60.0)
        # integrity counters: poison payloads refused, not absorbed
        self.rejected_updates = 0
        self.rejected_models = 0
        # -- serving-cluster state (cluster/) ----------------------------
        # the catalog shard this replica materializes ("0/1" = the whole
        # catalog, plain single-node serving)
        spec = (config.get_optional_string("oryx.cluster.shard")
                if config.get_bool("oryx.cluster.enabled") else None)
        self.shard_index, self.shard_count = parse_shard_spec(spec or "0/1")
        # accepted MODEL/MODEL-REF documents since offset 0: the
        # replica's model generation, identical across replicas of the
        # totally ordered topic, carried in heartbeats
        self.generation = 0
        # item id -> first-appearance index in the Y update stream: the
        # cluster's canonical tie-break ordinal (cluster/merge.py),
        # counting every Y id seen, those this shard skips included
        self.item_ordinals: dict[str, int] = {}
        # the next ordinal: not len(item_ordinals), since a slice-loaded
        # replica holds its local slices' ordinals only — it advances
        # from the manifest's total item count
        self._ordinal_next = 0
        # Y vectors skipped as another shard's
        self.skipped_remote_items = 0
        # the owned slices' summed manifest Gramians: /shard/yty answers
        # from them without a device scan until a Y write lands
        self._slice_yty: np.ndarray | None = None
        # slices bulk-loaded, and fallbacks to the monolithic artifacts
        self.slice_loads = 0
        self.slice_load_fallbacks = 0
        # artifact bytes the last slice load read (the model_slice_bytes
        # gauge)
        self.model_slice_bytes = 0
        # seconds from MODEL(-REF) receipt to a servable model: the
        # artifact paths stamp it when their load crosses the serving
        # gate, the replay path when the UP stream does
        self.model_load_s = 0.0
        self._model_received_at: float | None = None
        # the IVF index: card bytes of the current generation's mirror,
        # and generations that failed closed to the exact kinds (corrupt
        # artifact, failed build or recall measurement)
        self.ann_index_bytes = 0
        self.ann_index_fallbacks = 0
        # the generation's published index, collected during the slice
        # load for _maybe_build_ann
        self._ann_centroid_entry: dict | None = None
        self._ann_cells_by_id: dict[str, int] = {}
        self._ann_artifacts_broken = False

    def get_model(self) -> ALSServingModel | None:
        return self.model

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            self._consume_up(message)
        elif key in (KEY_MODEL, KEY_MODEL_REF):
            self._consume_model(key, message)
        elif key == KEY_HEARTBEAT:
            # cluster control plane on the shared update topic: the
            # layers' consumers filter it, this guard covers direct
            # manager drives
            return
        else:
            raise ValueError(f"Bad key: {key}")

    def _consume_up(self, message: str) -> None:
        model = self.model
        if model is None:
            return  # no model to interpret with yet
        parsed = als_common.parse_up_update(message, model.features)
        if parsed is None:
            self.rejected_updates += 1
            return
        kind, id_, vector, extras = parsed
        if kind == "X":
            model.set_user_vector(id_, vector)
            if extras is not None:
                model.add_known_items(id_, [str(i) for i in extras])
        elif kind == "Y":
            # the ordinal comes before the shard filter, and the counter
            # advances for every Y record (a slice-loaded replica cannot
            # tell a remote manifest item from a new one), so every
            # replica assigns the same ordinal to the same id;
            # setdefault keeps a known id's ordinal
            self.item_ordinals.setdefault(id_, self._ordinal_next)
            self._ordinal_next += 1
            if is_local_item(id_, self.shard_index, self.shard_count):
                model.set_item_vector(id_, vector)
                # a live Y write outdates the manifest's Gramian
                self._slice_yty = None
            else:
                self.skipped_remote_items += 1
        else:
            raise ValueError(f"Bad message: {message}")
        # outside the log rate limiter: a replay that ends inside one
        # 60 s window must not serve without solvers or a measured route
        if (not self._triggered_solver
                and model.get_fraction_loaded()
                >= self.min_model_load_fraction):
            self._triggered_solver = True
            if self._model_received_at is not None:
                self.model_load_s = round(
                    time.monotonic() - self._model_received_at, 6)
                self._model_received_at = None
            model.precompute_solvers()
            # replay-loaded factors: build the IVF index and measure its
            # certificate before the route, which then times the chain
            # the index may join
            self._maybe_build_ann(None)
            # time each eligible kernel path for the live shape so that
            # serving routes by measured cost (re-measures only if the
            # padded capacity changed)
            model.refresh_route()
        if self._log_rate_limit.test():
            _log.info("%s", model)

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
        x_ids = list(pmml_io.get_extension_content(pmml, "XIDs") or [])
        y_ids = list(pmml_io.get_extension_content(pmml, "YIDs") or [])
        # a shard counts and retains its local items only; the known
        # items keep the global id universe (exclusion works by id)
        local_y = [i for i in y_ids
                   if is_local_item(i, self.shard_index, self.shard_count)] \
            if self.shard_count > 1 else y_ids
        if self.model is None or features != self.model.features:
            _log.warning("No previous model, or # features changed; "
                         "creating new one")
            # a replacement model re-fires the solver and route trigger
            # at its own load fraction
            self._triggered_solver = False
            model = ALSServingModel(
                features, implicit, self.sample_rate,
                self.rescorer_provider,
                dtype=self.factor_dtype, device=self.device,
                int8_selection=self.int8_selection,
                fold_scan=self.fold_scan, item_shards=self.item_shards)
            # its expected ids before it is published: an empty model
            # reads as wholly loaded, and /ready and the replica's
            # heartbeat would call it ready (the reference publishes
            # the model first)
            model.set_expected_ids(x_ids, local_y)
            self.model = model
        else:
            self.model.set_expected_ids(x_ids, local_y)
        _log.info("Updating model")
        self.model.retain_recent_and_known_items(x_ids, y_ids)
        self.model.retain_recent_and_user_ids(x_ids)
        self.model.retain_recent_and_item_ids(local_y)
        self.generation += 1
        self._model_received_at = t_model
        # a new generation outdates the held manifest Gramian; a slice
        # load below sets the fresh one
        self._slice_yty = None
        # the previous generation's published index is stale
        self._ann_centroid_entry = None
        self._ann_cells_by_id = {}
        self._ann_artifacts_broken = False
        if manifest is not None:
            # bulk-load the slices; a bad slice falls back to the
            # monolithic artifacts — ready either way
            self._load_from_manifest(model_dir, manifest)
        # the IVF index is built inside the load clock (it is part of
        # serving at the advertised cost) and before the route, which
        # then times the "ivf" kind
        self._maybe_build_ann(model_dir)
        if (self._model_received_at is not None
                and self.model.get_fraction_loaded()
                >= self.min_model_load_fraction):
            # the artifacts alone crossed the serving gate: stamp the
            # load clock before the route measurement and the solvers
            self.model_load_s = round(time.monotonic() - t_model, 6)
            self._model_received_at = None
        # hot-swap: the new generation may have regrown the store
        self.model.refresh_route()
        if (not self._triggered_solver
                and self.model.get_fraction_loaded()
                >= self.min_model_load_fraction):
            # no UP flood follows to fire the trigger
            self._triggered_solver = True
            self.model.precompute_solvers()
        _log.info("Model updated: %s", self.model)

    def _load_from_manifest(self, model_dir: str, manifest: dict) -> None:
        """Bulk-load this shard's slices and the user artifact; any
        integrity failure falls back to :meth:`_load_full_artifacts` and
        counts ``slice_load_fallbacks``."""
        try:
            ring = int(manifest["ring"])
            owned = slices.owned_slices(ring, self.shard_index,
                                        self.shard_count)
            if owned is None:
                raise slices.SliceIntegrityError(
                    f"slice ring {ring} incompatible with shard count "
                    f"{self.shard_count} (pick a ring the shard count "
                    f"divides)")
            features = self.model.features
            total_bytes = 0
            gramian = np.zeros((features, features), dtype=np.float64)
            # the Gramians live in the store's manifest only (the
            # topic's copy leaves them out); without them /shard/yty
            # scans the store
            full = slices.read_manifest(model_dir)
            grams = (full or {}).get("gramians")
            entries = {int(e["slice"]): e for e in manifest["slices"]}
            self._ann_centroid_entry = manifest.get("ann")
            for s in owned:
                ids, matrix, ordinals = slices.read_slice(
                    model_dir, entries[s], features)
                if ids:
                    self.model.bulk_load_items(ids, matrix)
                    self.item_ordinals.update(zip(ids, ordinals))
                total_bytes += int(entries[s].get("bytes", 0))
                if grams is not None:
                    gramian += np.asarray(grams[s], dtype=np.float64)
                self._collect_slice_ann(model_dir, entries[s], ids)
            x_ids, X, known = slices.read_x_known(
                model_dir, manifest["x"], features)
            if x_ids:
                self.model.bulk_load_users(x_ids, X)
                for uid, items in zip(x_ids, known):
                    if items:
                        self.model.add_known_items(uid, items)
            total_bytes += int(manifest["x"].get("bytes", 0))
            self._ordinal_next = max(self._ordinal_next,
                                     int(manifest["items"]))
            self.slice_loads += len(owned)
            self.model_slice_bytes = total_bytes
            self._slice_yty = gramian if grams is not None else None
            _log.info("Slice-loaded %d/%d slices (%d items, %d users, %d "
                      "bytes) for shard %d/%d", len(owned), ring,
                      len(self.model.Y), len(self.model.X), total_bytes,
                      self.shard_index, self.shard_count)
        except (slices.SliceIntegrityError, OSError, KeyError, IndexError,
                TypeError, ValueError) as e:
            self.slice_load_fallbacks += 1
            self._slice_yty = None
            # a failed slice load discredits the manifest and its index
            # artifacts: the IVF build trains here over what the fallback
            # loads
            self._ann_centroid_entry = None
            self._ann_cells_by_id = {}
            _log.warning("Slice load failed (%s); falling back to the "
                         "monolithic artifacts", e)
            self._load_full_artifacts(model_dir)

    def _load_full_artifacts(self, model_dir: str) -> None:
        """The fallback: the monolithic ``Y``/``X`` artifacts the
        publisher also writes, filtered to this shard, with ordinals by
        artifact position — the state a full-stream replay builds (the
        artifact order is the stream order)."""
        from .update import load_features
        try:
            y_ids, Y = load_features(store.join(model_dir, "Y"))
            local = [j for j, iid in enumerate(y_ids)
                     if is_local_item(iid, self.shard_index,
                                      self.shard_count)]
            if local:
                self.model.bulk_load_items(
                    [y_ids[j] for j in local], Y[local])
            self.skipped_remote_items += len(y_ids) - len(local)
            for j, iid in enumerate(y_ids):
                self.item_ordinals.setdefault(iid, j)
            self._ordinal_next = max(self._ordinal_next, len(y_ids))
            x_ids, X = load_features(store.join(model_dir, "X"))
            if x_ids:
                self.model.bulk_load_users(x_ids, X)
            _log.info("Fallback-loaded monolithic artifacts: %d local "
                      "items, %d users", len(local), len(x_ids))
        except (OSError, ValueError) as e:
            # the store is unreachable: the model stays below the
            # serving gate — log, don't die
            _log.error("Monolithic artifact fallback also failed (%s); "
                       "the model will not reach ready until the store "
                       "returns", e)

    # -- the IVF index (ivf.py) ----------------------------------------------

    def _collect_slice_ann(self, model_dir: str, entry: dict,
                           ids: list[str]) -> None:
        """Read one owned slice's published cell assignments.  A corrupt
        or missing index artifact (chaos point ``ann-index-corrupt``)
        never fails the slice load (the factors are intact) but marks
        the generation's published index broken, so ``_maybe_build_ann``
        fails closed to the exact kinds."""
        aent = entry.get("ann")
        if aent is None or not self.ann_config.enabled \
                or self._ann_artifacts_broken:
            return
        try:
            cells = ivf.read_slice_cells(model_dir, aent)
            self._ann_cells_by_id.update(zip(ids, cells))
        except ivf.AnnIndexError as e:
            self._ann_artifacts_broken = True
            _log.warning("ANN index artifact unusable (%s); this "
                         "generation will serve on the exact kinds", e)

    def _maybe_build_ann(self, model_dir: str | None) -> None:
        """Build the generation's IVF index and measure its recall
        certificate against the exact kernel (``ivf.measure_recall``),
        before the route.  Published artifacts (centroids and per-slice
        cells) skip the k-means training here; any failure fails closed
        to the exact kinds with ``ann_index_fallbacks``: the index is an
        optimization, never a readiness gate."""
        cfg = self.ann_config
        model = self.model
        if not cfg.enabled or model is None or model._item_shards > 1 \
                or len(model.Y) == 0:
            return
        try:
            if self._ann_artifacts_broken:
                raise ivf.AnnIndexError(
                    "published index artifacts unreadable")
            cells = None
            if self._ann_centroid_entry is not None \
                    and model_dir is not None:
                centroids = ivf.read_centroids(
                    model_dir, self._ann_centroid_entry)
                cells = self._published_cells()
            else:
                yv, ya, _ids = model.Y.host_arrays()
                centroids = ivf.train_generation_centroids(
                    yv[ya][:, :model.features], cfg, device=model.device)
            state = ivf.AnnState(cfg, centroids, cells=cells)
            model.attach_ann(state)
            vecs, active, version = model.Y.device_arrays_versioned()
            mirror = model._cached_ivf(vecs, active, version)
            state.recall = ivf.measure_recall(model, mirror, cfg)
            self.ann_index_bytes = mirror.index_bytes
            if state.recall < cfg.min_recall:
                _log.warning(
                    "IVF recall certificate failed for generation %d: "
                    "recall@%d %.4f < min-recall %.2f; serving stays on "
                    "the exact kinds", self.generation, cfg.recall_at,
                    state.recall, cfg.min_recall)
            else:
                _log.info(
                    "IVF index ready for generation %d: %d cells, nprobe "
                    "%d, recall@%d %.4f, %d bytes", self.generation,
                    int(state.centroids.shape[0]), cfg.nprobe,
                    cfg.recall_at, state.recall, mirror.index_bytes)
        except Exception as e:  # noqa: BLE001 — fail closed to exact
            self.ann_index_fallbacks += 1
            self.ann_index_bytes = 0
            model.attach_ann(None)
            _log.warning("IVF index build failed (%s); generation %d "
                         "serves on the exact kinds", e, self.generation)

    def _published_cells(self) -> np.ndarray | None:
        """The published cell assignments in the store's row slots, or
        None where a row is not named (the mirror build then assigns on
        the device, which is always right)."""
        by_id = self._ann_cells_by_id
        if not by_id:
            return None
        row_ids = self.model.Y.row_ids()
        cells = np.zeros(len(row_ids), dtype=np.int32)
        for i, rid in enumerate(row_ids):
            if rid is None:
                continue
            c = by_id.get(rid)
            if c is None:
                return None
            cells[i] = c
        return cells

    def partial_yty(self) -> np.ndarray | None:
        """This shard's Gramian from the manifest's per-slice partials
        (``/shard/yty`` then answers without a device scan), or None
        when none is held: a replay-loaded model, a Y write since the
        load, or a manifest without Gramians."""
        g = self._slice_yty
        return None if g is None else np.asarray(g, dtype=np.float64)
