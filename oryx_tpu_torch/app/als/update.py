"""The ALS batch app: the MLUpdate over the torch trainer, and the
factor artifacts.

Counterpart of ``oryx_tpu/app/als/update.py`` (reference:
app/oryx-app-mllib/.../als/ALSUpdate.java — hyperparameters from the
config :84-101, buildModel :109-180 (parse, index, decay, aggregate,
factorize, PMML), evaluate :200-247 (implicit mean AUC, explicit
-RMSE), publishAdditionalModelData :287-319 (Y then X as UP records,
user rows with their known items), mfModelToPMML :430-473 (X and Y as
gzipped JSON text artifacts plus the XIDs/YIDs extensions), the
time-based splitNewDataToTrainTest :326-343, saveFeaturesRDD :490-499,
readFeaturesRDD :533-541).  A too-large model publishes its sliced
artifacts and a manifest with its MODEL-REF (``slices.py``), with
``oryx.als.ann.publish-index`` also the IVF index trained on the card
(centroids and per-slice cells).

Where ``oryx.batch.streaming.master`` and ``oryx.distributed.*`` give a
mesh (``parallel/mesh.mesh_from_config``), the candidates train over it
(``parallel/als_dist.train_als_distributed``), with the float64 rescue
for a diverged one.
"""

from __future__ import annotations

import functools
import gzip
import io
import json
import logging
import threading
import time
from typing import Sequence
from xml.etree.ElementTree import Element

import numpy as np

from ...common import pmml as pmml_io
from ...common import store
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KEY_UP, KeyMessage, TopicProducer
from ...ml import params as hp
from ...ml.integrity import NumericalDivergenceError, is_finite_array
from ...ml.mlupdate import MLUpdate
from ...parallel.als_dist import train_als_distributed
from ...parallel.mesh import mesh_from_config
from . import common as als_common
from . import evaluation
from . import slices
from .trainer import ALSModel, rescue_retrain_f64, train_als

_log = logging.getLogger(__name__)

__all__ = ["ALSUpdate", "save_features", "load_features"]


def save_features(path: str, ids: Sequence[str], matrix: np.ndarray) -> None:
    """Write a factor matrix as gzipped JSON lines ``["id",[floats]]``."""
    path = store.mkdirs(path)
    with store.open_write(store.join(path, "part-00000.gz")) as raw, \
            gzip.open(raw, "wt", encoding="utf-8") as f:
        for id_, row in zip(ids, matrix):
            f.write(text_utils.join_json(
                [id_, [round(float(v), 8) for v in row]]))
            f.write("\n")


def load_features(path: str) -> tuple[list[str], np.ndarray]:
    """Read a factor matrix directory written by save_features."""
    ids: list[str] = []
    rows: list[list[float]] = []
    for part in store.glob(path, "part-*"):
        with store.open_read(part) as raw:
            opener = gzip.open(raw, "rt", encoding="utf-8") \
                if part.endswith(".gz") \
                else io.TextIOWrapper(raw, encoding="utf-8")
            with opener as f:
                for line in f:
                    if line.strip():
                        id_, vector = json.loads(line)
                        ids.append(str(id_))
                        rows.append(vector)
    matrix = np.asarray(rows, dtype=np.float32) if rows else \
        np.zeros((0, 0), dtype=np.float32)
    return ids, matrix


def _timed(stage: str):
    """Add a method's seconds to ``self.stage_s[stage]``."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                self._stage(stage, t0)
        return timed
    return wrap


class ALSUpdate(MLUpdate):
    """Batch ALS: factor the full interaction history each generation,
    on ``device`` (None means ``cuda``).  ``stage_s`` sums the seconds
    of each stage of the candidates built so far: ``parse`` (events to
    ratings), ``train``, ``write`` (artifacts and PMML), ``evaluate``,
    ``validate`` and ``publish`` (slices or UP records)."""

    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.stage_s: dict[str, float] = {}
        self._stage_lock = threading.Lock()
        self.iterations = config.get_int("oryx.als.iterations")
        self.implicit = config.get_bool("oryx.als.implicit")
        self.log_strength = config.get_bool("oryx.als.logStrength")
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.decay_factor = config.get_double("oryx.als.decay.factor")
        self.decay_zero_threshold = config.get_double("oryx.als.decay.zero-threshold")
        # sharded model distribution (slices.py): murmur2 ring size for
        # the per-slice artifacts a too-large-to-inline model publishes
        # alongside its MODEL-REF; 0 disables (pure reference behavior)
        self.publish_slices = config.get_int("oryx.als.publish.slices")
        # the IVF index publish: train the coarse quantizer here and
        # ship centroids and per-slice cells with the sliced artifacts,
        # so a serving replica's index build skips the k-means
        self.publish_ann_index = config.get_bool(
            "oryx.als.ann.publish-index")
        from .ivf import AnnConfig
        self.ann_config = AnnConfig.from_config(config)
        if self.iterations <= 0:
            raise ValueError("iterations must be positive")
        if not 0.0 < self.decay_factor <= 1.0:
            raise ValueError("decay factor must be in (0,1]")
        if self.decay_zero_threshold < 0.0:
            raise ValueError("decay zero threshold must be >= 0")
        # the training mesh over several cards, joined across processes
        # by oryx.distributed.* (None: one device)
        self.mesh = mesh_from_config(config, self.device)
        self._hyper_params = [
            hp.from_config(config, "oryx.als.hyperparams.features"),
            hp.from_config(config, "oryx.als.hyperparams.lambda"),
            hp.from_config(config, "oryx.als.hyperparams.alpha"),
        ]
        if self.log_strength:
            self._hyper_params.append(
                hp.from_config(config, "oryx.als.hyperparams.epsilon"))

    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        return list(self._hyper_params)

    # -- train --------------------------------------------------------------

    def build_model(self, train_data, hyper_parameters, candidate_path) -> Element:
        features = int(hyper_parameters[0])
        lam = float(hyper_parameters[1])
        alpha = float(hyper_parameters[2])
        epsilon = float(hyper_parameters[3]) if self.log_strength else float("nan")
        if features <= 0 or lam < 0.0 or alpha <= 0.0:
            raise ValueError("bad hyperparameters")
        t0 = time.perf_counter()
        events = als_common.parse_events(train_data, self.decay_factor,
                                         self.decay_zero_threshold)
        ratings = als_common.aggregate(events, self.implicit,
                                       self.log_strength, epsilon)
        t0 = self._stage("parse", t0)
        try:
            if self.mesh is not None:
                model = train_als_distributed(
                    ratings, features, lam, alpha, self.implicit,
                    self.iterations, self.mesh)
                if not (is_finite_array(model.X)
                        and is_finite_array(model.Y)):
                    # the distributed trainer has no ladder in its loop:
                    # its diverged candidates get the float64 rescue
                    _log.warning("Distributed ALS diverged (features=%d "
                                 "lambda=%g); rescuing in float64 on the "
                                 "host", features, lam)
                    model = rescue_retrain_f64(ratings, features, lam,
                                               alpha, self.implicit,
                                               self.iterations)
            else:
                model = train_als(ratings, features, lam, alpha,
                                  self.implicit, self.iterations,
                                  device=self.device)
            self._stage("train", t0)
        except NumericalDivergenceError:
            # every rescue rung failed: a clean per-candidate failure —
            # the search skips it; one bad combo must not kill the sweep
            _log.exception("Candidate (features=%d lambda=%g) diverged "
                           "beyond rescue; skipping", features, lam)
            return None
        # cheap in-memory gate BEFORE the artifacts are written: the
        # rescue ladder should make this unreachable, and catching a
        # regression here costs one array pass instead of a round trip
        # through the gzipped artifacts
        if not (is_finite_array(model.X) and is_finite_array(model.Y)):
            _log.warning("Candidate (features=%d lambda=%g) produced "
                         "non-finite factors; skipping", features, lam)
            return None
        t0 = time.perf_counter()
        doc = self._model_to_pmml(model, features, lam, alpha, epsilon,
                                  candidate_path)
        self._stage("write", t0)
        return doc

    def _stage(self, name: str, t0: float) -> float:
        """Add the seconds since ``t0`` to stage ``name``; returns now."""
        t1 = time.perf_counter()
        with self._stage_lock:
            self.stage_s[name] = self.stage_s.get(name, 0.0) + (t1 - t0)
        return t1

    def _model_to_pmml(self, model: ALSModel, features: int, lam: float,
                       alpha: float, epsilon: float,
                       candidate_path: str) -> Element:
        """Ad-hoc factored-matrix serialization: the PMML carries pointers
        to the X/ Y/ artifact dirs plus the ID lists
        (reference: mfModelToPMML :430-473)."""
        save_features(store.join(candidate_path, "X"), model.user_ids, model.X)
        save_features(store.join(candidate_path, "Y"), model.item_ids, model.Y)
        doc = pmml_io.build_skeleton_pmml()
        pmml_io.add_extension(doc, "X", "X/")
        pmml_io.add_extension(doc, "Y", "Y/")
        pmml_io.add_extension(doc, "features", features)
        pmml_io.add_extension(doc, "lambda", lam)
        pmml_io.add_extension(doc, "implicit", self.implicit)
        if self.implicit:
            pmml_io.add_extension(doc, "alpha", alpha)
        pmml_io.add_extension(doc, "logStrength", self.log_strength)
        if self.log_strength:
            pmml_io.add_extension(doc, "epsilon", epsilon)
        if model.rescue is not None:
            # the generation records HOW it trained: precision rung and
            # any regularization escalation the rescue ladder took
            pmml_io.add_extension(doc, "rescue", json.dumps(model.rescue))
        pmml_io.add_extension_content(doc, "XIDs", model.user_ids)
        pmml_io.add_extension_content(doc, "YIDs", model.item_ids)
        return doc

    # -- evaluate -----------------------------------------------------------

    @_timed("evaluate")
    def evaluate(self, model: Element, candidate_path: str,
                 test_data, train_data) -> float:
        x_ids, X = load_features(store.join(candidate_path, "X"))
        y_ids, Y = load_features(store.join(candidate_path, "Y"))
        uidx = {u: j for j, u in enumerate(x_ids)}
        iidx = {i: j for j, i in enumerate(y_ids)}

        epsilon = float("nan")
        if self.log_strength:
            epsilon = float(pmml_io.get_extension_value(model, "epsilon"))
        events = als_common.parse_events(test_data, self.decay_factor,
                                         self.decay_zero_threshold)
        test = als_common.aggregate(events, self.implicit,
                                    self.log_strength, epsilon)
        # keep only test pairs whose user and item exist in the model
        users, items, values = [], [], []
        for u_i, i_i, v in zip(test.users, test.items, test.values):
            u_id = test.user_ids[u_i]
            i_id = test.item_ids[i_i]
            if u_id in uidx and i_id in iidx:
                users.append(uidx[u_id])
                items.append(iidx[i_id])
                values.append(v)
        if not users:
            return 0.0 if self.implicit else float("-inf")
        users = np.asarray(users, dtype=np.int32)
        items = np.asarray(items, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        if self.implicit:
            auc = evaluation.area_under_curve(X, Y, users, items,
                                              self.device)
            _log.info("AUC: %s", auc)
            return auc
        err = evaluation.rmse(X, Y, users, items, values, self.device)
        _log.info("RMSE: %s", err)
        return -err

    # -- pre-publish integrity ----------------------------------------------

    @_timed("validate")
    def validate_model(self, model: Element, candidate_path: str) -> bool:
        """The ARTIFACTS must be fully finite before the candidate is
        eligible to win publication: this validates what consumers will
        actually read (the in-memory factors are gated separately and
        cheaply in build_model), so a write-path corruption cannot ship.
        Cost is one load per candidate — the same class evaluate()
        already pays, and training dwarfs both."""
        for side in ("X", "Y"):
            _, matrix = load_features(store.join(candidate_path, side))
            if not is_finite_array(matrix):
                _log.warning("Candidate at %s has non-finite %s factors; "
                             "rejecting", candidate_path, side)
                return False
        return True

    # -- publish ------------------------------------------------------------

    def can_publish_additional_model_data(self) -> bool:
        return True

    @_timed("publish")
    def prepare_model_ref_payload(self, model, model_path: str,
                                  new_data, past_data) -> str:
        """Sharded distribution: a too-large model
        publishes per-slice item-factor artifacts + a manifest next to
        the PMML, and the MODEL-REF record carries the (slim) manifest
        so every consumer bulk-loads its murmur2 slices instead of
        replaying the full UP stream.  Known-items ride with the
        user-side artifact, so the whole per-row stream is replaced.
        Any write failure falls back to the bare-path payload — the
        UP stream then publishes as before (publish_additional checks
        for the manifest's presence, so the two stay consistent)."""
        if self.publish_slices < 1 or model is None:
            return model_path
        model_dir = model_path.rsplit("/", 1)[0]
        try:
            y_ids, Y = load_features(
                store.join(model_dir, pmml_io.get_extension_value(model, "Y")))
            x_ids, X = load_features(
                store.join(model_dir, pmml_io.get_extension_value(model, "X")))
            known = None
            if not self.no_known_items:
                all_events = als_common.parse_events(
                    list(new_data) + list(past_data), 1.0, 0.0)
                known = als_common.build_known_items(all_events)
            ann = None
            if self.publish_ann_index and len(y_ids):
                from ...ops import ann as ops_ann
                from . import ivf
                centroids = ivf.train_generation_centroids(
                    Y, self.ann_config, device=self.device)
                cells = ops_ann.assign_cells(Y, centroids,
                                             device=self.device)
                ann = (centroids, cells)
            slim = slices.publish_sliced(model_dir, y_ids, Y, x_ids, X,
                                         known, self.publish_slices,
                                         ann=ann)
            _log.info("Published sharded manifest: %d slices, %d items, "
                      "%d users at %s", self.publish_slices, len(y_ids),
                      len(x_ids), model_dir)
            return slices.model_ref_message(model_path, model_dir, slim)
        except OSError:
            _log.warning("Sharded slice publish failed; falling back to "
                         "the bare MODEL-REF + UP stream", exc_info=True)
            return model_path

    @_timed("publish")
    def publish_additional_model_data(self, model: Element, new_data, past_data,
                                      model_path: str,
                                      model_update_topic: TopicProducer) -> None:
        """Stream every factor row as an "UP" message — items first so
        user endpoints return complete results once they stop 404ing
        (reference: publishAdditionalModelData :287-319).  When the
        generation published a sharded manifest (prepare_model_ref
        wrote slices + X-with-known-items next to the model), the
        stream is fully replaced by bulk slice loads at the consumers
        and is skipped here — O(catalog) publish AND load both go."""
        if self.publish_slices >= 1 and store.exists(
                store.join(model_path, slices.MANIFEST_FILE)):
            _log.info("Sharded manifest present at %s; skipping the "
                      "Y/X UP stream", model_path)
            return
        y_rel = pmml_io.get_extension_value(model, "Y")
        y_ids, Y = load_features(store.join(model_path, y_rel))
        for id_, row in zip(y_ids, Y):
            model_update_topic.send(KEY_UP, text_utils.join_json(
                ["Y", id_, [float(v) for v in row]]))

        x_rel = pmml_io.get_extension_value(model, "X")
        x_ids, X = load_features(store.join(model_path, x_rel))
        if self.no_known_items:
            for id_, row in zip(x_ids, X):
                model_update_topic.send(KEY_UP, text_utils.join_json(
                    ["X", id_, [float(v) for v in row]]))
        else:
            all_events = als_common.parse_events(
                list(new_data) + list(past_data), 1.0, 0.0)
            known = als_common.build_known_items(all_events)
            for id_, row in zip(x_ids, X):
                model_update_topic.send(KEY_UP, text_utils.join_json(
                    ["X", id_, [float(v) for v in row],
                     sorted(known.get(id_, ()))]))

    # -- split --------------------------------------------------------------

    def split_new_data_to_train_test(self, new_data):
        """Split solely on time: earliest (1 - test_fraction) of the
        timestamp range trains, the most recent tail tests
        (reference: splitNewDataToTrainTest :326-343)."""
        def ts(km: KeyMessage) -> int:
            return als_common.parse_timestamp(
                text_utils.parse_input_line(km.message))

        stamps = [ts(km) for km in new_data]
        min_t, max_t = min(stamps), max(stamps)
        boundary = max_t - self.test_fraction * (max_t - min_t)
        train = [km for km, t in zip(new_data, stamps) if t < boundary]
        test = [km for km, t in zip(new_data, stamps) if t >= boundary]
        return train, test
