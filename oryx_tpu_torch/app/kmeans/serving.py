"""The k-means serving model and its manager.

Counterpart of ``oryx_tpu/app/kmeans/serving.py`` (reference:
KMeansServingModel.java:34 — the cluster list and closestCluster, an UP
replacing a cluster's center and count; KMeansServingModelManager.java:38
— UP, MODEL and MODEL-REF).  One datum is assigned by a host loop over
the clusters; a POSTed batch in one product on the manager's device
(None means ``cuda``).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from ...api.serving import AbstractServingModelManager, ServingModel
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from ..pmml_utils import read_pmml_from_update_key_message
from ..schema import InputSchema
from . import pmml as kmeans_pmml
from .common import (ClusterInfo, assign_points, closest_cluster,
                     features_from_tokens, parse_to_matrix)

_log = logging.getLogger(__name__)

__all__ = ["KMeansServingModel", "KMeansServingModelManager"]


class KMeansServingModel(ServingModel):

    def __init__(self, clusters: list[ClusterInfo],
                 input_schema: InputSchema, device=None):
        ids = [c.id for c in clusters]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate cluster IDs")
        self._clusters: dict[int, ClusterInfo] = {c.id: c for c in clusters}
        self.input_schema = input_schema
        self.device = resolve_device(device)
        self._lock = threading.Lock()

    @property
    def clusters(self) -> list[ClusterInfo]:
        with self._lock:
            return [self._clusters[i] for i in sorted(self._clusters)]

    @property
    def num_clusters(self) -> int:
        with self._lock:
            return len(self._clusters)

    def get_cluster(self, cluster_id: int) -> ClusterInfo:
        with self._lock:
            return self._clusters[cluster_id]

    def nearest_cluster_id(self, tokens: list[str]) -> int:
        if len(tokens) != self.input_schema.num_features:
            raise ValueError("Wrong number of features")
        vec = features_from_tokens(tokens, self.input_schema)
        return self.closest_cluster(vec)[0].id

    def nearest_cluster_ids(self, rows: list[list[str]]) -> list[int]:
        """Assignment of a POSTed batch in one product on the device."""
        for tokens in rows:
            if len(tokens) != self.input_schema.num_features:
                raise ValueError("Wrong number of features")
        points = parse_to_matrix(rows, self.input_schema)
        clusters = self.clusters
        centers = np.stack([c.center for c in clusters]).astype(np.float32)
        idx, _ = assign_points(points, centers, device=self.device)
        return [clusters[i].id for i in idx]

    def closest_cluster(self, vector) -> tuple[ClusterInfo, float]:
        return closest_cluster(self.clusters, vector)

    def update(self, cluster_id: int, center, count: int) -> None:
        """An UP replaces the cluster wholesale."""
        with self._lock:
            self._clusters[cluster_id] = ClusterInfo(cluster_id, center,
                                                     count)

    def get_fraction_loaded(self) -> float:
        return 1.0

    def __repr__(self):  # pragma: no cover
        return f"KMeansServingModel[clusters:{self.num_clusters}]"


class KMeansServingModelManager(AbstractServingModelManager):

    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.input_schema = InputSchema(config)
        self.model: KMeansServingModel | None = None

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            if self.model is None:
                return  # no model to apply the update to yet
            update = text_utils.read_json(message)
            self.model.update(int(update[0]),
                              [float(v) for v in update[1]],
                              int(update[2]))
            return
        if key in (KEY_MODEL, KEY_MODEL_REF):
            pmml = read_pmml_from_update_key_message(key, message)
            if pmml is None:
                return
            kmeans_pmml.validate_pmml_vs_schema(pmml, self.input_schema)
            self.model = KMeansServingModel(
                kmeans_pmml.read_clusters(pmml), self.input_schema,
                device=self.device)
            _log.info("New model: %s", self.model)
            return
        raise ValueError(f"Bad key: {key}")

    def get_model(self) -> KMeansServingModel | None:
        return self.model
