"""The k-means speed layer: incremental cluster-center updates.

Counterpart of ``oryx_tpu/app/kmeans/speed.py`` (reference:
KMeansSpeedModel.java:31, the cluster list, and
KMeansSpeedModelManager.java:79 — per micro-batch, assign each input
point to its closest cluster, take each cluster's mean and count of new
points, apply the moving-average ``ClusterInfo.update`` and emit
``[clusterId, center, count]`` JSON updates; "UP" messages are the
layer's own and are ignored).  The assignment is one batched product on
the manager's device (None means ``cuda``).
"""

from __future__ import annotations

import logging
from typing import Iterable, Sequence

import numpy as np

from ...api.speed import AbstractSpeedModelManager, SpeedModel
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP, KeyMessage
from ..pmml_utils import read_pmml_from_update_key_message
from ..schema import InputSchema
from . import pmml as kmeans_pmml
from .common import (ClusterInfo, assign_points, closest_cluster,
                     parse_to_matrix)

_log = logging.getLogger(__name__)

__all__ = ["KMeansSpeedModel", "KMeansSpeedModelManager"]


class KMeansSpeedModel(SpeedModel):
    """The in-memory cluster list."""

    def __init__(self, clusters: list[ClusterInfo]):
        self._clusters = {c.id: c for c in clusters}
        if len(self._clusters) != len(clusters):
            raise ValueError("duplicate cluster IDs")

    @property
    def clusters(self) -> list[ClusterInfo]:
        return [self._clusters[i] for i in sorted(self._clusters)]

    def get_cluster(self, cluster_id: int) -> ClusterInfo:
        return self._clusters[cluster_id]

    def set_cluster(self, cluster_id: int, info: ClusterInfo) -> None:
        self._clusters[cluster_id] = info

    def closest_cluster(self, vector) -> tuple[ClusterInfo, float]:
        return closest_cluster(self.clusters, vector)

    def get_fraction_loaded(self) -> float:
        return 1.0

    def __repr__(self):  # pragma: no cover
        return f"KMeansSpeedModel[clusters:{len(self._clusters)}]"


class KMeansSpeedModelManager(AbstractSpeedModelManager):

    def __init__(self, config: Config, device=None):
        self.device = resolve_device(device)
        self.input_schema = InputSchema(config)
        self.model: KMeansSpeedModel | None = None

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            return  # the layer's own updates
        if key in (KEY_MODEL, KEY_MODEL_REF):
            pmml = read_pmml_from_update_key_message(key, message)
            if pmml is None:
                return
            kmeans_pmml.validate_pmml_vs_schema(pmml, self.input_schema)
            self.model = KMeansSpeedModel(kmeans_pmml.read_clusters(pmml))
            _log.info("New model loaded: %s", self.model)
            return
        raise ValueError(f"Bad key: {key}")

    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        model = self.model
        if model is None or not new_data:
            return []
        lines = [text_utils.parse_input_line(km.message) for km in new_data]
        points = parse_to_matrix(lines, self.input_schema)
        clusters = model.clusters
        centers = np.stack([c.center for c in clusters]).astype(np.float32)
        idx, _ = assign_points(points, centers, device=self.device)
        out = []
        for pos in np.unique(idx):
            members = points[idx == pos].astype(np.float64)
            info = clusters[pos]
            info.update(members.mean(axis=0), len(members))
            model.set_cluster(info.id, info)
            out.append(text_utils.join_json(
                [info.id, info.center.tolist(), info.count]))
        return out
