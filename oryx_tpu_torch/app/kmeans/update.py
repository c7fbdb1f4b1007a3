"""The k-means batch app: the MLUpdate for clustering.

Counterpart of ``oryx_tpu/app/kmeans/update.py`` (reference:
KMeansUpdate.java:60-230 — the k hyperparameter, iterations, runs and
initialization from the config, the evaluation strategy :139-176, the
ClusteringModel PMML with cluster sizes :184).  Unsupervised: a target
or a categorical feature is refused.  Training and evaluation run on
``device`` (None means ``cuda``), or over the mesh of
``oryx.batch.streaming.master`` and ``oryx.distributed.*``
(``parallel/mesh.mesh_from_config``, ``parallel/kmeans_dist``).
"""

from __future__ import annotations

import logging
from typing import Sequence
from xml.etree.ElementTree import Element

from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KeyMessage
from ...ml import params as hp
from ...ml.mlupdate import MLUpdate
from ...parallel.kmeans_dist import train_kmeans_distributed
from ...parallel.mesh import mesh_from_config
from ..schema import InputSchema
from . import evaluation, pmml as kmeans_pmml
from .common import parse_to_matrix
from .trainer import K_MEANS_PARALLEL, RANDOM, train_kmeans

_log = logging.getLogger(__name__)

__all__ = ["KMeansUpdate"]


class KMeansUpdate(MLUpdate):

    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.initialization_strategy = config.get_string(
            "oryx.kmeans.initialization-strategy")
        self.evaluation_strategy = config.get_string(
            "oryx.kmeans.evaluation-strategy").upper()
        self.runs = config.get_int("oryx.kmeans.runs")
        self.iterations = config.get_int("oryx.kmeans.iterations")
        self.hyper_param_values = [
            hp.from_config(config, "oryx.kmeans.hyperparams.k")]
        self.input_schema = InputSchema(config)
        if self.iterations <= 0:
            raise ValueError("iterations must be positive")
        if self.runs <= 0:
            raise ValueError("runs must be positive")
        if self.initialization_strategy not in (K_MEANS_PARALLEL, RANDOM):
            raise ValueError(
                f"bad initialization-strategy: {self.initialization_strategy}")
        if self.evaluation_strategy not in evaluation.EVAL_STRATEGIES:
            raise ValueError(
                f"bad evaluation-strategy: {self.evaluation_strategy}")
        # the training mesh over several cards, joined across processes
        # by oryx.distributed.* (None: one device)
        self.mesh = mesh_from_config(config, self.device)
        # unsupervised, numeric-only
        if self.input_schema.has_target():
            raise ValueError("k-means does not take a target feature")
        for i in range(self.input_schema.num_features):
            if self.input_schema.is_categorical(i):
                raise ValueError("k-means supports only numeric features")

    def get_hyper_parameter_values(self):
        return self.hyper_param_values

    def _to_matrix(self, data: Sequence[KeyMessage]):
        lines = [text_utils.parse_input_line(km.message) for km in data]
        return parse_to_matrix(lines, self.input_schema)

    def build_model(self, train_data: Sequence[KeyMessage],
                    hyper_parameters: list,
                    candidate_path: str) -> Element | None:
        k = int(hyper_parameters[0])
        if k <= 1:
            raise ValueError("k must be > 1")
        points = self._to_matrix(train_data)
        if len(points) < k:
            _log.warning("Not enough training points (%d) for k=%d",
                         len(points), k)
            return None
        _log.info("Building KMeans model with %d clusters over %d points",
                  k, len(points))
        if self.mesh is not None:
            clusters = train_kmeans_distributed(
                points, k, self.iterations, self.mesh, self.runs,
                self.initialization_strategy)
        else:
            clusters = train_kmeans(points, k, self.iterations, self.runs,
                                    self.initialization_strategy,
                                    device=self.device)
        return kmeans_pmml.clusters_to_pmml(clusters, self.input_schema)

    def evaluate(self, model: Element, candidate_path: str,
                 test_data: Sequence[KeyMessage],
                 train_data: Sequence[KeyMessage]) -> float:
        kmeans_pmml.validate_pmml_vs_schema(model, self.input_schema)
        clusters = kmeans_pmml.read_clusters(model)
        # the reference evaluates over the union of train and test
        points = self._to_matrix(list(train_data) + list(test_data))
        eval_ = evaluation.evaluate(self.evaluation_strategy, clusters,
                                    points, device=self.device)
        _log.info("%s = %.6f", self.evaluation_strategy, eval_)
        return eval_
