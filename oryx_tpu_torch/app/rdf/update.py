"""RDF batch update: the MLUpdate for random decision forests.

Counterpart of ``oryx_tpu/app/rdf/update.py`` (reference:
RDFUpdate.java — num-trees and the max-split-candidates, max-depth and
impurity hyperparameters :99-102, categorical encodings from the
distinct values :205, training :141-163, PMML with record counts,
importances and extensions (rdfModelToPMML), evaluation by
classification accuracy or -RMSE (Evaluation.java:27-50)).  Training
and evaluation run on ``device`` (None means ``cuda``).  Not part of
this package yet, refused with an error naming its key: training over
several cards (``oryx.batch.streaming.master = "mesh"``,
``oryx.distributed.coordinator-address``).
"""

from __future__ import annotations

import logging
from typing import Sequence
from xml.etree.ElementTree import Element

import numpy as np

from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KeyMessage
from ...ml import params as hp
from ...ml.mlupdate import MLUpdate
from ..classreg import example_from_tokens
from ..schema import CategoricalValueEncodings, InputSchema
from . import pmml as rdf_pmml
from .forest_arrays import ForestArrays, examples_to_matrix
from .trainer import IMPURITIES, train_forest

_log = logging.getLogger(__name__)

__all__ = ["RDFUpdate"]


class RDFUpdate(MLUpdate):

    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.num_trees = config.get_int("oryx.rdf.num-trees")
        if self.num_trees < 1:
            raise ValueError("num-trees must be at least 1")
        self.hyper_param_values = [
            hp.from_config(config, f"oryx.rdf.hyperparams.{name}")
            for name in ("max-split-candidates", "max-depth", "impurity")]
        self.input_schema = InputSchema(config)
        if not self.input_schema.has_target():
            raise ValueError("rdf requires a target feature")
        if config.get_string("oryx.batch.streaming.master") == "mesh" or \
                config.get_optional_string(
                    "oryx.distributed.coordinator-address"):
            raise ValueError(
                "oryx.batch.streaming.master = \"mesh\" / "
                "oryx.distributed.coordinator-address: training over "
                "several cards is not part of this package yet")

    def get_hyper_parameter_values(self):
        return self.hyper_param_values

    # -- data prep ------------------------------------------------------------

    def _parse(self, data: Sequence[KeyMessage]) -> list[list[str]]:
        """Tokenize, dropping malformed rows (wrong token count would
        otherwise poison every future generation, since generations
        replay all past data) and unlabeled rows (empty target token,
        e.g. to-be-predicted data that reached the input topic)."""
        num = self.input_schema.num_features
        target = self.input_schema.target_feature_index
        out = []
        bad = 0
        for km in data:
            row = text_utils.parse_input_line(km.message)
            if len(row) != num:
                bad += 1
                continue
            if row[target]:
                out.append(row)
        if bad:
            _log.warning("Ignored %d rows with != %d tokens", bad, num)
        return out

    def _encodings_from(self, rows) -> CategoricalValueEncodings:
        # distinct values per categorical feature, sorted for run-to-run
        # stability (the reference's distinct() ordering is arbitrary)
        distinct: dict[int, list[str]] = {}
        for f in range(self.input_schema.num_features):
            if self.input_schema.is_categorical(f):
                distinct[f] = sorted({row[f] for row in rows})
        return CategoricalValueEncodings(distinct)

    def _to_matrices(self, rows, encodings: CategoricalValueEncodings):
        """Predictor matrix [B, P] + target vector (class encodings or
        floats), mirroring RDFUpdate.parseToLabeledPointRDD."""
        schema = self.input_schema
        x = np.zeros((len(rows), schema.num_predictors), dtype=np.float32)
        classification = schema.is_classification()
        y = np.zeros(len(rows),
                     dtype=np.int32 if classification else np.float32)
        for r, row in enumerate(rows):
            for f in range(schema.num_features):
                if schema.is_numeric(f):
                    encoded = float(row[f])
                elif schema.is_categorical(f):
                    encoded = encodings.encode(f, row[f])
                else:
                    continue
                if schema.is_target(f):
                    y[r] = encoded
                else:
                    x[r, schema.feature_to_predictor_index(f)] = encoded
        return x, y

    # -- MLUpdate contract ----------------------------------------------------

    def build_model(self, train_data: Sequence[KeyMessage],
                    hyper_parameters: list,
                    candidate_path: str) -> Element | None:
        max_split_candidates = int(hyper_parameters[0])
        max_depth = int(hyper_parameters[1])
        impurity = str(hyper_parameters[2])
        if max_split_candidates < 2:
            raise ValueError("max-split-candidates must be at least 2")
        if max_depth < 1:
            raise ValueError("max-depth must be at least 1")
        if impurity not in IMPURITIES:
            raise ValueError(f"bad impurity: {impurity}")

        schema = self.input_schema
        rows = self._parse(train_data)
        encodings = self._encodings_from(rows)
        x, y = self._to_matrices(rows, encodings)
        category_counts = {
            schema.feature_to_predictor_index(f): count
            for f, count in encodings.get_category_counts().items()
            if not schema.is_target(f)}
        num_classes = None
        if schema.is_classification():
            num_classes = encodings.get_value_count(
                schema.target_feature_index)
        _log.info("Building forest: %d trees, depth %d, %d bins, %s over "
                  "%d examples", self.num_trees, max_depth,
                  max_split_candidates, impurity, len(rows))
        forest = train_forest(x, y, schema, category_counts,
                              self.num_trees, max_depth,
                              max_split_candidates, impurity,
                              num_classes=num_classes, device=self.device)
        return rdf_pmml.forest_to_pmml(
            forest, schema, encodings, max_depth=max_depth,
            max_split_candidates=max_split_candidates, impurity=impurity)

    def evaluate(self, model: Element, candidate_path: str,
                 test_data: Sequence[KeyMessage],
                 train_data: Sequence[KeyMessage]) -> float:
        rdf_pmml.validate_pmml_vs_schema(model, self.input_schema)
        forest, encodings = rdf_pmml.read_forest(model)
        schema = self.input_schema
        examples = [example_from_tokens(row, schema, encodings)
                    for row in self._parse(test_data)]
        # a target value unseen at training time cannot be scored
        examples = [ex for ex in examples if ex.target is not None]
        if not examples:
            return float("nan")
        x = examples_to_matrix(examples, schema.num_features)
        if schema.is_classification():
            num_classes = encodings.get_value_count(
                schema.target_feature_index)
            arrays = ForestArrays(forest, schema.num_features, num_classes,
                                  device=self.device)
            predicted = arrays.predict_proba(x).argmax(axis=1)
            actual = np.array([ex.target for ex in examples])
            accuracy = float((predicted == actual).mean())
            _log.info("Accuracy: %s", accuracy)
            return accuracy
        arrays = ForestArrays(forest, schema.num_features, 0,
                              device=self.device)
        predicted = arrays.predict_value(x)
        actual = np.array([ex.target for ex in examples], dtype=np.float64)
        rmse = float(np.sqrt(np.mean((predicted - actual) ** 2)))
        _log.info("RMSE: %s", rmse)
        return -rmse
