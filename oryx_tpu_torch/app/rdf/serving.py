"""RDF serving model and manager.

Counterpart of ``oryx_tpu/app/rdf/serving.py`` (reference:
RDFServingModel.java — predict is the forest vote decoded to a target
value string, makePrediction checks the feature count — and
RDFServingModelManager.java — "UP" finds the terminal node by ID and
applies the online update: per-encoding counts for classification, mean
and count for regression; MODEL/MODEL-REF replace the model).

The mutable host forest is the source of truth (leaf updates mutate
it), and one datum walks it on the host; the node tables of
``ForestArrays`` on the manager's device (None means ``cuda``) are
built lazily for bulk prediction and dropped under the lock by every
leaf update.
"""

from __future__ import annotations

import logging
import threading
from typing import Sequence

import numpy as np

from ...api.serving import AbstractServingModelManager, ServingModel
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from ..classreg import (CategoricalPrediction, Example, NumericPrediction,
                        example_from_tokens)
from ..pmml_utils import read_pmml_from_update_key_message
from ..schema import CategoricalValueEncodings, InputSchema
from . import pmml as rdf_pmml
from .forest_arrays import ForestArrays, examples_to_matrix
from .tree import DecisionForest

_log = logging.getLogger(__name__)

__all__ = ["RDFServingModel", "RDFServingModelManager"]


class RDFServingModel(ServingModel):

    def __init__(self, forest: DecisionForest,
                 encodings: CategoricalValueEncodings,
                 input_schema: InputSchema, device=None):
        self.forest = forest
        self.encodings = encodings
        self.input_schema = input_schema
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._arrays: ForestArrays | None = None

    # -- prediction -----------------------------------------------------------

    def _example(self, data: Sequence[str]) -> Example:
        if len(data) != self.input_schema.num_features:
            raise ValueError("Wrong number of features")
        return example_from_tokens(data, self.input_schema, self.encodings)

    def make_prediction(self, data: Sequence[str]):
        with self._lock:
            return self.forest.predict(self._example(data))

    def predict(self, data: Sequence[str]) -> str:
        """Predicted target rendered as a string (reference:
        RDFServingModel.predict)."""
        prediction = self.make_prediction(data)
        if self.input_schema.is_classification():
            target = self.input_schema.target_feature_index
            return self.encodings.decode(
                target, prediction.get_most_probable_category_encoding())
        return text_utils._render(prediction.prediction)

    def predict_bulk(self, rows: Sequence[Sequence[str]]) -> list[str]:
        """Batched prediction: one forest walk over all rows on the
        device."""
        examples = [self._example(row) for row in rows]
        x = examples_to_matrix(examples, self.input_schema.num_features)
        with self._lock:
            arrays = self._compiled_locked()
            if self.input_schema.is_classification():
                target = self.input_schema.target_feature_index
                best = arrays.predict_proba(x).argmax(axis=1)
                return [self.encodings.decode(target, int(b)) for b in best]
            values = arrays.predict_value(x)
        return [text_utils._render(float(v)) for v in values]

    def _compiled_locked(self) -> ForestArrays:
        # caller holds _lock (the _locked suffix contract): _arrays is
        # invalidated under the lock by update_terminal_node
        if self._arrays is None:
            num_classes = 0
            if self.input_schema.is_classification():
                num_classes = self.encodings.get_value_count(
                    self.input_schema.target_feature_index)
            self._arrays = ForestArrays(
                self.forest, self.input_schema.num_features, num_classes,
                device=self.device)
        return self._arrays

    # -- updates --------------------------------------------------------------

    def update_terminal_node(self, tree_id: int, node_id: str,
                             update: list) -> None:
        with self._lock:
            node = self.forest.trees[tree_id].find_by_id(node_id)
            prediction = node.prediction
            if isinstance(prediction, CategoricalPrediction):
                for encoding, count in update[0].items():
                    prediction.update(int(encoding), int(count))
            else:
                assert isinstance(prediction, NumericPrediction)
                prediction.update(float(update[0]), int(update[1]))
            self._arrays = None  # recompile lazily on next bulk call

    def get_fraction_loaded(self) -> float:
        return 1.0

    def __repr__(self):  # pragma: no cover
        return f"RDFServingModel[numTrees:{len(self.forest.trees)}]"


class RDFServingModelManager(AbstractServingModelManager):

    def __init__(self, config: Config, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.input_schema = InputSchema(config)
        self._model: RDFServingModel | None = None

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            model = self._model
            if model is None:
                return  # no model to interpret with yet, so skip it
            update = text_utils.read_json(message)
            tree_id = int(update[0])
            node_id = str(update[1])
            model.update_terminal_node(tree_id, node_id, update[2:])
            return
        if key in (KEY_MODEL, KEY_MODEL_REF):
            _log.info("Loading new model")
            pmml = read_pmml_from_update_key_message(key, message)
            if pmml is None:
                return
            rdf_pmml.validate_pmml_vs_schema(pmml, self.input_schema)
            forest, encodings = rdf_pmml.read_forest(pmml)
            self._model = RDFServingModel(forest, encodings,
                                          self.input_schema,
                                          device=self.device)
            _log.info("New model: %s", self._model)
            return
        raise ValueError(f"Bad key: {key}")

    def get_model(self) -> RDFServingModel | None:
        return self._model
