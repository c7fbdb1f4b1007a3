"""RDF speed layer: route new examples to terminal nodes, aggregate
their targets, emit leaf-update deltas.

Counterpart of ``oryx_tpu/app/rdf/speed.py`` (reference:
RDFSpeedModel.java — the forest and encodings, fraction loaded 1.0 —
and RDFSpeedModelManager.java:93 — MODEL/MODEL-REF load a new model,
"UP" is ignored; buildUpdates routes every example through every tree
and emits, per (tree, terminal node), ``[treeID, nodeID, {encoding:
count, ...}]`` for classification or ``[treeID, nodeID, mean, count]``
for regression).  The whole micro-batch is routed in one
``ForestArrays.route_ids`` call on the manager's device (None means
``cuda``).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np

from ...api.speed import AbstractSpeedModelManager, SpeedModel
from ...common import text as text_utils
from ...common.config import Config
from ...common.device import resolve_device
from ...kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP, KeyMessage
from ..classreg import example_from_tokens
from ..pmml_utils import read_pmml_from_update_key_message
from ..schema import CategoricalValueEncodings, InputSchema
from . import pmml as rdf_pmml
from .forest_arrays import ForestArrays, examples_to_matrix
from .tree import DecisionForest

_log = logging.getLogger(__name__)

__all__ = ["RDFSpeedModel", "RDFSpeedModelManager"]


class RDFSpeedModel(SpeedModel):

    def __init__(self, forest: DecisionForest,
                 encodings: CategoricalValueEncodings,
                 num_features: int, num_classes: int, device=None):
        self.forest = forest
        self.encodings = encodings
        self.arrays = ForestArrays(forest, num_features, num_classes,
                                   device=device)

    def get_fraction_loaded(self) -> float:
        return 1.0

    def __repr__(self):  # pragma: no cover
        return f"RDFSpeedModel[numTrees:{len(self.forest.trees)}]"


class RDFSpeedModelManager(AbstractSpeedModelManager):

    def __init__(self, config: Config, device=None):
        self.device = resolve_device(device)
        self.input_schema = InputSchema(config)
        self.model: RDFSpeedModel | None = None

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_UP:
            return  # hearing our own updates
        if key in (KEY_MODEL, KEY_MODEL_REF):
            pmml = read_pmml_from_update_key_message(key, message)
            if pmml is None:
                return
            rdf_pmml.validate_pmml_vs_schema(pmml, self.input_schema)
            forest, encodings = rdf_pmml.read_forest(pmml)
            schema = self.input_schema
            num_classes = encodings.get_value_count(
                schema.target_feature_index) \
                if schema.is_classification() else 0
            self.model = RDFSpeedModel(forest, encodings,
                                       schema.num_features, num_classes,
                                       device=self.device)
            _log.info("New model loaded: %s", self.model)
            return
        raise ValueError(f"Bad key: {key}")

    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        model = self.model
        if model is None or not new_data:
            return []
        schema = self.input_schema
        examples = []
        for km in new_data:
            tokens = text_utils.parse_input_line(km.message)
            example = example_from_tokens(tokens, schema, model.encodings)
            if example.target is not None:
                examples.append(example)
        if not examples:
            return []
        x = examples_to_matrix(examples, schema.num_features)
        terminal_ids = model.arrays.route_ids(x)        # [T][B] node IDs

        out: list[str] = []
        classification = schema.is_classification()
        for tree_id, per_example in enumerate(terminal_ids):
            by_node: dict[str, list] = defaultdict(list)
            for example, node_id in zip(examples, per_example):
                by_node[node_id].append(example.target)
            for node_id, targets in by_node.items():
                if classification:
                    counts: dict[str, int] = defaultdict(int)
                    for enc in targets:
                        counts[str(int(enc))] += 1
                    out.append(text_utils.join_json(
                        [tree_id, node_id, dict(counts)]))
                else:
                    values = np.asarray(targets, dtype=np.float64)
                    out.append(text_utils.join_json(
                        [tree_id, node_id, float(values.mean()),
                         int(len(values))]))
        return out
