"""RDF PMML I/O: TreeModel / MiningModel (segmented forest) read,
write, and schema validation.

Counterpart of ``oryx_tpu/app/rdf/pmml.py`` (reference:
RDFPMMLUtils.java — validatePMMLVsSchema, read: MiningModel
segmentation weightedAverage/weightedMajorityVote or one TreeModel, the
True-predicate left child against the positive right child,
SimplePredicate >= / > (+ulp), SimpleSetPredicate isIn/isNotIn,
defaultChild, ScoreDistribution record counts; and the writer of
RDFUpdate.java rdfModelToPMML/toTreeModel: node IDs, record counts,
ScoreDistribution with confidence, MiningSchema importances, the
maxDepth/maxSplitCandidates/impurity extensions).  The document's bytes
are the reference's for the same forest.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from xml.etree.ElementTree import Element

from ...common import pmml as pmml_io
from ...common import text as text_utils
from .. import pmml_utils
from ..classreg import CategoricalPrediction, NumericPrediction
from ..schema import CategoricalValueEncodings, InputSchema
from .tree import (CategoricalDecision, DecisionForest, DecisionNode,
                   DecisionTree, NumericDecision, TerminalNode)

_q = pmml_io._q

__all__ = ["forest_to_pmml", "read_forest", "validate_pmml_vs_schema"]


# -- validation ---------------------------------------------------------------

def _find_models(pmml: Element) -> list[Element]:
    return [el for el in pmml
            if el.tag in (_q("TreeModel"), _q("MiningModel"))]


def validate_pmml_vs_schema(pmml: Element, schema: InputSchema) -> None:
    models = _find_models(pmml)
    if len(models) != 1:
        raise ValueError(
            f"Should have exactly one model, but had {len(models)}")
    model = models[0]
    function = model.get("functionName")
    expected = "classification" if schema.is_classification() \
        else "regression"
    if function != expected:
        raise ValueError(f"Expected {expected} function type "
                         f"but got {function}")
    dictionary = pmml.find(_q("DataDictionary"))
    if schema.feature_names != pmml_utils.get_feature_names(dictionary):
        raise ValueError("Feature names in schema don't match names in PMML")
    mining_schema = model.find(_q("MiningSchema"))
    if schema.feature_names != pmml_utils.get_feature_names(mining_schema):
        raise ValueError("Feature names in schema don't match MiningSchema")
    pmml_index = pmml_utils.find_target_index(mining_schema)
    if schema.has_target():
        if pmml_index is None or schema.target_feature_index != pmml_index:
            raise ValueError(
                f"Configured schema expects target at index "
                f"{schema.target_feature_index}, but PMML has target at "
                f"index {pmml_index}")
    elif pmml_index is not None:
        raise ValueError("PMML has a target but schema does not")


# -- write --------------------------------------------------------------------

def forest_to_pmml(forest: DecisionForest, schema: InputSchema,
                   encodings: CategoricalValueEncodings,
                   max_depth: int | None = None,
                   max_split_candidates: int | None = None,
                   impurity: str | None = None) -> Element:
    """Serialize a forest: one TreeModel, or a MiningModel segmentation
    for several trees (reference: RDFUpdate.rdfModelToPMML)."""
    classification = schema.is_classification()
    pmml = pmml_io.build_skeleton_pmml()
    pmml.append(pmml_utils.build_data_dictionary(schema, encodings))

    # forest importances are all-features-indexed;
    # build_mining_schema takes them per predictor
    importances = None
    if len(forest.feature_importances) == schema.num_features:
        importances = [
            forest.feature_importances[schema.predictor_to_feature_index(p)]
            for p in range(schema.num_predictors)]

    if len(forest.trees) == 1:
        model = _tree_to_model(forest.trees[0], schema, encodings,
                               classification)
    else:
        model = ET.Element(_q("MiningModel"))
        segmentation = ET.Element(
            _q("Segmentation"),
            {"multipleModelMethod": "weightedMajorityVote" if classification
             else "weightedAverage"})
        for tree_id, tree in enumerate(forest.trees):
            segment = ET.SubElement(segmentation, _q("Segment"),
                                    {"id": str(tree_id)})
            ET.SubElement(segment, _q("True"))
            tree_model = _tree_to_model(tree, schema, encodings,
                                        classification)
            segment.append(tree_model)
            segment.set("weight",
                        text_utils._render(float(forest.weights[tree_id])))

    model.set("functionName",
              "classification" if classification else "regression")
    mining_schema = pmml_utils.build_mining_schema(schema, importances)
    model.insert(0, mining_schema)
    if model.tag == _q("MiningModel"):
        model.append(segmentation)
    pmml.append(model)

    if max_depth is not None:
        pmml_io.add_extension(pmml, "maxDepth", max_depth)
    if max_split_candidates is not None:
        pmml_io.add_extension(pmml, "maxSplitCandidates",
                              max_split_candidates)
    if impurity is not None:
        pmml_io.add_extension(pmml, "impurity", impurity)
    return pmml


def _tree_to_model(tree: DecisionTree, schema: InputSchema,
                   encodings: CategoricalValueEncodings,
                   classification: bool) -> Element:
    model = ET.Element(_q("TreeModel"), {
        "splitCharacteristic": "binarySplit",
        "missingValueStrategy": "defaultChild",
    })
    root_el = _node_to_element(tree.root, None, schema, encodings,
                               classification)
    model.append(root_el)
    return model


def _node_to_element(node, decision_into, schema: InputSchema,
                     encodings: CategoricalValueEncodings,
                     classification: bool) -> Element:
    """``decision_into`` is the parent decision if this is its positive
    (right) child, else None -> True predicate."""
    el = ET.Element(_q("Node"), {"id": node.id,
                                 "recordCount": str(float(node.count))})
    el.append(_predicate_element(decision_into, schema, encodings))
    if node.is_terminal:
        prediction = node.prediction
        if classification:
            target = schema.target_feature_index
            enc_to_value = encodings.get_encoding_value_map(target)
            counts = prediction.category_counts
            probs = prediction.category_probabilities
            for enc, count in enumerate(counts):
                if count > 0.0:
                    dist = ET.SubElement(
                        el, _q("ScoreDistribution"),
                        {"value": enc_to_value[enc],
                         "recordCount": text_utils._render(float(count))})
                    dist.set("confidence",
                             text_utils._render(float(probs[enc])))
        else:
            el.set("score", text_utils._render(prediction.prediction))
    else:
        decision = node.decision
        positive = _node_to_element(node.right, decision, schema, encodings,
                                    classification)
        negative = _node_to_element(node.left, None, schema, encodings,
                                    classification)
        el.append(positive)
        el.append(negative)
        el.set("defaultChild",
               node.right.id if decision.default_decision else node.left.id)
    return el


def _predicate_element(decision, schema: InputSchema,
                       encodings: CategoricalValueEncodings) -> Element:
    if decision is None:
        return ET.Element(_q("True"))
    name = schema.feature_names[decision.feature_number]
    if isinstance(decision, CategoricalDecision):
        enc_to_value = encodings.get_encoding_value_map(
            decision.feature_number)
        values = [enc_to_value[c]
                  for c in sorted(decision.active_category_encodings)]
        pred = ET.Element(_q("SimpleSetPredicate"),
                          {"field": name, "booleanOperator": "isIn"})
        arr = ET.SubElement(pred, _q("Array"),
                            {"type": "string", "n": str(len(values))})
        arr.text = text_utils.join_pmml_delimited(values)
        return pred
    return ET.Element(_q("SimplePredicate"),
                      {"field": name, "operator": "greaterOrEqual",
                       "value": text_utils._render(decision.threshold)})


# -- read ---------------------------------------------------------------------

def read_forest(
        pmml: Element
) -> tuple[DecisionForest, CategoricalValueEncodings]:
    """Parse a forest + encodings out of PMML (reference:
    RDFPMMLUtils.read)."""
    dictionary = pmml.find(_q("DataDictionary"))
    feature_names = pmml_utils.get_feature_names(dictionary)
    encodings = pmml_utils.build_categorical_value_encodings(dictionary)

    model = _find_models(pmml)[0]
    mining_schema = model.find(_q("MiningSchema"))
    target_index = pmml_utils.find_target_index(mining_schema)
    if target_index is None:
        raise ValueError("no target in MiningSchema")

    if model.tag == _q("MiningModel"):
        segmentation = model.find(_q("Segmentation"))
        method = segmentation.get("multipleModelMethod")
        if method not in ("weightedAverage", "weightedMajorityVote"):
            raise ValueError(f"Bad segmentation method {method}")
        segments = segmentation.findall(_q("Segment"))
        if not segments:
            raise ValueError("No segments")
        trees, weights = [], []
        for segment in segments:
            if segment.find(_q("True")) is None:
                raise ValueError("Segment predicate must be True")
            weights.append(float(segment.get("weight", 1.0)))
            tree_model = segment.find(_q("TreeModel"))
            root = _translate_node(tree_model.find(_q("Node")), encodings,
                                   feature_names, target_index)
            trees.append(DecisionTree(root))
    else:
        root = _translate_node(model.find(_q("Node")), encodings,
                               feature_names, target_index)
        trees, weights = [DecisionTree(root)], [1.0]

    importances = [0.0] * len(feature_names)
    for i, field in enumerate(mining_schema.findall(_q("MiningField"))):
        imp = field.get("importance")
        if imp is not None:
            importances[i] = float(imp)

    return DecisionForest(trees, weights, importances), encodings


def _translate_node(node_el: Element, encodings: CategoricalValueEncodings,
                    feature_names: list[str], target_index: int):
    node_id = node_el.get("id")
    children = node_el.findall(_q("Node"))
    if not children:
        distributions = node_el.findall(_q("ScoreDistribution"))
        if distributions:
            value_to_enc = encodings.get_value_encoding_map(target_index)
            counts = [0.0] * len(value_to_enc)
            for dist in distributions:
                counts[value_to_enc[dist.get("value")]] = \
                    float(dist.get("recordCount"))
            prediction = CategoricalPrediction(counts)
        else:
            prediction = NumericPrediction(
                float(node_el.get("score")),
                int(round(float(node_el.get("recordCount", 0.0)))))
        return TerminalNode(node_id, prediction)

    if len(children) != 2:
        raise ValueError(f"Node {node_id} must have 2 children")
    child1, child2 = children
    if child1.find(_q("True")) is not None:
        negative_left, positive_right = child1, child2
    elif child2.find(_q("True")) is not None:
        negative_left, positive_right = child2, child1
    else:
        raise ValueError("One child must have a True predicate")

    default_decision = positive_right.get("id") == \
        node_el.get("defaultChild")
    simple = positive_right.find(_q("SimplePredicate"))
    simple_set = positive_right.find(_q("SimpleSetPredicate"))
    if simple is not None:
        operator = simple.get("operator")
        if operator not in ("greaterOrEqual", "greaterThan"):
            raise ValueError(f"Bad operator {operator}")
        threshold = float(simple.get("value"))
        if operator == "greaterThan":
            threshold += math.ulp(threshold)
        feature_number = feature_names.index(simple.get("field"))
        decision = NumericDecision(feature_number, threshold,
                                   default_decision)
    elif simple_set is not None:
        operator = simple_set.get("booleanOperator")
        if operator not in ("isIn", "isNotIn"):
            raise ValueError(f"Bad operator {operator}")
        feature_number = feature_names.index(simple_set.get("field"))
        value_to_enc = encodings.get_value_encoding_map(feature_number)
        categories = text_utils.parse_pmml_delimited(
            simple_set.find(_q("Array")).text)
        if operator == "isIn":
            active = {value_to_enc[c] for c in categories}
        else:
            active = set(value_to_enc.values()) - \
                {value_to_enc[c] for c in categories}
        decision = CategoricalDecision(feature_number, active,
                                       default_decision)
    else:
        raise ValueError("Positive child needs a simple or set predicate")

    count = int(round(float(node_el.get("recordCount", 0.0))))
    return DecisionNode(
        node_id, decision,
        _translate_node(negative_left, encodings, feature_names,
                        target_index),
        _translate_node(positive_right, encodings, feature_names,
                        target_index),
        count)
