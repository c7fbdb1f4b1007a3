"""App-tier PMML helpers.

Counterpart of ``oryx_tpu/app/pmml_utils.py`` (reference:
AppPMMLUtils.java — readPMMLFromUpdateKeyMessage :259: MODEL carries
inline XML, MODEL-REF a storage path or a manifest envelope naming one;
buildMiningSchema :131 with optional per-predictor importances,
buildDataDictionary :198 with the categorical value lists,
buildCategoricalValueEncodings :244 and toArray :116).
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET
from xml.etree.ElementTree import Element

from ..common import pmml as pmml_io
from ..common import text as text_utils
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF
from ..ml.integrity import ModelIntegrityError
from ..resilience.faults import fire as _fault
from .schema import CategoricalValueEncodings, InputSchema

_log = logging.getLogger(__name__)

__all__ = ["read_pmml_from_update_key_message", "ModelIntegrityError",
           "build_mining_schema", "build_data_dictionary",
           "get_feature_names", "find_target_index",
           "build_categorical_value_encodings", "to_pmml_array"]

_q = pmml_io._q


def build_mining_schema(schema: InputSchema, importances=None) -> Element:
    """MiningSchema element from an ``InputSchema``: numeric and
    categorical actives get their optypes, id and ignored features are
    supplementary, the target is predicted; active fields carry their
    ``importances`` (one per predictor) when given."""
    if importances is not None and \
            len(importances) != schema.num_predictors:
        raise ValueError("importances must match predictor count")
    ms = ET.Element(_q("MiningSchema"))
    for f, name in enumerate(schema.feature_names):
        attrs = {"name": name}
        if schema.is_numeric(name):
            attrs["optype"] = "continuous"
            attrs["usageType"] = "active"
        elif schema.is_categorical(name):
            attrs["optype"] = "categorical"
            attrs["usageType"] = "active"
        else:
            attrs["usageType"] = "supplementary"
        if schema.has_target() and schema.is_target(name):
            attrs["usageType"] = "predicted"
        if attrs["usageType"] == "active" and importances is not None:
            attrs["importance"] = text_utils._render(
                float(importances[schema.feature_to_predictor_index(f)]))
        ET.SubElement(ms, _q("MiningField"), attrs)
    return ms


def build_data_dictionary(
        schema: InputSchema,
        encodings: CategoricalValueEncodings | None = None) -> Element:
    """DataDictionary element of an ``InputSchema``; categorical fields
    list their values in encoding order when ``encodings`` has them (the
    clustering model passes none: it takes numeric features only)."""
    dd = ET.Element(_q("DataDictionary"),
                    {"numberOfFields": str(schema.num_features)})
    for f, name in enumerate(schema.feature_names):
        attrs = {"name": name}
        if schema.is_numeric(name):
            attrs["optype"] = "continuous"
            attrs["dataType"] = "double"
        elif schema.is_categorical(name):
            attrs["optype"] = "categorical"
            attrs["dataType"] = "string"
        field = ET.SubElement(dd, _q("DataField"), attrs)
        if schema.is_categorical(name) and encodings is not None \
                and f in encodings.get_category_counts():
            for i in range(encodings.get_value_count(f)):
                ET.SubElement(field, _q("Value"),
                              {"value": encodings.decode(f, i)})
    return dd


def get_feature_names(parent: Element) -> list[str]:
    """Feature names in order from a MiningSchema or DataDictionary."""
    return [el.get("name") for el in parent
            if el.tag in (_q("MiningField"), _q("DataField"))]


def find_target_index(mining_schema: Element) -> int | None:
    """Index of the predicted field of a MiningSchema, or None."""
    for i, el in enumerate(mining_schema.findall(_q("MiningField"))):
        if el.get("usageType") == "predicted":
            return i
    return None


def build_categorical_value_encodings(
        data_dictionary: Element) -> CategoricalValueEncodings:
    """Reverse of ``build_data_dictionary``: per-feature value lists
    from its DataField/Value elements."""
    index_to_values: dict[int, list[str]] = {}
    for f, field in enumerate(data_dictionary.findall(_q("DataField"))):
        values = [v.get("value") for v in field.findall(_q("Value"))]
        if values:
            index_to_values[f] = values
    return CategoricalValueEncodings(index_to_values)


def to_pmml_array(values) -> Element:
    """PMML real Array element from numbers."""
    vals = [float(v) for v in values]
    arr = ET.Element(_q("Array"), {"type": "real", "n": str(len(vals))})
    arr.text = text_utils.join_pmml_delimited_numbers(vals)
    return arr


def read_pmml_from_update_key_message(key: str,
                                      message: str) -> Element | None:
    """MODEL -> the parsed inline XML; MODEL-REF -> the document at the
    referenced path.  A missing or corrupt document returns None with a
    warning: the consumer replays from offset 0 on failure, so a raised
    parse error would make one poison message an endless cycle.  The
    ``store-corrupt-model`` point drives that path."""
    if key == KEY_MODEL:
        try:
            return pmml_io.from_string(message)
        except ET.ParseError:
            _log.warning("Ignoring corrupt inline model message (%d bytes)",
                         len(message))
            return None
    if key == KEY_MODEL_REF:
        from .als.slices import parse_model_ref
        path, _, _ = parse_model_ref(message)
        try:
            _fault("store-corrupt-model", error=lambda: ModelIntegrityError(
                f"injected corrupt model artifact at {path}"))
            return pmml_io.read(path)
        except OSError:
            _log.warning("Unable to load model file at %s; ignoring", path)
            return None
        except (ET.ParseError, ModelIntegrityError):
            _log.warning("Corrupt or truncated model artifact at %s; "
                         "ignoring", path)
            return None
    raise ValueError(f"Bad key: {key}")
