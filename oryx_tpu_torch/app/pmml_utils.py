"""App-tier PMML helpers.

Counterpart of ``oryx_tpu/app/pmml_utils.py`` (reference:
AppPMMLUtils.java — readPMMLFromUpdateKeyMessage :259: MODEL carries
inline XML, MODEL-REF a storage path or a manifest envelope naming one;
buildMiningSchema :131, buildDataDictionary :198 and toArray :116 for
the numeric features of a clustering model).
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

_log = logging.getLogger(__name__)

__all__ = ["read_pmml_from_update_key_message", "ModelIntegrityError",
           "build_mining_schema", "build_data_dictionary",
           "get_feature_names", "to_pmml_array"]

_q = pmml_io._q


def build_mining_schema(schema) -> Element:
    """MiningSchema element from an ``InputSchema``: numeric and
    categorical actives get their optypes, id and ignored features are
    supplementary, the target is predicted."""
    ms = ET.Element(_q("MiningSchema"))
    for name in schema.feature_names:
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
        ET.SubElement(ms, _q("MiningField"), attrs)
    return ms


def build_data_dictionary(schema) -> Element:
    """DataDictionary element of an ``InputSchema`` without categorical
    value lists (the clustering model takes numeric features only)."""
    dd = ET.Element(_q("DataDictionary"),
                    {"numberOfFields": str(schema.num_features)})
    for name in schema.feature_names:
        attrs = {"name": name}
        if schema.is_numeric(name):
            attrs["optype"] = "continuous"
            attrs["dataType"] = "double"
        elif schema.is_categorical(name):
            attrs["optype"] = "categorical"
            attrs["dataType"] = "string"
        ET.SubElement(dd, _q("DataField"), attrs)
    return dd


def get_feature_names(parent: Element) -> list[str]:
    """Feature names in order from a MiningSchema or DataDictionary."""
    return [el.get("name") for el in parent
            if el.tag in (_q("MiningField"), _q("DataField"))]


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
