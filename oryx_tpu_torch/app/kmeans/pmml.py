"""k-means clusters <-> a PMML ClusteringModel.

Counterpart of ``oryx_tpu/app/kmeans/pmml.py`` (reference:
KMeansPMMLUtils.java:71 — read a ClusteringModel into ClusterInfo, and
validate it against the schema :40; the writer of KMeansUpdate.java:184
— a ClusteringModel with a squaredEuclidean ComparisonMeasure and each
cluster's size and center Array).  The document's bytes are the
reference's for the same clusters.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.etree.ElementTree import Element

from ...common import pmml as pmml_io
from ...common import text as text_utils
from .. import pmml_utils
from ..schema import InputSchema
from .common import ClusterInfo

__all__ = ["clusters_to_pmml", "read_clusters", "validate_pmml_vs_schema"]

_q = pmml_io._q


def clusters_to_pmml(clusters: list[ClusterInfo],
                     schema: InputSchema) -> Element:
    """A PMML document holding one ClusteringModel."""
    root = pmml_io.build_skeleton_pmml()
    root.append(pmml_utils.build_data_dictionary(schema))
    model = ET.SubElement(root, _q("ClusteringModel"), {
        "functionName": "clustering",
        "modelClass": "centerBased",
        "numberOfClusters": str(len(clusters)),
    })
    model.append(pmml_utils.build_mining_schema(schema))
    cm = ET.SubElement(model, _q("ComparisonMeasure"), {"kind": "distance"})
    ET.SubElement(cm, _q("squaredEuclidean"))
    for f, name in enumerate(schema.feature_names):
        if schema.is_active(f):
            ET.SubElement(model, _q("ClusteringField"),
                          {"field": name, "isCenterField": "true"})
    for c in clusters:
        cl = ET.SubElement(model, _q("Cluster"),
                           {"id": str(c.id), "size": str(c.count)})
        cl.append(pmml_utils.to_pmml_array(c.center))
    return root


def read_clusters(root: Element) -> list[ClusterInfo]:
    """The ClusterInfo list of a PMML ClusteringModel."""
    model = root.find(_q("ClusteringModel"))
    if model is None:
        raise ValueError("no ClusteringModel in PMML")
    out = []
    for cl in model.findall(_q("Cluster")):
        arr = cl.find(_q("Array"))
        center = [float(v) for v in
                  text_utils.parse_delimited(arr.text.strip(), " ")]
        out.append(ClusterInfo(int(cl.get("id")), center,
                               int(cl.get("size"))))
    return out


def validate_pmml_vs_schema(root: Element, schema: InputSchema) -> None:
    """The model's MiningSchema must name the configured features."""
    model = root.find(_q("ClusteringModel"))
    if model is None:
        raise ValueError("PMML does not contain a ClusteringModel")
    ms = model.find(_q("MiningSchema"))
    names = pmml_utils.get_feature_names(ms)
    if names != schema.feature_names:
        raise ValueError(
            f"PMML features {names} != schema {schema.feature_names}")
