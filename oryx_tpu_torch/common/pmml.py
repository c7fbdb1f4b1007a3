"""PMML 4.3 document I/O on xml.etree.

Counterpart of ``oryx_tpu/common/pmml.py``, copied whole (reference:
PMMLUtils.java buildSkeletonPMML :55; AppPMMLUtils.java Extension
read/write :66-131 — how ALS carries its feature count and X/Y ID lists
through the model document).  Documents written by either package read
the same in both.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from typing import Any, Sequence

from . import text as text_utils

__all__ = [
    "PMML_NS", "build_skeleton_pmml", "to_string", "from_string",
    "read", "write", "get_extension_value", "add_extension",
    "add_extension_content", "get_extension_content",
]

PMML_NS = "http://www.dmg.org/PMML-4_3"
_APP_NAME = "Oryx"

ET.register_namespace("", PMML_NS)


def _q(tag: str) -> str:
    return f"{{{PMML_NS}}}{tag}"


def build_skeleton_pmml() -> ET.Element:
    """A new PMML document with only a Header
    (reference: PMMLUtils.buildSkeletonPMML)."""
    root = ET.Element(_q("PMML"), {"version": "4.3"})
    header = ET.SubElement(root, _q("Header"))
    ET.SubElement(header, _q("Application"), {"name": _APP_NAME})
    ts = ET.SubElement(header, _q("Timestamp"))
    ts.text = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    return root


def to_string(root: ET.Element) -> str:
    return ET.tostring(root, encoding="unicode")


def from_string(s: str) -> ET.Element:
    return ET.fromstring(s)


def read(path: str) -> ET.Element:
    """Parse a PMML document from any store scheme (reference:
    PMMLUtils.read; MODEL-REF paths may point at a shared store)."""
    from . import store
    with store.open_read(path) as f:
        return ET.parse(f).getroot()


def write(root: ET.Element, path: str) -> None:
    from . import store
    with store.open_write(path) as f:
        ET.ElementTree(root).write(f, encoding="utf-8",
                                   xml_declaration=True)


# -- Extension helpers (AppPMMLUtils parity) --------------------------------

def get_extension_value(root: ET.Element, name: str) -> str | None:
    """Value attribute of the named top-level Extension
    (reference: AppPMMLUtils.getExtensionValue)."""
    for ext in root.findall(_q("Extension")):
        if ext.get("name") == name:
            return ext.get("value")
    return None


def add_extension(root: ET.Element, name: str, value: Any) -> None:
    """Add a top-level Extension with a value attribute
    (reference: AppPMMLUtils.addExtension)."""
    if isinstance(value, bool):
        value = "true" if value else "false"
    ext = ET.Element(_q("Extension"), {"name": name, "value": str(value)})
    root.insert(_first_extension_insert_index(root), ext)


def add_extension_content(root: ET.Element, name: str,
                          content: Sequence[Any]) -> None:
    """Add an Extension whose body is PMML space-delimited tokens
    (reference: AppPMMLUtils.addExtensionContent)."""
    if not content:
        return
    ext = ET.Element(_q("Extension"), {"name": name})
    ext.text = text_utils.join_pmml_delimited(content)
    root.insert(_first_extension_insert_index(root), ext)


def get_extension_content(root: ET.Element, name: str) -> list[str] | None:
    """Parse an Extension body back into tokens
    (reference: AppPMMLUtils.getExtensionContent)."""
    for ext in root.findall(_q("Extension")):
        if ext.get("name") == name:
            return text_utils.parse_pmml_delimited(ext.text or "")
    return None


def _first_extension_insert_index(root: ET.Element) -> int:
    # Extensions come after Header (schema order); insert after the last
    # existing Extension or Header
    idx = 0
    for i, child in enumerate(root):
        if child.tag in (_q("Header"), _q("Extension")):
            idx = i + 1
    return idx
