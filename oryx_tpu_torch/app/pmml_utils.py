"""App-tier PMML helpers.

Counterpart of ``oryx_tpu/app/pmml_utils.py`` (reference:
AppPMMLUtils.readPMMLFromUpdateKeyMessage :259), cut down to the read
side: MODEL carries inline XML, MODEL-REF a storage path (or a
manifest envelope naming one).
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET
from xml.etree.ElementTree import Element

from ..common import pmml as pmml_io
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF
from ..ml.integrity import ModelIntegrityError
from ..resilience.faults import fire as _fault

_log = logging.getLogger(__name__)

__all__ = ["read_pmml_from_update_key_message", "ModelIntegrityError"]


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
