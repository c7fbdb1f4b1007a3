"""ALS model artifacts.

Counterpart of ``oryx_tpu/app/als/update.py``, cut down to the two
artifact functions the serving manager's fallback load reads through
(reference: ALSUpdate.saveFeaturesRDD :490-499, readFeaturesRDD
:533-541).  The batch trainer that writes them comes with the batch
layer.
"""

from __future__ import annotations

import gzip
import io
import json
from typing import Sequence

import numpy as np

from ...common import store
from ...common import text as text_utils

__all__ = ["save_features", "load_features"]


def save_features(path: str, ids: Sequence[str], matrix: np.ndarray) -> None:
    """Write a factor matrix as gzipped JSON lines ``["id",[floats]]``."""
    path = store.mkdirs(path)
    with store.open_write(store.join(path, "part-00000.gz")) as raw, \
            gzip.open(raw, "wt", encoding="utf-8") as f:
        for id_, row in zip(ids, matrix):
            f.write(text_utils.join_json(
                [id_, [round(float(v), 8) for v in row]]))
            f.write("\n")


def load_features(path: str) -> tuple[list[str], np.ndarray]:
    """Read a factor matrix directory written by save_features."""
    ids: list[str] = []
    rows: list[list[float]] = []
    for part in store.glob(path, "part-*"):
        with store.open_read(part) as raw:
            opener = gzip.open(raw, "rt", encoding="utf-8") \
                if part.endswith(".gz") \
                else io.TextIOWrapper(raw, encoding="utf-8")
            with opener as f:
                for line in f:
                    if line.strip():
                        id_, vector = json.loads(line)
                        ids.append(str(id_))
                        rows.append(vector)
    matrix = np.asarray(rows, dtype=np.float32) if rows else \
        np.zeros((0, 0), dtype=np.float32)
    return ids, matrix
