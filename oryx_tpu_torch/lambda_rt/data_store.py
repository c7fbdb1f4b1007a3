"""Generation-file data store: historical input + TTL cleanup.

Counterpart of ``oryx_tpu/lambda_rt/data_store.py``, whole, on this
package's store (local paths and ``file://``); a generation file
written by either package is read by the other.

Reference: the batch layer persists each generation's input as
timestamped SequenceFiles under data-dir on a *shared* filesystem and
re-reads ALL of them as "past data" each generation
(SaveToHDFSFunction.java:35-86 writes ``oryx-<timestampMs>.data``
idempotently; BatchUpdateFunction.java:103-130 globs
``data-dir/*/part-*``), and TTL-deletes old data/model dirs
(DeleteOldDataFn.java:37-79).

Here a generation is one gzipped JSONL file of [key, message] pairs,
written through ``common.store``.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import re
import time
from typing import Sequence

from ..common import store
from ..kafka.api import KeyMessage

_log = logging.getLogger(__name__)

__all__ = ["save_generation", "read_all_data", "last_saved_offsets",
           "delete_old_data", "delete_old_models"]

_DATA_FILE_RE = re.compile(r"^oryx-(\d+)\.data\.jsonl\.gz$")


def save_generation(data_dir: str, timestamp_ms: int,
                    data: Sequence[KeyMessage],
                    end_offsets: dict[str, list[int]] | None = None
                    ) -> str | None:
    """Write one generation's input; idempotent (a partial earlier
    attempt is replaced, as the reference deletes partial output).

    ``end_offsets`` ({topic: per-partition end offsets}) rides in the
    file's first line, INSIDE the same atomic rename as the data: a
    crash between this save and the broker offset commit would
    otherwise make the next generation read these records both as past
    data (from this file) and as new data (from the uncommitted input
    range) — the batch layer reconciles from this header on start
    (:func:`last_saved_offsets`, BatchLayer._recover_offsets)."""
    if not data:
        return None
    store.mkdirs(data_dir)
    path = store.join(data_dir, f"oryx-{timestamp_ms}.data.jsonl.gz")
    tmp = path + ".tmp"
    with store.open_write(tmp) as raw, \
            gzip.open(raw, "wt", encoding="utf-8") as f:
        if end_offsets:
            f.write(json.dumps({"end_offsets": end_offsets}) + "\n")
        for km in data:
            f.write(json.dumps([km.key, km.message]) + "\n")
    store.rename(tmp, path)
    return path


def last_saved_offsets(data_dir: str) -> dict[str, list[int]] | None:
    """The newest generation file's covered input end-offsets, or None
    (no data, or files written before headers existed)."""
    paths = [p for p in store.glob(data_dir, "oryx-*.data.jsonl.gz")
             if _DATA_FILE_RE.match(os.path.basename(p))]
    if not paths:
        return None
    newest = max(paths, key=lambda p: int(
        _DATA_FILE_RE.match(os.path.basename(p)).group(1)))
    with store.open_read(newest) as raw, \
            gzip.open(raw, "rt", encoding="utf-8") as f:
        first = f.readline()
    try:
        obj = json.loads(first) if first.strip() else None
    except ValueError:
        return None
    if isinstance(obj, dict) and "end_offsets" in obj:
        return {t: [int(o) for o in offs]
                for t, offs in obj["end_offsets"].items()}
    return None


def read_all_data(data_dir: str,
                  before_timestamp_ms: int | None = None) -> list[KeyMessage]:
    """All stored generations (optionally only those strictly older than
    a timestamp), in generation order."""
    out: list[KeyMessage] = []
    for path in store.glob(data_dir, "oryx-*.data.jsonl.gz"):
        m = _DATA_FILE_RE.match(os.path.basename(path))
        if not m:
            continue
        if before_timestamp_ms is not None and int(m.group(1)) >= before_timestamp_ms:
            continue
        with store.open_read(path) as raw, \
                gzip.open(raw, "rt", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    if isinstance(rec, dict):
                        continue  # offsets header, not a record
                    out.append(KeyMessage(rec[0], rec[1]))
    return out


def _delete_older_than(dir_path: str, pattern: str, extract_ts, max_age_hours: int,
                       kind: str) -> int:
    if max_age_hours < 0:
        return 0
    cutoff = int(time.time() * 1000) - max_age_hours * 3_600_000
    deleted = 0
    for path in store.glob(dir_path, pattern):
        ts = extract_ts(os.path.basename(path))
        if ts is not None and ts < cutoff:
            _log.info("Deleting old %s %s", kind, path)
            store.delete_recursively(path)
            deleted += 1
    return deleted


def delete_old_data(data_dir: str, max_age_hours: int) -> int:
    """TTL-delete generation data files (reference: DeleteOldDataFn)."""
    def ts(name: str):
        m = _DATA_FILE_RE.match(name)
        return int(m.group(1)) if m else None

    return _delete_older_than(data_dir, "oryx-*.data.jsonl.gz", ts,
                              max_age_hours, "data file")


def delete_old_models(model_dir: str, max_age_hours: int) -> int:
    """TTL-delete timestamped model dirs (reference: DeleteOldDataFn)."""
    def ts(name: str):
        return int(name) if name.isdigit() else None

    return _delete_older_than(model_dir, "[0-9]*", ts, max_age_hours,
                              "model dir")
