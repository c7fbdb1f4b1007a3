"""Sharded model distribution: per-slice factor artifacts + manifest.

Counterpart of ``oryx_tpu/app/als/slices.py``.  The item-factor rows are
partitioned into ``ring`` slices by the murmur2 contract of
``cluster/sharding.shard_of``; each slice is one deterministic gzip
artifact of JSON rows ``[id, [floats], ordinal]`` (the ordinal is the
row's index in the monolithic Y order); the user-side artifact holds
``[id, [floats], [known...]]`` rows; a manifest records the ring, each
artifact's path, row count, byte count and CRC-32, and each slice's
partial Gramian.  The MODEL-REF record carries the manifest without the
Gramians as a JSON envelope ``{"path", "dir", "manifest"}``.  With an IVF
index (``oryx.als.ann.publish-index``) the manifest also names the
centroid artifact, and each slice entry its cell assignments.  The bytes
and checksums are the reference's for the same catalog, so either
package reads what the other wrote.  A missing or corrupt slice
(checksum mismatch; chaos point ``store-slice-missing``) raises
``SliceIntegrityError``, and the serving manager falls back to the
monolithic ``Y/`` and ``X/`` artifacts.
"""

from __future__ import annotations

import gzip
import io
import json
import logging
import zlib

import numpy as np

from ...cluster.sharding import shard_of
from ...common import store
from ...common import text as text_utils
from ...resilience.faults import fire as _fault

_log = logging.getLogger(__name__)

__all__ = [
    "MANIFEST_FILE", "SliceIntegrityError", "owned_slices", "iter_slices",
    "publish_sliced", "read_manifest", "read_slice", "read_x_known",
    "model_ref_message", "parse_model_ref",
]

MANIFEST_FILE = "manifest.json"
_SLICES_DIR = "Y-slices"
_X_KNOWN_FILE = "X-known.jsonl.gz"


class SliceIntegrityError(Exception):
    """A slice artifact is missing, truncated, or fails its checksum —
    the caller falls back to the monolithic artifacts."""


def owned_slices(ring: int, shard_index: int,
                 shard_count: int) -> list[int] | None:
    """Slices a ``shard_index/shard_count`` replica owns, or None when
    the ring is incompatible (``shard_count`` does not divide ``ring``
    — slice membership ``h % ring`` then says nothing about shard
    membership ``h % shard_count``, and the caller must fall back)."""
    if shard_count <= 1:
        return list(range(ring))
    if ring % shard_count:
        return None
    return [j for j in range(ring) if j % shard_count == shard_index]


def iter_slices(item_ids: list[str], Y, ring: int):
    """Yield ``(slice_index, ids, rows, ordinals)`` per murmur2 slice,
    gathering rows by index from the (n, features) matrix ``Y``."""
    by_slice: list[list[int]] = [[] for _ in range(ring)]
    for idx, iid in enumerate(item_ids):
        by_slice[shard_of(iid, ring)].append(idx)
    features = int(Y.shape[1]) if len(item_ids) else 0
    for s, idxs in enumerate(by_slice):
        if idxs:
            rows = np.asarray(Y[np.asarray(idxs, dtype=np.int64)],
                              dtype=np.float32)
        else:
            rows = np.zeros((0, features), dtype=np.float32)
        yield s, [item_ids[i] for i in idxs], rows, idxs


def _gzip_lines(lines) -> bytes:
    """Deterministic gzip of JSON lines (mtime pinned so the artifact
    bytes — and therefore the manifest checksum — are a pure function
    of the content)."""
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
        for line in lines:
            gz.write(line.encode("utf-8"))
            gz.write(b"\n")
    return buf.getvalue()


def _write_artifact(model_dir: str, rel_path: str, payload: bytes) -> int:
    with store.open_write(store.join(model_dir, rel_path)) as f:
        f.write(payload)
    return zlib.crc32(payload)


def publish_sliced(model_dir: str, y_ids: list[str], Y,
                   x_ids: list[str], X,
                   known: dict[str, list[str]] | None,
                   ring: int, ann=None) -> dict:
    """Write the sliced artifacts + manifest under ``model_dir`` and
    return the slim manifest (no Gramians) for the MODEL-REF envelope.
    Rows are serialized with ``save_features``' 8-decimal rounding, so a
    slice-loaded model holds the same float32 vectors as one that
    replayed the UP stream.

    ``ann`` is an optional ``(centroids, cells)`` pair: the trainer's IVF
    coarse quantizer and each item's cell, aligned to ``y_ids``.  The
    centroids go out once per generation, each slice's cells beside its
    factors, so a serving replica reads the cells of the slices it
    owns."""
    if ring < 1:
        raise ValueError(f"slice ring must be >= 1, got {ring}")
    ann_cells = None
    if ann is not None:
        from . import ivf
        centroids, ann_cells = ann
        ann_cells = np.asarray(ann_cells, dtype=np.int64)
        if len(ann_cells) != len(y_ids):
            raise ValueError(
                f"{len(ann_cells)} cell assignments for "
                f"{len(y_ids)} items")
        ann_entry = ivf.publish_centroids(model_dir, centroids)
    features = int(Y.shape[1]) if len(y_ids) else \
        (int(X.shape[1]) if len(x_ids) else 0)
    slices_meta = []
    gramians = []
    for s, ids, rows, idxs in iter_slices(y_ids, Y, ring):
        # 8-decimal rounding, like save_features — rounded ONCE in f64
        # so the serialized decimals, the Gramian, and the f32 values a
        # consumer parses back all describe the same numbers
        r64 = np.round(rows.astype(np.float64), 8)
        lines = (text_utils.join_json([iid, list(row), ordinal])
                 for iid, row, ordinal in zip(ids, r64.tolist(), idxs))
        payload = _gzip_lines(lines)
        rel = f"{_SLICES_DIR}/slice-{s:05d}.jsonl.gz"
        crc = _write_artifact(model_dir, rel, payload)
        entry = {"slice": s, "path": rel, "rows": len(ids),
                 "bytes": len(payload), "crc32": crc}
        if ann_cells is not None:
            cells_payload = _gzip_lines([json.dumps(
                [int(ann_cells[i]) for i in idxs],
                separators=(",", ":"))])
            cells_rel = f"{_SLICES_DIR}/ann-{s:05d}.json.gz"
            cells_crc = _write_artifact(model_dir, cells_rel,
                                        cells_payload)
            entry["ann"] = {"path": cells_rel, "rows": len(ids),
                            "bytes": len(cells_payload),
                            "crc32": cells_crc}
        slices_meta.append(entry)
        # the partial Gramian of EXACTLY the float32 rows a consumer
        # will hold, accumulated in f64: partials over disjoint row
        # sets sum to the full YtY within the docs/NUMERICS.md bound
        held = r64.astype(np.float32).astype(np.float64)
        g = held.T @ held
        gramians.append([[float(v) for v in grow] for grow in g])

    def x_lines():
        x64 = np.round(np.asarray(X, dtype=np.float32)
                       .astype(np.float64), 8)
        for uid, row in zip(x_ids, x64.tolist()):
            if known is None:
                yield text_utils.join_json([uid, row])
            else:
                yield text_utils.join_json(
                    [uid, row, sorted(known.get(uid, ()))])

    x_payload = _gzip_lines(x_lines())
    x_crc = _write_artifact(model_dir, _X_KNOWN_FILE, x_payload)
    manifest = {
        "version": 1,
        "ring": ring,
        "features": features,
        "items": len(y_ids),
        "users": len(x_ids),
        "slices": slices_meta,
        "x": {"path": _X_KNOWN_FILE, "rows": len(x_ids),
              "bytes": len(x_payload), "crc32": x_crc,
              "known_items": known is not None},
        "gramians": gramians,
    }
    if ann is not None:
        manifest["ann"] = ann_entry
    with store.open_write(store.join(model_dir, MANIFEST_FILE)) as f:
        f.write(json.dumps(manifest).encode("utf-8"))
    return {k: v for k, v in manifest.items() if k != "gramians"}


def read_manifest(model_dir: str) -> dict | None:
    """The FULL manifest (Gramians included) from the store, or None
    when absent/corrupt — callers that only need the slim manifest
    already hold it from the MODEL-REF envelope."""
    try:
        with store.open_read(store.join(model_dir, MANIFEST_FILE)) as f:
            return json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None


def _read_checked(model_dir: str, entry: dict) -> bytes:
    """Artifact bytes for a manifest entry, checksum-verified.  The
    chaos point ``store-slice-missing`` models a missing/corrupt slice
    (docs/RESILIENCE.md): the caller fails closed to the monolithic
    artifacts and counts ``slice_load_fallbacks``."""
    _fault("store-slice-missing", error=lambda: SliceIntegrityError(
        f"injected corrupt slice at {entry.get('path')}"))
    path = store.join(model_dir, entry["path"])
    try:
        with store.open_read(path) as f:
            payload = f.read()
    except OSError as e:
        raise SliceIntegrityError(f"unreadable slice {path}: {e}") from e
    if zlib.crc32(payload) != int(entry["crc32"]):
        raise SliceIntegrityError(f"checksum mismatch for {path}")
    return payload


def _parse_lines(payload: bytes) -> list:
    try:
        with gzip.open(io.BytesIO(payload), "rt", encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
    except (OSError, EOFError, ValueError) as e:
        raise SliceIntegrityError(f"undecodable slice artifact: {e}") from e


def read_slice(model_dir: str, entry: dict, features: int
               ) -> tuple[list[str], np.ndarray, list[int]]:
    """(ids, float32 matrix, global ordinals) for one slice entry,
    integrity-checked; raises :class:`SliceIntegrityError` on any
    mismatch so the caller can fail closed."""
    rows = _parse_lines(_read_checked(model_dir, entry))
    if len(rows) != int(entry["rows"]):
        raise SliceIntegrityError(
            f"slice {entry['path']}: {len(rows)} rows, manifest says "
            f"{entry['rows']}")
    ids = [str(r[0]) for r in rows]
    matrix = np.asarray([r[1] for r in rows], dtype=np.float32) \
        if rows else np.zeros((0, features), dtype=np.float32)
    if rows and matrix.shape != (len(rows), features):
        raise SliceIntegrityError(
            f"slice {entry['path']}: bad row shape {matrix.shape}")
    if rows and not np.isfinite(matrix).all():
        raise SliceIntegrityError(
            f"slice {entry['path']}: non-finite factors")
    return ids, matrix, [int(r[2]) for r in rows]


def read_x_known(model_dir: str, entry: dict, features: int
                 ) -> tuple[list[str], np.ndarray, list[list[str]]]:
    """(ids, float32 matrix, per-user known-item lists) from the
    user-side artifact; rows without a known list yield []."""
    rows = _parse_lines(_read_checked(model_dir, entry))
    if len(rows) != int(entry["rows"]):
        raise SliceIntegrityError(
            f"x artifact: {len(rows)} rows, manifest says {entry['rows']}")
    ids = [str(r[0]) for r in rows]
    matrix = np.asarray([r[1] for r in rows], dtype=np.float32) \
        if rows else np.zeros((0, features), dtype=np.float32)
    if rows and (matrix.shape != (len(rows), features)
                 or not np.isfinite(matrix).all()):
        raise SliceIntegrityError("x artifact: bad or non-finite rows")
    known = [[str(i) for i in r[2]] if len(r) > 2 else [] for r in rows]
    return ids, matrix, known


# -- MODEL-REF envelope -------------------------------------------------------

def model_ref_message(pmml_path: str, model_dir: str,
                      slim_manifest: dict) -> str:
    """The manifest-carrying MODEL-REF payload.  Old consumers treated
    the message as a bare path; the envelope is JSON (first byte '{'
    can never start a filesystem/URI path the old publisher emitted),
    and :func:`parse_model_ref` accepts both forms."""
    return json.dumps({"path": pmml_path, "dir": model_dir,
                       "manifest": slim_manifest},
                      separators=(",", ":"))


def parse_model_ref(message: str) -> tuple[str, str | None, dict | None]:
    """(pmml path, model dir, slim manifest) from a MODEL-REF payload;
    bare-path messages (the pre-manifest publisher, and every non-ALS
    app) return (path, None, None)."""
    text = message.lstrip()
    if not text.startswith("{"):
        return message, None, None
    try:
        d = json.loads(text)
        path = str(d["path"])
        manifest = d.get("manifest")
        return (path, str(d["dir"]) if "dir" in d else None,
                manifest if isinstance(manifest, dict) else None)
    except (ValueError, KeyError, TypeError):
        _log.warning("Malformed MODEL-REF envelope (%d bytes); treating "
                     "as a bare path", len(message))
        return message, None, None
