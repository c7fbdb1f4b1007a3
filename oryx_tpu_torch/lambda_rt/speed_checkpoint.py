"""The durable micro-batch fence of the (sharded) speed layer.

Counterpart of ``oryx_tpu/lambda_rt/speed_checkpoint.py``.  A speed
worker killed between a micro-batch's UP publishes and its input-offset
commit reads the batch again on restart, and ``build_updates`` would
fold it a second time against a model whose update consumer has already
applied the first attempt's deltas.  Reading again is unavoidable;
folding twice is not.  One atomic JSON checkpoint per worker holds

- ``input``: the next input-topic offset of each partition, where the
  micro-batch loop resumes;
- ``next_batch``: a persisted batch counter, so batch identity never
  depends on the wall clock and restarts never collide;
- ``dest_scanned``: the update-topic offsets recovery has examined, so
  the next scan is incremental;
- ``pending``: the staged batch — the exact update strings, their base
  headers and the input ``ends`` they cover — written before the first
  publish.

Every published UP carries ``speed-shard``/``speed-batch``/``speed-seq``
headers.  After a crash inside the window, recovery scans the update
topic from ``dest_scanned`` for this worker's (shard, batch) records,
takes the log as the arbiter of what landed, republishes only the
missing sequence numbers from the staged bytes (byte-identical to the
first attempt, never derived again against the moved model), and then
commits.  Found sequences count as ``speed_shard_dedup_skips``.
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Iterable, Sequence

from ..common import store

_log = logging.getLogger(__name__)

__all__ = ["SpeedCheckpoint", "recover_pending", "stamp_headers",
           "H_SPEED_SHARD", "H_SPEED_BATCH", "H_SPEED_SEQ"]

# the record headers of every checkpointed UP publish: the worker, the
# micro-batch and the position in it, the identity recovery dedups on
H_SPEED_SHARD = "speed-shard"
H_SPEED_BATCH = "speed-batch"
H_SPEED_SEQ = "speed-seq"


def stamp_headers(base: dict, shard_tag: str, batch: int,
                  seq: int) -> dict:
    """One staged update's publish headers: the batch's base headers
    (``ts``, maybe ``traceparent``) and the worker/batch/seq identity."""
    h = dict(base)
    h[H_SPEED_SHARD] = shard_tag
    h[H_SPEED_BATCH] = str(batch)
    h[H_SPEED_SEQ] = str(seq)
    return h


class SpeedCheckpoint:
    """One speed worker's durable state, a single JSON document written
    atomically (tmp, then rename).  The staged batch lives in the same
    document, so a load sees the batch staged (a crash before the
    commit, which recovery resolves) or committed, never half of each."""

    FILE = "speed-checkpoint.json"

    def __init__(self, checkpoint_dir: str):
        store.mkdirs(checkpoint_dir)
        self.path = store.join(checkpoint_dir, self.FILE)
        self.input: dict[int, int] = {}
        self.dest_scanned: dict[int, int] = {}
        self.next_batch = 0
        self.pending: dict | None = None
        self.load()

    def load(self) -> None:
        if not store.exists(self.path):
            return
        try:
            with store.open_read(self.path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            _log.warning("Unreadable speed checkpoint at %s; the worker "
                         "restarts from group offsets with no pending "
                         "batch", self.path, exc_info=True)
            return
        self.input = {int(k): int(v)
                      for k, v in (doc.get("input") or {}).items()}
        self.dest_scanned = {int(k): int(v) for k, v
                             in (doc.get("dest_scanned") or {}).items()}
        self.next_batch = int(doc.get("next_batch", 0))
        pending = doc.get("pending")
        self.pending = pending if isinstance(pending, dict) else None

    def save(self) -> None:
        doc = {
            "input": {str(k): v for k, v in self.input.items()},
            "dest_scanned": {str(k): v
                             for k, v in self.dest_scanned.items()},
            "next_batch": self.next_batch,
            "pending": self.pending,
        }
        tmp = self.path + ".tmp"
        with store.open_write(tmp, "wb") as f:
            f.write(json.dumps(doc, sort_keys=True).encode("utf-8"))
        store.rename(tmp, self.path)

    # -- the micro-batch protocol -------------------------------------------

    def stage_batch(self, ends: Sequence[int], updates: Sequence[str],
                    headers: dict) -> int:
        """Stage a derived micro-batch durably before its first publish;
        returns the batch id the publishes stamp."""
        batch = self.next_batch
        self.pending = {"batch": batch, "ends": [int(e) for e in ends],
                        "headers": dict(headers),
                        "updates": list(updates)}
        self.save()
        return batch

    def commit_batch(self, ends: Sequence[int],
                     dest_ends: Sequence[int] | None = None) -> None:
        """Every publish of the batch is in the update topic: advance the
        input fence past it, retire the staged batch and (best effort)
        move the update-topic scan mark, in one atomic write."""
        self.input = {i: int(e) for i, e in enumerate(ends)}
        self.next_batch += 1
        self.pending = None
        if dest_ends is not None:
            for p, e in enumerate(dest_ends):
                if e is None:
                    continue
                self.dest_scanned[p] = max(self.dest_scanned.get(p, 0),
                                           int(e))
        self.save()


def recover_pending(checkpoint: SpeedCheckpoint, shard_tag: str,
                    read_dest: Callable[[list[int], list[int]], Iterable],
                    dest_ends: Sequence[int],
                    publish: Callable[[str, dict], None]
                    ) -> tuple[int, int]:
    """Resolve a staged, uncommitted micro-batch against the update
    topic.

    ``read_dest(starts, ends)`` yields the update records (objects with
    ``.headers``) in ``[starts, ends)``; ``publish(message, headers)``
    appends one update.  Returns ``(republished, deduped)``: the staged
    sequences missing from the log and sent again from the staged bytes,
    and those found already there.  ``(0, 0)`` with nothing pending.  A
    crash anywhere inside leaves the stage in place, and a later run
    converges."""
    pending = checkpoint.pending
    if pending is None:
        return 0, 0
    batch = int(pending["batch"])
    updates = list(pending.get("updates") or [])
    base = dict(pending.get("headers") or {})
    starts = [checkpoint.dest_scanned.get(p, 0)
              for p in range(len(dest_ends))]
    found: set[int] = set()
    for km in read_dest(starts, [int(e) for e in dest_ends]):
        h = getattr(km, "headers", None) or {}
        if h.get(H_SPEED_SHARD) != shard_tag:
            continue
        try:
            if int(h.get(H_SPEED_BATCH)) != batch:
                continue
            found.add(int(h.get(H_SPEED_SEQ)))
        except (TypeError, ValueError):
            continue
    republished = 0
    for seq, update in enumerate(updates):
        if seq in found:
            continue  # already in the log: skip, never fold twice
        publish(update, stamp_headers(base, shard_tag, batch, seq))
        republished += 1
    if republished or found:
        _log.info("Speed recovery (%s batch %d): %d already durable, "
                  "%d republished from the staged bytes", shard_tag,
                  batch, len(found), republished)
    # dest_ends predates the republishes, so the scan mark can never
    # pass a record a later recovery needs: scans look only for the one
    # pending batch, and it is committed here
    checkpoint.commit_batch(pending.get("ends") or [], dest_ends=dest_ends)
    return republished, len(found)
