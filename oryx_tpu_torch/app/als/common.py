"""ALS input parsing, decay and aggregation, and the update-topic
trust gate.

Counterpart of ``oryx_tpu/app/als/common.py``, whole (reference:
ALSUpdate.java — parsedToRatingRDD :349, an empty strength is a delete
and becomes NaN; decayRating :383; aggregateScores :395-423, implicit:
a NaN-propagating sum, so a delete wipes the pair, explicit: the last
value wins; knownsRDD :551-577).  These are host-side transforms; their
output is a compact COO triple for the trainer.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Iterable, NamedTuple, Sequence

import numpy as np

from ...common import text as text_utils
from ...kafka.api import KeyMessage
from ...ml.integrity import is_finite_array

__all__ = ["ParsedRatings", "parse_timestamp", "parse_events", "aggregate",
           "build_known_items", "decay_value", "parse_up_update"]

_log = logging.getLogger(__name__)

MS_PER_DAY = 86_400_000.0


def parse_up_update(message: str, features: int | None = None
                    ) -> tuple[str, str, np.ndarray, list | None] | None:
    """Parse and check an "UP" factor update payload
    ``["X"|"Y", id, [floats], [known...]?]``.

    Returns ``(kind, id, vector, extras)`` — ``extras`` the optional
    4th element (known-item IDs) or None — or None when the payload is
    malformed, of the wrong dimension (``features``, when given), or
    carries non-finite values.  The callers count the refusal and skip
    the record: a raised error inside a replay-from-0 consumer would
    make one poison message an endless cycle, and an absorbed NaN row
    would poison every score it touches."""
    try:
        update = text_utils.read_json(message)
        # KeyError: a JSON object payload indexes by key, not position
        kind, id_ = str(update[0]), str(update[1])
        vector = np.asarray(update[2], dtype=np.float32)
        extras = list(update[3]) if len(update) > 3 else None
    except (ValueError, IndexError, KeyError, TypeError):
        _log.warning("Rejecting malformed update (%d bytes)", len(message))
        return None
    if vector.ndim != 1 \
            or (features is not None and vector.shape[0] != features) \
            or not is_finite_array(vector):
        _log.warning("Rejecting non-finite/malformed %s update for %s "
                     "(shape %s, expected (%s,))",
                     kind, id_, vector.shape, features)
        return None
    return kind, id_, vector, extras


class ParsedRatings(NamedTuple):
    """Aggregated interaction data in index space."""

    user_ids: list[str]           # index -> user ID (sorted)
    item_ids: list[str]           # index -> item ID (sorted)
    users: np.ndarray             # (nnz,) int32 user indices
    items: np.ndarray             # (nnz,) int32 item indices
    values: np.ndarray            # (nnz,) float32 aggregated strengths


def parse_timestamp(tokens: list[str]) -> int:
    """Timestamp from the optional 4th input field (reference:
    MLFunctions.TO_TIMESTAMP_FN); 0 when absent/empty."""
    return int(float(tokens[3])) if len(tokens) > 3 and tokens[3] != "" else 0


def _parse_line(line: str) -> tuple[str, str, float, int]:
    tokens = text_utils.parse_input_line(line)
    user, item = tokens[0], tokens[1]
    # empty strength means 'delete'; propagate as NaN
    value = float("nan") if tokens[2] == "" else float(tokens[2])
    return user, item, value, parse_timestamp(tokens)


def decay_value(value: float, timestamp_ms: int, now_ms: int,
                factor: float) -> float:
    """Per-day exponential decay (reference: ALSUpdate.decayRating :383)."""
    if timestamp_ms >= now_ms:
        return value
    days = (now_ms - timestamp_ms) / MS_PER_DAY
    return value * math.pow(factor, days)


def parse_events(data: Iterable[KeyMessage | str],
                 decay_factor: float = 1.0,
                 decay_zero_threshold: float = 0.0,
                 now_ms: int | None = None) -> list[tuple[str, str, float, int]]:
    """Parse, decay, and threshold raw input lines; returns (user, item,
    value, ts) tuples ordered by timestamp."""
    now_ms = int(time.time() * 1000) if now_ms is None else now_ms
    out = []
    for km in data:
        line = km.message if isinstance(km, KeyMessage) else km
        user, item, value, ts = _parse_line(line)
        if decay_factor < 1.0 and not math.isnan(value):
            value = decay_value(value, ts, now_ms, decay_factor)
        # decayed to nothing -> drop; NaN (delete) compares False and is kept
        if decay_zero_threshold > 0.0 and value <= decay_zero_threshold:
            continue
        out.append((user, item, value, ts))
    out.sort(key=lambda t: t[3])
    return out


def aggregate(events: Sequence[tuple[str, str, float, int]],
              implicit: bool,
              log_strength: bool = False,
              epsilon: float = float("nan")) -> ParsedRatings:
    """Collapse per-(user,item) events into one strength each.

    Implicit: sum with NaN propagation — any delete wipes the pair, and
    the pair drops out entirely.  Explicit: last (by timestamp) wins;
    NaN last value drops the pair.  (reference: aggregateScores :395-423)
    """
    agg: dict[tuple[str, str], float] = {}
    for user, item, value, _ in events:  # events already timestamp-ordered
        key = (user, item)
        if implicit:
            cur = agg.get(key)
            agg[key] = value if cur is None else cur + value  # NaN propagates
        else:
            agg[key] = value
    pairs = [(k, v) for k, v in agg.items() if not math.isnan(v)]

    if log_strength:
        if not epsilon > 0.0:
            raise ValueError(f"epsilon must be positive: {epsilon}")
        # log1p(v/eps) is undefined for v <= -eps; treat as NaN (the
        # reference's Math.log1p yields NaN rather than raising) and
        # drop the pair instead of aborting the whole build
        def _log1p_or_nan(v: float) -> float:
            ratio = v / epsilon
            return math.log1p(ratio) if ratio > -1.0 else float("nan")

        pairs = [(k, w) for k, w in ((k, _log1p_or_nan(v)) for k, v in pairs)
                 if not math.isnan(w)]

    user_ids = sorted({u for (u, _), _ in pairs})
    item_ids = sorted({i for (_, i), _ in pairs})
    uidx = {u: j for j, u in enumerate(user_ids)}
    iidx = {i: j for j, i in enumerate(item_ids)}
    n = len(pairs)
    users = np.empty(n, dtype=np.int32)
    items = np.empty(n, dtype=np.int32)
    values = np.empty(n, dtype=np.float32)
    for j, ((u, i), v) in enumerate(pairs):
        users[j] = uidx[u]
        items[j] = iidx[i]
        values[j] = v
    return ParsedRatings(user_ids, item_ids, users, items, values)


def build_known_items(events: Sequence[tuple[str, str, float, int]]
                      ) -> dict[str, set[str]]:
    """Timestamp-ordered known-items per user: a delete (NaN) removes the
    item from the set (reference: ALSUpdate.knownsRDD :551-577)."""
    known: dict[str, set[str]] = {}
    for user, item, value, _ in events:
        s = known.setdefault(user, set())
        if math.isnan(value):
            s.discard(item)
        else:
            s.add(item)
    return known
