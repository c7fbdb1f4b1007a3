"""ALS update-topic parsing.

Counterpart of ``oryx_tpu/app/als/common.py``, cut down to
``parse_up_update``, the trust gate of the UP consumers.  The input
parsing and aggregation of the batch layer come with the trainer.
"""

from __future__ import annotations

import logging

import numpy as np

from ...common import text as text_utils

__all__ = ["parse_up_update"]

_log = logging.getLogger(__name__)


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
            or not (vector.size == 0 or bool(np.all(np.isfinite(vector)))):
        _log.warning("Rejecting non-finite/malformed %s update for %s "
                     "(shape %s, expected (%s,))",
                     kind, id_, vector.shape, features)
        return None
    return kind, id_, vector, extras
