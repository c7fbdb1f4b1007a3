"""The clock the request batcher reads.

Counterpart of ``oryx_tpu/common/clock.py``, cut down to ``monotonic``:
the simulation clocks that seam exists for are not part of this
package.
"""

from __future__ import annotations

import time as _time

__all__ = ["monotonic"]


def monotonic() -> float:
    return _time.monotonic()
