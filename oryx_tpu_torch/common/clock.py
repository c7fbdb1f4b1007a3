"""The clock the request batcher and the supervisor read.

Counterpart of ``oryx_tpu/common/clock.py``, cut down to ``monotonic``
and ``sleep``: the simulation clocks that seam exists for are not part
of this package.
"""

from __future__ import annotations

import time as _time

__all__ = ["monotonic", "sleep"]


def monotonic() -> float:
    return _time.monotonic()


def sleep(seconds: float) -> None:
    _time.sleep(seconds)
