"""Small statistics helpers.

Counterpart of ``oryx_tpu/common/stats.py``, as is (reference: framework/oryx-common/src/main/java/com/cloudera/oryx/common/
math/DoubleWeightedMean.java:29, the storeless weighted mean).
"""

from __future__ import annotations

__all__ = ["DoubleWeightedMean"]


class DoubleWeightedMean:
    """Online weighted mean: increment(value, weight); .result; .count."""

    def __init__(self):
        self._count = 0
        self._total_weight = 0.0
        self._mean = 0.0

    def increment(self, value: float, weight: float = 1.0) -> None:
        self._count += 1
        self._total_weight += weight
        if self._total_weight != 0.0:
            self._mean += (weight / self._total_weight) * (value - self._mean)

    @property
    def result(self) -> float:
        return self._mean if self._count > 0 else float("nan")

    @property
    def count(self) -> int:
        return self._count

    def clear(self) -> None:
        self.__init__()

    def __repr__(self):  # pragma: no cover
        return f"DoubleWeightedMean({self.result})"
