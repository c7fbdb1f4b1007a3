"""ALS result rescoring plugin API.

Counterpart of ``oryx_tpu/app/als/rescorer.py``, cut down to the
``Rescorer`` type that ``ALSServingModel.top_n`` takes (reference:
Rescorer.java:24).  Providers and their loading come with the
config-driven model manager of a later slice.
"""

from __future__ import annotations

import abc

__all__ = ["Rescorer"]


class Rescorer(abc.ABC):
    """Transforms scores of candidate results, or filters them out."""

    @abc.abstractmethod
    def rescore(self, item_id: str, score: float) -> float: ...

    def is_filtered(self, item_id: str) -> bool:
        return False
