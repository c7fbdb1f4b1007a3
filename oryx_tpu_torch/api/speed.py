"""Speed layer user contract.

Counterpart of ``oryx_tpu/api/speed.py`` (reference:
SpeedModelManager.java:37-68, SpeedModel.java:23,
AbstractSpeedModelManager.java:36).
"""

from __future__ import annotations

import abc
from typing import Iterable, Iterator, Sequence

from ..kafka.api import KeyMessage

__all__ = ["SpeedModel", "SpeedModelManager", "AbstractSpeedModelManager"]


class SpeedModel(abc.ABC):
    """In-memory model state of the speed layer."""

    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Approximate fraction of the model loaded so far (the gate
        below which no update is built)."""


class SpeedModelManager(abc.ABC):
    """Consumes models and updates from the update topic and derives
    deltas from new input.  Configured via
    ``oryx.speed.model-manager-class``."""

    @abc.abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        """Read model and update messages until the stream ends,
        maintaining the in-memory speed model."""

    @abc.abstractmethod
    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        """Derive model deltas from one micro-batch of input; each
        returned string is sent with key "UP"."""

    def close(self) -> None:
        pass


class AbstractSpeedModelManager(SpeedModelManager):
    """Adapts the stream contract to a per-message callback."""

    def consume(self, updates: Iterator[KeyMessage]) -> None:
        for km in updates:
            self.consume_key_message(km.key, km.message)

    @abc.abstractmethod
    def consume_key_message(self, key: str | None, message: str) -> None: ...
