"""Batch layer user contract.

Counterpart of ``oryx_tpu/api/batch.py`` (reference:
BatchLayerUpdate.java:38-59).  The update is handed plain in-memory
sequences of (key, message) pairs; its heavy compute goes through
torch tensors built from them.
"""

from __future__ import annotations

import abc
from typing import Sequence

from ..kafka.api import KeyMessage, TopicProducer

__all__ = ["BatchLayerUpdate"]


class BatchLayerUpdate(abc.ABC):
    """How a new batch of data updates the model.  Configured via
    ``oryx.batch.update-class`` (a class of this package)."""

    @abc.abstractmethod
    def run_update(self,
                   timestamp_ms: int,
                   new_data: Sequence[KeyMessage],
                   past_data: Sequence[KeyMessage],
                   model_dir: str,
                   model_update_topic: TopicProducer | None) -> None:
        """Run one generation: combine new and historical data into a
        new model, written under ``model_dir`` and announced on the
        update topic."""
