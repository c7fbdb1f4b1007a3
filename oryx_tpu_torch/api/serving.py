"""Serving layer user contract.

Counterpart of ``oryx_tpu/api/serving.py`` (reference:
ServingModelManager.java:35-76, ServingModel.java:23,
OryxServingException.java:26, HasCSV.java:25), without the
update-topic types: the Kafka/update-topic model load comes with a
later slice, so ``consume`` takes any iterable of updates.
"""

from __future__ import annotations

import abc
from typing import Any, Iterable

__all__ = ["ServingModel", "ServingModelManager", "OryxServingException",
           "HasCSV"]


class ServingModel(abc.ABC):
    """In-memory model state of the serving layer."""

    @abc.abstractmethod
    def get_fraction_loaded(self) -> float: ...


class ServingModelManager(abc.ABC):
    """Consumes models/updates and exposes the current servable model."""

    @abc.abstractmethod
    def consume(self, updates: Iterable[Any]) -> None: ...

    @abc.abstractmethod
    def get_model(self) -> Any: ...

    def is_read_only(self) -> bool:
        return False


class OryxServingException(Exception):
    """An error with an HTTP status, mapped to a plain-text error response
    (reference: OryxServingException.java:26).  ``headers`` optionally
    rides extra response headers out with the error page."""

    def __init__(self, status: int, message: str = "",
                 headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.headers = headers


class HasCSV(abc.ABC):
    """Response DTOs that know how to render as a CSV line
    (reference: HasCSV.java:25)."""

    @abc.abstractmethod
    def to_csv(self) -> str: ...
