"""Serving bench fixtures.

Counterpart of ``oryx_tpu/bench/load.py``, cut down to
``StaticModelManager`` (reference test scope:
MockServingModelManager.java:27).  The load generators come with the
port's benchmark.
"""

from __future__ import annotations

from ..api.serving import ServingModelManager

__all__ = ["StaticModelManager"]


class StaticModelManager(ServingModelManager):
    """Read-only manager serving a prebuilt model, for benches, endpoint
    tests and the chip smoke run.  Subclass per use and set the
    ``model`` class attribute."""

    model = None

    def __init__(self, config=None):
        pass

    def consume(self, updates) -> None:
        pass

    def get_model(self):
        return type(self).model

    def is_read_only(self) -> bool:
        return True
