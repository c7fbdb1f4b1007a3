"""Example speed layer: incremental co-occurrence counts.

Counterpart of ``oryx_tpu/example/speed.py``, on this package's framework
API.

Reference: app/example/src/main/java/com/cloudera/oryx/example/speed/
ExampleSpeedModelManager.java:37 — MODEL replaces the in-memory map;
each micro-batch counts the batch's distinct-other-words, adds them to
the map, and emits "word,newCount" UP messages.
"""

from __future__ import annotations

import json
import threading
from typing import Iterable, Sequence

from ..api.speed import AbstractSpeedModelManager
from ..common.config import Config
from ..common.device import resolve_device
from ..kafka.api import KEY_MODEL, KEY_UP, KeyMessage
from .batch import count_distinct_other_words

__all__ = ["ExampleSpeedModelManager"]


class ExampleSpeedModelManager(AbstractSpeedModelManager):

    def __init__(self, config: Config, device=None):
        # word counts live on the host; ``device`` (None means ``cuda``)
        # is resolved as every entry point of the package resolves it
        resolve_device(device)
        self._words: dict[str, int] = {}
        self._lock = threading.Lock()

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == KEY_MODEL:
            model = json.loads(message)
            with self._lock:
                self._words.clear()
                self._words.update(model)
        elif key == KEY_UP:
            pass  # hearing our own updates
        else:
            raise ValueError(f"Bad key {key}")

    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        out = []
        for word, count in count_distinct_other_words(new_data).items():
            with self._lock:
                new_count = self._words.get(word, 0) + count
                self._words[word] = new_count
            out.append(f"{word},{new_count}")
        return out
