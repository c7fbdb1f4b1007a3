"""Example serving layer: model manager + /distinct and /add resources.

Counterpart of ``oryx_tpu/example/serving.py``, on this package's framework
API.

Reference: app/example/src/main/java/com/cloudera/oryx/example/serving/
ExampleServingModelManager.java:35 (MODEL replaces the map, UP applies
"word,count"), Distinct.java:35 (GET /distinct and /distinct/{word}),
Add.java:36 (POST /add/{line} writes the input topic).
"""

from __future__ import annotations

import json
import threading

from ..api.serving import (AbstractServingModelManager, OryxServingException,
                           ServingModel)
from ..common.config import Config
from ..common.device import resolve_device
from ..kafka.api import KEY_MODEL, KEY_UP
from ..lambda_rt.http import Request, Route
from ..serving import console
from ..serving.framework import get_serving_model, send_input

__all__ = ["ExampleServingModel", "ExampleServingModelManager", "ROUTES"]


class ExampleServingModel(ServingModel):

    def __init__(self, words: dict[str, int], lock: threading.Lock):
        self._words = words
        self._lock = lock

    def get_words(self) -> dict[str, int]:
        with self._lock:
            return dict(self._words)

    def get_count(self, word: str) -> int | None:
        with self._lock:
            return self._words.get(word)

    def get_fraction_loaded(self) -> float:
        return 1.0


class ExampleServingModelManager(AbstractServingModelManager):

    def __init__(self, config: Config, device=None):
        super().__init__(config)
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
            word, count = message.split(",")
            with self._lock:
                self._words[word] = int(count)
        else:
            raise ValueError(f"Bad key {key}")

    def get_model(self) -> ExampleServingModel:
        return ExampleServingModel(self._words, self._lock)


def _distinct(req: Request):
    return get_serving_model(req).get_words()


def _distinct_word(req: Request):
    count = get_serving_model(req).get_count(req.params["word"])
    if count is None:
        raise OryxServingException(400, "No such word")
    return count


def _add(req: Request):
    send_input(req, req.params["line"])
    return None


ROUTES = [
    Route("GET", "/distinct", _distinct),
    Route("GET", "/distinct/{word}", _distinct_word),
    Route("POST", "/add/{line}", _add, mutates=True),
    console.console_route("Word Count Example", [
        console.Endpoint("/distinct"),
        console.Endpoint("/distinct/{0}", ("word",)),
        console.Endpoint("/add/{0}", ("line",), method="POST"),
        console.Endpoint("/ready"),
    ]),
]
