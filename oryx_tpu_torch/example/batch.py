"""Example batch update: distinct co-occurring word counts.

Counterpart of ``oryx_tpu/example/batch.py``, on this package's framework
API.

Reference: app/example/src/main/java/com/cloudera/oryx/example/batch/
ExampleBatchLayerUpdate.java:39 — per generation, over new+past data:
for every line, form all ordered (word, otherWord) pairs of distinct
tokens, deduplicate pairs globally, count per word, publish the whole
map as an inline JSON "MODEL" message.
"""

from __future__ import annotations

import json
from typing import Sequence

from ..api.batch import BatchLayerUpdate
from ..common.config import Config
from ..common.device import resolve_device
from ..kafka.api import KEY_MODEL, KeyMessage, TopicProducer

__all__ = ["ExampleBatchLayerUpdate", "count_distinct_other_words"]


def count_distinct_other_words(
        data: Sequence[KeyMessage]) -> dict[str, int]:
    pairs: set[tuple[str, str]] = set()
    for km in data:
        tokens = set(km.message.split(" "))
        for a in tokens:
            for b in tokens:
                if a != b:
                    pairs.add((a, b))
    counts: dict[str, int] = {}
    for a, _ in pairs:
        counts[a] = counts.get(a, 0) + 1
    return counts


class ExampleBatchLayerUpdate(BatchLayerUpdate):

    def __init__(self, config: Config, device=None):
        # word counts live on the host; ``device`` (None means ``cuda``)
        # is resolved as every entry point of the package resolves it
        resolve_device(device)

    def run_update(self, timestamp_ms: int,
                   new_data: Sequence[KeyMessage],
                   past_data: Sequence[KeyMessage],
                   model_dir: str,
                   model_update_topic: TopicProducer | None) -> None:
        all_data = list(new_data) + list(past_data or [])
        model = count_distinct_other_words(all_data)
        if model_update_topic is not None:
            model_update_topic.send(KEY_MODEL, json.dumps(model))
