"""Topic admin against a broker URI.

Counterpart of ``oryx_tpu/kafka/utils.py`` (reference: KafkaUtils.java
maybeCreateTopic :63), cut down to what the serving layer calls.
"""

from __future__ import annotations

import logging

from .inproc import resolve_broker

_log = logging.getLogger(__name__)

__all__ = ["maybe_create_topic", "input_topic_partitions"]


def input_topic_partitions(config) -> int:
    """The configured input-topic partition count
    (``oryx.input-topic.partitions``, 4 in reference.conf, the count
    oryx-run.sh:343 uses): every component that may create the input
    topic creates it with this many."""
    return config.get_int("oryx.input-topic.partitions")


def maybe_create_topic(broker_uri: str, topic: str,
                       partitions: int = 1) -> None:
    broker = resolve_broker(broker_uri)
    if broker.topic_exists(topic):
        existing = broker.num_partitions(topic)
        if existing != partitions:
            _log.warning(
                "Topic %s already exists with %d partition(s), not the "
                "requested %d; leaving it as-is", topic, existing,
                partitions)
    else:
        _log.info("Creating topic %s with %d partition(s)", topic,
                  partitions)
        broker.create_topic(topic, partitions)

