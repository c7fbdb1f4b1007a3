"""Topic admin and group offsets against a broker URI.

Counterpart of ``oryx_tpu/kafka/utils.py`` (reference: KafkaUtils.java
maybeCreateTopic :63, topicExists :100, deleteTopic :113,
getTopicOffsets/getOffsets :134, setOffsets :161, fillInLatestOffsets
:181).
"""

from __future__ import annotations

import logging

from .inproc import resolve_broker

_log = logging.getLogger(__name__)

__all__ = ["maybe_create_topic", "topic_exists", "delete_topic",
           "get_offsets", "set_offsets", "fill_in_latest_offsets",
           "input_topic_partitions"]


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


def topic_exists(broker_uri: str, topic: str) -> bool:
    return resolve_broker(broker_uri).topic_exists(topic)


def delete_topic(broker_uri: str, topic: str) -> None:
    broker = resolve_broker(broker_uri)
    if broker.topic_exists(topic):
        _log.info("Deleting topic %s", topic)
        broker.delete_topic(topic)


def get_offsets(broker_uri: str, group: str,
                topics: list[str]) -> dict[str, list[int | None]]:
    """The group's committed offsets, topic -> one per partition."""
    broker = resolve_broker(broker_uri)
    return {t: broker.get_offsets(group, t) for t in topics}


def set_offsets(broker_uri: str, group: str,
                offsets: dict[str, list[int]]) -> None:
    broker = resolve_broker(broker_uri)
    for topic, offs in offsets.items():
        broker.set_offsets(group, topic, offs)


def fill_in_latest_offsets(broker_uri: str, group: str,
                           topics: list[str]) -> None:
    resolve_broker(broker_uri).fill_in_latest_offsets(group, topics)
