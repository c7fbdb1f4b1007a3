"""Synthetic data producers and topic tailers, for tests and operations.

Counterpart of ``oryx_tpu/kafka/produce.py`` (reference: framework/
kafka-util test scope — DatumGenerator.java, one (key, message) per id;
ProduceData.java:36, random CSV data sent to a topic; ConsumeData.java:
29 and ConsumeTopicRunnable, a topic tailed into a list).  The
``kafka-input`` command streams real files and does not use these.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..common.rand import RandomManager
from .api import KeyMessage
from .inproc import resolve_broker

__all__ = ["DatumGenerator", "csv_datum_generator", "ProduceData",
           "ConsumeTopic"]

# DatumGenerator contract: (id, rng) -> (key, message)
DatumGenerator = Callable[[int, object], tuple[str | None, str]]


def csv_datum_generator(num_features: int = 3) -> DatumGenerator:
    """Random CSV feature rows like ``3,true,-0.135`` (the reference's
    default ProduceData payload)."""

    def generate(id_: int, rng) -> tuple[str | None, str]:
        fields = [str(id_)]
        for f in range(num_features - 1):
            if f % 2 == 0:
                fields.append(str(bool(rng.integers(0, 2))).lower())
            else:
                fields.append(f"{rng.standard_normal():.3f}")
        return None, ",".join(fields)

    return generate


class ProduceData:
    """Send ``how_many`` generated records to a topic, optionally paced
    (reference: ProduceData.start/doProduce)."""

    def __init__(self, generator: DatumGenerator, broker_uri: str,
                 topic: str, how_many: int, interval_sec: float = 0.0):
        self.generator = generator
        self.broker_uri = broker_uri
        self.topic = topic
        self.how_many = how_many
        self.interval_sec = interval_sec

    def start(self) -> int:
        broker = resolve_broker(self.broker_uri)
        rng = RandomManager.random()
        for i in range(self.how_many):
            key, message = self.generator(i, rng)
            broker.send(self.topic, key, message)
            if self.interval_sec:
                time.sleep(self.interval_sec)
        return self.how_many


class ConsumeTopic:
    """A background tailer collecting a topic's messages into a list
    (reference: ConsumeTopicRunnable / ConsumeDataIterator)."""

    def __init__(self, broker_uri: str, topic: str,
                 from_beginning: bool = True):
        self.broker_uri = broker_uri
        self.topic = topic
        self.from_beginning = from_beginning
        self.key_messages: list[KeyMessage] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ConsumeTopic":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ConsumeTopic-{self.topic}")
        self._thread.start()
        return self

    def _run(self) -> None:
        broker = resolve_broker(self.broker_uri)
        for km in broker.consume(self.topic,
                                 from_beginning=self.from_beginning,
                                 stop=self._stop):
            self.key_messages.append(km)

    def await_count(self, n: int, timeout_sec: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_sec
        while time.monotonic() < deadline:
            if len(self.key_messages) >= n:
                return True
            time.sleep(0.02)
        return len(self.key_messages) >= n

    def close(self) -> list[KeyMessage]:
        self._stop.set()
        if self._thread:
            self._thread.join(5.0)
        return list(self.key_messages)
