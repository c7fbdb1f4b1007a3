"""The Kafka wire binding behind the broker seam.

Counterpart of ``oryx_tpu/kafka/client.py`` (reference: framework/
kafka-util/.../KafkaUtils.java:63-181 — topic create, exists and delete
and per-(topic, partition) consumer-group offsets against a real
broker).  The layers address brokers by URI: ``memory://`` and
``file://`` resolve in-process (inproc.py), a bare ``host:port`` here to
a ``KafkaBroker`` speaking the Kafka binary protocol over sockets
(wire.py).  It offers ``InProcBroker``'s surface, so every layer runs
unchanged against a Kafka cluster.

Consumers assign partitions explicitly and commit offsets as standalone
consumers (generation -1): the layers consume whole topics with offsets
they manage (AbstractSparkLayer.java:170-216, UpdateOffsetsFn.java:
37-64), so group rebalancing is out of scope.  Offsets live broker-side
in ``__consumer_offsets``.  Record headers (``ts``, ``traceparent``,
the speed checkpoint's ``speed-shard``/``speed-batch``/``speed-seq``)
travel as v2 record headers both ways; the reference's binding accepts
them on send and drops them.  Two more departures, each one request
where the reference makes several: ``send_many`` sends a pipelined
multi-record produce as one Produce request (the reference's
``InProcTopicProducer.send_many`` has no wire counterpart), and
``latest_offsets`` reads every partition's end with one ListOffsets
request — one broker answers either as a single snapshot, so a reader
never sees part of a ``send_many``.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator

from ..resilience.policy import Backoff, Retry
from .api import KeyMessage, TopicProducer
from .partitioner import partition_for_key
from .wire import KafkaProtocolError, WireKafkaClient

__all__ = ["kafka_client_available", "get_kafka_broker", "KafkaBroker",
           "KafkaTopicProducer", "is_transient_kafka_error"]

# error codes a client retries: the broker is alive but this request
# lost a race it wins later (leadership moved, timed out, coordinator
# still loading)
_TRANSIENT_CODES = {6, 7, 15}


def is_transient_kafka_error(e: BaseException) -> bool:
    """Retry policy for broker I/O: connection failures and the
    transient Kafka codes; anything else (bad request, unknown topic)
    is a caller's bug and surfaces at once."""
    if isinstance(e, KafkaProtocolError):
        return e.code in _TRANSIENT_CODES
    return isinstance(e, (ConnectionError, OSError, TimeoutError))


_BROKERS: dict[str, "KafkaBroker"] = {}
_BROKERS_LOCK = threading.Lock()


def kafka_client_available() -> bool:
    """Always true: the wire client is part of the package."""
    return True


def get_kafka_broker(bootstrap: str) -> "KafkaBroker":
    """The shared client of one address (as get_broker's registry)."""
    with _BROKERS_LOCK:
        broker = _BROKERS.get(bootstrap)
        if broker is None:
            broker = KafkaBroker(bootstrap)
            _BROKERS[bootstrap] = broker
        return broker


def _enc(s: str | None) -> bytes | None:
    return None if s is None else s.encode("utf-8")


def _dec(b: bytes | None) -> str | None:
    return None if b is None else b.decode("utf-8")


def _enc_headers(headers: dict | None) -> list[tuple[str, bytes | None]]:
    return [(k, _enc(v)) for k, v in (headers or {}).items()]


def _key_message(key: bytes | None, value: bytes | None,
                 headers: list) -> KeyMessage:
    return KeyMessage(_dec(key), _dec(value),
                      {k: _dec(v) for k, v in headers} if headers else None)


class KafkaBroker:
    """``InProcBroker``'s surface over the wire client."""

    def __init__(self, bootstrap: str):
        self.bootstrap = bootstrap
        self._client = WireKafkaClient(bootstrap)
        # transient broker errors (timed out, leader moved, coordinator
        # loading, connection died) retry with backoff instead of
        # failing a layer's generation; the stats feed /metrics
        self._retry = Retry(f"kafka-client[{bootstrap}]",
                            retryable=is_transient_kafka_error,
                            max_attempts=5,
                            backoff=Backoff(initial=0.05, maximum=1.0))
        self._lock = threading.Lock()
        # sticky per-topic round-robin pointer for unkeyed sends
        self._rr: dict[str, int] = {}
        # per-group coordinator clients: offset commits and fetches go
        # to the group's coordinator on a multi-node cluster
        self._coord: dict[str, WireKafkaClient] = {}
        self._coord_lock = threading.Lock()

    def _coordinator(self, group: str) -> WireKafkaClient:
        with self._coord_lock:
            c = self._coord.get(group)
            if c is None:
                host, port = self._client.find_coordinator(group)
                if (host, port) == (self._client.host, self._client.port):
                    c = self._client
                else:
                    c = WireKafkaClient(f"{host}:{port}")
                self._coord[group] = c
            return c

    # -- topic admin (KafkaUtils.java:63-133) ----------------------------

    def topic_exists(self, topic: str) -> bool:
        return self._client.partitions_for(topic) is not None

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        err = self._client.create_topic(topic, partitions)
        if err not in (0, 36):  # exists is fine
            raise KafkaProtocolError(err, f"CreateTopics({topic})")

    def delete_topic(self, topic: str) -> None:
        err = self._client.delete_topic(topic)
        if err not in (0, 3):   # missing is fine
            raise KafkaProtocolError(err, f"DeleteTopics({topic})")

    def num_partitions(self, topic: str) -> int:
        parts = self._client.partitions_for(topic)
        return len(parts) if parts else 1

    def _partitions(self, topic: str) -> list[int]:
        parts = self._client.partitions_for(topic)
        if parts is None:
            raise ValueError(f"no partition metadata for {topic!r}")
        return parts

    def _partition_of(self, topic: str, key: str | None,
                      parts: list[int]) -> int:
        if key is not None:
            return parts[partition_for_key(key, len(parts))]
        with self._lock:
            i = self._rr.get(topic, 0)
            self._rr[topic] = i + 1
        return parts[i % len(parts)]

    # -- produce / consume ----------------------------------------------

    def send(self, topic: str, key: str | None, message: str,
             headers: dict | None = None) -> int:
        p = self._partition_of(topic, key, self._partitions(topic))
        # a retried produce can duplicate a record the broker acked but
        # whose ack was lost — at least once, every layer's contract
        return self._retry.call(
            self._client.produce, topic, p,
            [(_enc(key), _enc(message), _enc_headers(headers))])

    def send_many(self, topic: str,
                  entries: list[tuple[str | None, str, dict | None]]
                  ) -> int:
        """Pipelined produce: every record classified to its partition,
        then one Produce request carrying each partition's records in
        order.  A failure retries the whole request (at least once).
        Returns the records sent."""
        parts = self._partitions(topic)
        by_partition: dict[int, list] = {}
        for key, message, headers in entries:
            by_partition.setdefault(
                self._partition_of(topic, key, parts), []).append(
                    (_enc(key), _enc(message), _enc_headers(headers)))
        if by_partition:
            self._retry.call(self._client.produce_many, topic,
                             by_partition)
        return sum(len(v) for v in by_partition.values())

    def latest_offset(self, topic: str) -> int:
        offs = self.latest_offsets(topic)
        if len(offs) != 1:
            raise ValueError(
                f"topic {topic!r} has {len(offs)} partitions; "
                "use latest_offsets")
        return offs[0]

    def latest_offsets(self, topic: str) -> list[int]:
        parts = self._partitions(topic)
        got = self._retry.call(self._client.list_offsets, topic, parts, -1)
        return [got[p] for p in parts]

    def read_range(self, topic: str, start: int, end: int) -> list[KeyMessage]:
        return self.read_ranges(topic, [start], [end])

    def read_ranges(self, topic: str, starts: list[int | None],
                    ends: list[int]) -> list[KeyMessage]:
        if len(starts) != len(ends):
            raise ValueError(
                f"read_ranges: {len(starts)} starts vs {len(ends)} ends")
        if all(e <= (0 if s is None else s)
               for s, e in zip(starts, ends)):
            return []
        parts = self._partitions(topic)
        if len(parts) != len(starts):
            raise ValueError(
                f"read_ranges: topic {topic!r} has {len(parts)} "
                f"partition(s) but {len(starts)} range(s) were given"
                " — refusing a partial drain")
        out: list[KeyMessage] = []
        # a connection of its own: a drain long-polls each partition and
        # must not hold the shared connection other calls wait on
        c = WireKafkaClient(self.bootstrap)
        try:
            for p, (s, e) in zip(parts, zip(starts, ends)):
                s = 0 if s is None else s
                pos = s
                deadline = time.monotonic() + 30
                while pos < e:
                    if time.monotonic() >= deadline:
                        # a silent partial drain would let the caller
                        # commit past unread records: fail, and the
                        # layer retries the whole range next run
                        raise TimeoutError(
                            f"drained only [{s}, {pos}) of [{s}, {e}) "
                            f"from {topic}/p{p} within 30s")
                    recs = self._retry.call(c.fetch, topic, p, pos,
                                            max_wait_ms=500,
                                            with_headers=True)
                    for off, key, value, headers in recs:
                        if off >= e:
                            break
                        out.append(_key_message(key, value, headers))
                    if recs:
                        pos = max(pos + 1, recs[-1][0] + 1)
            return out
        finally:
            c.close()

    def consume(self, topic: str, group: str | None = None,
                from_beginning: bool = False,
                poll_timeout_sec: float = 0.1,
                stop: threading.Event | None = None,
                max_idle_sec: float | None = None) -> Iterator[KeyMessage]:
        parts = self._partitions(topic)
        # a connection of its own: a tailing consumer long-polls for
        # ever and must not serialize other callers behind it
        c = WireKafkaClient(self.bootstrap)
        positions: dict[int, int] = {}
        committed: dict[int, int | None] = (
            self._coordinator(group).offset_fetch(group, topic, parts)
            if group is not None else {p: None for p in parts})
        for p in parts:
            if committed.get(p) is not None:
                positions[p] = committed[p]
            elif from_beginning:
                positions[p] = 0
            else:
                positions[p] = c.list_offset(topic, p, -1)
        idle_since = time.monotonic()
        # offsets of records handed back AND processed (control came
        # back to this generator), committed in one round trip per poll
        # batch — at least once on a crash between commits
        pending: dict[int, int] = {}

        def _commit_pending() -> None:
            if group is not None and pending:
                self._coordinator(group).offset_commit(
                    group, topic, dict(pending))
                pending.clear()

        def _fetch(p: int) -> list:
            try:
                return self._retry.call(c.fetch, topic, p, positions[p],
                                        max_wait_ms=wait_ms,
                                        with_headers=True)
            except KafkaProtocolError as e:
                if e.code != 1:  # OFFSET_OUT_OF_RANGE
                    raise
                # retention truncated past the position (or the topic
                # was recreated): reset as auto.offset.reset does and
                # keep the consumer alive
                positions[p] = c.list_offset(
                    topic, p, -2 if from_beginning else -1)
                return []

        wait_ms = max(1, int(poll_timeout_sec * 1000))
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                _commit_pending()
                got = False
                for p in parts:
                    for off, key, value, headers in _fetch(p):
                        got = True
                        idle_since = time.monotonic()
                        positions[p] = off + 1
                        yield _key_message(key, value, headers)
                        # reaching here means the caller processed the
                        # record; committing before the yield would
                        # commit unprocessed records
                        pending[p] = off + 1
                        if stop is not None and stop.is_set():
                            return
                if (not got and max_idle_sec is not None
                        and time.monotonic() - idle_since > max_idle_sec):
                    return
        finally:
            try:
                _commit_pending()
            finally:
                c.close()

    # -- offsets (broker-side group offsets; KafkaUtils.java:134-180) ----

    def get_offset(self, group: str, topic: str,
                   partition: int = 0) -> int | None:
        return self._coordinator(group).offset_fetch(
            group, topic, [partition]).get(partition)

    def get_offsets(self, group: str, topic: str) -> list[int | None]:
        parts = self._partitions(topic)
        got = self._coordinator(group).offset_fetch(group, topic, parts)
        return [got.get(p) for p in parts]

    def set_offset(self, group: str, topic: str, offset: int,
                   partition: int = 0) -> None:
        self._retry.call(self._coordinator(group).offset_commit, group,
                         topic, {partition: offset})

    def set_offsets(self, group: str, topic: str,
                    offsets: list[int]) -> None:
        # a commit lost to a transient failure only redelivers (at
        # least once); retrying keeps that window narrow
        self._retry.call(self._coordinator(group).offset_commit, group,
                         topic, dict(enumerate(offsets)))

    def fill_in_latest_offsets(self, group: str, topics: list[str]) -> None:
        for topic in topics:
            latest = self.latest_offsets(topic)
            committed = self.get_offsets(group, topic)
            missing = {p: end for p, (end, cur) in
                       enumerate(zip(latest, committed)) if cur is None}
            if missing:
                self._coordinator(group).offset_commit(group, topic,
                                                       missing)

    def flush(self) -> None:
        pass  # sends are synchronous acked produces

    def close(self) -> None:
        self._client.close()
        with self._coord_lock:
            for c in self._coord.values():
                if c is not self._client:
                    c.close()
            self._coord.clear()


class KafkaTopicProducer(TopicProducer):
    """TopicProducer over a Kafka broker (TopicProducerImpl parity)."""

    def __init__(self, broker_uri: str, topic: str, async_send: bool = False):
        self._broker_uri = broker_uri
        self._topic = topic
        self._broker = get_kafka_broker(broker_uri)

    def send(self, key: str | None, message: str,
             headers: dict | None = None) -> None:
        self._broker.send(self._topic, key, message, headers)

    def send_many(self, entries: list[tuple[str | None, str,
                                            dict | None]]) -> None:
        """Pipelined multi-record produce: one Produce request."""
        self._broker.send_many(self._topic, entries)

    def get_update_broker(self) -> str:
        return self._broker_uri

    def get_topic(self) -> str:
        return self._topic

    def close(self) -> None:
        self._broker.flush()
