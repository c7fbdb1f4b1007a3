"""In-process message broker with Kafka's topic/partition/offset
semantics, optionally backed by files.

Counterpart of ``oryx_tpu/kafka/inproc.py``: topics (created, checked,
deleted), keyed partitioning, appends (one record, or a pipelined batch
in one write per partition, for the input topic's ``/ingest``), offset
reads, range reads of every partition (the batch and speed layers'
drains), the blocking consume, from a group's committed offsets when
one is named, and committed per-(group, topic, partition) offsets, from
which the batch and speed layers resume.

Brokers are addressed by URI: ``memory://<name>`` is a shared named
broker in this process; ``file://<dir>`` keeps each partition as an
append-only JSONL file under ``<dir>`` in the reference's on-disk
format — one ``[key, message]`` (or ``[key, message, headers]``) JSON
array per line, partition 0 in ``<topic>.topic.jsonl``, partitions
1.. in ``<topic>.p<i>.topic.jsonl``, the partition count in
``<topic>.meta.json`` when above 1, the committed offsets in an
``offsets.json`` sidecar written behind with a short throttle (and on
``flush``) — so a topic and a group's offsets written by either package
are read by the other.  A bare ``host:port`` address is a Kafka broker,
spoken to over the wire protocol (kafka/client.py).
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from ..common import clock as clockmod
from ..resilience import faults
from .api import KeyMessage, TopicProducer
from .partitioner import partition_for_key

__all__ = ["InProcBroker", "get_broker", "resolve_broker", "drop_broker",
           "InProcTopicProducer"]

_REGISTRY: dict[str, "InProcBroker"] = {}
_REGISTRY_LOCK = threading.Lock()

# write-behind interval for the offsets sidecar of a persisted broker
_OFFSET_FLUSH_SEC = 0.1


def get_broker(name: str = "default",
               persist_dir: str | None = None) -> "InProcBroker":
    """The shared named broker, created on first use.  Asking for a
    persist_dir other than the one it was created with is an error."""
    with _REGISTRY_LOCK:
        broker = _REGISTRY.get(name)
        if broker is None:
            broker = InProcBroker(name=name, persist_dir=persist_dir)
            _REGISTRY[name] = broker
        elif persist_dir is not None and (
                broker._persist_dir is None
                or os.path.abspath(broker._persist_dir)
                != os.path.abspath(persist_dir)):
            raise ValueError(
                f"broker {name!r} already exists with persist_dir="
                f"{broker._persist_dir!r}, requested {persist_dir!r}")
        return broker


def drop_broker(name: str) -> bool:
    """Close and forget a named broker."""
    with _REGISTRY_LOCK:
        broker = _REGISTRY.pop(name, None)
    if broker is None:
        return False
    broker.close()
    return True


def resolve_broker(broker_uri: str):
    """``memory://<name>`` (or bare ``memory://``) names an in-process
    broker; ``file://<dir>`` a durable one whose logs live under
    ``<dir>``, shared between processes and packages; anything else is
    a Kafka broker's ``host:port``, bound to the wire client
    (``client.KafkaBroker``, one per address)."""
    if broker_uri.startswith("memory://"):
        return get_broker(broker_uri[len("memory://"):] or "default")
    if broker_uri.startswith("file://"):
        path = os.path.abspath(broker_uri[len("file://"):])
        return get_broker(name=f"file:{path}", persist_dir=path)
    from .client import get_kafka_broker
    return get_kafka_broker(broker_uri)


class _Partition:
    """One partition log.  When persisted, the JSONL file is the source
    of truth shared between processes: appends go through a raw
    O_APPEND fd (one write per record), and readers tail the file for
    records other processes appended."""

    def __init__(self, notify, persist_path: str | None):
        self.log: list[tuple[str | None, str, dict | None]] = []
        self._lock = threading.RLock()
        self._notify = notify
        self.persist_path = persist_path
        self._fd: int | None = None
        self._read_pos = 0
        self._tail = b""  # partial last line from a mid-record read
        if persist_path:
            self._fd = os.open(persist_path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
            with self._lock:
                self._refresh_locked()

    def _refresh_locked(self) -> bool:
        """Pull records appended by other processes into memory; True
        when new records appeared.  The caller holds ``_lock``."""
        if self.persist_path is None:
            return False
        try:
            size = os.path.getsize(self.persist_path)
        except OSError:
            return False
        if size <= self._read_pos:
            return False
        with open(self.persist_path, "rb") as f:
            f.seek(self._read_pos)
            chunk = self._tail + f.read()
            # where the read ended, not the size seen before it: another
            # process may have appended in between, and those bytes are
            # in ``chunk`` already
            self._read_pos = f.tell()
        lines = chunk.split(b"\n")
        self._tail = lines.pop()  # b"" unless the last record is partial
        appended = False
        for raw in lines:
            if raw.strip():
                rec = json.loads(raw.decode("utf-8"))
                self.log.append((rec[0], rec[1],
                                 rec[2] if len(rec) > 2 else None))
                appended = True
        return appended

    def append(self, key: str | None, message: str,
               headers: dict | None = None) -> int:
        return self.append_many([(key, message, headers)])

    def append_many(self,
                    records: list[tuple[str | None, str, dict | None]]
                    ) -> int:
        """Append every record in ONE write (one lock, one wake-up);
        O_APPEND keeps the blob contiguous beside other writers.
        Returns the last record's offset."""
        blob = b"".join(
            (json.dumps([k, m] if h is None else [k, m, h]) + "\n")
            .encode("utf-8") for k, m, h in records)
        with self._lock:
            if self.persist_path is not None and self._fd is None:
                # a closed durable broker handed back by the registry:
                # re-open rather than ack into memory only
                self._fd = os.open(self.persist_path,
                                   os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                                   0o644)
            if self._fd is not None:
                # write, then re-read up to and past our records so the
                # in-memory offsets follow the file's order
                if blob:
                    os.write(self._fd, blob)
                self._refresh_locked()
            else:
                self.log.extend(records)
            offset = len(self.log) - 1
        self._notify()
        return offset

    def refresh(self) -> None:
        with self._lock:
            appended = self._refresh_locked()
        if appended:
            self._notify()

    def size(self) -> int:
        with self._lock:
            return len(self.log)

    def get(self, pos: int) -> tuple[str | None, str, dict | None]:
        with self._lock:
            return self.log[pos]

    def latest_offset(self) -> int:
        with self._lock:
            self._refresh_locked()
            return len(self.log)

    def read_range(self, start: int, end: int) -> list[KeyMessage]:
        if end <= start:
            return []
        with self._lock:
            self._refresh_locked()
            return [KeyMessage(k, m, h) for k, m, h in self.log[start:end]]

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


class _Topic:
    """Named partition logs: same key -> same partition, keyless ->
    round-robin."""

    def __init__(self, name: str, paths: list[str | None]):
        self.name = name
        self.cond = threading.Condition()
        self.partitions = [_Partition(self._notify, p) for p in paths]
        self._rr = 0
        self._rr_lock = threading.Lock()

    def _notify(self) -> None:
        with self.cond:
            self.cond.notify_all()

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def partition_for(self, key: str | None) -> int:
        n = len(self.partitions)
        if n == 1:
            return 0
        if key is None:
            with self._rr_lock:
                self._rr = (self._rr + 1) % n
                return self._rr
        return partition_for_key(key, n)

    def refresh_all(self) -> None:
        for p in self.partitions:
            p.refresh()

    def close(self) -> None:
        for p in self.partitions:
            p.close()


def _partition_paths(persist_dir: str | None, topic: str,
                     n: int) -> list[str | None]:
    """Partition 0 in the flat ``<topic>.topic.jsonl``; partitions 1..
    in ``<topic>.p<i>.topic.jsonl`` (the reference's layout)."""
    if persist_dir is None:
        return [None] * n
    return [os.path.join(persist_dir, f"{topic}.topic.jsonl")] + [
        os.path.join(persist_dir, f"{topic}.p{i}.topic.jsonl")
        for i in range(1, n)]


def _meta_partitions(persist_dir: str | None, topic: str) -> int:
    if persist_dir:
        meta = os.path.join(persist_dir, f"{topic}.meta.json")
        if os.path.exists(meta):
            with open(meta, encoding="utf-8") as f:
                return int(json.load(f).get("partitions", 1))
    return 1


class InProcBroker:
    """Named in-process broker of partitioned topics and per-group
    committed per-partition offsets."""

    def __init__(self, name: str = "default",
                 persist_dir: str | None = None):
        self.name = name
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
        self._persist_dir = persist_dir or None
        self._topics: dict[str, _Topic] = {}
        self._lock = threading.Lock()
        # (group, topic, partition) -> the next offset to read
        self._offsets: dict[tuple[str, str, int], int] = {}
        self._offsets_path = (os.path.join(self._persist_dir, "offsets.json")
                              if self._persist_dir else None)
        self._offsets_dirty = False
        self._offsets_last_write = 0.0
        if self._offsets_path and os.path.exists(self._offsets_path):
            with open(self._offsets_path, encoding="utf-8") as f:
                self._offsets = _decode_offsets(json.load(f))
        if self._persist_dir:
            # a ".p<i>" suffix marks a partition file only when the
            # stripped name has a meta sidecar
            metas = {fn[:-len(".meta.json")]
                     for fn in os.listdir(self._persist_dir)
                     if fn.endswith(".meta.json")}
            for fn in os.listdir(self._persist_dir):
                if not fn.endswith(".topic.jsonl"):
                    continue
                base = fn[:-len(".topic.jsonl")]
                head, dot, tail = base.rpartition(".")
                if dot and tail.startswith("p") and tail[1:].isdigit() \
                        and head in metas:
                    continue
                self._topic(base)
            for t in metas:
                self._topic(t)

    def topic_exists(self, topic: str) -> bool:
        with self._lock:
            return topic in self._topics

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        with self._lock:
            existing = self._topics.get(topic)
            if existing is not None:
                if existing.num_partitions != partitions:
                    raise ValueError(
                        f"topic {topic!r} exists with "
                        f"{existing.num_partitions} partition(s), "
                        f"requested {partitions}")
                return
            self._topics[topic] = _Topic(
                topic, _partition_paths(self._persist_dir, topic,
                                        partitions))
            if self._persist_dir and partitions > 1:
                meta = os.path.join(self._persist_dir, f"{topic}.meta.json")
                tmp = meta + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"partitions": partitions}, f)
                os.replace(tmp, meta)

    def delete_topic(self, topic: str) -> None:
        """Drop the topic, its partition logs and meta sidecar, and every
        group's offsets of it."""
        with self._lock:
            t = self._topics.pop(topic, None)
            if t:
                t.close()
                for p in t.partitions:
                    if p.persist_path and os.path.exists(p.persist_path):
                        os.remove(p.persist_path)
                if self._persist_dir:
                    meta = os.path.join(self._persist_dir,
                                        f"{topic}.meta.json")
                    if os.path.exists(meta):
                        os.remove(meta)
            self._offsets = {k: v for k, v in self._offsets.items()
                             if k[1] != topic}
            if self._offsets_path:
                self._write_offsets_locked(drop_topic=topic)

    def _topic(self, topic: str) -> _Topic:
        with self._lock:
            if topic not in self._topics:
                # another process may have created the topic since this
                # broker started: its meta sidecar gives the count
                n = _meta_partitions(self._persist_dir, topic)
                self._topics[topic] = _Topic(
                    topic, _partition_paths(self._persist_dir, topic, n))
            return self._topics[topic]

    def num_partitions(self, topic: str) -> int:
        return self._topic(topic).num_partitions

    def send(self, topic: str, key: str | None, message: str,
             headers: dict | None = None) -> int:
        """Append to the key's partition; returns the record's offset
        within that partition."""
        # chaos seam: error (broker down), delay (slow broker), drop
        # (acked but lost) or duplicate (a producer retry's redelivery)
        action = faults.fire("inproc-send")
        if action == "drop":
            return -1
        t = self._topic(topic)
        p = t.partitions[t.partition_for(key)]
        offset = p.append(key, message, headers)
        if action == "duplicate":
            offset = p.append(key, message, headers)
        return offset

    def send_many(self, topic: str,
                  entries: list[tuple[str | None, str, dict | None]]
                  ) -> int:
        """Pipelined produce: classify every record to its partition,
        then append each partition's records in one write, in order.
        The ``inproc-send`` seam fires per record, so drop and
        duplicate keep their per-record meaning, and an error raises
        before ANY record lands.  Returns the records appended."""
        t = self._topic(topic)
        groups: dict[int, list[tuple[str | None, str, dict | None]]] = {}
        sent = 0
        for key, message, headers in entries:
            action = faults.fire("inproc-send")
            if action == "drop":
                continue
            p = t.partition_for(key)
            groups.setdefault(p, []).append((key, message, headers))
            sent += 1
            if action == "duplicate":
                groups[p].append((key, message, headers))
        for p, recs in groups.items():
            t.partitions[p].append_many(recs)
        return sent

    def latest_offset(self, topic: str) -> int:
        """The end offset of a single-partition topic."""
        t = self._topic(topic)
        if t.num_partitions != 1:
            raise ValueError(
                f"topic {topic!r} has {t.num_partitions} partitions; "
                "use latest_offsets")
        return t.partitions[0].latest_offset()

    def latest_offsets(self, topic: str) -> list[int]:
        """Per-partition end offsets."""
        return [p.latest_offset() for p in self._topic(topic).partitions]

    def read_range(self, topic: str, start: int, end: int) -> list[KeyMessage]:
        """[start, end) of a single-partition topic."""
        t = self._topic(topic)
        if t.num_partitions != 1:
            raise ValueError(
                f"topic {topic!r} has {t.num_partitions} partitions; "
                "use read_ranges")
        return t.partitions[0].read_range(start, end)

    def read_ranges(self, topic: str, starts: list[int | None],
                    ends: list[int]) -> list[KeyMessage]:
        """Drain [start, end) of every partition (a None start is 0),
        the partitions read concurrently, the records concatenated in
        partition order: order within a partition is kept, order across
        partitions is unspecified (Kafka's guarantee)."""
        faults.fire("inproc-read")  # chaos seam: drain failure mid-fetch
        t = self._topic(topic)
        n = t.num_partitions
        if len(starts) != n or len(ends) != n:
            raise ValueError(f"expected {n} starts/ends for topic {topic!r}")
        jobs = [(p, 0 if s is None else s, e)
                for p, s, e in zip(t.partitions, starts, ends)]
        if n == 1:
            return jobs[0][0].read_range(jobs[0][1], jobs[0][2])
        with ThreadPoolExecutor(max_workers=n) as pool:
            chunks = list(pool.map(lambda j: j[0].read_range(j[1], j[2]),
                                   jobs))
        return [km for chunk in chunks for km in chunk]

    def consume(self, topic: str, group: str | None = None,
                from_beginning: bool = False,
                poll_timeout_sec: float = 0.1,
                stop: threading.Event | None = None,
                max_idle_sec: float | None = None) -> Iterator[KeyMessage]:
        """Blocking iterator over every partition of a topic.  With a
        ``group``, each partition starts at the group's committed offset
        (else as below) and commits as the consumer comes back for the
        next record — at least once (UpdateOffsetsFn.java:37-64);
        without one, from offset 0 with ``from_beginning`` or else from
        the latest, never committing.  Partitions are interleaved
        round-robin; order within a partition is kept.  Ends when
        ``stop`` is set or ``max_idle_sec`` passes with no new
        record."""
        t = self._topic(topic)
        n = t.num_partitions
        pos: list[int] = []
        for part in range(n):
            p = None if group is None else self.get_offset(group, topic,
                                                           part)
            if p is None:
                p = 0 if from_beginning \
                    else t.partitions[part].latest_offset()
            pos.append(p)
        idle_since = clockmod.monotonic()
        next_part = 0
        try:
            while True:
                while True:
                    ready = [i for i in range(n)
                             if pos[i] < t.partitions[i].size()]
                    if ready:
                        break
                    if stop is not None and stop.is_set():
                        return
                    if (max_idle_sec is not None
                            and clockmod.monotonic() - idle_since
                            > max_idle_sec):
                        return
                    with t.cond:
                        # bounded wait: an append between the size check
                        # and this wait costs at most one poll interval
                        t.cond.wait(poll_timeout_sec)  # wall-clock: Condition poll; the sim reads through read_range, never this loop
                    # other processes' appends never signal our Condition
                    t.refresh_all()
                part = min(ready, key=lambda i: (i - next_part) % n)
                key, message, headers = t.partitions[part].get(pos[part])
                pos[part] += 1
                next_part = (part + 1) % n
                idle_since = clockmod.monotonic()
                # committed only once the consumer has processed the
                # record and come back: a consumer that dies mid-record
                # has it redelivered
                yield KeyMessage(key, message, headers)
                if group is not None:
                    self.set_offset(group, topic, pos[part], part)
                if stop is not None and stop.is_set():
                    return
        finally:
            if group is not None:
                self.flush()

    # -- committed offsets ---------------------------------------------------

    def get_offset(self, group: str, topic: str,
                   partition: int = 0) -> int | None:
        """The group's committed offset of one partition, or None."""
        with self._lock:
            return self._offsets.get((group, topic, partition))

    def get_offsets(self, group: str, topic: str) -> list[int | None]:
        """The group's committed offset of every partition (None where
        it has none)."""
        n = self.num_partitions(topic)
        with self._lock:
            return [self._offsets.get((group, topic, p)) for p in range(n)]

    def set_offset(self, group: str, topic: str, offset: int,
                   partition: int = 0) -> None:
        """Commit the group's next offset of one partition."""
        faults.fire("inproc-commit")  # chaos seam: commit failure
        with self._lock:
            self._offsets[(group, topic, partition)] = int(offset)
            self._maybe_write_offsets_locked()

    def set_offsets(self, group: str, topic: str,
                    offsets: list[int]) -> None:
        """Commit the group's next offset of every partition."""
        faults.fire("inproc-commit")  # chaos seam: commit failure
        with self._lock:
            for p, off in enumerate(offsets):
                self._offsets[(group, topic, p)] = int(off)
            self._maybe_write_offsets_locked()

    def fill_in_latest_offsets(self, group: str, topics: list[str]) -> None:
        """Commit the latest offset of every (topic, partition) the group
        has none for — "start from now" (KafkaUtils.fillInLatestOffsets)."""
        for topic in topics:
            for part, end in enumerate(self.latest_offsets(topic)):
                if self.get_offset(group, topic, part) is None:
                    self.set_offset(group, topic, end, part)

    def _maybe_write_offsets_locked(self) -> None:
        # written behind with a throttle: losing the last interval's
        # commits in a crash only redelivers, which at-least-once
        # allows; flush() (and a grouped consume's end) bounds the window
        if self._offsets_path:
            self._offsets_dirty = True
            if (clockmod.monotonic() - self._offsets_last_write
                    >= _OFFSET_FLUSH_SEC):
                self._write_offsets_locked()

    def _write_offsets_locked(self, drop_topic: str | None = None) -> None:
        # merged with the file's entries, so processes sharing the
        # broker directory keep each other's groups
        merged: dict[tuple[str, str, int], int] = {}
        if os.path.exists(self._offsets_path):
            try:
                with open(self._offsets_path, encoding="utf-8") as f:
                    merged = _decode_offsets(json.load(f))
            except (OSError, ValueError):
                pass
        merged.update(self._offsets)
        if drop_topic is not None:
            merged = {k: v for k, v in merged.items() if k[1] != drop_topic}
        tmp = self._offsets_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({f"{g}\x00{t}\x00{p}": v
                       for (g, t, p), v in merged.items()}, f)
        os.replace(tmp, self._offsets_path)
        self._offsets_dirty = False
        self._offsets_last_write = clockmod.monotonic()

    def flush(self) -> None:
        """Write committed offsets that are still behind to the sidecar."""
        with self._lock:
            if self._offsets_dirty:
                self._write_offsets_locked()

    def close(self) -> None:
        """Flush the offsets and release the topic log file handles."""
        with self._lock:
            if self._offsets_dirty:
                self._write_offsets_locked()
            for topic in self._topics.values():
                topic.close()


def _decode_offsets(raw: dict[str, int]) -> dict[tuple[str, str, int], int]:
    """The offsets sidecar's ``group\0topic\0partition`` keys."""
    out: dict[tuple[str, str, int], int] = {}
    for k, v in raw.items():
        group, topic, partition = k.split("\x00")
        out[(group, topic, int(partition))] = v
    return out


class InProcTopicProducer(TopicProducer):
    """TopicProducer over an in-process broker (reference:
    TopicProducerImpl.java:32-94; the append is synchronous)."""

    def __init__(self, broker_uri: str, topic: str):
        self._broker_uri = broker_uri
        self._topic = topic
        self._broker = resolve_broker(broker_uri)

    def send(self, key: str | None, message: str,
             headers: dict | None = None) -> None:
        self._broker.send(self._topic, key, message, headers)

    def send_many(self, entries: list[tuple[str | None, str,
                                            dict | None]]) -> None:
        """Pipelined multi-record produce (one broker call, one write
        per partition touched)."""
        self._broker.send_many(self._topic, entries)

    def get_update_broker(self) -> str:
        return self._broker_uri

    def get_topic(self) -> str:
        return self._topic

    def close(self) -> None:
        pass
