"""MiniKafkaBroker: an in-process TCP server speaking the Kafka protocol
subset of wire.py.

Counterpart of ``oryx_tpu/kafka/mini_broker.py`` (reference: the test
tier's real broker inside the suite, LocalKafkaBroker.java:35 and
LocalZKServer.java:41), so the client binding runs against real sockets
and real protocol bytes.  State is in memory: per-partition record logs
(record headers kept) and per-(group, topic, partition) committed
offsets.  Fetch long-polls up to max_wait_ms as a real broker does, so
tailing consumers do not spin.

Not a durability or replication story (the file:// broker in inproc.py
is the cross-process durable log); this is the protocol stand-in for a
production cluster.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from ..resilience import faults
from .wire import (API_API_VERSIONS, API_CREATE_TOPICS, API_DELETE_TOPICS,
                   API_FETCH, API_FIND_COORD, API_LIST_OFFSETS,
                   API_METADATA, API_OFFSET_COMMIT, API_OFFSET_FETCH,
                   API_PRODUCE, Reader, Writer, decode_record_batches,
                   encode_record_batch)

__all__ = ["MiniKafkaBroker"]


class _Topic:
    def __init__(self, partitions: int):
        # each partition: a list of (key, value, headers); offset = index
        self.parts: list[list[tuple]] = [[] for _ in range(partitions)]


class MiniKafkaBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auto_create_partitions: int | None = None):
        """``auto_create_partitions``: when set, unknown topics named in
        a Metadata request are created with that many partitions
        (auto.create.topics.enable); None = strict."""
        self._topics: dict[str, _Topic] = {}
        self._offsets: dict[tuple[str, str, int], int] = {}
        self._lock = threading.Lock()
        self._data_event = threading.Condition(self._lock)
        self._auto_create = auto_create_partitions
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.host, self.port = self._srv.getsockname()
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True,
                                               name="MiniKafkaBroker")
        self._accept_thread.start()

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass

    # -- server loop ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._closed:
                head = self._read_n(conn, 4)
                if head is None:
                    return
                (size,) = struct.unpack("!i", head)
                payload = self._read_n(conn, size)
                if payload is None:
                    return
                r = Reader(payload)
                api_key, api_version, corr = r.i16(), r.i16(), r.i32()
                r.string()  # client id
                # chaos seam: the broker dies after reading a request and
                # before answering — the client cannot know whether the
                # operation happened (the ambiguity at-least-once covers)
                if faults.fire("mini-broker-drop") == "drop":
                    return
                body = self._dispatch(api_key, api_version, r)
                out = Writer().i32(corr).raw(body).getvalue()
                conn.sendall(struct.pack("!i", len(out)) + out)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_n(conn: socket.socket, n: int) -> bytes | None:
        chunks = []
        while n:
            try:
                got = conn.recv(n)
            except OSError:
                return None
            if not got:
                return None
            chunks.append(got)
            n -= len(got)
        return b"".join(chunks)

    # -- dispatch -------------------------------------------------------

    def _dispatch(self, key: int, version: int, r: Reader) -> bytes:
        handlers = {
            API_API_VERSIONS: self._api_versions,
            API_METADATA: self._metadata,
            API_PRODUCE: self._produce,
            API_FETCH: self._fetch,
            API_LIST_OFFSETS: self._list_offsets,
            API_FIND_COORD: self._find_coordinator,
            API_OFFSET_COMMIT: self._offset_commit,
            API_OFFSET_FETCH: self._offset_fetch,
            API_CREATE_TOPICS: self._create_topics,
            API_DELETE_TOPICS: self._delete_topics,
        }
        handler = handlers.get(key)
        if handler is None:
            raise ConnectionError(f"unsupported api {key}")
        return handler(version, r)

    def _api_versions(self, version: int, r: Reader) -> bytes:
        w = Writer().i16(0)
        pairs = [(API_PRODUCE, 3, 3), (API_FETCH, 4, 4),
                 (API_LIST_OFFSETS, 1, 1), (API_METADATA, 1, 4),
                 (API_OFFSET_COMMIT, 2, 2), (API_OFFSET_FETCH, 1, 1),
                 (API_FIND_COORD, 0, 0), (API_API_VERSIONS, 0, 0),
                 (API_CREATE_TOPICS, 0, 0), (API_DELETE_TOPICS, 0, 0)]
        w.i32(len(pairs))
        for k, lo, hi in pairs:
            w.i16(k).i16(lo).i16(hi)
        return w.getvalue()

    def _metadata(self, version: int, r: Reader) -> bytes:
        n = r.i32()
        names = [r.string() for _ in range(max(0, n))]
        allow_auto = bool(r.i8()) if version >= 4 and r.remaining() \
            else version < 4
        with self._lock:
            if n < 0 or not names:
                names = list(self._topics)
            if self._auto_create is not None and allow_auto:
                for name in names:
                    if name not in self._topics:
                        self._topics[name] = _Topic(self._auto_create)
            w = Writer()
            if version >= 3:
                w.i32(0)                    # throttle
            w.i32(1)                        # one broker
            w.i32(0).string(self.host).i32(self.port).string(None)
            if version >= 2:
                w.string(None)              # cluster id
            w.i32(0)                        # controller id
            w.i32(len(names))
            for name in names:
                topic = self._topics.get(name)
                w.i16(0 if topic is not None else 3)
                w.string(name)
                w.i8(0)                     # is_internal
                parts = topic.parts if topic is not None else []
                w.i32(len(parts))
                for p in range(len(parts)):
                    w.i16(0).i32(p).i32(0)  # error, index, leader
                    w.i32(1).i32(0)         # replicas [0]
                    w.i32(1).i32(0)         # isr [0]
            return w.getvalue()

    def _produce(self, version: int, r: Reader) -> bytes:
        r.string()                          # transactional id
        r.i16()                             # acks
        r.i32()                             # timeout
        # chaos seam: answer REQUEST_TIMED_OUT without appending — the
        # transient code a loaded broker returns
        inject_err = faults.fire("mini-broker-produce-error") == "drop"
        results = []
        # every partition of the request is appended under one lock: a
        # reader sees all of its batches or none
        with self._data_event:
            for _ in range(r.i32()):
                name = r.string()
                for _ in range(r.i32()):
                    p = r.i32()
                    batch = r.bytes_()
                    topic = self._topics.get(name)
                    if inject_err:
                        results.append((name, p, 7, -1))
                        continue
                    if topic is None or p >= len(topic.parts):
                        results.append((name, p, 3, -1))
                        continue
                    log = topic.parts[p]
                    base = len(log)
                    for _, key, value, headers in decode_record_batches(
                            batch or b"", with_headers=True):
                        log.append((key, value, headers))
                    results.append((name, p, 0, base))
            self._data_event.notify_all()
        w = Writer()
        w.i32(len(results))
        for name, p, err, base in results:
            w.string(name)
            w.i32(1)
            w.i32(p).i16(err).i64(base).i64(-1)
        w.i32(0)                            # throttle
        return w.getvalue()

    def _fetch(self, version: int, r: Reader) -> bytes:
        r.i32()                             # replica
        max_wait = r.i32()
        r.i32()                             # min bytes
        r.i32()                             # max bytes
        r.i8()                              # isolation
        wants = []
        for _ in range(r.i32()):
            name = r.string()
            for _ in range(r.i32()):
                p = r.i32()
                off = r.i64()
                r.i32()                     # partition max bytes
                wants.append((name, p, off))

        def have_data() -> bool:
            for name, p, off in wants:
                t = self._topics.get(name)
                if t is None or p >= len(t.parts):
                    return True             # an error answers at once
                if len(t.parts[p]) > off:
                    return True
            return False

        # chaos seam: a transient fetch failure (the code a rebalancing
        # or loaded broker returns), apart from the produce point so
        # that concurrent traffic cannot take the other's activation
        inject_err = faults.fire("mini-broker-fetch-error") == "drop"
        deadline = time.monotonic() + max_wait / 1000.0
        with self._data_event:
            while not have_data():
                if inject_err:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._data_event.wait(left)
            w = Writer()
            w.i32(0)                        # throttle
            w.i32(len(wants))
            for name, p, off in wants:
                t = self._topics.get(name)
                w.string(name)
                w.i32(1)
                if inject_err:
                    w.i32(p).i16(7).i64(-1).i64(-1).i32(0)
                    w.bytes_(None)
                    continue
                if t is None or p >= len(t.parts):
                    w.i32(p).i16(3).i64(-1).i64(-1).i32(0)
                    w.bytes_(None)
                    continue
                log = t.parts[p]
                hw = len(log)
                if off > hw:
                    w.i32(p).i16(1).i64(hw).i64(hw).i32(0)  # out of range
                    w.bytes_(None)
                    continue
                slice_ = log[off:off + 1000]
                records = encode_record_batch(off, slice_) if slice_ \
                    else None
                w.i32(p).i16(0).i64(hw).i64(hw).i32(0)
                w.bytes_(records)
            return w.getvalue()

    def _list_offsets(self, version: int, r: Reader) -> bytes:
        r.i32()                             # replica
        wants = []
        for _ in range(r.i32()):
            name = r.string()
            for _ in range(r.i32()):
                p = r.i32()
                ts = r.i64()
                wants.append((name, p, ts))
        with self._lock:
            w = Writer()
            w.i32(len(wants))
            for name, p, ts in wants:
                t = self._topics.get(name)
                w.string(name)
                w.i32(1)
                if t is None or p >= len(t.parts):
                    w.i32(p).i16(3).i64(-1).i64(-1)
                elif ts == -2:              # earliest
                    w.i32(p).i16(0).i64(-1).i64(0)
                else:                       # latest
                    w.i32(p).i16(0).i64(-1).i64(len(t.parts[p]))
            return w.getvalue()

    def _find_coordinator(self, version: int, r: Reader) -> bytes:
        r.string()
        return (Writer().i16(0).i32(0).string(self.host).i32(self.port)
                .getvalue())

    def _offset_commit(self, version: int, r: Reader) -> bytes:
        group = r.string()
        r.i32()                             # generation
        r.string()                          # member
        r.i64()                             # retention
        results = []
        with self._lock:
            for _ in range(r.i32()):
                name = r.string()
                for _ in range(r.i32()):
                    p = r.i32()
                    off = r.i64()
                    r.string()              # metadata
                    self._offsets[(group, name, p)] = off
                    results.append((name, p))
        w = Writer()
        w.i32(len(results))
        for name, p in results:
            w.string(name)
            w.i32(1)
            w.i32(p).i16(0)
        return w.getvalue()

    def _offset_fetch(self, version: int, r: Reader) -> bytes:
        group = r.string()
        wants = []
        for _ in range(r.i32()):
            name = r.string()
            for p in r.array(Reader.i32):
                wants.append((name, p))
        with self._lock:
            w = Writer()
            w.i32(len(wants))
            for name, p in wants:
                off = self._offsets.get((group, name, p), -1)
                w.string(name)
                w.i32(1)
                w.i32(p).i64(off).string(None).i16(0)
            return w.getvalue()

    def _create_topics(self, version: int, r: Reader) -> bytes:
        results = []
        with self._lock:
            for _ in range(r.i32()):
                name = r.string()
                partitions = r.i32()
                r.i16()                     # replication
                for _ in range(r.i32()):    # assignments
                    r.i32()
                    r.array(Reader.i32)
                for _ in range(r.i32()):    # configs
                    r.string()
                    r.string()
                if name in self._topics:
                    results.append((name, 36))
                elif partitions < 1:
                    results.append((name, 37))
                else:
                    self._topics[name] = _Topic(partitions)
                    results.append((name, 0))
        r.i32()                             # timeout
        w = Writer()
        w.i32(len(results))
        for name, err in results:
            w.string(name).i16(err)
        return w.getvalue()

    def _delete_topics(self, version: int, r: Reader) -> bytes:
        names = r.array(Reader.string)
        r.i32()                             # timeout
        results = []
        with self._lock:
            for name in names:
                if name in self._topics:
                    del self._topics[name]
                    results.append((name, 0))
                else:
                    results.append((name, 3))
        w = Writer()
        w.i32(len(results))
        for name, err in results:
            w.string(name).i16(err)
        return w.getvalue()
