"""Kafka wire protocol on stdlib sockets: the codec and a synchronous
client.

Counterpart of ``oryx_tpu/kafka/wire.py`` (reference: the framework's
messaging backend is a real Kafka cluster, framework/kafka-util/.../
KafkaUtils.java:63-181 and AbstractSparkLayer.java:170-216).  A bare
``host:port`` broker address binds to this client (kafka/client.py);
the serving tier's HTTP/1.1, HTTP/2 and HPACK are hand-written the same
way, and the card's machine has no Kafka client library.

Protocol subset (classic non-flexible versions, spoken by every broker
since 0.11):

  ApiVersions v0, Metadata v4, Produce v3, Fetch v4, ListOffsets v1,
  FindCoordinator v0, OffsetCommit v2, OffsetFetch v1,
  CreateTopics v0, DeleteTopics v0

Records travel as v2 RecordBatches (magic 2: zigzag-varint records,
CRC32C over the batch tail).  A record is ``(key, value)`` or ``(key,
value, headers)`` with ``headers`` a list of ``(str, bytes | None)``
pairs, written as v2 record headers; without headers the bytes are the
reference's, byte for byte (it writes a header count of 0 and skips
headers on read).  Group offsets use standalone-consumer commits
(generation -1): the layers assign partitions explicitly and never
rebalance.

MiniKafkaBroker (mini_broker.py) speaks the same subset server-side.
"""

from __future__ import annotations

import io
import socket
import struct
import threading

from ..resilience import faults

__all__ = [
    "KafkaProtocolError", "WireKafkaClient",
    "encode_record_batch", "decode_record_batches", "crc32c",
]


class KafkaProtocolError(RuntimeError):
    def __init__(self, code: int, where: str):
        super().__init__(f"Kafka error {code} ({ERRORS.get(code, '?')}) "
                         f"in {where}")
        self.code = code


ERRORS = {
    0: "NONE", 1: "OFFSET_OUT_OF_RANGE", 3: "UNKNOWN_TOPIC_OR_PARTITION",
    6: "NOT_LEADER", 7: "REQUEST_TIMED_OUT", 15: "COORDINATOR_NOT_AVAILABLE",
    25: "UNKNOWN_MEMBER_ID", 36: "TOPIC_ALREADY_EXISTS",
    37: "INVALID_PARTITIONS", 41: "NOT_CONTROLLER", 42: "INVALID_REQUEST",
}

API_PRODUCE, API_FETCH, API_LIST_OFFSETS, API_METADATA = 0, 1, 2, 3
API_OFFSET_COMMIT, API_OFFSET_FETCH, API_FIND_COORD = 8, 9, 10
API_API_VERSIONS, API_CREATE_TOPICS, API_DELETE_TOPICS = 18, 19, 20


# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) --------------------------

def _make_crc32c_tables() -> list[list[int]]:
    base = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        base.append(c)
    tables = [base]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([base[prev[n] & 0xFF] ^ (prev[n] >> 8)
                       for n in range(256)])
    return tables


_CRC32C_TABLES = _make_crc32c_tables()


def crc32c(data: bytes) -> int:
    """Slicing-by-8 CRC32C: eight bytes per step, one table each."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC32C_TABLES
    crc = 0xFFFFFFFF
    n = len(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        crc ^= int.from_bytes(data[i:i + 4], "little")
        b4, b5, b6, b7 = data[i + 4:i + 8]
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[b4] ^ t2[b5] ^ t1[b6] ^ t0[b7])
        i += 8
    t = t0
    for b in data[end8:]:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- primitive codec ---------------------------------------------------------

class Writer:
    def __init__(self):
        self._b = io.BytesIO()

    def i8(self, v):
        self._b.write(struct.pack("!b", v))
        return self

    def i16(self, v):
        self._b.write(struct.pack("!h", v))
        return self

    def i32(self, v):
        self._b.write(struct.pack("!i", v))
        return self

    def i64(self, v):
        self._b.write(struct.pack("!q", v))
        return self

    def u32(self, v):
        self._b.write(struct.pack("!I", v))
        return self

    def string(self, s: str | None):
        if s is None:
            return self.i16(-1)
        raw = s.encode("utf-8")
        self.i16(len(raw))
        self._b.write(raw)
        return self

    def bytes_(self, b: bytes | None):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self._b.write(b)
        return self

    def raw(self, b: bytes):
        self._b.write(b)
        return self

    def array(self, items, enc):
        self.i32(len(items))
        for it in items:
            enc(self, it)
        return self

    def getvalue(self) -> bytes:
        return self._b.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise KafkaProtocolError(42, "short frame")
        out = self._d[self._o:self._o + n]
        self._o += n
        return out

    def i8(self):
        return struct.unpack("!b", self._take(1))[0]

    def i16(self):
        return struct.unpack("!h", self._take(2))[0]

    def i32(self):
        return struct.unpack("!i", self._take(4))[0]

    def i64(self):
        return struct.unpack("!q", self._take(8))[0]

    def u32(self):
        return struct.unpack("!I", self._take(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self._take(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def array(self, dec) -> list:
        n = self.i32()
        if n < 0:
            return []
        return [dec(self) for _ in range(n)]

    def remaining(self) -> int:
        return len(self._d) - self._o


# -- varints (zigzag, protobuf-style) ----------------------------------------

def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def write_varint(buf: bytearray, v: int) -> None:
    v = _zigzag(v) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_varint(data: bytes, o: int) -> tuple[int, int]:
    shift = out = 0
    while True:
        b = data[o]
        o += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(out), o
        shift += 7


def _write_bytes(buf: bytearray, b: bytes | None) -> None:
    """A varint length (-1 for null) and the bytes."""
    if b is None:
        write_varint(buf, -1)
    else:
        write_varint(buf, len(b))
        buf.extend(b)


# -- v2 RecordBatch ----------------------------------------------------------

def encode_record_batch(base_offset: int, records: list[tuple],
                        timestamp_ms: int = 0) -> bytes:
    """One magic-2 batch from ``(key, value)`` or ``(key, value,
    headers)`` records; ``headers`` is a list of ``(str, bytes | None)``
    pairs."""
    body = bytearray()
    for delta, rec_in in enumerate(records):
        key, value = rec_in[0], rec_in[1]
        headers = rec_in[2] if len(rec_in) > 2 else None
        rec = bytearray()
        rec.append(0)  # attributes
        write_varint(rec, 0)          # timestamp delta
        write_varint(rec, delta)      # offset delta
        _write_bytes(rec, key)
        _write_bytes(rec, value)
        write_varint(rec, len(headers or ()))
        for hkey, hvalue in headers or ():
            _write_bytes(rec, hkey.encode("utf-8"))
            _write_bytes(rec, hvalue)
        prefixed = bytearray()
        write_varint(prefixed, len(rec))
        prefixed.extend(rec)
        body.extend(prefixed)
    tail = Writer()
    tail.i16(0)                       # attributes
    tail.i32(len(records) - 1)        # lastOffsetDelta
    tail.i64(timestamp_ms)            # baseTimestamp
    tail.i64(timestamp_ms)            # maxTimestamp
    tail.i64(-1).i16(-1).i32(-1)      # producer id/epoch/baseSequence
    tail.i32(len(records))
    tail.raw(bytes(body))
    tail_bytes = tail.getvalue()
    head = Writer()
    head.i64(base_offset)
    head.i32(4 + 1 + 4 + len(tail_bytes))  # partitionLeaderEpoch..end
    head.i32(-1)                      # partitionLeaderEpoch
    head.i8(2)                        # magic
    head.u32(crc32c(tail_bytes))
    head.raw(tail_bytes)
    return head.getvalue()


def decode_record_batches(data: bytes, with_headers: bool = False
                          ) -> list[tuple]:
    """Every ``(offset, key, value)`` record of concatenated batches
    (``(offset, key, value, headers)`` with ``with_headers``, headers a
    list of ``(str, bytes | None)``); a truncated trailing batch is
    dropped (brokers may cut at max_bytes)."""
    out: list[tuple] = []
    o = 0
    while o + 12 <= len(data):
        base_offset, batch_len = struct.unpack_from("!qi", data, o)
        end = o + 12 + batch_len
        if end > len(data):
            break  # truncated tail
        magic = data[o + 16]
        if magic != 2:
            raise KafkaProtocolError(42, f"unsupported magic {magic}")
        body = data[o + 21:end]       # after crc
        r = Reader(body)
        attributes = r.i16()
        if attributes & 0x07:
            # a compressed batch's bytes are not record varints: refuse
            # rather than yield garbage (this client never compresses)
            raise KafkaProtocolError(
                42, f"compressed record batch (codec {attributes & 7}) "
                    "not supported")
        if attributes & 0x20:
            # control batch (transaction markers): not data
            o = end
            continue
        r.i32()                       # lastOffsetDelta
        r.i64()
        r.i64()
        r.i64()
        r.i16()
        r.i32()
        count = r.i32()
        raw = body[r._o:]
        p = 0
        for _ in range(count):
            rec_len, p = read_varint(raw, p)
            rec_end = p + rec_len
            p += 1                    # attributes
            _, p = read_varint(raw, p)          # ts delta
            delta, p = read_varint(raw, p)      # offset delta
            klen, p = read_varint(raw, p)
            key = None if klen < 0 else raw[p:p + klen]
            p += max(0, klen)
            vlen, p = read_varint(raw, p)
            value = None if vlen < 0 else raw[p:p + vlen]
            p += max(0, vlen)
            if with_headers:
                headers = []
                n_headers, p = read_varint(raw, p)
                for _ in range(n_headers):
                    hlen, p = read_varint(raw, p)
                    hkey = raw[p:p + hlen].decode("utf-8")
                    p += hlen
                    hvlen, p = read_varint(raw, p)
                    hvalue = None if hvlen < 0 else raw[p:p + hvlen]
                    p += max(0, hvlen)
                    headers.append((hkey, hvalue))
                out.append((base_offset + delta, key, value, headers))
            else:
                out.append((base_offset + delta, key, value))
            p = rec_end
        o = end
    return out


# -- client ------------------------------------------------------------------

class _Conn:
    """One blocking connection with correlation-id bookkeeping."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def request(self, api_key: int, api_version: int, body: bytes,
                timeout: float | None = None) -> Reader:
        # chaos seam: the broker connection dies before the request
        if faults.fire("wire-send",
                       error=lambda: ConnectionError(
                           "injected connection drop")) == "drop":
            self.close()
            raise ConnectionError("injected connection drop")
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = Writer()
            head.i16(api_key).i16(api_version).i32(corr)
            head.string(self.client_id)
            payload = head.getvalue() + body
            if timeout is not None:
                self.sock.settimeout(timeout)
            self.sock.sendall(struct.pack("!i", len(payload)) + payload)
            raw = self._read_frame()
            r = Reader(raw)
            got = r.i32()
            if got != corr:
                raise KafkaProtocolError(42, f"correlation {got} != {corr}")
            return r

    def _read_frame(self) -> bytes:
        size_b = self._read_n(4)
        (size,) = struct.unpack("!i", size_b)
        if size < 0 or size > (1 << 30):
            raise KafkaProtocolError(42, f"bad frame size {size}")
        return self._read_n(size)

    def _read_n(self, n: int) -> bytes:
        # chaos seam: "drop" reads part of the frame, then kills the
        # connection — a mid-read broker death leaves the stream out of
        # step, the case reconnect-and-retry covers
        partial = faults.fire("wire-read",
                              error=lambda: ConnectionError(
                                  "injected read failure")) == "drop"
        chunks = []
        while n:
            got = self.sock.recv(n)
            if not got:
                raise ConnectionError("broker closed connection")
            chunks.append(got)
            n -= len(got)
            if partial:
                self.close()
                raise ConnectionError("injected partial read")
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class WireKafkaClient:
    """Synchronous single-broker protocol client (the bootstrap broker
    answers everything on a one-node cluster; multi-node metadata is
    returned so callers can refuse rather than mis-route)."""

    def __init__(self, bootstrap: str, client_id: str = "oryx-tpu",
                 timeout: float = 30.0):
        host, _, port = bootstrap.partition(":")
        self.host, self.port = host, int(port or 9092)
        self.client_id = client_id
        self.timeout = timeout
        self._conn: _Conn | None = None
        self._lock = threading.Lock()

    def _c(self) -> _Conn:
        with self._lock:
            if self._conn is None:
                self._conn = _Conn(self.host, self.port, self.client_id,
                                   self.timeout)
            return self._conn

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _request(self, key: int, version: int, body: bytes,
                 timeout: float | None = None) -> Reader:
        try:
            return self._c().request(key, version, body, timeout)
        except (ConnectionError, OSError):
            # one reconnect: brokers close idle connections
            self.close()
            return self._c().request(key, version, body, timeout)

    # -- api ------------------------------------------------------------

    def api_versions(self) -> dict[int, tuple[int, int]]:
        r = self._request(API_API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaProtocolError(err, "ApiVersions")
        out = {}
        for _ in range(r.i32()):
            k, lo, hi = r.i16(), r.i16(), r.i16()
            out[k] = (lo, hi)
        return out

    def metadata(self, topics: list[str] | None = None) -> dict:
        # v4: the first version with allow_auto_topic_creation — an
        # existence probe must not create the topic broker-side
        w = Writer()
        if topics is None:
            w.i32(-1)
        else:
            w.array(topics, Writer.string)
        w.i8(0)  # allow_auto_topic_creation = false
        r = self._request(API_METADATA, 4, w.getvalue())
        r.i32()  # throttle
        brokers = r.array(lambda rr: (rr.i32(), rr.string(), rr.i32(),
                                      rr.string()))
        r.string()  # cluster id
        r.i32()  # controller id
        out_topics = {}
        for _ in range(r.i32()):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                index = r.i32()
                leader = r.i32()
                r.array(Reader.i32)
                r.array(Reader.i32)
                parts[index] = {"error": perr, "leader": leader}
            out_topics[name] = {"error": err, "partitions": parts}
        return {"brokers": brokers, "topics": out_topics}

    def partitions_for(self, topic: str) -> list[int] | None:
        meta = self.metadata([topic])["topics"].get(topic)
        if meta is None or meta["error"] == 3:
            return None
        if meta["error"]:
            raise KafkaProtocolError(meta["error"], f"Metadata({topic})")
        return sorted(meta["partitions"])

    def produce(self, topic: str, partition: int, records: list[tuple],
                acks: int = -1) -> int:
        return self.produce_many(topic, {partition: records}, acks)[
            partition]

    def produce_many(self, topic: str, by_partition: dict[int, list],
                     acks: int = -1) -> dict[int, int]:
        """One Produce request carrying a batch for each partition of
        ``by_partition``; the base offset of each."""
        w = Writer()
        w.string(None)            # transactional_id
        w.i16(acks).i32(int(self.timeout * 1000))
        w.i32(1)                  # one topic
        w.string(topic)
        w.i32(len(by_partition))
        for partition, records in sorted(by_partition.items()):
            w.i32(partition)
            w.bytes_(encode_record_batch(0, records))
        r = self._request(API_PRODUCE, 3, w.getvalue())
        out: dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                off = r.i64()
                r.i64()  # log append time
                if err:
                    raise KafkaProtocolError(err, f"Produce({topic})")
                out[p] = off
        return {p: out.get(p, -1) for p in by_partition}

    def fetch(self, topic: str, partition: int, offset: int,
              max_wait_ms: int = 500, max_bytes: int = 1 << 22,
              with_headers: bool = False) -> list[tuple]:
        w = Writer()
        w.i32(-1).i32(max_wait_ms).i32(1).i32(max_bytes).i8(0)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition).i64(offset).i32(max_bytes)
        r = self._request(API_FETCH, 4, w.getvalue(),
                          timeout=self.timeout + max_wait_ms / 1000.0)
        r.i32()  # throttle
        out: list[tuple] = []
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                r.i64()  # high watermark
                r.i64()  # last stable
                n_aborted = r.i32()
                for _ in range(max(0, n_aborted)):
                    r.i64()
                    r.i64()
                records = r.bytes_()
                if err:
                    raise KafkaProtocolError(err,
                                             f"Fetch({topic}/{partition})")
                if records:
                    out.extend(decode_record_batches(records, with_headers))
        # a batch may start before the requested offset (compaction)
        return [rec for rec in out if rec[0] >= offset]

    def list_offset(self, topic: str, partition: int,
                    timestamp: int = -1) -> int:
        """-1 = latest (log end), -2 = earliest."""
        return self.list_offsets(topic, [partition], timestamp)[partition]

    def list_offsets(self, topic: str, partitions: list[int],
                     timestamp: int = -1) -> dict[int, int]:
        """Every partition's offset from ONE ListOffsets request: a
        single broker answers it as one snapshot of the partitions."""
        w = Writer()
        w.i32(-1)
        w.i32(1)
        w.string(topic)
        w.i32(len(partitions))
        for p in partitions:
            w.i32(p).i64(timestamp)
        r = self._request(API_LIST_OFFSETS, 1, w.getvalue())
        out: dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                err = r.i16()
                r.i64()  # timestamp
                off = r.i64()
                if err:
                    raise KafkaProtocolError(
                        err, f"ListOffsets({topic}/{p})")
                out[p] = off
        missing = [p for p in partitions if p not in out]
        if missing:
            raise KafkaProtocolError(
                42, f"ListOffsets({topic}) did not answer {missing}")
        return out

    def find_coordinator(self, group: str) -> tuple[str, int]:
        w = Writer()
        w.string(group)
        r = self._request(API_FIND_COORD, 0, w.getvalue())
        err = r.i16()
        r.i32()  # node id
        host = r.string()
        port = r.i32()
        if err:
            raise KafkaProtocolError(err, f"FindCoordinator({group})")
        return host, port

    def offset_commit(self, group: str, topic: str,
                      offsets: dict[int, int]) -> None:
        w = Writer()
        w.string(group).i32(-1).string("").i64(-1)
        w.i32(1)
        w.string(topic)
        w.i32(len(offsets))
        for p, off in sorted(offsets.items()):
            w.i32(p).i64(off).string(None)
        r = self._request(API_OFFSET_COMMIT, 2, w.getvalue())
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                if err:
                    raise KafkaProtocolError(err, f"OffsetCommit({group})")

    def offset_fetch(self, group: str, topic: str,
                     partitions: list[int]) -> dict[int, int | None]:
        w = Writer()
        w.string(group)
        w.i32(1)
        w.string(topic)
        w.array(partitions, Writer.i32)
        r = self._request(API_OFFSET_FETCH, 1, w.getvalue())
        out: dict[int, int | None] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                off = r.i64()
                r.string()  # metadata
                err = r.i16()
                if err:
                    raise KafkaProtocolError(err, f"OffsetFetch({group})")
                out[p] = None if off < 0 else off
        return out

    def create_topic(self, topic: str, partitions: int = 1) -> int:
        w = Writer()
        w.i32(1)
        w.string(topic).i32(partitions).i16(1)
        w.i32(0)  # assignments
        w.i32(0)  # configs
        w.i32(int(self.timeout * 1000))
        r = self._request(API_CREATE_TOPICS, 0, w.getvalue())
        for _ in range(r.i32()):
            r.string()
            return r.i16()
        return 0

    def delete_topic(self, topic: str) -> int:
        w = Writer()
        w.array([topic], Writer.string)
        w.i32(int(self.timeout * 1000))
        r = self._request(API_DELETE_TOPICS, 0, w.getvalue())
        for _ in range(r.i32()):
            r.string()
            return r.i16()
        return 0
