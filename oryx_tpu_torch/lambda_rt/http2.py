"""HTTP/2 (RFC 9113) server connection handling over the same HttpApp.

Counterpart of ``oryx_tpu/lambda_rt/http2.py``, whole.

Reference parity: the serving connector negotiates HTTP/2
(ServingLayer.java:202-255 adds Http2Protocol to the Tomcat connector,
h2 over TLS via ALPN and h2c upgrade).  Here the fast HTTP/1.1 handler
(lambda_rt/http.py) hands a connection to :func:`serve_connection` when
it sees the h2 prior-knowledge preface, or immediately when TLS ALPN
selected "h2"; every route, the DIGEST auth, gzip, CSV negotiation and
read-only gating then run unchanged — the h2 layer only adapts frames
to the handler surface HttpApp already speaks.

Scope: the server side of the protocol a real client (curl/nghttp2,
Java clients) exercises — SETTINGS exchange, HPACK header blocks with
CONTINUATION, request DATA with padding, flow control in both
directions, PING, RST_STREAM, GOAWAY.  Server push is never used
(SETTINGS_ENABLE_PUSH is irrelevant server-side), and prioritization
frames are legal to ignore.
"""

from __future__ import annotations

import io
import struct
import threading
from typing import BinaryIO

from .hpack import HpackDecoder, HpackEncoder, HpackError

__all__ = ["serve_connection", "PREFACE", "H2Error"]

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

DEFAULT_WINDOW = 65535
MAX_FRAME_SIZE = 16384  # what we advertise and enforce on receipt

# error codes
NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x3
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
ENHANCE_YOUR_CALM = 0xB

# per-request resource bounds, mirroring the HTTP/1.1 parser's
# header-count/line-length guards (lambda_rt/http.py)
MAX_HEADER_BLOCK = 65536
MAX_BODY_BYTES = 64 * 1024 * 1024
# what we advertise in SETTINGS_MAX_CONCURRENT_STREAMS — and enforce:
# streams opened past this are refused with RST_STREAM(REFUSED_STREAM)
MAX_CONCURRENT_STREAMS = 128
# aggregate request-body bytes buffered across all open streams of one
# connection; one client holding many streams open with partial DATA
# must not grow host memory without bound
MAX_CONN_BUFFERED = 256 * 1024 * 1024


class H2Error(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class _Stream:
    __slots__ = ("id", "headers", "body", "ended", "send_window")

    def __init__(self, sid: int, initial_window: int):
        self.id = sid
        self.headers: list[tuple[str, str]] | None = None
        self.body = bytearray()
        self.ended = False
        self.send_window = initial_window


class _H2Handler:
    """The handler surface HttpApp writes responses through, buffering
    status/headers/body for one stream (responses are emitted as frames
    by the connection after the route handler returns)."""

    def __init__(self, command: str, path: str, headers: dict[str, str],
                 body: bytes):
        self.command = command
        self.path = path
        self.headers = headers
        self.rfile = io.BytesIO(body)
        self.wfile = io.BytesIO()
        self.status = 0
        self.out_headers: list[tuple[str, str]] = []

    def send_response(self, status: int) -> None:
        self.status = status

    def send_header(self, key: str, value) -> None:
        self.out_headers.append((key.lower(), str(value)))

    def end_headers(self) -> None:
        pass


class _Connection:
    def __init__(self, app, rfile: BinaryIO, wfile: BinaryIO):
        self.app = app
        self.rfile = rfile
        self.wfile = wfile
        self.decoder = HpackDecoder()
        self.encoder = HpackEncoder()
        self.streams: dict[int, _Stream] = {}
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = MAX_FRAME_SIZE
        self.conn_send_window = DEFAULT_WINDOW
        self.max_seen_stream = 0
        self.goaway = False
        self._wlock = threading.Lock()
        # queued completed requests + re-entrancy latch so a request
        # that completes while a response is blocked on flow control is
        # answered iteratively, never by nested _respond recursion
        self._response_q: list[_Stream] = []
        self._responding = False

    # -- frame IO ------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.rfile.read(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def read_frame(self) -> tuple[int, int, int, bytes]:
        head = self._read_exact(9)
        length = int.from_bytes(head[:3], "big")
        ftype, flags = head[3], head[4]
        sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
        if length > MAX_FRAME_SIZE:
            raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
        return ftype, flags, sid, self._read_exact(length)

    def write_frame(self, ftype: int, flags: int, sid: int,
                    payload: bytes = b"") -> None:
        with self._wlock:
            self.wfile.write(len(payload).to_bytes(3, "big")
                             + bytes([ftype, flags])
                             + sid.to_bytes(4, "big") + payload)
            self.wfile.flush()

    # -- connection lifecycle ------------------------------------------------

    def run(self) -> None:
        # our SETTINGS first (defaults; advertise a concurrency bound)
        self.write_frame(SETTINGS, 0, 0, struct.pack(
            "!HI", SETTINGS_MAX_CONCURRENT_STREAMS,
            MAX_CONCURRENT_STREAMS))
        try:
            while not self.goaway:
                try:
                    ftype, flags, sid, payload = self.read_frame()
                except ConnectionError:
                    return
                self.dispatch(ftype, flags, sid, payload)
        except H2Error as e:
            try:
                self.write_frame(GOAWAY, 0, 0, struct.pack(
                    "!II", self.max_seen_stream, e.code)
                    + str(e).encode()[:128])
            except OSError:
                pass

    def dispatch(self, ftype: int, flags: int, sid: int,
                 payload: bytes) -> None:
        if ftype == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif ftype == HEADERS:
            self._on_headers(flags, sid, payload)
        elif ftype == CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "CONTINUATION out of sequence")
        elif ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == PING:
            if not flags & FLAG_ACK:
                self.write_frame(PING, FLAG_ACK, 0, payload)
        elif ftype == RST_STREAM:
            self.streams.pop(sid, None)
        elif ftype == GOAWAY:
            self.goaway = True
        elif ftype in (PRIORITY, PUSH_PROMISE):
            pass  # PRIORITY is advisory; clients do not push
        # unknown frame types are ignored per RFC 9113 §4.1

    # -- frame handlers ------------------------------------------------------

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & FLAG_ACK:
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "bad SETTINGS length")
        for off in range(0, len(payload), 6):
            ident, value = struct.unpack_from("!HI", payload, off)
            if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > 0x7FFFFFFF:
                    raise H2Error(FLOW_CONTROL_ERROR, "window > 2^31-1")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for s in self.streams.values():
                    s.send_window += delta
            elif ident == SETTINGS_MAX_FRAME_SIZE:
                if 16384 <= value <= 16777215:
                    self.peer_max_frame = value
            # header-table-size changes flow through HPACK size updates
        self.write_frame(SETTINGS, FLAG_ACK, 0)

    def _strip_padding(self, flags: int, payload: bytes) -> bytes:
        if flags & FLAG_PADDED:
            if not payload:
                raise H2Error(PROTOCOL_ERROR, "padded empty frame")
            pad = payload[0]
            if pad >= len(payload):
                raise H2Error(PROTOCOL_ERROR, "padding >= frame")
            payload = payload[1:len(payload) - pad]
        return payload

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0 or sid % 2 == 0:
            raise H2Error(PROTOCOL_ERROR, "bad client stream id")
        payload = self._strip_padding(flags, payload)
        if flags & FLAG_PRIORITY:
            if len(payload) < 5:
                raise H2Error(PROTOCOL_ERROR, "short priority field")
            payload = payload[5:]
        block = payload
        f = flags
        while not f & FLAG_END_HEADERS:
            ftype, f, csid, cpayload = self.read_frame()
            if ftype != CONTINUATION or csid != sid:
                raise H2Error(PROTOCOL_ERROR, "expected CONTINUATION")
            block += cpayload
            if len(block) > MAX_HEADER_BLOCK:
                # same invariant the HTTP/1.1 parser enforces: one
                # client must not grow host memory without bound
                raise H2Error(ENHANCE_YOUR_CALM, "header block too large")
        prior_max = self.max_seen_stream
        self.max_seen_stream = max(self.max_seen_stream, sid)
        # always decode before any refusal: HPACK state is shared across
        # the connection (RFC 7541 §2.2), so a skipped block would
        # corrupt every later request's headers
        try:
            decoded = self.decoder.decode(block, max_headers=256)
        except HpackError as e:
            raise H2Error(PROTOCOL_ERROR, f"HPACK: {e}") from e
        stream = self.streams.get(sid)
        if stream is None:
            if sid <= prior_max:
                # an id at or below the high-water mark with no live
                # stream is closed — responded, reset, or refused.
                # Trailers for it must not resurrect a stream (which
                # would then die on a missing :method), and tracking
                # no per-id state keeps this O(1) for any client.
                return
            if len(self.streams) >= MAX_CONCURRENT_STREAMS:
                # enforce the advertised SETTINGS_MAX_CONCURRENT_STREAMS
                self.write_frame(RST_STREAM, 0, sid,
                                 struct.pack("!I", REFUSED_STREAM))
                return
            stream = self.streams[sid] = _Stream(
                sid, self.peer_initial_window)
        if stream.headers is None:
            stream.headers = decoded
        # else: request trailers (RFC 9113 §8.1) — fields are legal to
        # ignore, and they must not clobber :method/:path
        if flags & FLAG_END_STREAM:
            stream.ended = True
            self._respond(stream)

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        stream = self.streams.get(sid)
        if stream is None:
            if sid <= self.max_seen_stream:
                # in-flight DATA for a closed/refused stream: drop it,
                # but replenish the connection window it consumed
                if payload:
                    self.write_frame(WINDOW_UPDATE, 0, 0,
                                     struct.pack("!I", len(payload)))
                return
            raise H2Error(PROTOCOL_ERROR, f"DATA on idle stream {sid}")
        consumed = len(payload)  # padding counts toward flow control
        payload = self._strip_padding(flags, payload)
        stream.body += payload
        if len(stream.body) > MAX_BODY_BYTES:
            raise H2Error(ENHANCE_YOUR_CALM, "request body too large")
        if sum(len(s.body) for s in self.streams.values()) \
                > MAX_CONN_BUFFERED:
            raise H2Error(ENHANCE_YOUR_CALM,
                          "aggregate buffered bodies too large")
        if consumed:
            # replenish both windows immediately: requests are consumed
            # whole, so there is no reason to throttle the peer
            inc = struct.pack("!I", consumed)
            self.write_frame(WINDOW_UPDATE, 0, 0, inc)
            self.write_frame(WINDOW_UPDATE, 0, sid, inc)
        if flags & FLAG_END_STREAM:
            stream.ended = True
            self._respond(stream)

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = struct.unpack("!I", payload)[0] & 0x7FFFFFFF
        if sid == 0:
            self.conn_send_window += inc
        else:
            s = self.streams.get(sid)
            if s is not None:
                s.send_window += inc

    # -- request dispatch -----------------------------------------------------

    def _respond(self, stream: _Stream) -> None:
        # A response blocked on flow control dispatches incoming frames
        # inline (_send_response), so another request can complete while
        # one is mid-send.  Queue it and let the outermost call drain
        # iteratively — nested _respond calls would otherwise recurse
        # once per pipelined request while the peer holds windows at 0.
        self._response_q.append(stream)
        if self._responding:
            return
        self._responding = True
        try:
            while self._response_q:
                self._respond_one(self._response_q.pop(0))
        finally:
            self._responding = False

    def _respond_one(self, stream: _Stream) -> None:
        method = path = None
        headers: dict[str, str] = {}
        for name, value in stream.headers or ():
            if name == ":method":
                method = value
            elif name == ":path":
                path = value
            elif name == ":authority":
                headers.setdefault("Host", value)
            elif not name.startswith(":"):
                # Title-Case to match the HTTP/1.1 handler's surface
                headers["-".join(p.capitalize()
                                 for p in name.split("-"))] = value
        if method is None or path is None:
            raise H2Error(PROTOCOL_ERROR, "missing :method/:path")
        if stream.body:
            headers["Content-Length"] = str(len(stream.body))
        handler = _H2Handler(method, path, headers, bytes(stream.body))
        self.app.handle(handler)
        self._send_response(stream, handler)
        self.streams.pop(stream.id, None)

    def _send_response(self, stream: _Stream,
                       handler: _H2Handler) -> None:
        status = handler.status or 500
        block = self.encoder.encode([(":status", str(status))]
                                    + handler.out_headers)
        body = handler.wfile.getvalue()
        self.write_frame(HEADERS,
                         FLAG_END_HEADERS
                         | (FLAG_END_STREAM if not body else 0),
                         stream.id, block)
        sent = 0
        while sent < len(body):
            budget = min(self.peer_max_frame,
                         self.conn_send_window, stream.send_window)
            if budget <= 0:
                # blocked on flow control: keep reading frames (the
                # peer's WINDOW_UPDATE / SETTINGS / PING arrive here)
                ftype, flags, sid, payload = self.read_frame()
                self.dispatch(ftype, flags, sid, payload)
                continue
            chunk = body[sent:sent + budget]
            sent += len(chunk)
            self.conn_send_window -= len(chunk)
            stream.send_window -= len(chunk)
            self.write_frame(DATA,
                             FLAG_END_STREAM if sent >= len(body) else 0,
                             stream.id, chunk)


def serve_connection(app, rfile: BinaryIO, wfile: BinaryIO,
                     preface_consumed: bool = False) -> None:
    """Speak server-side HTTP/2 on an accepted connection until the
    peer goes away.  ``preface_consumed`` is True when the HTTP/1.1
    handler already read the prior-knowledge preface while sniffing."""
    conn = _Connection(app, rfile, wfile)
    if not preface_consumed:
        got = conn._read_exact(len(PREFACE))
        if got != PREFACE:
            raise H2Error(PROTOCOL_ERROR, "bad connection preface")
    conn.run()
