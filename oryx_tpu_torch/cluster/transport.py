"""Multiplexed framed router→replica transport: one persistent
connection per replica carrying interleaved request streams.

Counterpart of ``oryx_tpu/cluster/transport.py``, whole: the frames are
the reference's bytes, so either package's router speaks to either
package's replicas.

The legacy internal hop (cluster/scatter.py) is HTTP/1.1 over a
per-URL socket pool: every concurrently outstanding request to a
replica pins one socket, a hedge costs a TCP connect when the pool is
empty, and cancelling a losing attempt means abandoning a socket
mid-response.  This module replaces the hop with a length-prefixed
frame protocol over ONE connection per replica:

- **streams** — every request gets a per-connection stream id;
  responses come back in completion order and are demultiplexed by id,
  so a slow response never head-of-line-blocks its poolmates;
- **hedges cost a frame** — a hedged attempt is one more REQ frame on
  the sibling's existing connection, not a connect;
- **cancellation is explicit** — a losing hedge (or an expired
  deadline) sends a CANCEL frame; the replica skips the work if it has
  not started and drops the response if it has, and the connection
  stays healthy for every other stream;
- **deadline propagation** — the REQ header carries the request's
  remaining budget exactly as ``X-Deadline-Ms`` does on the HTTP hop.

Wire format (all integers big-endian)::

    frame   := u32 length | u8 type | u32 stream_id | payload
    REQ(1)  := u32 hlen | header-JSON | body          (router → replica)
    RESP(2) := u32 hlen | header-JSON | body          (replica → router)
    CANCEL(3) (empty payload)                         (router → replica)
    AUTH(4) := JSON {"ha1": md5(user:realm:password)} (router → replica)

REQ header-JSON: ``{"m": method, "p": path, "h": {headers}}``; RESP
header-JSON: ``{"s": status, "h": {lower-cased response headers}}``.
The replica answers frames through the SAME HttpApp dispatcher the
``/shard/*`` HTTP resources run on (a buffered handler adapter), so a
framed answer is byte-identical to the HTTP hop's by construction —
and the dispatcher consults the replica-side result cache
(cluster/result_cache.py ShardResultCache) first, so a repeated shard
query under an unchanged model epoch skips the device entirely.

Trust model: the framed hop is cluster-internal cleartext TCP.  When
DIGEST credentials are configured (``oryx.serving.api.user-name``) the
first frame on a connection must be an AUTH frame carrying the same
HA1 the DIGEST scheme stores; a mismatch closes the connection.
Deployments that require TLS on the internal hop keep
``oryx.cluster.transport.enabled = false`` — the HTTP/1.1 pool remains
the fallback and the default.

Chaos seam: ``transport-frame-stall`` stalls ONE stream's response
write on the replica (mode=delay) — the chaos proof that its
connection-mates keep flowing and the router's hedge fires a frame,
not a connect.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import socket
import struct
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, SimpleQueue

from ..common import clock as clockmod
from ..common.device import bind_thread
from ..resilience import faults

_log = logging.getLogger(__name__)

__all__ = ["FrameTransport", "FrameServer", "StreamAbandoned",
           "FRAME_REQ", "FRAME_RESP", "FRAME_CANCEL", "FRAME_AUTH",
           "read_frame", "write_frame"]

FRAME_REQ = 1
FRAME_RESP = 2
FRAME_CANCEL = 3
FRAME_AUTH = 4

# u32 length | u8 type | u32 stream
_HEAD = struct.Struct(">IBI")
# a frame larger than this is protocol abuse or corruption, not data
_MAX_FRAME = 64 << 20


class StreamAbandoned(Exception):
    """This stream was cancelled locally (a hedge sibling won, or the
    deadline expired) — not a replica failure and never breaker
    evidence."""


def write_frame(sock: socket.socket, ftype: int, stream: int,
                payload: bytes, lock: threading.Lock) -> None:
    """One frame, atomically with respect to other writers on the same
    connection (the whole point of the per-connection write lock: an
    interleaved half-frame would desync every stream at once)."""
    head = _HEAD.pack(5 + len(payload), ftype, stream)
    with lock:
        sock.sendall(head + payload)


def read_frame(rfile) -> tuple[int, int, bytes]:
    """(type, stream, payload); raises ConnectionError at EOF or on a
    malformed/oversized frame."""
    head = rfile.read(_HEAD.size)
    if not head:
        raise ConnectionError("frame connection closed")
    while len(head) < _HEAD.size:
        more = rfile.read(_HEAD.size - len(head))
        if not more:
            raise ConnectionError("truncated frame head")
        head += more
    length, ftype, stream = _HEAD.unpack(head)
    if length < 5 or length > _MAX_FRAME:
        raise ConnectionError(f"bad frame length {length}")
    need = length - 5
    chunks = []
    while need:
        got = rfile.read(need)
        if not got:
            raise ConnectionError("truncated frame payload")
        chunks.append(got)
        need -= len(got)
    return ftype, stream, b"".join(chunks)


def _pack_msg(header: dict, body: bytes) -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return struct.pack(">I", len(hj)) + hj + body


def _unpack_msg(payload: bytes) -> tuple[dict, bytes]:
    (hlen,) = struct.unpack_from(">I", payload)
    header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    return header, payload[4 + hlen:]


def auth_ha1(user: str, password: str, realm: str = "Oryx") -> str:
    """The DIGEST scheme's HA1 — the shared secret both ends of the
    framed hop already hold (lambda_rt/http.py `_auth_ok`)."""
    return hashlib.md5(
        f"{user}:{realm}:{password or ''}".encode()).hexdigest()


# -- client (router side) -----------------------------------------------------

# posted into a stream's box when the stream is cancelled locally
_ABANDON = object()


class _ClientConn:
    """One multiplexed connection: a writer-locked socket, a reader
    thread demuxing RESP frames into per-stream boxes."""

    def __init__(self, addr: tuple[str, int], connect_timeout: float,
                 ha1: str | None):
        self.sock = socket.create_connection(addr,
                                             timeout=connect_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)
        self._rfile = self.sock.makefile("rb")
        self.wlock = threading.Lock()
        self._lock = threading.Lock()
        self._streams: dict[int, SimpleQueue] = {}
        self._next = 0
        self.dead = False
        self.last_used = clockmod.monotonic()
        if ha1 is not None:
            write_frame(self.sock, FRAME_AUTH, 0,
                        json.dumps({"ha1": ha1}).encode(), self.wlock)
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name="transport-reader")
        self._reader.start()

    def open_stream(self) -> tuple[int, SimpleQueue]:
        with self._lock:
            if self.dead:
                raise ConnectionError("frame connection dead")
            self._next += 1
            box: SimpleQueue = SimpleQueue()
            self._streams[self._next] = box
            return self._next, box

    def close_stream(self, stream: int) -> None:
        with self._lock:
            self._streams.pop(stream, None)

    def abandon_stream(self, stream: int) -> bool:
        """Wake the stream's waiter with the abandoned sentinel and
        send a CANCEL frame (best-effort).  True when the stream was
        still open."""
        with self._lock:
            box = self._streams.pop(stream, None)
        if box is None:
            return False
        box.put(_ABANDON)
        try:
            write_frame(self.sock, FRAME_CANCEL, stream, b"",
                        self.wlock)
        except OSError:
            pass
        return True

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._streams)

    def _read_loop(self) -> None:
        try:
            while True:
                ftype, stream, payload = read_frame(self._rfile)
                if ftype != FRAME_RESP:
                    continue  # unknown server frame: ignore, stay up
                with self._lock:
                    box = self._streams.pop(stream, None)
                if box is not None:
                    box.put(payload)
        except (OSError, ConnectionError, ValueError):
            pass
        finally:
            self.kill()

    def kill(self) -> None:
        with self._lock:
            if self.dead:
                return
            self.dead = True
            streams = list(self._streams.values())
            self._streams.clear()
        for box in streams:
            box.put(ConnectionError("frame connection died"))
        try:
            self.sock.close()
        except OSError:
            pass


class FrameTransport:
    """Router-side framed client: one :class:`_ClientConn` per replica
    transport address, idle connections aged out with the same TTL
    policy the scatter pool uses (autoscaler churn on ephemeral ports
    must not grow the map forever)."""

    def __init__(self, config):
        c = "oryx.cluster.transport"
        self.connect_timeout = \
            config.get_int(f"{c}.connect-timeout-ms") / 1000.0
        self.idle_ttl_sec = config.get_int(f"{c}.idle-ttl-ms") / 1000.0
        user = config.get_optional_string("oryx.serving.api.user-name")
        self._ha1 = auth_ha1(user, config.get_optional_string(
            "oryx.serving.api.password")) if user else None
        self._conns: dict[tuple[str, int], _ClientConn] = {}
        self._lock = threading.Lock()
        self._last_sweep = clockmod.monotonic()
        # operator counters (surfaced through ScatterGather.stats)
        self.cancels_sent = 0
        self.reconnects = 0

    # -- connection map ------------------------------------------------------

    def _addr_of(self, hb) -> tuple[str, int]:
        host = urllib.parse.urlparse(hb.url).hostname
        return (host, int(hb.tport))

    def _acquire(self, addr: tuple[str, int]
                 ) -> tuple[_ClientConn, bool]:
        """(connection, reused) — reused means from the map, which may
        have died since its last frame (replica restart)."""
        self._sweep()
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.dead:
                conn.last_used = clockmod.monotonic()
                return conn, True
        fresh = _ClientConn(addr, self.connect_timeout, self._ha1)
        with self._lock:
            cur = self._conns.get(addr)
            if cur is not None and not cur.dead:
                # lost the connect race: ride the winner, drop ours
                fresh.kill()
                cur.last_used = clockmod.monotonic()
                return cur, True
            if cur is not None:
                self.reconnects += 1
            self._conns[addr] = fresh
        return fresh, False

    def _drop(self, addr: tuple[str, int], conn: _ClientConn) -> None:
        with self._lock:
            if self._conns.get(addr) is conn:
                del self._conns[addr]
        conn.kill()

    def _sweep(self) -> None:
        """Age out idle connections — the same eviction the scatter
        pool applies: a retired replica's ephemeral port must not pin
        a socket (and a map entry) forever."""
        now = clockmod.monotonic()
        if now - self._last_sweep < max(1.0, self.idle_ttl_sec / 4):
            return
        with self._lock:
            self._last_sweep = now
            stale = [(a, c) for a, c in self._conns.items()
                     if c.dead or (c.in_flight == 0
                                   and now - c.last_used
                                   > self.idle_ttl_sec)]
            for addr, _ in stale:
                del self._conns[addr]
        for _, conn in stale:
            conn.kill()

    def open_connections(self) -> int:
        with self._lock:
            return sum(1 for c in self._conns.values() if not c.dead)

    def connection_snapshot(self) -> dict:
        """addr -> in-flight stream count, for /metrics and the bench's
        sockets-per-replica evidence."""
        with self._lock:
            return {f"{a[0]}:{a[1]}": c.in_flight
                    for a, c in self._conns.items() if not c.dead}

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.kill()

    # -- one round trip ------------------------------------------------------

    def request(self, hb, method: str, path: str, body: bytes | None,
                headers: dict[str, str], timeout: float,
                cancel=None) -> tuple[int, bytes, dict[str, str]]:
        """One framed request against ``hb``'s transport listener.
        Mirrors the HTTP hop's contract: (status, body bytes,
        lower-cased response headers); ConnectionError on transport
        death (retried once internally when the cached connection was
        stale — the replica-restart case); TimeoutError when the
        window expires (the stream is CANCELled); StreamAbandoned when
        ``cancel`` fired (a hedge sibling won)."""
        addr = self._addr_of(hb)
        conn, reused = self._acquire(addr)
        try:
            return self._roundtrip(conn, method, path, body, headers,
                                   timeout, cancel)
        except ConnectionError:
            self._drop(addr, conn)
            if not reused:
                raise
            # stale cached connection: the replica restarted between
            # frames — a property of THIS connection, not the replica.
            # Internal queries are idempotent reads; retry once fresh.
            conn, _ = self._acquire(addr)
            try:
                return self._roundtrip(conn, method, path, body,
                                       headers, timeout, cancel)
            except ConnectionError:
                self._drop(addr, conn)
                raise

    def _roundtrip(self, conn: _ClientConn, method: str, path: str,
                   body: bytes | None, headers: dict[str, str],
                   timeout: float, cancel) -> tuple[int, bytes, dict]:
        stream, box = conn.open_stream()
        registered = None
        if cancel is not None:
            registered = cancel.register(
                lambda: self._abandon(conn, stream))
            if registered is None:
                # the race was already lost before the frame went out
                conn.close_stream(stream)
                raise StreamAbandoned("cancelled before send")
        try:
            payload = _pack_msg({"m": method, "p": path, "h": headers},
                                body or b"")
            write_frame(conn.sock, FRAME_REQ, stream, payload,
                        conn.wlock)
            try:
                got = box.get(timeout=max(0.001, timeout))
            except Empty:
                # the window expired: tell the replica to stop — the
                # cancellation that used to mean an abandoned socket
                # is now one frame on a healthy connection
                if conn.abandon_stream(stream):
                    with self._lock:
                        self.cancels_sent += 1
                raise TimeoutError(
                    f"frame stream timed out after {timeout:.3f}s"
                ) from None
            if got is _ABANDON:
                with self._lock:
                    self.cancels_sent += 1
                raise StreamAbandoned("hedge sibling won")
            if isinstance(got, BaseException):
                raise got
            header, raw = _unpack_msg(got)
            rhdrs = {str(k).lower(): str(v)
                     for k, v in (header.get("h") or {}).items()}
            return int(header["s"]), raw, rhdrs
        finally:
            if registered is not None:
                cancel.unregister(registered)
            conn.close_stream(stream)
            conn.last_used = clockmod.monotonic()

    @staticmethod
    def _abandon(conn: _ClientConn, stream: int) -> None:
        conn.abandon_stream(stream)


# -- server (replica side) ----------------------------------------------------

class _FrameHandler:
    """The buffered handler adapter the frame dispatcher hands to
    HttpApp.handle — the exact surface the threaded server's handler
    exposes, with the response captured instead of written to a
    socket.  Framed requests dispatch through the SAME app (routes,
    metrics, tracing, deadline minting), so a framed answer is
    byte-identical to the HTTP hop's by construction."""

    def __init__(self, method: str, path: str, headers: dict[str, str],
                 body: bytes):
        self.command = method
        self.path = path
        self.headers = dict(headers)
        self.headers["Content-Length"] = str(len(body))
        self.rfile = io.BytesIO(body)
        self.wfile = io.BytesIO()
        self.status = 0
        self.resp_headers: dict[str, str] = {}
        self._close = False
        # connection-level AUTH already ran (FrameServer): skip the
        # per-request DIGEST dance the HTTP hop pays
        self._oryx_preauth = True

    def send_response(self, status: int) -> None:
        self.status = status

    def send_header(self, key: str, value: str) -> None:
        self.resp_headers[key] = str(value)

    def end_headers(self) -> None:
        pass


class FrameServer:
    """Replica-side frame listener: accepts the router's multiplexed
    connections, dispatches REQ frames through the serving layer's
    HttpApp on a bounded worker pool, honors CANCEL, and consults the
    replica-side result cache before touching the device."""

    def __init__(self, app, config, metrics=None, shard_cache=None,
                 port: int | None = None):
        c = "oryx.cluster.transport"
        self.app = app
        self.metrics = metrics
        self.shard_cache = shard_cache
        self._workers = ThreadPoolExecutor(
            max_workers=max(1, config.get_int(f"{c}.workers")),
            thread_name_prefix="frame-serve", initializer=bind_thread,
            initargs=(getattr(app, "thread_card", None),))
        self._require_ha1 = None
        if app.user_name is not None:
            self._require_ha1 = auth_ha1(app.user_name,
                                         app.password or "")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0",
                         config.get_int(f"{c}.port")
                         if port is None else port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._accept_thread: threading.Thread | None = None
        self.frames_served = 0
        self.cancelled_streams = 0

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="frame-accept")
        self._accept_thread.start()

    def close(self) -> None:
        self._stop.set()
        try:
            # shutdown BEFORE close: the accept thread is blocked in
            # accept(2) and a bare close leaves the listener fd alive
            # in the kernel (the port stays bound, a restart can't
            # rebind); shutdown wakes the accept with an error
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._workers.shutdown(wait=False)
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True, name="frame-conn").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wlock = threading.Lock()
        cancelled: set[int] = set()
        clock = threading.Lock()
        authed = self._require_ha1 is None
        try:
            while True:
                ftype, stream, payload = read_frame(rfile)
                if ftype == FRAME_AUTH:
                    try:
                        offered = json.loads(payload).get("ha1")
                    except (ValueError, AttributeError):
                        offered = None
                    if self._require_ha1 is not None \
                            and offered != self._require_ha1:
                        _log.warning("frame connection rejected: "
                                     "bad AUTH")
                        return
                    authed = True
                    continue
                if not authed:
                    _log.warning("frame connection rejected: first "
                                 "frame not AUTH")
                    return
                if ftype == FRAME_CANCEL:
                    with clock:
                        cancelled.add(stream)
                        if len(cancelled) > 4096:
                            # a CANCEL that crossed its RESP on the
                            # wire leaves an id nothing will ever
                            # consume; ids are per-connection
                            # monotonic, so on a long-lived connection
                            # those races would otherwise accumulate
                            # forever.  Clearing is benign: a false
                            # negative just writes a response the
                            # router demuxes to nothing.
                            cancelled.clear()
                            cancelled.add(stream)
                    self.cancelled_streams += 1
                    if self.metrics is not None:
                        self.metrics.inc("transport_cancelled_streams")
                    continue
                if ftype != FRAME_REQ:
                    continue  # unknown client frame: ignore
                try:
                    self._workers.submit(self._serve_frame, conn,
                                         wlock, cancelled, clock,
                                         stream, payload)
                except RuntimeError:
                    return  # pool shut down under us: server closing
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_frame(self, conn, wlock, cancelled, clock, stream,
                     payload) -> None:
        try:
            with clock:
                if stream in cancelled:
                    cancelled.discard(stream)
                    return  # cancelled before it ever started: no work
            header, body = _unpack_msg(payload)
            method = str(header.get("m", "GET"))
            path = str(header.get("p", "/"))
            headers = {str(k).title(): str(v)
                       for k, v in (header.get("h") or {}).items()}
            # chaos: ONE stream's answer stalls mid-frame — fired
            # per-stream BEFORE the write lock, so connection-mates
            # (and their hedges) keep flowing
            faults.fire("transport-frame-stall")
            status, rhdrs, out = self._answer(method, path, headers,
                                              body)
            with clock:
                if stream in cancelled:
                    cancelled.discard(stream)
                    return  # loser of a hedge: drop the bytes
            write_frame(conn, FRAME_RESP, stream,
                        _pack_msg({"s": status, "h": rhdrs}, out),
                        wlock)
            with clock:
                # a CANCEL racing the write above lands in the set
                # AFTER this stream already answered: reclaim it here
                # so the common race (timeout boundary) never leaks
                cancelled.discard(stream)
            self.frames_served += 1
        except (ConnectionError, OSError):
            pass  # connection died under the response: nothing to do
        except Exception:  # noqa: BLE001 — a dispatcher bug must not
            _log.exception("frame dispatch failed")  # kill the loop

    def _answer(self, method: str, path: str, headers: dict,
                body: bytes) -> tuple[int, dict, bytes]:
        cache = self.shard_cache
        base = path.split("?", 1)[0]
        cacheable = (cache is not None and cache.enabled
                     and base.startswith("/shard/")
                     and base != "/shard/meta")
        epoch0 = 0
        if cacheable:
            got = cache.lookup(method, path, body)
            if got is not None:
                return got
            epoch0 = cache.epoch()
        handler = _FrameHandler(method, path, headers, body)
        self.app.handle(handler)
        out = handler.wfile.getvalue()
        rhdrs = {k.lower(): v for k, v in handler.resp_headers.items()}
        if cacheable:
            cache.store(method, path, body, epoch0, handler.status,
                        rhdrs, out)
        return handler.status, rhdrs, out
