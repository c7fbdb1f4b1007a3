"""C10K router front end: an asyncio event loop speaking the same
``Route``/dispatcher contract as the threaded server.

Counterpart of ``oryx_tpu/cluster/async_http.py``, whole.

The threaded front end (lambda_rt/http.py ``make_server``) spends one
OS thread per in-flight connection — the reference's Tomcat shape,
``maxThreads=400`` — so its concurrency ceiling is thread stacks, not
sockets.  The result cache makes the common answer a sub-millisecond hit,
which is exactly the workload an event loop multiplies: tens of
thousands of idle keep-alive connections cost file descriptors, and a
hit is served entirely ON the loop with zero thread handoffs.

Division of labor per request:

- **on-loop fast path** — HTTP/1.1 parse, route match, result-cache
  probe/lookup: a present entry renders through the same
  ``ResultCache.render`` the threaded server uses (byte-identical by
  construction) and never touches a thread.  A coalesced follower
  parks a *coroutine* on the leader's flight (woken by
  ``call_soon_threadsafe``) instead of a thread on its event.
- **bridge pool** — everything else (cache misses bound for the
  scatter, writes, admin) dispatches ``HttpApp.handle`` onto a small
  fixed executor through a buffered handler adapter.  Thread count is
  the pool size — a constant independent of connection count.  The
  pool's backlog is bounded: past it, requests shed as fast 503s
  (``async_bridge_sheds``) instead of queueing into collapse.
- **connection cap** — at ``oryx.cluster.async.max-connections`` a new
  connection gets one fast 503 and a close, never a hang
  (``async_rejected_connections``).

A watchdog task measures loop lag every tick; a handler that blocks
the loop (the one sin this architecture cannot absorb) is counted
(``async_loop_stalls``) and logged with the measured stall.  Chaos
seam ``async-loop-block`` injects exactly that sin.

Gated by ``oryx.cluster.async.enabled`` (default false); the threaded
server remains the default and the fallback.
"""

from __future__ import annotations

import asyncio
import io
import logging
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

from ..common import clock as clockmod
from ..common.device import bind_thread
from ..lambda_rt.http import (_KNOWN_METHODS, _REASONS, _render_kind,
                              render_error_page, wants_csv)
from ..resilience import faults

_log = logging.getLogger(__name__)

__all__ = ["AsyncFrontEnd"]


class _BufferedHandler:
    """The handler-surface adapter the bridge pool hands to
    ``HttpApp.handle``: the exact attribute contract of the threaded
    server's handler, with the request body pre-read (the loop owns
    the socket) and the response captured as wire bytes."""

    def __init__(self, method: str, path: str, headers: dict[str, str],
                 body: bytes, close: bool):
        self.command = method
        self.path = path
        self.headers = headers
        self.rfile = io.BytesIO(body)
        self.wfile = io.BytesIO()
        self._close = close
        self._head: list[str] = []

    def send_response(self, status: int) -> None:
        self._head.append(
            f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n")

    def send_header(self, key: str, value: str) -> None:
        self._head.append(f"{key}: {value}\r\n")

    def end_headers(self) -> None:
        self._head.append("\r\n")
        self.wfile.write("".join(self._head).encode("latin-1"))
        self._head = []


def _error_response(status: int, message: str, accept: str,
                    extra: dict[str, str] | None = None,
                    close: bool = False) -> bytes:
    payload, ctype = render_error_page(status, None, message, accept)
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}\r\n")
    head.append(f"Content-Type: {ctype}\r\n")
    head.append(f"Content-Length: {len(payload)}\r\n")
    if close:
        head.append("Connection: close\r\n")
    head.append("\r\n")
    return "".join(head).encode("latin-1") + payload


class AsyncFrontEnd:
    """start()/shutdown() around the event loop, run on one background
    thread so the router's lifecycle contract is unchanged."""

    def __init__(self, app, port: int, config, ssl_context=None):
        c = "oryx.cluster.async"
        self.app = app
        self.requested_port = port
        self.ssl_context = ssl_context
        self.max_connections = config.get_int(f"{c}.max-connections")
        self.bridge_workers = max(1, config.get_int(
            f"{c}.bridge-workers"))
        # past this many queued-or-running bridged requests the front
        # end sheds instead of queueing (the executor's queue is
        # unbounded; the collapse mode of an un-gated front end)
        self.bridge_backlog = self.bridge_workers * 4
        self.watchdog_interval = config.get_int(
            f"{c}.watchdog-interval-ms") / 1000.0
        self.watchdog_stall = config.get_int(
            f"{c}.watchdog-stall-ms") / 1000.0
        self._bridge = ThreadPoolExecutor(
            max_workers=self.bridge_workers,
            thread_name_prefix="router-bridge", initializer=bind_thread,
            initargs=(getattr(app, "thread_card", None),))
        self.port: int | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = None
        self._thread: threading.Thread | None = None
        self._writers: set = set()
        self._started = threading.Event()
        self._startup_error: BaseException | None = None
        # loop-owned counters (single-threaded mutation on the loop;
        # reads from /metrics gauge closures are torn-value safe)
        self.open_connections = 0
        self.bridge_inflight = 0
        self.loop_stalls = 0
        self.loop_lag_ms = 0.0
        self.rejected_connections = 0
        self.bridge_sheds = 0
        self.fast_hits = 0
        self.fast_coalesced = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="RouterAsyncLoop")
        self._thread.start()
        self._started.wait(30.0)
        if self._startup_error is not None:
            raise self._startup_error
        if self.port is None:
            raise RuntimeError("async front end failed to start")

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._serve_connection, "0.0.0.0", self.requested_port,
                ssl=self.ssl_context, backlog=512))
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as e:  # noqa: BLE001 — surfaced to start()
            self._startup_error = e
            self._started.set()
            return
        watchdog = loop.create_task(self._watchdog())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            try:
                watchdog.cancel()
                self._server.close()
                for w in list(self._writers):
                    try:
                        w.close()
                    except Exception:  # noqa: BLE001
                        pass
                loop.run_until_complete(asyncio.sleep(0))
            finally:
                loop.close()

    def shutdown(self) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(10.0)
        self._bridge.shutdown(wait=False)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- watchdog ------------------------------------------------------------

    async def _watchdog(self) -> None:
        """Measure loop lag: schedule a sleep, see how late it fires.
        A blocked loop (a handler doing synchronous work on it — the
        ``async-loop-block`` chaos) shows as lag past the stall
        threshold; count it and log the slow-request evidence."""
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.watchdog_interval)
            lag = loop.time() - t0 - self.watchdog_interval
            self.loop_lag_ms = max(0.0, lag * 1000.0)
            if lag > self.watchdog_stall:
                self.loop_stalls += 1
                metrics = self.app.metrics
                if metrics is not None:
                    metrics.inc("async_loop_stalls")
                _log.warning(
                    "SLOW LOOP: event loop blocked %.0f ms (threshold "
                    "%.0f ms) — a handler ran synchronous work on the "
                    "loop; open_connections=%d bridge_inflight=%d",
                    lag * 1000.0, self.watchdog_stall * 1000.0,
                    self.open_connections, self.bridge_inflight)

    # -- per-connection ------------------------------------------------------

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        if self.open_connections >= self.max_connections:
            # graceful at the cap: one fast 503, then close — a
            # refused client learns NOW instead of hanging in a
            # backlog the server will never drain
            self.rejected_connections += 1
            metrics = self.app.metrics
            if metrics is not None:
                metrics.inc("async_rejected_connections")
            try:
                writer.write(_error_response(
                    503, "connection limit reached", "", close=True))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            writer.close()
            return
        self.open_connections += 1
        self._writers.add(writer)
        try:
            while await self._one_request(reader, writer):
                pass
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        except asyncio.LimitOverrunError:
            pass
        finally:
            self.open_connections -= 1
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _one_request(self, reader, writer) -> bool:
        try:
            line = await reader.readline()
        except ValueError:  # overlong request line
            writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Content-Length: 0\r\n\r\n")
            await writer.drain()
            return False
        if line in (b"\r\n", b"\n"):  # tolerated leading blank line
            line = await reader.readline()
        if not line:
            return False  # clean keep-alive close
        parts = line.split()
        if len(parts) != 3 or not parts[2].startswith(b"HTTP/"):
            writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Content-Length: 0\r\n\r\n")
            await writer.drain()
            return False
        method = parts[0].decode("latin-1")
        target = parts[1].decode("latin-1")
        headers: dict[str, str] = {}
        while True:
            try:
                h = await reader.readline()
            except ValueError:
                h = b" " * 65537  # overlong header line: reject below
            if h in (b"\r\n", b"\n", b""):
                break
            # same guards as the threaded parser: bounded line/count,
            # reject missing ':' and obs-fold continuations (RFC 9112
            # §5 — request-smuggling surface)
            k, sep, v = h.partition(b":")
            if (len(h) > 65536 or len(headers) >= 128 or not sep
                    or h[:1] in (b" ", b"\t")):
                writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                             b"Content-Length: 0\r\n\r\n")
                await writer.drain()
                return False
            headers[k.decode("latin-1").strip().title()] = \
                v.decode("latin-1").strip()
        close = (headers.get("Connection", "").lower() == "close"
                 or parts[2] == b"HTTP/1.0")
        if headers.get("Transfer-Encoding"):
            # chunked framing is never negotiated here (same contract
            # as the threaded parser's _drain_body): the body is left
            # unread, so the connection must close or the chunk stream
            # would be parsed as the next request line — a response-
            # desync/smuggling surface behind a keep-alive proxy
            close = True
        if headers.get("Expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = b""
        try:
            length = int(headers.get("Content-Length") or 0)
        except ValueError:
            length = 0  # the dispatcher 400s it; framing unknown
            close = True
        if length > 0:
            body = await reader.readexactly(length)
        # chaos: a handler that does synchronous work ON the loop —
        # the watchdog must see the stall and count it
        faults.fire("async-loop-block")

        if method in ("GET", "HEAD"):
            fast = await self._fast_path(method == "HEAD", target,
                                         headers)
            if fast is not None:
                writer.write(fast)
                await writer.drain()
                return not close
        # bridge: the full dispatcher on a bounded pool
        if self.bridge_inflight >= self.bridge_backlog:
            self.bridge_sheds += 1
            metrics = self.app.metrics
            if metrics is not None:
                metrics.inc("async_bridge_sheds")
            writer.write(_error_response(
                503, "overloaded; retry later",
                headers.get("Accept", ""), extra={"Retry-After": "1"}))
            await writer.drain()
            return not close
        self.bridge_inflight += 1
        try:
            payload, handler_close = await asyncio.get_running_loop() \
                .run_in_executor(self._bridge, self._dispatch, method,
                                 target, headers, body, close)
        finally:
            self.bridge_inflight -= 1
        writer.write(payload)
        await writer.drain()
        return not (close or handler_close)

    def _dispatch(self, method, target, headers, body,
                  close) -> tuple[bytes, bool]:
        """Bridge-pool worker: the FULL threaded dispatcher against a
        buffered handler — auth, admission, coalescing leadership,
        scatter, everything — producing the same wire bytes the
        threaded server would."""
        handler = _BufferedHandler(method, target, headers, body, close)
        try:
            if method in _KNOWN_METHODS:
                self.app.handle(handler)
            else:
                self.app._send_error(handler, 405, "method not allowed")
                self.app._drain_body(handler)
        except Exception as e:  # noqa: BLE001 — uniform 500, keep loop
            _log.exception("bridged dispatch failed")
            return _error_response(
                500, f"{type(e).__name__}: {e}",
                headers.get("Accept", ""), close=True), True
        return handler.wfile.getvalue(), handler._close

    # -- the on-loop fast path ----------------------------------------------

    def _deadline_sec(self, headers) -> float | None:
        """Remaining-budget seconds for an on-loop coalesce wait — the
        same tighter-of-two rule HttpApp._deadline applies."""
        ms = self.app.request_deadline_ms \
            if self.app.request_deadline_ms > 0 else None
        hdr = headers.get("X-Deadline-Ms")
        if hdr:
            try:
                client_ms = int(hdr)
            except ValueError:
                client_ms = None
            if client_ms is not None and client_ms >= 0:
                ms = client_ms if ms is None else min(ms, client_ms)
        return None if ms is None else ms / 1000.0

    async def _fast_path(self, head_only: bool, target: str,
                         headers: dict[str, str]) -> bytes | None:
        """Serve a cache hit (or join an in-flight leader) entirely on
        the loop; None = not servable here, bridge it.  DIGEST-secured
        routers always bridge: the challenge dance belongs to the full
        dispatcher."""
        app = self.app
        rc = app.result_cache
        if rc is None or app.user_name is not None:
            return None
        if not (rc.store_enabled or rc.coalesce):
            return None
        t0 = clockmod.monotonic()
        parsed = urllib.parse.urlparse(target)
        path = urllib.parse.unquote(parsed.path)
        if app.context_path and path.startswith(app.context_path):
            path = path[len(app.context_path):] or "/"
        route = match = None
        for r, regex in app._routes:
            if not r.cache or r.method != "GET":
                continue
            m = regex.match(path)
            if m is not None:
                route, match = r, m
                break
        if route is None:
            return None
        query = urllib.parse.parse_qs(parsed.query)
        probe = rc.probe(route.pattern, path, query, match.groupdict())
        if probe is None:
            return None
        entry = rc.lookup_present(probe)
        verdict = "hit"
        if entry is None and rc.coalesce:
            fl = rc.flight_for(probe.key)
            if fl is not None:
                entry = await self._join_flight(rc, fl, headers)
                verdict = "coalesced"
        if entry is None:
            return None
        if verdict == "coalesced":
            rc.count_coalesced()
            self.fast_coalesced += 1
        else:
            self.fast_hits += 1
        return self._render_response(route, entry, verdict, headers,
                                     head_only, t0)

    async def _join_flight(self, rc, flight, headers):
        """Park THIS COROUTINE on the leader's flight — the async form
        of the follower's event wait, costing a heap frame instead of
        a thread.  Returns the shared entry or None (leader died /
        uncacheable / timed out → the caller bridges to its own
        scatter, the can-save-work-never-lose-a-request contract)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def wake():
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))

        if rc.add_flight_waiter(flight, wake):
            timeout = rc.coalesce_wait_sec
            deadline = self._deadline_sec(headers)
            if deadline is not None:
                timeout = min(timeout, max(0.0, deadline))
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                return None
        return flight.entry if flight.done else None

    def _render_response(self, route, entry, verdict, headers,
                         head_only, t0) -> bytes:
        """The wire form of lambda_rt.http._send_entry — same header
        order, same preserialized bytes, stamped ``X-Oryx-Cache`` —
        plus the request-side bookkeeping (metrics/trace/events) the
        threaded dispatcher would have done."""
        app = self.app
        accept = headers.get("Accept", "")
        span = None
        trace_id = None
        if app.tracer is not None:
            span = app.tracer.begin_request(
                app._request_span, headers.get("Traceparent"))
            if span.sampled:
                trace_id = span.trace_id
            with app.tracer.span("router.cache_lookup") as sp:
                sp.set_attr("cache", verdict)
        status = entry.status
        head = []
        if status != 200:
            # negative entry (hot 404): the same error page a cold
            # miss renders, Accept negotiation included
            payload, ctype = render_error_page(status, None,
                                               entry.value, accept)
            head.append(
                f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n")
            if trace_id:
                head.append(f"X-Oryx-Trace: {trace_id}\r\n")
            head.append(f"X-Oryx-Cache: {verdict}\r\n")
            head.append(f"Content-Type: {ctype}\r\n")
            head.append(f"Content-Length: {len(payload)}\r\n")
        else:
            gzip_ok = "gzip" in headers.get("Accept-Encoding", "")
            payload, ctype, gzipped = app.result_cache.render(
                entry, wants_csv(accept), gzip_ok, _render_kind)
            head.append("HTTP/1.1 200 OK\r\n")
            if trace_id:
                head.append(f"X-Oryx-Trace: {trace_id}\r\n")
            head.append(f"X-Oryx-Cache: {verdict}\r\n")
            head.append(f"Content-Type: {ctype}\r\n")
            if gzipped:
                head.append("Content-Encoding: gzip\r\n")
            head.append(f"Content-Length: {len(payload)}\r\n")
        head.append("\r\n")
        out = "".join(head).encode("latin-1")
        if not head_only:
            out += payload
        route_key = f"{route.method} {route.pattern}"
        dur = clockmod.monotonic() - t0
        if app.metrics is not None:
            app.metrics.record(route_key, status, dur,
                               trace_id=trace_id)
        if span is not None and span.sampled:
            app.tracer.end_request(span, status=status, route=route_key)
        if app.events is not None:
            dur_ms = dur * 1000.0
            if app.events.should_emit(status, dur_ms,
                                      trace_id is not None):
                spans = app.tracer.spans_for(trace_id) \
                    if app.tracer is not None and trace_id else None
                app.events.emit(route_key, status, dur_ms, trace_id,
                                spans)
        return out
