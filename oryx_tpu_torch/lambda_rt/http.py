"""Minimal HTTP resource framework for the serving layer.

Counterpart of ``oryx_tpu/lambda_rt/http.py`` (reference: the serving
runtime hosts JAX-RS resources in embedded Tomcat with Jersey —
ServingLayer.java:58-339, OryxApplication.java:41-98,
CSVMessageBodyWriter.java:39, ErrorResource.java:36), cut down to
HTTP/1.1: route patterns with path variables (including multi-segment
tails), JSON/CSV content negotiation, gzip, plain-text and HTML error
pages, per-request deadlines, read-only gating, and the observability
hooks of the dispatcher (the metrics registry's per-route record with a
trace exemplar, the request span and its ``X-Oryx-Trace`` echo, the
wide-event line and the flight recorder's ring append).  HTTP/2, TLS,
DIGEST auth and the serving cluster's admission and result-cache hooks
come with later slices.
"""

from __future__ import annotations

import gzip
import html as html_mod
import json
import re
import time
import urllib.parse
from http.server import ThreadingHTTPServer
from typing import Any, Callable, NamedTuple

from ..resilience.policy import Deadline, DeadlineExceeded
from ..api.serving import OryxServingException

__all__ = ["Route", "Request", "HttpApp", "json_or_csv", "wants_csv",
           "HtmlResponse", "TextResponse", "render_error_page",
           "make_server"]


class HtmlResponse:
    """A handler result rendered verbatim as text/html (console pages —
    reference: AbstractConsoleResource returning MediaType.TEXT_HTML)."""

    def __init__(self, html: str):
        self.html = html


class TextResponse:
    """A handler result rendered verbatim as text regardless of Accept
    (the error page's text form — ErrorResource.errorText).  The
    content type defaults to text/plain; the OpenMetrics exposition
    overrides it (the scraper contract names a dedicated media type)."""

    def __init__(self, text: str, content_type: str = "text/plain"):
        self.text = text
        self.content_type = content_type


def render_error_page(status: int, uri: str | None, message: str | None,
                      accept: str) -> tuple[bytes, str]:
    """The uniform error page, negotiated by Accept the way the
    reference's error forward target renders it: an HTML document for
    browsers, plain text otherwise (ErrorResource.java:40-120,
    errorHTML/errorText; monospace-on-teal is its signature style).
    Every in-flight error is rendered through here, and the /error
    resource (serving/framework.py) is the addressable form of the same
    page.  Returns (payload, content-type)."""
    if "text/html" in accept:
        parts = ["<!DOCTYPE html><html><head><title>Error</title>"
                 '<style type="text/css">'
                 "body{background-color:#01596e} "
                 "body,p{font-family:monospace;color:white}"
                 "</style></head><body>",
                 f"<p><strong>Error {status}</strong>"]
        if uri:
            parts.append(f" : {html_mod.escape(uri)}")
        parts.append("</p>")
        if message:
            parts.append(
                f"<p><strong>{html_mod.escape(message)}</strong></p>")
        parts.append("</body></html>")
        return "".join(parts).encode(), "text/html; charset=utf-8"
    text = f"HTTP {status}"
    if uri:
        text += f" : {uri}"
    text += "\n"
    if message:
        text += f"{message}\n"
    return text.encode(), "text/plain"


class Route(NamedTuple):
    method: str               # GET / POST / DELETE / HEAD
    pattern: str              # e.g. "/recommend/{userID}", "/similarity/{itemID:+}"
    handler: Callable[["Request"], Any]
    mutates: bool = False     # disabled in read-only mode


class Request(NamedTuple):
    method: str
    path: str
    params: dict[str, str]        # path variables
    query: dict[str, list[str]]
    body: bytes
    headers: dict[str, str]
    context: dict[str, Any]       # app-scope objects (model manager, producer...)
    # per-call deadline (resilience.policy.Deadline) minted at the front
    # end from oryx.resilience.request-deadline-ms and/or the client's
    # X-Deadline-Ms header; None = unbounded.  Handlers thread it into
    # queueing work (the scoring micro-batcher) so an expired request is
    # refused (503) instead of queueing to die.
    deadline: Any = None

    def q1(self, name: str, default: str | None = None) -> str | None:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def q_int(self, name: str, default: int) -> int:
        v = self.q1(name)
        return default if v is None else int(v)

    def q_list(self, name: str) -> list[str]:
        return self.query.get(name, [])


def _compile(pattern: str) -> re.Pattern:
    out = []
    for part in pattern.strip("/").split("/"):
        if part.startswith("{") and part.endswith("}"):
            name = part[1:-1]
            if name.endswith(":+"):
                out.append(f"(?P<{name[:-2]}>.+)")
            else:
                out.append(f"(?P<{name}>[^/]+)")
        else:
            out.append(re.escape(part))
    return re.compile("^/" + "/".join(out) + "$")


def wants_csv(accept: str) -> bool:
    """The CSV-vs-JSON negotiation predicate."""
    return "text/csv" in accept or (
        "text/plain" in accept and "json" not in accept)


def json_or_csv(value: Any, accept: str) -> tuple[bytes, str]:
    """Render a response honoring Accept: JSON by default (compact —
    no whitespace; at top-N row counts the separators are a measurable
    fraction of every body), CSV lines when text/csv is asked for
    (reference: CSVMessageBodyWriter)."""
    if isinstance(value, HtmlResponse):
        return value.html.encode(), "text/html; charset=utf-8"
    if isinstance(value, TextResponse):
        return value.text.encode(), value.content_type
    if wants_csv(accept):
        if isinstance(value, (list, tuple)):
            lines = []
            for item in value:
                if hasattr(item, "to_csv"):  # HasCSV contract, duck-typed
                    lines.append(item.to_csv())
                elif isinstance(item, (list, tuple)):
                    lines.append(",".join(str(x) for x in item))
                else:
                    lines.append(str(item))
            return ("\n".join(lines) + ("\n" if lines else "")).encode(), \
                "text/csv"
        if hasattr(value, "to_csv"):
            return (value.to_csv() + "\n").encode(), "text/csv"
        return (str(value) + "\n").encode(), "text/plain"
    # JSON — DTO lists take the fragment fast path (a /recommend under
    # load serializes thousands of IDValue rows per second; the
    # default-callback protocol costs ~3x per element)
    if isinstance(value, list) and value \
            and hasattr(type(value[0]), "to_json_fragment"):
        return ("[" + ",".join(v.to_json_fragment() for v in value)
                + "]").encode(), "application/json"

    def _default(o):
        if hasattr(o, "__dict__"):
            return o.__dict__
        raise TypeError(type(o).__name__)

    return json.dumps(value, default=_default,
                      separators=(",", ":")).encode(), "application/json"


def _split_result(result) -> tuple[int, Any, dict]:
    """Normalize handler results: value | (status, value) | (status,
    value, headers) — the 3-form lets resources attach response headers."""
    if isinstance(result, tuple) and len(result) == 3 \
            and isinstance(result[0], int) \
            and isinstance(result[2], dict):
        return result
    if isinstance(result, tuple) and len(result) == 2 \
            and isinstance(result[0], int):
        return result[0], result[1], {}
    return 200, result, {}




class HttpApp:
    """Routes + app context, servable by ``make_server``."""

    def __init__(self, routes: list[Route], context: dict[str, Any],
                 read_only: bool = False, context_path: str = "/",
                 request_deadline_ms: int = 0):
        self._routes = [(r, _compile(r.pattern)) for r in routes]
        self.context = context
        # the dispatcher records into the registry /metrics reads
        self.metrics = context.get("metrics")
        # request tracing (obs/trace.py): None = disabled, and the whole
        # apparatus costs one attribute check per request
        self.tracer = context.get("tracer")
        self._request_span = (f"{self.tracer.service}.request"
                              if self.tracer is not None else None)
        # wide-event request log (obs/events.py): None = disabled
        self.events = context.get("events")
        # flight recorder (obs/flight.py): None = disabled; armed it
        # costs one ring append per request in the finally block
        self.flight = context.get("flight")
        self.read_only = read_only
        self.context_path = "" if context_path in ("/", "") \
            else context_path.rstrip("/")
        self.request_deadline_ms = request_deadline_ms

    def _deadline(self, handler):
        """Mint the per-request Deadline: the tighter of the configured
        default and the client's X-Deadline-Ms header (a client's bound
        may only shrink the server's, never extend it)."""
        ms = self.request_deadline_ms if self.request_deadline_ms > 0 \
            else None
        hdr = handler.headers.get("X-Deadline-Ms")
        if hdr:
            try:
                client_ms = int(hdr)
            except ValueError:
                client_ms = None
            if client_ms is not None and client_ms >= 0:
                # 0 is a valid (already expired) budget, not "none"
                ms = client_ms if ms is None else min(ms, client_ms)
        if ms is None:
            return None
        return Deadline.after(ms / 1000.0)

    # -- dispatch ------------------------------------------------------------

    @staticmethod
    def _drain_body(handler) -> None:
        """Keep-alive hygiene for error paths that return before the
        request body is read: leftover bytes on the socket would be
        parsed as the next request line.  Reads and discards a bounded
        body; past the bound (or with chunked framing, which this server
        never negotiates) the connection is marked for close instead."""
        try:
            length = int(handler.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if handler.headers.get("Transfer-Encoding"):
            handler._close = True
            return
        if length <= 0:
            return
        if length > (1 << 20):
            handler._close = True
            return
        handler.rfile.read(length)

    def handle(self, handler) -> None:
        t0 = time.perf_counter()
        handler._oryx_route = None
        handler._oryx_status = 0
        # reset per request: a handler object serves every request of a
        # keep-alive connection, and a stale trace id must not leak onto
        # the next response's X-Oryx-Trace header
        handler._oryx_trace = None
        span = None
        if self.tracer is not None:
            # a sampled (or inbound-sampled) request gets a request span
            # and echoes X-Oryx-Trace; an unsampled one gets the shared
            # no-op span — one branch, no allocation
            span = self.tracer.begin_request(
                self._request_span, handler.headers.get("Traceparent"))
            if span.sampled:
                handler._oryx_trace = span.trace_id
        try:
            self._handle(handler)
        except BrokenPipeError:  # client went away
            pass
        finally:
            self._observe(handler, span, t0)

    def _observe(self, handler, span, t0: float) -> None:
        """The per-request observability tail: every hook is best-effort
        inside (a failing recorder degrades to a counter), so none can
        fail the request it observes."""
        route = handler._oryx_route or "unmatched"
        status = handler._oryx_status
        trace_id = handler._oryx_trace
        if self.metrics is not None:
            # unmatched paths pool under one bucket so scanners can't
            # grow the registry; status 0 means the request died before
            # any response was written.  A sampled request's trace id
            # rides along as its latency bucket's exemplar.
            self.metrics.record(route, status, time.perf_counter() - t0,
                                trace_id=trace_id)
        if span is not None and span.sampled:
            self.tracer.end_request(span, status=status,
                                    route=handler._oryx_route)
        if self.events is None and self.flight is None:
            return
        # after end_request, so the request span and the batcher's
        # retroactive spans are in the ring
        dur_ms = (time.perf_counter() - t0) * 1000.0
        spans = self.tracer.spans_for(trace_id) \
            if self.tracer is not None and trace_id else None
        if self.events is not None and self.events.should_emit(
                status, dur_ms, trace_id is not None):
            self.events.emit(route, status, dur_ms, trace_id, spans)
        if self.flight is not None:
            self.flight.observe_request(route, status, dur_ms, trace_id,
                                        spans)

    def _handle(self, handler) -> None:
        parsed = urllib.parse.urlparse(handler.path)
        path = urllib.parse.unquote(parsed.path)
        if self.context_path and path.startswith(self.context_path):
            path = path[len(self.context_path):] or "/"
        query = urllib.parse.parse_qs(parsed.query)
        method = handler.command
        lookup_method = "GET" if method == "HEAD" else method

        matched_path = False
        for route, regex in self._routes:
            m = regex.match(path)
            if not m:
                continue
            matched_path = True
            if route.method != lookup_method:
                continue
            handler._oryx_route = f"{route.method} {route.pattern}"
            if route.mutates and self.read_only:
                self._send_error(handler, 403, "endpoint is read-only")
                self._drain_body(handler)
                return
            self._dispatch_route(handler, route, path, m, query, method)
            return
        if matched_path:
            self._send_error(handler, 405, "method not allowed")
        else:
            self._send_error(handler, 404, f"no resource at {path}")
        self._drain_body(handler)

    def _dispatch_route(self, handler, route, path, m, query,
                        method) -> None:
        try:
            length = int(handler.headers.get("Content-Length") or 0)
        except ValueError:
            handler._close = True  # framing unknown: don't reuse
            self._send_error(handler, 400, "bad Content-Length")
            return
        body = handler.rfile.read(length) if length > 0 else b""
        if handler.headers.get("Content-Encoding", "") == "gzip" and body:
            try:
                body = gzip.decompress(body)
            except (gzip.BadGzipFile, OSError, EOFError):
                self._send_error(handler, 400,
                                 "Content-Encoding gzip but body is not")
                return
        req = Request(method, path, m.groupdict(), query, body,
                      dict(handler.headers), self.context,
                      deadline=self._deadline(handler))
        try:
            result = route.handler(req)
        except OryxServingException as e:
            # e.headers (e.g. Retry-After) ride out with the error page
            self._send_error(handler, e.status, str(e), headers=e.headers)
            return
        except DeadlineExceeded as e:
            # the request's time budget ran out while queued or in
            # flight: shed it rather than report a server fault
            self._send_error(handler, 503, str(e))
            return
        except (ValueError, KeyError) as e:
            self._send_error(handler, 400, f"bad request: {e}")
            return
        except Exception as e:  # noqa: BLE001 — uniform 500 page
            self._send_error(handler, 500, f"{type(e).__name__}: {e}")
            return
        self._send(handler, result, method == "HEAD",
                   handler.headers.get("Accept", ""),
                   "gzip" in handler.headers.get("Accept-Encoding", ""))

    def _send(self, handler, result, head_only: bool, accept: str,
              gzip_ok: bool) -> None:
        status, result, extra_headers = _split_result(result)
        trace_id = getattr(handler, "_oryx_trace", None)
        if result is None:
            status = status if status != 200 else 204
            handler._oryx_status = status
            handler.send_response(status)
            if trace_id:
                handler.send_header("X-Oryx-Trace", trace_id)
            for k, v in extra_headers.items():
                handler.send_header(k, v)
            handler.end_headers()
            return
        handler._oryx_status = status
        payload, ctype = json_or_csv(result, accept)
        handler.send_response(status)
        if trace_id:
            # a sampled request: hand the trace id back, so a slow answer
            # can be matched with its recorded trace (/admin/traces)
            handler.send_header("X-Oryx-Trace", trace_id)
        for k, v in extra_headers.items():
            handler.send_header(k, v)
        handler.send_header("Content-Type", ctype)
        if isinstance(result, HtmlResponse):
            # console pages carry anti-clickjacking + cache headers
            # (reference: AbstractConsoleResource.getHTML)
            handler.send_header("X-Frame-Options", "SAMEORIGIN")
            handler.send_header("Cache-Control", "public")
        if gzip_ok and len(payload) > 256:
            payload = gzip.compress(payload)
            handler.send_header("Content-Encoding", "gzip")
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        if not head_only:
            handler.wfile.write(payload)

    def _send_error(self, handler, status: int, message: str,
                    headers: dict[str, str] | None = None) -> None:
        # uniform error page, HTML for browsers (reference:
        # ErrorResource.java:36, wired as the error page for every
        # status by ServingLayer.java:305-311)
        handler._oryx_status = status
        payload, ctype = render_error_page(
            status, None, message, handler.headers.get("Accept", ""))
        handler.send_response(status)
        trace_id = getattr(handler, "_oryx_trace", None)
        if trace_id:
            handler.send_header("X-Oryx-Trace", trace_id)
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        if getattr(handler, "command", None) == "HEAD":
            return  # HEAD: headers only, or keep-alive framing breaks
        try:
            handler.wfile.write(payload)
        except BrokenPipeError:
            pass


_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request",
            401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
            405: "Method Not Allowed", 500: "Internal Server Error",
            503: "Service Unavailable"}

_KNOWN_METHODS = frozenset({"GET", "HEAD", "POST", "DELETE"})


def make_server(app: HttpApp, port: int) -> ThreadingHTTPServer:
    """HTTP/1.1 server with keep-alive hosting the app; port 0 picks a
    free one.

    The per-request parser is hand-rolled rather than
    ``BaseHTTPRequestHandler``, as in the reference: the stdlib handler
    routes every request through the email-message machinery, a large
    share of per-request host CPU at serving load.  The surface HttpApp
    needs — ``command``/``path``/``headers`` (Title-Case keys)/``rfile``/
    ``wfile``/``send_response``/``send_header``/``end_headers`` — is
    preserved exactly."""
    import socketserver

    class _Handler(socketserver.StreamRequestHandler):
        wbufsize = -1  # buffered response writes, one flush per request

        def handle(self):
            try:
                while self._handle_one():
                    pass
            except (ConnectionError, TimeoutError, OSError):
                pass  # client went away

        def _handle_one(self) -> bool:
            line = self.rfile.readline(65537)
            if line in (b"\r\n", b"\n"):  # tolerated leading blank line
                line = self.rfile.readline(65537)
            if not line:
                return False  # clean keep-alive close
            parts = line.split()
            if len(parts) != 3 or not parts[2].startswith(b"HTTP/"):
                self.wfile.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"Content-Length: 0\r\n\r\n")
                self.wfile.flush()
                return False
            self.command = parts[0].decode("latin-1")
            self.path = parts[1].decode("latin-1")
            headers: dict[str, str] = {}
            while True:
                h = self.rfile.readline(65537)
                if h in (b"\r\n", b"\n", b""):
                    break
                # reject oversized lines, too many headers, a field line
                # without ':' and obs-fold continuations (RFC 9112 §5)
                k, sep, v = h.partition(b":")
                if (len(h) > 65536 or len(headers) >= 128 or not sep
                        or h[:1] in (b" ", b"\t")):
                    self.wfile.write(b"HTTP/1.1 400 Bad Request\r\n"
                                     b"Content-Length: 0\r\n\r\n")
                    self.wfile.flush()
                    return False
                headers[k.decode("latin-1").strip().title()] = \
                    v.decode("latin-1").strip()
            self.headers = headers
            self._close = (headers.get("Connection", "").lower() == "close"
                           or parts[2] == b"HTTP/1.0")
            if headers.get("Expect", "").lower() == "100-continue":
                self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                self.wfile.flush()
            self._head: list[str] = []
            if self.command in _KNOWN_METHODS:
                app.handle(self)
            else:
                app._send_error(self, 405, "method not allowed")
                app._drain_body(self)
            self.wfile.flush()
            return not self._close

        # -- the response surface HttpApp writes through ----------------

        def send_response(self, status: int) -> None:
            self._head.append(
                f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n")

        def send_header(self, key: str, value: str) -> None:
            self._head.append(f"{key}: {value}\r\n")

        def end_headers(self) -> None:
            self._head.append("\r\n")
            self.wfile.write("".join(self._head).encode("latin-1"))
            self._head = []

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        # hundreds of concurrent keep-alive clients; the socketserver
        # default backlog of 5 refuses connections under load
        request_queue_size = 512

    return _Server(("0.0.0.0", port), _Handler)
