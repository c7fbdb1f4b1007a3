"""Deadline-propagating, hedging, circuit-broken fan-out to shard
replicas.

Counterpart of ``oryx_tpu/cluster/scatter.py``, whole: an attempt
against a replica whose heartbeat advertises a transport port rides the
multiplexed framed transport (``cluster/transport.py``, with
``oryx.cluster.transport.enabled``); every other attempt rides the
HTTP/1.1 socket pool.

One :class:`ScatterGather` lives on the router.  Per public request it
queries every catalog shard (``scatter``) or any one replica
(``any_replica`` — for endpoints answered from the replicated user
store).  Per shard it walks the membership registry's candidates
(ready, newest generation first) with *hedged* attempts: the first
replica gets ``hedge-after-ms`` to answer before a second attempt is
launched against the next replica — both stay in flight and the first
success wins, so one slow replica costs the hedge window, not the
whole deadline.  Every attempt runs behind a per-replica
:class:`~oryx_tpu_torch.resilience.policy.CircuitBreaker` (a dead replica is
shed in microseconds until its half-open probe passes) and carries the
request's REMAINING deadline downstream as ``X-Deadline-Ms`` so a
shard never computes an answer nobody is waiting for.

Transport is a hand-rolled keep-alive HTTP/1.1 client over a per-URL
connection pool (the stdlib client's email-parser machinery costs real
qps at gateway rates — same reasoning as bench/load.py's driver).  It
speaks the replicas' whole front-door surface: TLS to ``https``
heartbeat URLs (unverified — the cluster-internal trust model for the
replicas' self-signed serving certs) and the serving tier's DIGEST
auth (``qop="auth"``; credentials from ``oryx.serving.api.user-name/
password``, so one shared ``--conf`` secures the public door and the
scatter plane alike), with one challenge round per replica URL and
cached-nonce reuse until the replica rotates its nonce set.

HTTP responses — ANY status — are authoritative: a 404 means "user
unknown", not "replica down", and must neither trip the breaker nor
trigger a hedge.  Only transport errors, timeouts, and 5xx count as
attempt failures.

Chaos seam: ``router-shard-timeout`` fires once per shard query
(mode=delay simulates a stalled shard eating the deadline; mode=error
a shard that fails outright — the partial-answer path's test handle).
"""

from __future__ import annotations

import hashlib
import json
import logging
import re
import secrets
import socket
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, SimpleQueue
from typing import Sequence

from ..common import clock as clockmod
from ..api.serving import OryxServingException
from ..resilience import faults
from ..resilience.policy import CircuitBreaker, CircuitOpenError, Deadline
from .membership import Heartbeat, MembershipRegistry
from .transport import FrameTransport, StreamAbandoned

_log = logging.getLogger(__name__)

__all__ = ["ScatterGather", "ShardUnavailable", "ShardResponse"]


class ShardUnavailable(OryxServingException):
    """No replica of a shard produced an authoritative response within
    the deadline — the shard drops out of the merge (partial answer).
    An OryxServingException(503), so one escaping a router handler
    (every shard down, no replica for a vector gather) renders as the
    serving tier's standard 503 degrade, never a 500."""

    def __init__(self, message: str):
        super().__init__(503, message)


class ShardResponse:
    __slots__ = ("shard", "status", "payload", "replica")

    def __init__(self, shard: int, status: int, payload, replica: str):
        self.shard = shard
        self.status = status
        self.payload = payload
        self.replica = replica

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class _Pool:
    """Keep-alive socket pool per base URL.  ``https`` replica URLs get
    TLS without certificate verification: the scatter plane rides the
    cluster-internal network against the replicas' own (typically
    self-signed) serving certs, the same trust model the repo's TLS
    tests use client-side.

    Hygiene (``oryx.cluster.pool.*``): idle sockets age out after
    ``idle_ttl_sec`` and each URL's stack is bounded at
    ``max_per_url`` — with autoscaled replicas on ephemeral ports
    every spawn/retire cycle adds a URL, and an unbounded pool would
    pin dead sockets (and map entries) forever.  The sweep runs
    opportunistically on release, so an idle router still converges:
    its next request (or the periodic scrape) reclaims the lot."""

    def __init__(self, connect_timeout: float = 5.0,
                 idle_ttl_sec: float = 30.0, max_per_url: int = 64):
        # url -> [(socket, rfile, released_at_monotonic), ...]
        self._conns: dict[str, list[tuple]] = {}
        self._lock = threading.Lock()
        self.connect_timeout = connect_timeout
        self.idle_ttl_sec = idle_ttl_sec
        self.max_per_url = max(1, max_per_url)
        self._tls = None
        self._last_sweep = clockmod.monotonic()
        self.idle_evictions = 0
        self.cap_evictions = 0

    def acquire(self, url: str) -> tuple[tuple[socket.socket, object], bool]:
        """(connection, reused) — ``reused`` means keep-alive from the
        pool, which may have died since its last request.  Entries
        idle past the TTL are discarded on the way out: a socket that
        sat unused that long has likely been dropped by the far end
        (or a middlebox), and handing it out just buys a stale-socket
        retry."""
        now = clockmod.monotonic()
        stale = []
        try:
            with self._lock:
                stack = self._conns.get(url)
                while stack:
                    conn, rfile, released = stack.pop()
                    if now - released <= self.idle_ttl_sec:
                        return (conn, rfile), True
                    stale.append((conn, rfile))
                    self.idle_evictions += 1
        finally:
            for conn_rf in stale:
                self.discard(conn_rf)
        return self.fresh(url), False

    def fresh(self, url: str) -> tuple[socket.socket, object]:
        p = urllib.parse.urlparse(url)
        conn = socket.create_connection((p.hostname, p.port),
                                        timeout=self.connect_timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if p.scheme == "https":
            if self._tls is None:
                import ssl
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                self._tls = ctx
            conn = self._tls.wrap_socket(conn, server_hostname=p.hostname)
        return conn, conn.makefile("rb")

    def release(self, url: str, conn_rf) -> None:
        dropped = []
        with self._lock:
            stack = self._conns.setdefault(url, [])
            stack.append((conn_rf[0], conn_rf[1], clockmod.monotonic()))
            while len(stack) > self.max_per_url:
                # oldest-idle first: the bound sheds the sockets least
                # likely to be reused
                dropped.append(stack.pop(0))
                self.cap_evictions += 1
        for conn, rfile, _ in dropped:
            self.discard((conn, rfile))
        self._sweep()

    def _sweep(self) -> None:
        """Reclaim idle-past-TTL sockets across EVERY url and drop
        empty url keys — the long-gone-replica path: once its sockets
        age out nothing references the URL again."""
        now = clockmod.monotonic()
        stale = []
        with self._lock:
            if now - self._last_sweep < max(1.0, self.idle_ttl_sec / 4):
                return
            self._last_sweep = now
            for url in list(self._conns):
                stack = self._conns[url]
                keep = []
                for entry in stack:
                    if now - entry[2] <= self.idle_ttl_sec:
                        keep.append(entry)
                    else:
                        stale.append(entry)
                        self.idle_evictions += 1
                if keep:
                    self._conns[url] = keep
                else:
                    del self._conns[url]
        for conn, rfile, _ in stale:
            self.discard((conn, rfile))

    def pooled(self, url: str | None = None) -> int:
        """Pooled-socket count (per url, or total) — test/metrics
        introspection."""
        with self._lock:
            if url is not None:
                return len(self._conns.get(url, ()))
            return sum(len(s) for s in self._conns.values())

    def discard(self, conn_rf) -> None:
        # shutdown BEFORE close: a hedge-cancel closer runs on the
        # winner's thread while the loser is blocked in recv on this
        # socket — close() alone does not reliably wake a concurrent
        # reader; shutdown() does (the read returns EOF/ECONNRESET
        # and the loser exits through the abandoned path)
        try:
            conn_rf[0].shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn_rf[0].close()
        except OSError:
            pass

    def purge(self, url: str) -> None:
        """Drop every pooled connection for a URL — when one reused
        socket turns out dead (replica restart), its poolmates almost
        certainly are too."""
        with self._lock:
            stack = self._conns.pop(url, [])
        for conn, rfile, _ in stack:
            self.discard((conn, rfile))

    def close(self) -> None:
        with self._lock:
            for stack in self._conns.values():
                for conn, rfile, _ in stack:
                    self.discard((conn, rfile))
            self._conns.clear()


def _request(conn, rfile, method: str, path: str, body: bytes | None,
             headers: dict[str, str], timeout: float
             ) -> tuple[int, bytes, dict[str, str]]:
    conn.settimeout(max(0.001, timeout))
    head = [f"{method} {path} HTTP/1.1", "Host: oryx-cluster",
            "Accept: application/json"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    if body is not None:
        head.append(f"Content-Length: {len(body)}")
        head.append("Content-Type: application/json")
    payload = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
    if body is not None:
        payload += body
    conn.sendall(payload)
    status_line = rfile.readline(65537)
    if not status_line:
        raise ConnectionError("replica closed connection")
    status = int(status_line.split(b" ", 2)[1])
    clen = 0
    rhdrs: dict[str, str] = {}
    while True:
        h = rfile.readline(65537)
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.partition(b":")
        rhdrs[name.strip().lower().decode("latin-1")] = \
            value.strip().decode("latin-1")
        if name.strip().lower() == b"content-length":
            clen = int(value)
    out = b""
    while len(out) < clen:
        got = rfile.read(clen - len(out))
        if not got:
            raise ConnectionError("short body from replica")
        out += got
    return status, out, rhdrs


class _CancelToken:
    """One hedged shard query's cancellation latch.  Each in-flight
    attempt registers a closer (close the HTTP socket / CANCEL the
    frame stream); when a sibling wins — or the query gives up — the
    token fires every registered closer, so the losers are torn down
    NOW instead of finishing reads nobody will consume and returning
    possibly-stalled sockets to the keep-alive pool."""

    __slots__ = ("_lock", "_closers", "_next", "fired")

    def __init__(self):
        self._lock = threading.Lock()
        self._closers: dict[int, object] = {}
        self._next = 0
        self.fired = False

    def register(self, closer) -> int | None:
        """None when the token already fired (the race is over before
        this attempt got started)."""
        with self._lock:
            if self.fired:
                return None
            self._next += 1
            self._closers[self._next] = closer
            return self._next

    def update(self, key: int, closer) -> bool:
        with self._lock:
            if self.fired:
                return False
            self._closers[key] = closer
            return True

    def unregister(self, key: int) -> None:
        with self._lock:
            self._closers.pop(key, None)

    def fire(self) -> None:
        with self._lock:
            if self.fired:
                return
            self.fired = True
            closers = list(self._closers.values())
            self._closers.clear()
        for fn in closers:
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


# sentinel threaded through the breaker for a cancelled loser: a
# normal return, so the breaker never counts failure evidence against
# a replica that was merely slower than its hedge sibling
_ABANDONED = object()


class _DigestAuth:
    """DIGEST client for the replicas' challenge (the serving tier's
    MD5 ``qop="auth"`` scheme — lambda_rt/http.py `_auth_ok`).  One
    challenge round per replica URL, then the cached nonce is reused
    with an incrementing nc; when the replica rotates its nonce set
    (401 on a previously good nonce) the caller re-challenges."""

    def __init__(self, user: str, password: str):
        self.user = user
        self.password = password or ""
        # url -> (realm, nonce, next nc)
        self._state: dict[str, tuple[str, str, int]] = {}
        self._lock = threading.Lock()

    def challenge(self, url: str, www_authenticate: str) -> bool:
        pairs = re.findall(r'(\w+)=(?:"([^"]*)"|([^, ]*))',
                           www_authenticate)
        parts = {k: (q or b) for k, q, b in pairs}
        if "nonce" not in parts:
            return False
        with self._lock:
            self._state[url] = (parts.get("realm", ""), parts["nonce"], 1)
        return True

    def header(self, url: str, method: str, uri: str) -> str | None:
        with self._lock:
            st = self._state.get(url)
            if st is None:
                return None
            realm, nonce, nc = st
            self._state[url] = (realm, nonce, nc + 1)
        cnonce = secrets.token_hex(8)
        ncs = f"{nc:08x}"

        def md5(s: str) -> str:
            return hashlib.md5(s.encode()).hexdigest()

        ha1 = md5(f"{self.user}:{realm}:{self.password}")
        ha2 = md5(f"{method}:{uri}")
        response = md5(f"{ha1}:{nonce}:{ncs}:{cnonce}:auth:{ha2}")
        return (f'Digest username="{self.user}", realm="{realm}", '
                f'nonce="{nonce}", uri="{uri}", qop=auth, nc={ncs}, '
                f'cnonce="{cnonce}", response="{response}"')


class ScatterGather:
    def __init__(self, registry: MembershipRegistry, config,
                 max_concurrency: int = 64, tracer=None):
        self.registry = registry
        # obs/trace.py tracer (None = tracing off): each shard query of
        # a sampled request gets a `router.shard_call` span whose
        # context rides the internal hop as the `traceparent` header,
        # so the replica's own request span parents under it
        self.tracer = tracer
        # unsampled requests must ALSO propagate context (flags 00):
        # sampling is decided once at the root, and without the header
        # a tracing-enabled replica would re-roll its own dice on every
        # internal hop.  One process-constant string keeps the
        # unsampled hot path allocation-free.
        self._unsampled_tp = None
        if tracer is not None:
            from ..obs.trace import unsampled_traceparent
            self._unsampled_tp = unsampled_traceparent()
        c = "oryx.cluster"
        self.hedge_after_sec = config.get_int(f"{c}.hedge-after-ms") / 1000.0
        self.shard_timeout_sec = \
            config.get_int(f"{c}.shard-timeout-ms") / 1000.0
        self.max_attempts = config.get_int(f"{c}.max-attempts-per-shard")
        self._config = config
        # the multiplexed framed transport (cluster/transport.py): when
        # enabled, attempts against replicas that advertise a transport
        # port ride one persistent framed connection per replica; the
        # HTTP/1.1 pool serves replicas that don't (mixed-fleet rollout)
        self.transport = FrameTransport(config) \
            if config.get_bool(f"{c}.transport.enabled") else None
        self._pool = _Pool(
            idle_ttl_sec=config.get_int(
                f"{c}.pool.idle-ttl-ms") / 1000.0,
            max_per_url=config.get_int(f"{c}.pool.max-per-url"))
        user = config.get_optional_string("oryx.serving.api.user-name")
        self._auth = _DigestAuth(
            user, config.get_optional_string("oryx.serving.api.password")
        ) if user else None
        self._exec = ThreadPoolExecutor(max_workers=max_concurrency,
                                        thread_name_prefix="router-scatter")
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        # operator counters (router /metrics)
        self.hedges = 0
        self.shard_failures = 0
        self.partial_answers = 0
        self.group_failovers = 0
        # hedged losers torn down mid-flight instead of finishing
        # reads nobody consumes (and poisoning the keep-alive pool)
        self.hedge_abandoned = 0
        # attempts that rode the HTTP/1.1 socket pool (stats()["pool"]
        # ["attempts"]): a fleet whose every heartbeat advertises a
        # transport port keeps it at 0 with the framed transport on
        self.http_attempts = 0
        # replica url -> (reported scoring queue-wait ms, seen
        # monotonic): piggybacked on every shard envelope, the live
        # overload signal the router's admission control reads
        self._queue_waits: dict[str, tuple[float, float]] = {}
        self._qw_cache: tuple[float | None, float] = (None, -1e9)

    # how long a replica's reported queue wait stays a valid admission
    # signal; past this (replica silent / not queried) it is ignored
    QUEUE_WAIT_TTL_SEC = 10.0
    # the aggregated signal is an envelope-rate EWMA — recomputing the
    # shards x group walk (registry lock + rotation) on EVERY admitted
    # request buys nothing; a short-lived cache keeps the admission
    # gate near-zero cost on the hot path
    QUEUE_WAIT_CACHE_SEC = 0.25

    def note_queue_wait(self, url: str, ms: float) -> None:
        with self._lock:
            self._queue_waits[url] = (ms, clockmod.monotonic())

    def cluster_queue_wait_ms(self) -> float | None:
        """The cluster's effective scoring queue wait: per shard the
        MIN over its replica group (the best member routing could
        pick), then the MAX over shards (every scatter waits for its
        slowest shard).  None until any replica has reported."""
        now = clockmod.monotonic()
        with self._lock:
            value, at = self._qw_cache
            if now - at <= self.QUEUE_WAIT_CACHE_SEC:
                return value
            # evict long-dead entries: with autoscaled members on
            # ephemeral ports every spawn/retire cycle adds a URL, and
            # TTL-ignoring without removal would grow the map forever
            dead = [u for u, (_, seen) in self._queue_waits.items()
                    if now - seen > 6 * self.QUEUE_WAIT_TTL_SEC]
            for u in dead:
                del self._queue_waits[u]
            waits = dict(self._queue_waits)
        worst, seen = 0.0, False
        for shard in range(self.registry.shard_count):
            best = None
            for hb in self.registry.candidates(shard):
                v = waits.get(hb.url)
                if v is not None and now - v[1] <= self.QUEUE_WAIT_TTL_SEC:
                    best = v[0] if best is None else min(best, v[0])
            if best is not None:
                seen = True
                worst = max(worst, best)
        out = worst if seen else None
        with self._lock:
            self._qw_cache = (out, now)
        return out

    def close(self) -> None:
        self._exec.shutdown(wait=False)
        self._pool.close()
        if self.transport is not None:
            self.transport.close()

    def _breaker(self, url: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(url)
            if b is None:
                b = CircuitBreaker.from_config(
                    f"router-replica[{url}]", self._config)
                self._breakers[url] = b
            return b

    # -- one attempt ---------------------------------------------------------

    def _attempt(self, hb: Heartbeat, shard: int, method: str, path: str,
                 body: bytes | None, deadline: Deadline | None,
                 traceparent: str | None = None, cancel=None):
        timeout = self.shard_timeout_sec
        headers = {}
        if traceparent:
            headers["Traceparent"] = traceparent
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0.0:
                raise ShardUnavailable("deadline exhausted")
            timeout = min(timeout, remaining)
            # remaining-budget propagation: the shard sheds work the
            # router would no longer wait for
            headers["X-Deadline-Ms"] = str(max(1, int(remaining * 1000)))

        if self.transport is not None and getattr(hb, "tport", None):
            # the multiplexed framed hop: one persistent connection
            # per replica, this attempt is one more interleaved stream
            # on it (auth is the connection-level AUTH frame)
            out = self._breaker(hb.url).call(
                self._framed_call, hb, shard, method, path, body,
                headers, timeout, traceparent, cancel)
            if out is _ABANDONED:
                raise StreamAbandoned(f"hedge abandoned for {hb.url}")
            return out

        with self._lock:
            self.http_attempts += 1
        if self._auth is not None:
            h = self._auth.header(hb.url, method, path)
            if h:
                headers["Authorization"] = h

        # the closer a firing cancel token runs: close THE CURRENT
        # in-flight socket so the loser's blocked read dies now —
        # holder[0] tracks it across the stale-socket retry, and is
        # cleared before release so a pooled socket is never closed
        holder = [None]

        def close_inflight():
            conn_rf = holder[0]
            if conn_rf is not None:
                self._pool.discard(conn_rf)

        def call():
            conn_rf, reused = self._pool.acquire(hb.url)
            holder[0] = conn_rf
            ckey = None
            if cancel is not None:
                ckey = cancel.register(close_inflight)
                if ckey is None:
                    # the race was over before this attempt started
                    holder[0] = None
                    self._pool.release(hb.url, conn_rf)
                    return self._abandon()
            try:
                try:
                    status, raw, rhdrs = _request(conn_rf[0], conn_rf[1],
                                                  method, path, body,
                                                  headers, timeout)
                except ConnectionError:
                    if cancel is not None and cancel.fired:
                        self._pool.discard(conn_rf)
                        return self._abandon()
                    # a reused keep-alive socket died between requests
                    # (the replica restarted — a designed, supervised
                    # event): that is a property of THIS socket, not of
                    # the replica, so retry once on a fresh connection
                    # before letting the failure count against the
                    # breaker.  Internal queries are all idempotent
                    # reads.  Timeouts deliberately do NOT retry (a
                    # slow replica must cost one window, not two).
                    self._pool.discard(conn_rf)
                    if not reused:
                        raise
                    self._pool.purge(hb.url)
                    conn_rf = self._pool.fresh(hb.url)
                    holder[0] = conn_rf
                    if cancel is not None and cancel.fired:
                        self._pool.discard(conn_rf)
                        return self._abandon()
                    try:
                        status, raw, rhdrs = _request(conn_rf[0],
                                                      conn_rf[1],
                                                      method, path, body,
                                                      headers, timeout)
                    except BaseException:
                        self._pool.discard(conn_rf)
                        if cancel is not None and cancel.fired:
                            return self._abandon()
                        raise
                except BaseException:
                    self._pool.discard(conn_rf)
                    if cancel is not None and cancel.fired:
                        return self._abandon()
                    raise
                if status == 401 and self._auth is not None and \
                        self._auth.challenge(
                            hb.url, rhdrs.get("www-authenticate", "")):
                    # first contact, or the replica rotated its nonce
                    # set: answer the fresh challenge once on the same
                    # keep-alive connection (the 401 carries
                    # Content-Length: 0)
                    headers["Authorization"] = self._auth.header(
                        hb.url, method, path)
                    try:
                        status, raw, rhdrs = _request(conn_rf[0],
                                                      conn_rf[1],
                                                      method, path, body,
                                                      headers, timeout)
                    except BaseException:
                        self._pool.discard(conn_rf)
                        if cancel is not None and cancel.fired:
                            return self._abandon()
                        raise
            finally:
                if ckey is not None:
                    cancel.unregister(ckey)
            holder[0] = None
            if cancel is not None and cancel.fired:
                # won race landed between the read and here: the
                # socket's state is unknowable (the closer may have
                # fired mid-release) — never pool it
                self._pool.discard(conn_rf)
            else:
                self._pool.release(hb.url, conn_rf)
            return self._finish_attempt(hb, shard, status, raw)

        out = self._breaker(hb.url).call(call)
        if out is _ABANDONED:
            raise StreamAbandoned(f"hedge abandoned for {hb.url}")
        return out

    def _abandon(self):
        with self._lock:
            self.hedge_abandoned += 1
        return _ABANDONED

    def _framed_call(self, hb, shard, method, path, body, headers,
                     timeout, traceparent, cancel):
        t0 = clockmod.monotonic()
        try:
            status, raw, _ = self.transport.request(
                hb, method, path, body, headers, timeout, cancel=cancel)
        except StreamAbandoned:
            return self._abandon()
        self._record_frame_span(traceparent, t0, clockmod.monotonic(),
                                hb, shard, status)
        return self._finish_attempt(hb, shard, status, raw)

    def _record_frame_span(self, tp, t0, t1, hb, shard, status) -> None:
        """Retroactive ``transport.frame_call`` span under the sampled
        request's shard_call — the framed hop's wire time, named so a
        slow frame is attributable separately from replica compute."""
        if self.tracer is None or not tp:
            return
        from ..obs.trace import parse_traceparent
        ctx = parse_traceparent(tp)
        if not ctx or not ctx[2]:
            return
        self.tracer.record_span(
            "transport.frame_call", (ctx[0], ctx[1]), t0, t1,
            attrs={"replica": hb.url, "shard": shard,
                   "http.status": status})

    def _finish_attempt(self, hb, shard: int, status: int,
                        raw: bytes) -> ShardResponse:
        """The attempt epilogue shared by both transports: parse the JSON
        envelope, harvest the queue-wait piggyback, and fail over on 5xx
        exactly like a transport fault."""
        payload = None
        if raw:
            try:
                payload = json.loads(raw)
            except ValueError:
                payload = {"error": raw[:512].decode("latin-1")}
        if isinstance(payload, dict) \
                and "queue_wait_ms" in payload:
            try:
                self.note_queue_wait(hb.url,
                                     float(payload["queue_wait_ms"]))
            except (TypeError, ValueError):
                pass  # malformed envelope field: not load-bearing
        if status >= 500:
            # replica answered but is unhealthy (lost its model,
            # internal error): failover like a transport fault
            raise ConnectionError(f"replica {hb.url} -> {status}")
        return ShardResponse(shard, status, payload, hb.url)

    # -- hedged per-shard query ---------------------------------------------

    def query_shard(self, shard: int, method: str, path: str,
                    body: bytes | None = None,
                    deadline: Deadline | None = None,
                    parent_span=None,
                    candidates: "list[Heartbeat] | None" = None
                    ) -> ShardResponse:
        """Authoritative response from ``shard``, via hedged attempts
        over its live replicas; :class:`ShardUnavailable` when none
        answers within the deadline.

        ``parent_span`` is the caller's request span when this call
        runs on a pool thread (scatter fan-out) where thread-local
        trace context does not follow; called inline on the handler
        thread, the tracer's thread-current span is used.
        ``candidates`` is the scatter fan-out's consistent routing-plan
        slice (registry.routing_plan()); None re-reads the registry —
        fine for single-shard callers like the Gramian fetch."""
        faults.fire("router-shard-timeout")
        span, tp = self._begin_shard_span(shard, parent_span)
        try:
            res = self._query_shard(shard, method, path, body, deadline,
                                    tp, candidates=candidates)
        except BaseException:
            if span is not None:
                span.end("error")
            raise
        if span is not None:
            span.set_attr("replica", res.replica)
            span.set_attr("http.status", res.status)
            span.end()
        return res

    def _begin_shard_span(self, shard: int, parent_span):
        """(span, traceparent) for one shard query — (None, None) when
        tracing is off, (None, flags-00 context) when the root decided
        not to sample."""
        if self.tracer is None:
            return None, None
        parent = parent_span if parent_span is not None \
            else self.tracer.current()
        span = self.tracer.child_span(parent, "router.shard_call")
        if not span.sampled:
            return None, self._unsampled_tp
        span.set_attr("shard", shard)
        return span, span.traceparent()

    def _query_shard(self, shard: int, method: str, path: str,
                     body: bytes | None, deadline: Deadline | None,
                     tp: str | None,
                     candidates: "list[Heartbeat] | None" = None
                     ) -> ShardResponse:
        if candidates is None:
            candidates = self.registry.candidates(shard)
        if not candidates:
            with self._lock:
                self.shard_failures += 1
            raise ShardUnavailable(f"shard {shard}: no live ready replica")
        if len(candidates) == 1:
            # nothing to hedge against: run the single attempt inline
            # (per-request thread spawns are measurable at gateway qps)
            try:
                return self._attempt(candidates[0], shard, method, path,
                                     body, deadline, tp)
            except ShardUnavailable:
                with self._lock:
                    self.shard_failures += 1
                raise
            except Exception as e:  # noqa: BLE001 — one shot only
                with self._lock:
                    self.shard_failures += 1
                raise ShardUnavailable(
                    f"shard {shard}: {type(e).__name__}: {e}") from e
        box: SimpleQueue = SimpleQueue()
        errors: list[BaseException] = []
        in_flight = 0
        # hedge cancellation: the moment one attempt wins (or the
        # query gives up), every other in-flight attempt is torn down
        # — a socket close on the HTTP hop, a CANCEL frame on the
        # framed hop — so a stalled replica can't poison the
        # keep-alive pool with a mid-response socket and never
        # computes an answer nobody is waiting for
        cancel = _CancelToken()

        def attempt_async(hb: Heartbeat) -> None:
            def run():
                try:
                    box.put(self._attempt(hb, shard, method, path, body,
                                          deadline, tp, cancel=cancel))
                except BaseException as e:  # noqa: BLE001 — collected
                    box.put(e)
            threading.Thread(target=run, daemon=True,
                             name=f"router-hedge-s{shard}").start()

        def drain(window: float | None) -> ShardResponse | None:
            """Wait up to ``window`` (None = until deadline/timeout) for
            a success; failures decrement in-flight and keep waiting."""
            nonlocal in_flight
            t_end = clockmod.monotonic() + (window if window is not None
                                        else self.shard_timeout_sec)
            if deadline is not None:
                t_end = min(t_end, deadline.t_end)
            while in_flight:
                wait = t_end - clockmod.monotonic()
                if wait <= 0:
                    return None
                try:
                    got = box.get(timeout=wait)
                except Empty:
                    return None
                in_flight -= 1
                if isinstance(got, ShardResponse):
                    return got
                errors.append(got)
                if isinstance(got, ShardUnavailable):
                    # deadline exhausted inside the attempt: no point
                    # waiting for more
                    return None
            return None

        try:
            for i, hb in enumerate(candidates[:self.max_attempts]):
                if deadline is not None and deadline.expired:
                    break
                attempt_async(hb)
                in_flight += 1
                last = (i + 1 >= min(len(candidates), self.max_attempts))
                res = drain(None if last else self.hedge_after_sec)
                if res is not None:
                    if errors:
                        # a sibling answered after a group member
                        # FAILED (not merely hedged): the replica-group
                        # failover evidence — a dead member costs
                        # latency, never coverage
                        with self._lock:
                            self.group_failovers += 1
                    return res
                if not last:
                    with self._lock:
                        self.hedges += 1
            res = drain(None)
            if res is not None:
                if errors:
                    with self._lock:
                        self.group_failovers += 1
                return res
        finally:
            # win or give-up: the losers are cancelled NOW (counted
            # in hedge_abandoned), never left to finish reads nobody
            # consumes
            cancel.fire()
        with self._lock:
            self.shard_failures += 1
        detail = "; ".join(f"{type(e).__name__}: {e}" for e in errors[-3:])
        raise ShardUnavailable(
            f"shard {shard}: no replica answered ({detail or 'timeout'})")

    # -- fan-out -------------------------------------------------------------

    def scatter(self, method: str, paths: "dict[int, str] | str",
                body: bytes | None = None,
                deadline: Deadline | None = None,
                shards: "Sequence[int] | None" = None
                ) -> tuple[dict[int, ShardResponse], list[int]]:
        """Query every shard — or only ``shards`` when given (e.g. the
        Gramian cache fetching just the shards whose generation moved).
        ``paths`` is one path for all shards or a per-shard map.
        Returns (responses by shard, failed shards).  Raises
        ShardUnavailable only when EVERY queried shard failed."""
        # ONE consistent routing snapshot for the whole fan-out: the
        # topology and every shard's candidate list come from a single
        # locked registry read, so a cutover mid-request can never mix
        # two rings' shards into one merge (the atomic-cutover
        # contract; a request in flight at the cutover instant routes
        # entirely on the ring it started with)
        of, plan = self.registry.routing_plan()
        if shards is None:
            targets = range(of)
            plan_for = {s: plan[s] for s in targets}
        else:
            targets = shards
            # explicit-shard callers (the Gramian cache) key their own
            # state by (topology, shard, generation); candidates
            # re-read per shard as before
            plan_for = {s: None for s in targets}
        # trace context is captured HERE, on the requesting handler
        # thread — the per-shard queries run on pool threads where the
        # tracer's thread-local current span does not follow
        parent = self.tracer.current() if self.tracer is not None \
            else None
        futures = {
            s: self._exec.submit(
                self.query_shard, s,
                method, paths if isinstance(paths, str) else paths[s],
                body, deadline, parent, plan_for[s])
            for s in targets}
        results: dict[int, ShardResponse] = {}
        failed: list[int] = []
        # collection bound: the REQUEST deadline (plus a small grace for
        # result plumbing), not the per-attempt transport cap — a shard
        # stalled mid-attempt must degrade to a partial answer by the
        # deadline, not hold the whole response for the transport cap
        for s, f in futures.items():
            try:
                results[s] = f.result(
                    timeout=self.shard_timeout_sec + 1.0
                    if deadline is None
                    else max(0.05, deadline.remaining()) + 0.25)
            except Exception as e:  # noqa: BLE001 — shard drops out
                _log.warning("shard %d dropped from merge: %s", s, e)
                failed.append(s)
        if not results:
            raise ShardUnavailable(
                f"all {len(futures)} queried shard(s) unavailable")
        if failed:
            with self._lock:
                self.partial_answers += 1
        return results, failed

    def any_replica(self, method: str, path: str,
                    body: bytes | None = None,
                    deadline: Deadline | None = None) -> ShardResponse:
        """Authoritative response from any ready replica (endpoints
        answered from the replicated user store)."""
        candidates = self.registry.any_candidates()
        if not candidates:
            raise ShardUnavailable("no live ready replica")
        span, tp = self._begin_shard_span(-1, None)
        last: BaseException | None = None
        for hb in candidates[:max(self.max_attempts, 1)]:
            try:
                res = self._attempt(hb, hb.shard, method, path, body,
                                    deadline, tp)
            except (ShardUnavailable, CircuitOpenError,
                    OSError, ConnectionError, ValueError) as e:
                last = e
                continue
            if span is not None:
                span.set_attr("shard", hb.shard)
                span.set_attr("replica", res.replica)
                span.set_attr("http.status", res.status)
                span.end()
            return res
        if span is not None:
            span.end("error")
        raise ShardUnavailable(f"no replica answered: {last}")

    def scrape_replicas(self, path: str,
                        deadline: Deadline | None = None,
                        method: str = "GET"
                        ) -> list[tuple[Heartbeat, dict]]:
        """Best-effort request against EVERY live ready replica — not
        one per shard like ``scatter`` — returning ``(heartbeat,
        payload)`` for each 2xx JSON answer.  The cluster-wide metrics
        merge needs every replica's histogram buckets; a replica that
        fails or stalls is simply absent from the merge (the
        exposition reports how many were scraped).  ``method="POST"``
        drives the cluster-wide control fan-outs (the flight
        recorder's correlated dump) over the same transport."""
        candidates = self.registry.any_candidates()
        if not candidates:
            return []
        # scrapes are control plane, never trace roots: mark them
        # explicitly unsampled so replicas don't sample 1% of them
        futures = [(hb, self._exec.submit(self._attempt, hb, hb.shard,
                                          method, path, None, deadline,
                                          self._unsampled_tp))
                   for hb in candidates]
        out: list[tuple[Heartbeat, dict]] = []
        for hb, f in futures:
            try:
                r = f.result(timeout=self.shard_timeout_sec + 1.0
                             if deadline is None
                             else max(0.05, deadline.remaining()) + 0.25)
            except Exception:  # noqa: BLE001 — replica drops from merge
                continue
            if r.ok and isinstance(r.payload, dict):
                out.append((hb, r.payload))
        return out

    def stats(self) -> dict:
        qw = self.cluster_queue_wait_ms()
        with self._lock:
            out = {"hedges": self.hedges,
                   "shard_failures": self.shard_failures,
                   "partial_answers": self.partial_answers,
                   "group_failovers": self.group_failovers,
                   "hedge_abandoned": self.hedge_abandoned,
                   "cluster_queue_wait_ms":
                       None if qw is None else round(qw, 2),
                   "pool": {"sockets": self._pool.pooled(),
                            "attempts": self.http_attempts,
                            "idle_evictions": self._pool.idle_evictions,
                            "cap_evictions": self._pool.cap_evictions}}
        if self.transport is not None:
            out["transport"] = {
                "open_connections": self.transport.open_connections(),
                "per_replica": self.transport.connection_snapshot(),
                "cancels_sent": self.transport.cancels_sent,
                "reconnects": self.transport.reconnects,
            }
        return out
