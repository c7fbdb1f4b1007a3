"""The port's asyncio front end (``oryx_tpu_torch/cluster/async_http.py``)
held against the reference's, each over its own package's ``HttpApp``
and ``ResultCache``: a cache hit is served on the loop (no handler
call, no bridge) with the bytes the threaded server sends, and the same
bytes as the reference's front end; the connection cap answers one fast
503 and closes; a full bridge sheds fast 503s with ``Retry-After``; and
the ``async-loop-block`` chaos point is seen by the loop-lag watchdog."""

from __future__ import annotations

import socket
import threading
import time

import pytest

from oryx_tpu.cluster import async_http as jasync
from oryx_tpu.cluster import result_cache as jrc
from oryx_tpu.common import config as jconfig
from oryx_tpu.lambda_rt import http as jhttp
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JMetrics
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu.serving.als import IDValue as JIDValue
from oryx_tpu_torch.cluster import async_http as tasync
from oryx_tpu_torch.cluster import result_cache as trc
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt import http as thttp
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TMetrics
from oryx_tpu_torch.resilience import faults as tfaults
from oryx_tpu_torch.serving.als import IDValue as TIDValue

PACKAGES = {
    "port": (tasync, trc, tconfig, thttp, TMetrics, tfaults, TIDValue),
    "ref": (jasync, jrc, jconfig, jhttp, JMetrics, jfaults, JIDValue)}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class _Reg:
    def generation_topology(self):
        return (2, (1, 1), False)


class _Front:
    """One package's app (a cacheable /recommend, a slow route) behind
    its asyncio front end."""

    def __init__(self, pkg, **extra):
        (self.mod, rc_mod, config_mod, self.http, metrics_cls,
         self.faults, idv) = PACKAGES[pkg]
        config = config_mod.from_dict({
            "oryx.cluster.cache.enabled": True,
            "oryx.cluster.coalesce.enabled": True, **extra})
        self.metrics = metrics_cls()
        self.calls = 0

        def recommend(req):
            self.calls += 1
            u = req.params["userID"]
            return [idv(f"{u}-i{j}", 1.0 / (j + 1)) for j in range(40)]

        def slow(req):
            time.sleep(0.5)
            return {"slow": True}

        route = self.http.Route
        self.app = self.http.HttpApp(
            [route("GET", "/recommend/{userID}", recommend, cache=True),
             route("GET", "/slow", slow)],
            context={"metrics": self.metrics,
                     "result_cache": rc_mod.ResultCache(
                         config, self.metrics, _Reg())})
        self.front = self.mod.AsyncFrontEnd(self.app, 0, config)
        self.front.start()
        self.port = self.front.port

    def close(self):
        self.front.shutdown()


def _raw(port, request: bytes, timeout=10.0) -> bytes:
    """Send one raw request; read the whole response (status line,
    headers, Content-Length body)."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.sendall(request)
        f = s.makefile("rb")
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            line = f.readline()
            if not line:
                break
            head += line
        length = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                length = int(line.split(b":")[1])
        return head + f.read(length)


def _get(port, path, extra=b""):
    return _raw(port, b"GET " + path.encode() + b" HTTP/1.1\r\nHost: a\r\n"
                + extra + b"\r\n")


@pytest.fixture
def fronts():
    made = []

    def make(pkg, **extra):
        made.append(_Front(pkg, **extra))
        return made[-1]

    yield make
    for f in made:
        f.close()


def test_hits_are_served_on_the_loop_byte_identical(fronts):
    port, ref = fronts("port"), fronts("ref")
    out = {}
    for name, fe in (("port", port), ("ref", ref)):
        miss = _get(fe.port, "/recommend/u1?howMany=5")
        hit = _get(fe.port, "/recommend/u1?howMany=5")
        gz = _get(fe.port, "/recommend/u1?howMany=5",
                  b"Accept-Encoding: gzip\r\n")
        csv = _get(fe.port, "/recommend/u1?howMany=5", b"Accept: text/csv\r\n")
        assert b"X-Oryx-Cache: miss" in miss and b"X-Oryx-Cache: hit" in hit
        assert miss.split(b"\r\n\r\n", 1)[1] == hit.split(b"\r\n\r\n", 1)[1]
        # the hits never reached the handler nor the bridge
        assert fe.calls == 1
        assert fe.front.fast_hits == 3
        # the threaded server serves the same hit bytes from the cache
        server = fe.http.make_server(fe.app, 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            threaded = _get(server.server_address[1],
                            "/recommend/u1?howMany=5")
        finally:
            server.shutdown()
            server.server_close()
        assert threaded == hit
        out[name] = (miss, hit, gz, csv)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_connection_cap_answers_one_fast_503(fronts, pkg):
    fe = fronts(pkg, **{"oryx.cluster.async.max-connections": 2})
    held = [socket.create_connection(("127.0.0.1", fe.port), timeout=10)
            for _ in range(2)]
    try:
        for s in held:  # both served: they count against the cap
            s.sendall(b"GET /recommend/u2 HTTP/1.1\r\nHost: a\r\n\r\n")
            assert s.recv(12).startswith(b"HTTP/1.1 200")
        t0 = time.monotonic()
        with socket.create_connection(("127.0.0.1", fe.port),
                                      timeout=10) as s:
            # the answer comes at accept, before any request is read,
            # and the server closes after it
            answer = s.makefile("rb").read()
        assert answer.startswith(b"HTTP/1.1 503")
        assert b"Connection: close" in answer
        assert time.monotonic() - t0 < 5.0
        assert fe.front.rejected_connections == 1
        assert fe.metrics.counters_snapshot()[
            "async_rejected_connections"] == 1
    finally:
        for s in held:
            s.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_full_bridge_sheds_fast_503s(fronts, pkg):
    """One bridge worker: a backlog of four; the rest of a burst of
    slow requests is shed at once with Retry-After."""
    fe = fronts(pkg, **{"oryx.cluster.async.bridge-workers": 1})
    answers = []
    lock = threading.Lock()

    def one():
        got = _get(fe.port, "/slow")
        with lock:
            answers.append(got)

    threads = [threading.Thread(target=one) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    shed = [a for a in answers if a.startswith(b"HTTP/1.1 503")]
    ok = [a for a in answers if a.startswith(b"HTTP/1.1 200")]
    assert len(shed) + len(ok) == 10 and shed and ok
    assert all(b"Retry-After: 1" in a for a in shed)
    assert fe.front.bridge_sheds == len(shed)
    assert fe.metrics.counters_snapshot()["async_bridge_sheds"] == len(shed)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_loop_block_is_seen_by_the_watchdog(fronts, pkg):
    fe = fronts(pkg, **{"oryx.cluster.async.watchdog-interval-ms": 20,
                        "oryx.cluster.async.watchdog-stall-ms": 100})
    fe.faults.inject("async-loop-block", mode="delay", times=1,
                     delay_sec=0.5)
    assert _get(fe.port, "/recommend/u3").startswith(b"HTTP/1.1 200")
    assert fe.faults.fired("async-loop-block") == 1
    deadline = time.monotonic() + 5.0
    while fe.front.loop_stalls < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fe.front.loop_stalls >= 1
    assert fe.metrics.counters_snapshot()["async_loop_stalls"] >= 1
