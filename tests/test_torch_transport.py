"""The port's framed transport (``oryx_tpu_torch/cluster/transport.py``)
held against the reference's: frames are byte-identical; the port's
``FrameTransport`` against the reference's ``FrameServer``, and the
reference's client against the port's server, give the same answers as
the same package on both ends; CANCEL drops a timed-out stream's answer
and keeps the connection; the ``transport-frame-stall`` chaos point
stalls one stream while its connection-mates keep flowing; and an AUTH
frame with the wrong DIGEST HA1 closes the connection."""

from __future__ import annotations

import json
import socket
import threading
import time

import pytest

from oryx_tpu.cluster import transport as jtr
from oryx_tpu.common import config as jconfig
from oryx_tpu.lambda_rt import http as jhttp
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.cluster import transport as ttr
from oryx_tpu_torch.cluster.membership import Heartbeat
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt import http as thttp
from oryx_tpu_torch.resilience import faults as tfaults

PACKAGES = {"port": (ttr, tconfig, thttp), "ref": (jtr, jconfig, jhttp)}
USER, PASSWORD = "oryx-admin", "s3cret"


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _overlay(**extra):
    return {"oryx.cluster.transport.enabled": True,
            "oryx.serving.api.user-name": USER,
            "oryx.serving.api.password": PASSWORD, **extra}


def _app(http_mod, user=USER, password=PASSWORD):
    def _echo(req):
        return {"path": req.path, "body": req.body.decode(),
                "query": {k: v for k, v in sorted(req.query.items())},
                "deadline_ms": None if req.deadline is None
                else int(req.deadline.remaining() * 1000) // 1000}

    def _slow(req):
        time.sleep(float(req.q1("sec", "0.5")))
        return {"slow": True}

    routes = [http_mod.Route("POST", "/shard/echo", _echo),
              http_mod.Route("GET", "/shard/echo", _echo),
              http_mod.Route("GET", "/shard/slow", _slow),
              http_mod.Route("GET", "/shard/missing",
                             lambda req: (404, {"missing": True}))]
    return http_mod.HttpApp(routes, context={}, user_name=user,
                            password=password)


def _server(pkg, **extra):
    tr, config, http_mod = PACKAGES[pkg]
    server = tr.FrameServer(_app(http_mod), config.from_dict(
        _overlay(**extra)))
    server.start()
    return server


def _client(pkg, **extra):
    tr, config, _ = PACKAGES[pkg]
    return tr.FrameTransport(config.from_dict(_overlay(**extra)))


def _hb(server):
    return Heartbeat(replica="r", shard=0, of=1,
                     url=f"http://127.0.0.1:{server.port}", generation=1,
                     ready=True, tport=server.port)


def test_frames_are_byte_identical():
    for ftype in (ttr.FRAME_REQ, ttr.FRAME_RESP, ttr.FRAME_CANCEL,
                  ttr.FRAME_AUTH):
        header = {"m": "POST", "p": "/shard/query?x=1",
                  "h": {"X-Deadline-Ms": "250", "Traceparent": "00-a"}}
        frames = []
        for tr in (ttr, jtr):
            a, b = socket.socketpair()
            try:
                tr.write_frame(a, ftype, 12345, tr._pack_msg(
                    header, b"\x00body\xff"), threading.Lock())
                a.shutdown(socket.SHUT_WR)
                frames.append(b.makefile("rb").read())
            finally:
                a.close()
                b.close()
        assert frames[0] == frames[1]
        assert ttr.read_frame(_reader(frames[0])) == \
            jtr.read_frame(_reader(frames[0]))
    assert (ttr.FRAME_REQ, ttr.FRAME_RESP, ttr.FRAME_CANCEL,
            ttr.FRAME_AUTH) == (jtr.FRAME_REQ, jtr.FRAME_RESP,
                                jtr.FRAME_CANCEL, jtr.FRAME_AUTH)
    assert ttr.auth_ha1(USER, PASSWORD) == jtr.auth_ha1(USER, PASSWORD)


def _reader(data: bytes):
    import io
    return io.BytesIO(data)


CALLS = [("POST", "/shard/echo", b"hello", {"X-Deadline-Ms": "2500"}),
         ("GET", "/shard/echo?b=2&a=1", b"", {}),
         ("GET", "/shard/missing", b"", {}),
         ("GET", "/shard/nothing-here", b"", {})]


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "ref"), ("ref", "port")])
def test_cross_package_answers_match(client_pkg, server_pkg):
    """The port's client against the reference's server, and the other
    way round, answer as the reference on both ends does."""
    def run(cpkg, spkg):
        server, client = _server(spkg), _client(cpkg)
        try:
            out = []
            for method, path, body, headers in CALLS:
                status, raw, rhdrs = client.request(
                    _hb(server), method, path, body, dict(headers), 5.0)
                out.append((status, raw, rhdrs.get("content-type")))
            assert client.open_connections() == 1
            return out
        finally:
            client.close()
            server.close()

    assert run(client_pkg, server_pkg) == run("ref", "ref")


def test_cancel_drops_the_answer_and_keeps_the_connection():
    server, client = _server("port"), _client("port")
    try:
        hb = _hb(server)
        with pytest.raises(TimeoutError):
            client.request(hb, "GET", "/shard/slow?sec=1.0", b"", {},
                           timeout=0.15)
        assert client.cancels_sent == 1
        deadline = time.monotonic() + 5.0
        while server.cancelled_streams < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert server.cancelled_streams == 1
        status, raw, _ = client.request(hb, "POST", "/shard/echo", b"y",
                                        {}, timeout=5.0)
        assert status == 200 and json.loads(raw)["body"] == "y"
        assert client.open_connections() == 1
    finally:
        client.close()
        server.close()


def test_frame_stall_stalls_one_stream_only():
    """``transport-frame-stall`` on the port's replica side: the armed
    stream's answer stalls; a stream-mate on the same connection is
    answered at once."""
    server, client = _server("port"), _client("port")
    tfaults.inject("transport-frame-stall", mode="delay", times=1,
                   delay_sec=1.0)
    try:
        hb = _hb(server)
        results = {}

        def call(name):
            t0 = time.monotonic()
            status, _, _ = client.request(hb, "POST", "/shard/echo",
                                          name.encode(), {}, timeout=10.0)
            results[name] = (status, time.monotonic() - t0)

        stalled = threading.Thread(target=call, args=("stalled",))
        stalled.start()
        deadline = time.monotonic() + 5.0
        while tfaults.fired("transport-frame-stall") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        call("bystander")
        stalled.join(5.0)
        assert tfaults.fired("transport-frame-stall") == 1
        assert results["bystander"][0] == 200
        assert results["bystander"][1] < 0.5
        assert results["stalled"][0] == 200
        assert results["stalled"][1] >= 0.9
        assert client.open_connections() == 1
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_auth_mismatch_closes_the_connection(server_pkg):
    """The port's client with the right HA1 is served by either
    package's server; with the wrong one, the server closes the
    connection and the request fails."""
    server = _server(server_pkg)
    good = _client("port")
    bad = _client("port", **{"oryx.serving.api.password": "wrong"})
    try:
        hb = _hb(server)
        assert good.request(hb, "POST", "/shard/echo", b"ok", {},
                            timeout=5.0)[0] == 200
        with pytest.raises((ConnectionError, TimeoutError)):
            bad.request(hb, "POST", "/shard/echo", b"no", {}, timeout=2.0)
        assert bad.open_connections() == 0
    finally:
        good.close()
        bad.close()
        server.close()
