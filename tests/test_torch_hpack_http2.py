"""HPACK and HTTP/2 of the port (``oryx_tpu_torch/lambda_rt/{hpack,
http2}.py``) held against the reference's: the RFC 7541 Appendix C
vectors, Huffman round trips, byte-identical encodings of 200 seeded
header lists that each package's decoder reads back, and a port and a
reference ``ServingLayer`` answering the same h2c prior-knowledge
streams (several on one connection) alike; the port's ``make_server``
also takes h2 over TLS when ALPN selects it."""

from __future__ import annotations

import http.client
import json
import socket
import ssl
import threading
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt import hpack as jhpack
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt import hpack as thpack
from oryx_tpu_torch.lambda_rt.http2 import PREFACE
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer
from tests.test_torch_http_auth import _self_signed_pem

N_ITEMS, N_USERS, F = 300, 12, 6
WAIT_S = 60.0

# RFC 7541 C.4's Huffman-coded strings (hex) and their plain text
RFC_HUFFMAN = [
    ("f1e3c2e5f23a6ba0ab90f4ff", b"www.example.com"),
    ("a8eb10649cbf", b"no-cache"),
    ("25a849e95ba97d7f", b"custom-key"),
    ("25a849e95bb8e8b4bf", b"custom-value"),
    ("6402", b"302"),
    ("aec3771a4b", b"private"),
    ("d07abe941054d444a8200595040b8166e082a62d1bff",
     b"Mon, 21 Oct 2013 20:13:21 GMT"),
    ("9d29ad171863c78f0b97c8e9ae82ae43d3", b"https://www.example.com"),
]

# RFC 7541 C.3 (plain literals) and C.4 (Huffman): three requests on one
# connection, the dynamic table carried from one to the next
RFC_REQUESTS = {
    "C.3": ["828684410f7777772e6578616d706c652e636f6d",
            "828684be58086e6f2d6361636865",
            "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"],
    "C.4": ["828684418cf1e3c2e5f23a6ba0ab90f4ff",
            "828684be5886a8eb10649cbf",
            "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"],
}
RFC_DECODED = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com"), ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]


@pytest.mark.parametrize("section", sorted(RFC_REQUESTS))
def test_rfc7541_request_sequences(section):
    port, ref = thpack.HpackDecoder(), jhpack.HpackDecoder()
    for block, want in zip(RFC_REQUESTS[section], RFC_DECODED):
        raw = bytes.fromhex(block)
        assert port.decode(raw) == want
        assert ref.decode(raw) == want


def test_huffman_vectors_and_round_trips():
    for hx, text in RFC_HUFFMAN:
        assert thpack.huffman_decode(bytes.fromhex(hx)) == text
        assert thpack.huffman_encode(text).hex() == hx
    rng = np.random.default_rng(2)
    for _ in range(200):
        raw = bytes(rng.integers(0, 256, int(rng.integers(0, 60)),
                                 dtype=np.uint8))
        enc = thpack.huffman_encode(raw)
        assert enc == jhpack.huffman_encode(raw)
        assert thpack.huffman_decode(enc) == raw


def _header_lists(n: int, seed: int) -> list:
    """Seeded header lists: static-table names and pairs, and random
    names and values of printable ASCII."""
    rng = np.random.default_rng(seed)
    static = thpack.STATIC_TABLE
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-_./ ",
                             dtype=np.uint8)
    out = []
    for _ in range(n):
        headers = []
        for _ in range(int(rng.integers(1, 9))):
            pick = int(rng.integers(0, 3))
            name, value = static[int(rng.integers(0, len(static)))]
            if pick == 1:
                value = bytes(rng.choice(alphabet, int(rng.integers(0, 24)))
                              ).decode()
            elif pick == 2:
                name = "x-" + bytes(rng.choice(
                    alphabet[:36], int(rng.integers(1, 12)))).decode()
                value = bytes(rng.choice(alphabet, int(rng.integers(0, 40)))
                              ).decode()
            headers.append((name, value))
        out.append(headers)
    return out


def test_encoders_agree_and_decoders_read_each_other():
    tenc, jenc = thpack.HpackEncoder(), jhpack.HpackEncoder()
    tdec, jdec = thpack.HpackDecoder(), jhpack.HpackDecoder()
    for headers in _header_lists(200, 11):
        block = tenc.encode(headers)
        assert block == jenc.encode(headers)
        assert jdec.decode(block) == headers
        assert tdec.decode(jenc.encode(headers)) == headers


# -- h2 over the serving layer ------------------------------------------------

def h2_exchange(port: int, requests: list, tls: bool = False) -> list:
    """One HTTP/2 connection (h2c with prior knowledge, or TLS with ALPN
    ``h2``) carrying one stream per ``(method, path, extra headers)``,
    all sent before any answer is read: [(status, headers, body)] in
    request order.  A raw-socket client on the port's HPACK codec."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    if tls:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        ctx.set_alpn_protocols(["h2"])
        sock = ctx.wrap_socket(sock)
        assert sock.selected_alpn_protocol() == "h2"

    def frame(ftype, flags, sid, payload=b""):
        return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                + sid.to_bytes(4, "big") + payload)

    enc, dec = thpack.HpackEncoder(), thpack.HpackDecoder()
    got: dict = {}
    try:
        sock.sendall(PREFACE + frame(4, 0, 0))
        for n, (method, path, extra) in enumerate(requests):
            block = enc.encode([(":method", method), (":path", path),
                                (":scheme", "https" if tls else "http"),
                                (":authority", "127.0.0.1")]
                               + list(extra.items()))
            sock.sendall(frame(1, 0x5, 2 * n + 1, block))
        r = sock.makefile("rb")
        while sum(1 for v in got.values() if v["done"]) < len(requests):
            head = r.read(9)
            assert len(head) == 9, "connection closed"
            length = int.from_bytes(head[:3], "big")
            ftype, flags = head[3], head[4]
            sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
            payload = r.read(length)
            if ftype == 1:
                headers = dec.decode(payload)
                got[sid] = {"headers": headers, "body": b"",
                            "done": bool(flags & 0x1)}
            elif ftype == 0:
                got[sid]["body"] += payload
                got[sid]["done"] = bool(flags & 0x1)
            elif ftype == 4 and not flags & 0x1:
                sock.sendall(frame(4, 0x1, 0))
            assert ftype != 7, f"GOAWAY {payload!r}"
    finally:
        sock.close()
    out = []
    for n in range(len(requests)):
        st = got[2 * n + 1]
        headers = dict(st["headers"])
        out.append((int(headers.pop(":status")), headers, st["body"]))
    return out


def _h1(port, path, tls=False):
    if tls:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30,
                                           context=ctx)
    else:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path, headers={"Accept": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _publish(uris):
    rng = np.random.default_rng(42)
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    x_ids = [f"u{j}" for j in range(N_USERS)]
    Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
    X = rng.standard_normal((N_USERS, F)).astype(np.float32)
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    records = [("MODEL", pmml_io.to_string(doc))]
    records += [("UP", json.dumps(["Y", i, [float(v) for v in row]]))
                for i, row in zip(y_ids, Y)]
    records += [("UP", json.dumps(["X", u, [float(v) for v in row],
                                   [f"i{j}" for j in range(3)]]))
                for u, row in zip(x_ids, X)]
    for producer_cls, uri in uris:
        producer = producer_cls(uri, "OryxUpdate")
        for key, message in records:
            producer.send(key, message)
        producer.close()


@pytest.fixture
def layer_pair(tmp_path):
    """A reference and a port ServingLayer, each on a memory:// broker
    of its own carrying the same records, plus a TLS door of the port's
    layer."""
    tag = f"h2-{time.monotonic_ns()}"
    juri, turi = f"memory://{tag}-j", f"memory://{tag}-t"
    common = {"oryx.serving.application-resources": None,
              "oryx.input-topic.broker": None}
    jl = JaxLayer(jconfig.from_dict({
        **common, "oryx.update-topic.broker": juri,
        "oryx.serving.model-manager-class":
            "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu.serving.als"}),
        port=0)
    tl = TorchLayer(tconfig.from_dict({
        **common, "oryx.update-topic.broker": turi,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources":
            "oryx_tpu_torch.serving.als"}), port=0, device="cpu")
    started = []
    try:
        for layer in (jl, tl):
            layer.start()
            started.append(layer)
        _publish([(jinproc.InProcTopicProducer, juri),
                  (tinproc.InProcTopicProducer, turi)])
        deadline = time.monotonic() + WAIT_S
        while not all(_h1(l.port, f"/recommend/u{N_USERS - 1}")[0] == 200
                      for l in (jl, tl)):
            assert time.monotonic() < deadline, "models did not load"
            time.sleep(0.05)
        yield jl, tl
    finally:
        for layer in started:
            layer.close()


PATHS = ["/ready", "/recommend/u1?howMany=5", "/recommend/u4?howMany=7",
         "/knownItems/u2", "/recommend/nobody", "/mostPopularItems"]


def test_h2c_streams_match_the_reference_and_http11(layer_pair):
    jl, tl = layer_pair
    requests = [("GET", p, {"accept": "application/json"}) for p in PATHS]
    port = h2_exchange(tl.port, requests)
    ref = h2_exchange(jl.port, requests)
    for path, (ps, ph, pb), (rs, rh, rb) in zip(PATHS, port, ref):
        assert ps == rs, path
        assert sorted(ph) == sorted(rh), path
        assert ph.get("content-type") == rh.get("content-type"), path
        # the port's h2 answer is its HTTP/1.1 answer
        assert (ps, pb) == _h1(tl.port, path), path
        if path.startswith("/recommend/u"):
            p, r = json.loads(pb), json.loads(rb)
            assert [d["id"] for d in p] == [d["id"] for d in r], path
            np.testing.assert_allclose([d["value"] for d in p],
                                       [d["value"] for d in r], rtol=1e-5)
        elif ps == 200 and pb:
            assert json.loads(pb) == json.loads(rb), path
        else:
            assert pb == rb, path


def test_tls_alpn_selects_h2(tmp_path):
    """The port's make_server offers h2 by ALPN: an h2 client gets h2,
    and its answers equal HTTPS/1.1's on the same door."""
    from oryx_tpu_torch.lambda_rt.http import HttpApp, Route, make_server
    app = HttpApp([Route("GET", "/hello/{name}",
                         lambda req: {"hi": req.params["name"]})], {})
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(_self_signed_pem(tmp_path))
    server = make_server(app, 0, ssl_context=ctx)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        got = h2_exchange(port, [("GET", "/hello/a", {}),
                                 ("GET", "/hello/b", {}),
                                 ("GET", "/nothing", {})], tls=True)
        assert [(s, b) for s, _, b in got] == [
            _h1(port, "/hello/a", tls=True), _h1(port, "/hello/b", tls=True),
            _h1(port, "/nothing", tls=True)]
        assert got[0][0] == 200 and json.loads(got[0][2]) == {"hi": "a"}
    finally:
        server.shutdown()
        server.server_close()
