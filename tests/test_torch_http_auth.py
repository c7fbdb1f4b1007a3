"""TLS and DIGEST auth on every hop of the port: the serving layer's
public door (HTTPS on ``secure-port``, DIGEST on every route), the
headless layers' side door, the router's public door, and the router's
scatter hop to its replicas (``https`` to TLS replicas, DIGEST answers to
replicas that challenge) — the reference's
``tests/test_cluster_it.py:275`` and ``:392`` on the port's cluster —
plus a stale keep-alive socket retried on a fresh connection (``:344``).
The DIGEST scheme is the reference's byte for byte: each package's
client answers the other package's challenge.  Certificates are made
with ``cryptography``, as ``tests/test_serving.py`` makes them."""

from __future__ import annotations

import datetime
import http.client
import http.server
import json
import ssl
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from oryx_tpu.cluster import scatter as jscatter
from oryx_tpu.lambda_rt import http as jhttp
from oryx_tpu_torch.cluster import scatter as tscatter
from oryx_tpu_torch.cluster.membership import Heartbeat, MembershipRegistry
from oryx_tpu_torch.cluster.router import RouterLayer
from oryx_tpu_torch.cluster.scatter import ScatterGather
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import pmml as pmml_io
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt import http as thttp
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.obs.server import ObsServer

USER, PASSWORD = "oryx-admin", "s3cret"
WAIT_S = 30.0


def _self_signed_pem(tmp_path):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost")]), critical=False)
            .sign(key, hashes.SHA256()))
    pem = tmp_path / "server.pem"
    pem.write_bytes(
        key.private_bytes(serialization.Encoding.PEM,
                          serialization.PrivateFormat.TraditionalOpenSSL,
                          serialization.NoEncryption())
        + cert.public_bytes(serialization.Encoding.PEM))
    return str(pem)


def _unverified():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _opener(base, tls=False):
    mgr = urllib.request.HTTPPasswordMgrWithDefaultRealm()
    mgr.add_password(None, base + "/", USER, PASSWORD)
    handlers = [urllib.request.HTTPDigestAuthHandler(mgr)]
    if tls:
        handlers.append(urllib.request.HTTPSHandler(context=_unverified()))
    return urllib.request.build_opener(*handlers)


def _fetch(opener, url):
    with opener.open(url, timeout=15) as r:
        return r.status, dict(r.headers), json.loads(r.read() or b"null")


def _status(url, tls=False):
    try:
        with urllib.request.urlopen(
                url, timeout=10,
                context=_unverified() if tls else None) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _await(predicate, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _overlay(broker, **extra):
    overlay = {
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
        "oryx.input-topic.broker": None,
        "oryx.update-topic.broker": f"memory://{broker}",
        "oryx.update-topic.message.topic": "AuthUp",
        "oryx.cluster.heartbeat-interval-ms": 60,
        "oryx.cluster.heartbeat-ttl-ms": 400,
    }
    overlay.update(extra)
    return tconfig.from_dict(overlay)


def _publish(broker_name, n_users=4, n_items=10, features=3):
    broker = tinproc.get_broker(broker_name)
    users = [f"au{j}" for j in range(n_users)] + ["sp ace"]
    items = [f"ai{j}" for j in range(n_items)]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", features)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", users)
    pmml_io.add_extension_content(doc, "YIDs", items)
    broker.send("AuthUp", "MODEL", pmml_io.to_string(doc))
    rng = np.random.default_rng(3)
    for iid in items:
        broker.send("AuthUp", "UP", json.dumps(
            ["Y", iid, rng.standard_normal(features).tolist()]))
    for uid in users:
        broker.send("AuthUp", "UP", json.dumps(
            ["X", uid, rng.standard_normal(features).tolist(), []]))


# -- the serving layer and the side door -------------------------------------

def test_serving_layer_https_with_digest_auth(tmp_path):
    pem = _self_signed_pem(tmp_path)
    layer = ServingLayer(tconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
        "oryx.serving.api.user-name": "oryx",
        "oryx.serving.api.password": "pass",
        "oryx.serving.api.keystore-file": pem,
        "oryx.input-topic.broker": None, "oryx.update-topic.broker": None}),
        port=0, device="cpu")
    with layer:
        assert layer.scheme == "https"
        base = f"https://127.0.0.1:{layer.port}"
        # plain HTTP against the TLS port fails at the transport level
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{layer.port}/ready",
                                   timeout=5)
        assert _status(base + "/metrics", tls=True) == 401
        mgr = urllib.request.HTTPPasswordMgrWithDefaultRealm()
        mgr.add_password(None, base + "/", "oryx", "pass")
        opener = urllib.request.build_opener(
            urllib.request.HTTPSHandler(context=_unverified()),
            urllib.request.HTTPDigestAuthHandler(mgr))
        status, _, body = _fetch(opener, base + "/metrics")
        assert status == 200 and "routes" in body
        # no model yet: authenticated, then the layer's own 503
        with pytest.raises(urllib.error.HTTPError) as e:
            opener.open(base + "/ready", timeout=10)
        assert e.value.code == 503
        # a wrong password is challenged again
        bad = urllib.request.HTTPPasswordMgrWithDefaultRealm()
        bad.add_password(None, base + "/", "oryx", "wrong")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.build_opener(
                urllib.request.HTTPSHandler(context=_unverified()),
                urllib.request.HTTPDigestAuthHandler(bad)).open(
                    base + "/metrics", timeout=10)
        assert e.value.code == 401


def test_https_secure_port_default(tmp_path):
    """With a keystore and no port override, the layer binds
    secure-port (reference: connector.setPort(securePort))."""
    pem = _self_signed_pem(tmp_path)
    layer = ServingLayer(tconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.api.keystore-file": pem,
        "oryx.serving.api.secure-port": 0,
        "oryx.serving.api.port": 1,
        "oryx.input-topic.broker": None, "oryx.update-topic.broker": None}),
        device="cpu")
    assert layer.keystore_file == pem
    with layer:
        assert layer.scheme == "https" and layer.port > 1
        ctx = _unverified()
        with _TlsClient(layer.port, ctx) as s:
            # h2 first, as the reference's connector offers it
            assert s.selected_alpn_protocol() == "h2"


class _TlsClient:
    """A TLS client socket that offers h2 and http/1.1 by ALPN."""

    def __init__(self, port, ctx):
        ctx.set_alpn_protocols(["h2", "http/1.1"])
        import socket
        self._raw = socket.create_connection(("127.0.0.1", port),
                                             timeout=10)
        self._tls = ctx.wrap_socket(self._raw, server_hostname="localhost")

    def __enter__(self):
        return self._tls

    def __exit__(self, *exc):
        self._tls.close()


def test_side_door_serves_digest_credentials():
    cfg = tconfig.from_dict({"oryx.obs.metrics-port": 0,
                             "oryx.serving.api.user-name": USER,
                             "oryx.serving.api.password": PASSWORD})
    side = ObsServer(cfg, MetricsRegistry(), None)
    side.start()
    try:
        base = f"http://127.0.0.1:{side.port}"
        assert _status(base + "/metrics") == 401
        status, _, body = _fetch(_opener(base), base + "/metrics")
        assert status == 200 and "routes" in body
    finally:
        side.close()


# -- the DIGEST scheme across packages ---------------------------------------

def _serve(mod, user, password):
    app = mod.HttpApp([mod.Route("GET", "/x", lambda req: {"ok": 1})], {},
                      user_name=user, password=password)
    server = mod.make_server(app, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _raw(port, path, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("WWW-Authenticate", "")
    finally:
        conn.close()


@pytest.mark.parametrize("client,server", [
    (tscatter, thttp), (tscatter, jhttp), (jscatter, thttp)])
def test_digest_client_answers_either_packages_challenge(client, server):
    srv = _serve(server, USER, PASSWORD)
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}"
    try:
        status, challenge = _raw(port, "/x", {})
        assert status == 401 and challenge.startswith("Digest ")
        auth = client._DigestAuth(USER, PASSWORD)
        assert auth.header(url, "GET", "/x") is None
        assert auth.challenge(url, challenge)
        for _ in range(3):  # cached nonce, nc counting up
            assert _raw(port, "/x", {"Authorization":
                                     auth.header(url, "GET", "/x")})[0] == 200
        wrong = client._DigestAuth(USER, "nope")
        wrong.challenge(url, challenge)
        assert _raw(port, "/x", {"Authorization":
                                 wrong.header(url, "GET", "/x")})[0] == 401
        # a nonce the server never issued is refused
        forged = challenge.replace('nonce="', 'nonce="0')
        auth.challenge(url, forged)
        assert _raw(port, "/x", {"Authorization":
                                 auth.header(url, "GET", "/x")})[0] == 401
    finally:
        srv.shutdown()
        srv.server_close()


# -- the cluster's hops ------------------------------------------------------

def _replica(cfg):
    layer = ServingLayer(cfg, port=0, device="cpu")
    layer.start()
    return layer


def test_digest_auth_secures_public_and_scatter_hops():
    """One shared conf with DIGEST credentials: the router challenges
    the public client and answers the replica's challenge on the scatter
    hop — rows through the router prove both hops."""
    broker = "torch-cluster-auth"
    _publish(broker)
    auth = {"oryx.serving.api.user-name": USER,
            "oryx.serving.api.password": PASSWORD}
    replica = _replica(_overlay(broker, **auth, **{
        "oryx.cluster.enabled": True, "oryx.cluster.shard": "0/1"}))
    router = RouterLayer(_overlay(broker, **auth), port=0, device="cpu")
    router.start()
    try:
        rbase = f"http://127.0.0.1:{replica.port}"
        gbase = f"http://127.0.0.1:{router.port}"
        ropen, gopen = _opener(rbase), _opener(gbase)
        _await(lambda: _fetch(ropen, rbase + "/shard/meta")[2]["ready"],
               "the replica's model")
        _await(lambda: _fetch(gopen, gbase + "/ready")[0] in (200, 204),
               "the router's readiness")
        assert _status(gbase + "/recommend/au0") == 401
        assert _status(rbase + "/shard/recommend/au0") == 401
        status, headers, rows = _fetch(gopen,
                                       gbase + "/recommend/au0?howMany=5")
        assert status == 200 and headers.get("X-Oryx-Partial") is None
        _, _, local = _fetch(ropen, rbase + "/shard/recommend/au0?howMany=5")
        assert [d["id"] for d in rows] == [r[0] for r in local["rows"]]
        # a percent-encoded id through the proxied user-store hop
        status, _, known = _fetch(gopen, gbase + "/knownItems/sp%20ace")
        assert status == 200 and known == []
        # the fold-in: /shard/yty through the authenticated hop
        status, _, anon = _fetch(gopen,
                                 gbase + "/recommendToAnonymous/ai1/ai2")
        assert status == 200 and len(anon) > 0
    finally:
        router.close()
        replica.close()
        tinproc.drop_broker(broker)


def test_tls_replicas_behind_plain_router(tmp_path):
    """HTTPS replicas advertise https:// URLs in their heartbeats, and
    the router's scatter speaks TLS to them."""
    broker = "torch-cluster-tls"
    _publish(broker)
    pem = _self_signed_pem(tmp_path)
    replica = _replica(_overlay(broker, **{
        "oryx.cluster.enabled": True, "oryx.cluster.shard": "0/1",
        "oryx.serving.api.keystore-file": pem}))
    assert replica.scheme == "https"
    router = RouterLayer(_overlay(broker), port=0, device="cpu")
    router.start()
    try:
        rbase = f"https://127.0.0.1:{replica.port}"
        plain = urllib.request.build_opener(
            urllib.request.HTTPSHandler(context=_unverified()))
        _await(lambda: _fetch(plain, rbase + "/shard/meta")[2]["ready"],
               "the TLS replica's model")
        hb = router.membership.any_candidates
        _await(lambda: hb() and hb()[0].url.startswith("https://"),
               "the https heartbeat")
        gbase = f"http://127.0.0.1:{router.port}"
        _await(lambda: _status(gbase + "/ready") in (200, 204),
               "the router's readiness")
        status, headers, rows = _fetch(urllib.request.build_opener(),
                                       gbase + "/recommend/au0?howMany=5")
        assert status == 200 and headers.get("X-Oryx-Partial") is None
        local = _fetch(plain, rbase + "/shard/recommend/au0?howMany=5")[2]
        assert [d["id"] for d in rows] == [r[0] for r in local["rows"]]
    finally:
        router.close()
        replica.close()
        tinproc.drop_broker(broker)


def test_router_public_door_serves_https(tmp_path):
    broker = "torch-router-tls"
    _publish(broker)
    pem = _self_signed_pem(tmp_path)
    replica = _replica(_overlay(broker, **{
        "oryx.cluster.enabled": True, "oryx.cluster.shard": "0/1"}))
    router = RouterLayer(_overlay(broker, **{
        "oryx.serving.api.keystore-file": pem}), port=0, device="cpu")
    router.start()
    try:
        assert router.scheme == "https"
        gbase = f"https://127.0.0.1:{router.port}"
        _await(lambda: _status(gbase + "/ready", tls=True) in (200, 204),
               "the router's readiness")
        opener = urllib.request.build_opener(
            urllib.request.HTTPSHandler(context=_unverified()))
        status, _, rows = _fetch(opener, gbase + "/recommend/au1?howMany=3")
        assert status == 200 and len(rows) == 3
    finally:
        router.close()
        replica.close()
        tinproc.drop_broker(broker)


def test_stale_keepalive_socket_retries_on_fresh_connection():
    """A pooled keep-alive socket whose replica restarted retries once
    on a fresh connection: a dead socket is the pool's, not a shard
    failure."""
    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            body = b'{"rows": []}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    def start(port=0):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    srv = start()
    port = srv.server_address[1]
    reg = MembershipRegistry(ttl_sec=60.0)
    reg.note(Heartbeat(replica="r", shard=0, of=1,
                       url=f"http://127.0.0.1:{port}", generation=1,
                       ready=True))
    sg = ScatterGather(reg, tconfig.from_dict({}))
    try:
        assert sg.query_shard(0, "GET", "/x").ok  # pools the socket
        assert sg._pool.pooled() == 1
        srv.shutdown()
        srv.server_close()
        srv2 = start(port)  # the replica is back on the same URL
        assert sg.query_shard(0, "GET", "/x").ok  # stale -> fresh retry
        assert sg.shard_failures == 0
        srv2.shutdown()
        srv2.server_close()
    finally:
        sg.close()
