"""Every ALS route of the reference's serving layer, and its write path,
held against the port's.  Two layers share one ``file://`` broker — the
reference's, configured with ``oryx_tpu`` classes, and the port's, from
``oryx_tpu_torch/conf/als-example.conf`` on the CPU — each with an input
topic of its own on it.  After the same MODEL + UP replay both answer
every read route alike (ids equal, scores within rtol 1e-4; counts, ID
lists and the console page's bytes equal), and ``/pref`` and
``/ingest`` leave the same keys and messages in the same partitions of
their input topics, read back from the JSONL logs (the ``ts`` header is
the only field that differs).  Also here: read-only refusal, 403
without an input topic, a 400 that appends nothing, the ingest gate's
503 + Retry-After, rescorer providers, and the popularity counters
across MODEL swaps.  Every wait is bounded."""

from __future__ import annotations

import gzip
import http.client
import io
import json
import os
import time
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

from oryx_tpu.app.als import rescorer as jrescorer
from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu.serving import framework as jframework
from oryx_tpu_torch.api.serving import OryxServingException
from oryx_tpu_torch.app.als import rescorer as trescorer
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.app.als.serving_manager import ALSServingModelManager
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka.partitioner import partition_for_key
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer
from oryx_tpu_torch.resilience import faults as tfaults
from oryx_tpu_torch.resilience.policy import (CircuitBreaker,
                                              CircuitOpenError,
                                              ResilientTopicProducer, Retry)
from oryx_tpu_torch.serving import framework as tframework
from oryx_tpu_torch.serving import ingest as tingest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, N_USERS, F = 600, 30, 10
WAIT_S = 60.0
HTTP_TIMEOUT_S = 30.0
RTOL = 1e-4
JAX_INPUT, TORCH_INPUT = "JaxInput", "TorchInput"


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


# -- rescorer providers, loaded by class path --------------------------------

def _reorder(item_id: str, score: float) -> float:
    return score + 0.5 * (int(item_id[1:]) % 5)


class _JaxShift(jrescorer.Rescorer):
    def rescore(self, item_id, score):
        return _reorder(item_id, score)

    def is_filtered(self, item_id):
        return item_id.endswith("3")


class JaxProvider(jrescorer.RescorerProvider):
    def get_recommend_rescorer(self, user_id, args):
        return _JaxShift()

    def get_recommend_to_anonymous_rescorer(self, item_ids, args):
        return _JaxShift()

    def get_most_similar_items_rescorer(self, args):
        return _JaxShift()

    def get_most_popular_items_rescorer(self, args):
        return _JaxShift()

    def get_most_active_users_rescorer(self, args):
        return _JaxShift()


class _TorchShift(trescorer.Rescorer):
    def rescore(self, item_id, score):
        return _reorder(item_id, score)

    def is_filtered(self, item_id):
        return item_id.endswith("3")


class TorchProvider(trescorer.RescorerProvider):
    def get_recommend_rescorer(self, user_id, args):
        return _TorchShift()

    def get_recommend_to_anonymous_rescorer(self, item_ids, args):
        return _TorchShift()

    def get_most_similar_items_rescorer(self, args):
        return _TorchShift()

    def get_most_popular_items_rescorer(self, args):
        return _TorchShift()

    def get_most_active_users_rescorer(self, args):
        return _TorchShift()


# -- two layers on one broker ------------------------------------------------

def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request(method, path, body=body,
                     headers={"Accept": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _get(port, path, accept="application/json"):
    status, body, _ = _request(port, "GET", path,
                               headers={"Accept": accept})
    return status, body


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class Layers:
    """The reference's and the port's layer on one broker."""

    def __init__(self, tmp_path, input_topics: bool = True, **extra):
        self.broker_dir = str(tmp_path / "broker")
        self.uri = f"file://{self.broker_dir}"
        inp = self.uri if input_topics else None
        common = {"oryx.update-topic.broker": self.uri,
                  "oryx.input-topic.broker": inp, **extra}
        jcfg = jconfig.from_dict({
            "oryx.serving.model-manager-class":
                "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
            "oryx.serving.application-resources": "oryx_tpu.serving.als",
            "oryx.input-topic.message.topic": JAX_INPUT,
            **{k: (f"{__name__}.JaxProvider" if v == "provider" else v)
               for k, v in common.items()}})
        tcfg = tconfig.overlay_on(
            {"oryx.input-topic.message.topic": TORCH_INPUT,
             **{k: (f"{__name__}.TorchProvider" if v == "provider" else v)
                for k, v in common.items()}},
            tconfig.from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                           "als-example.conf")))
        self.topic = tcfg.get_string("oryx.update-topic.message.topic")
        self.jl = JaxLayer(jcfg, port=0)
        self.tl = TorchLayer(tcfg, port=0, device="cpu")
        self.started = []

    def start(self):
        for layer in (self.jl, self.tl):
            layer.start()
            self.started.append(layer)

    def close(self):
        for layer in self.started:
            layer.close()
        name = f"file:{os.path.abspath(self.broker_dir)}"
        jinproc.drop_broker(name)
        tinproc.drop_broker(name)

    @property
    def ports(self):
        return self.jl.port, self.tl.port

    def both(self, method, path, body=None, headers=None):
        return [_request(p, method, path, body, headers) for p in self.ports]

    def log(self, topic):
        """Per partition, the (key, message, headers) records of a topic's
        JSONL log on disk."""
        with open(os.path.join(self.broker_dir, f"{topic}.meta.json")) as f:
            n = json.load(f)["partitions"]
        out = []
        for i in range(n):
            name = f"{topic}.topic.jsonl" if i == 0 else \
                f"{topic}.p{i}.topic.jsonl"
            path = os.path.join(self.broker_dir, name)
            recs = []
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    recs = [json.loads(line) for line in f if line.strip()]
            out.append(recs)
        return out


def _catalog(seed=42):
    rng = np.random.default_rng(seed)
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    x_ids = [f"u{j}" for j in range(N_USERS)]
    Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
    X = rng.standard_normal((N_USERS, F)).astype(np.float32)
    known = {u: [f"i{j}" for j in rng.integers(0, 40, 6)] for u in x_ids}
    return y_ids, Y, x_ids, X, known


def _model_doc(x_ids, y_ids):
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", F)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    return pmml_io.to_string(doc)


def _publish(layers: Layers):
    """MODEL + UP through the reference's producer: its layer shares the
    writer's partition, and the port's layer tails the file."""
    y_ids, Y, x_ids, X, known = _catalog()
    producer = jinproc.InProcTopicProducer(layers.uri, layers.topic)
    producer.send("MODEL", _model_doc(x_ids, y_ids))
    for i, row in zip(y_ids, Y):
        producer.send("UP", json.dumps(["Y", i, [float(v) for v in row]]))
    for u, row in zip(x_ids, X):
        producer.send("UP", json.dumps(["X", u, [float(v) for v in row],
                                        known[u]]))
    return y_ids, Y, x_ids, X, known


def _loaded(layer, n_users=N_USERS, n_items=N_ITEMS):
    model = layer.model_manager.get_model()
    return (model is not None and len(model.X) == n_users
            and len(model.Y) == n_items
            and len(model.get_known_items(f"u{n_users - 1}")) > 0
            and model.get_yty_solver(blocking=False) is not None)


def _solvers_current(model) -> bool:
    """Whether both Gramian solvers were solved from the stores as they
    stand: a solver present, no solve in flight and none pending.  The
    caches of both packages clear their dirty mark when a solve begins,
    and an update during the solve marks it again, so a clean, idle
    cache holds a solve begun after the last applied UP.  (A blocking
    get is not that condition: with the cache clean and a solve in
    flight, it returns the older solver without waiting, in both
    packages.)  A non-blocking get starts the solve a dirty cache
    needs."""
    for get, cache in ((model.get_xtx_solver, model.cached_xtx_solver),
                       (model.get_yty_solver, model.cached_yty_solver)):
        get(blocking=False)
        with cache._cond:
            if cache._dirty or cache._in_flight or cache._solver is None:
                return False
    return True


def _ready(layers: Layers):
    for layer in (layers.jl, layers.tl):
        _wait(lambda: _loaded(layer), "the replay")
    for layer in (layers.jl, layers.tl):
        # every UP is applied (the last user's is the replay's last
        # record), so nothing dirties the solvers after this
        model = layer.model_manager.get_model()
        _wait(lambda: _solvers_current(model), "the Gramian solvers")
    for p in layers.ports:
        _wait(lambda: _get(p, "/ready")[0] in (200, 204), "/ready")


def _replayed(path):
    made = Layers(path)
    try:
        made.start()
        _publish(made)
        _ready(made)
        yield made
    finally:
        made.close()


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """One replay shared by the read and write tests (none of which
    changes the model)."""
    yield from _replayed(tmp_path_factory.mktemp("routes"))


@pytest.fixture
def fresh_layers(tmp_path):
    yield from _replayed(tmp_path)


def _pairs(body):
    return [(d["id"], d["value"]) for d in json.loads(body)]


def _same_pairs(path, jb, tb):
    want, got = _pairs(jb), _pairs(tb)
    assert want, path
    assert [i for i, _ in got] == [i for i, _ in want], path
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=RTOL, atol=1e-6, err_msg=path)


# -- the read routes ---------------------------------------------------------

SCORED = [
    "/recommendToAnonymous/i1/i2=2.5/i3?howMany=8",
    "/recommendToAnonymous/i4=0.5/nope/i5?howMany=5&offset=2",
    "/recommendWithContext/u3/i5=1.5/i7?howMany=6",
    "/recommendWithContext/u8/i1/i9=-0.5?howMany=4&offset=1",
    "/similarity/i1/i2?howMany=5",
    "/similarity/i9?howMany=5&offset=2",
    "/similarity/i10/i11/i12/i13/i14?howMany=7",
    "/similarityToItem/i3/i4/i5/i6",
    "/estimate/u2/i1/i2/nope",
    "/because/u4/i10?howMany=5",
    "/mostSurprising/u5?howMany=4",
    "/mostSurprising/u6?howMany=3&offset=1",
]

COUNTED = ["/mostActiveUsers?howMany=10", "/mostActiveUsers?offset=3",
           "/mostPopularItems?howMany=10", "/mostPopularItems?offset=5"]

LISTS = ["/popularRepresentativeItems", "/user/allIDs", "/item/allIDs",
         "/allUserIDs", "/allItemIDs", "/knownItems/u7"]

MISSING = ["/similarity/nope", "/similarity/i1/nope",
           "/similarityToItem/nope/i1", "/similarityToItem/i1/nope",
           "/estimate/nobody/i1", "/estimateForAnonymous/nope/i1",
           "/recommendWithContext/nobody/i1", "/because/u1/nope",
           "/mostSurprising/nobody", "/recommendToAnonymous/nope"]


@pytest.mark.parametrize("path", SCORED)
def test_scored_routes_answer_alike(layers, path):
    (js, jb), (ts, tb) = (_get(p, path) for p in layers.ports)
    assert js == ts == 200, (path, js, ts, tb[:300])
    _same_pairs(path, jb, tb)


@pytest.mark.parametrize("path", COUNTED + LISTS)
def test_counts_and_id_lists_answer_alike(layers, path):
    (js, jb), (ts, tb) = (_get(p, path) for p in layers.ports)
    assert js == ts == 200, (path, js, ts, tb[:300])
    assert json.loads(jb) and json.loads(tb) == json.loads(jb), path


def test_estimates_for_anonymous_and_csv_answer_alike(layers):
    for path in ("/estimateForAnonymous/i3/i4=2/i5",
                 "/estimateForAnonymous/i3/nope"):
        (js, jb), (ts, tb) = (_get(p, path) for p in layers.ports)
        assert js == ts == 200
        np.testing.assert_allclose(json.loads(tb), json.loads(jb),
                                   rtol=RTOL, atol=1e-6)
    assert json.loads(_get(layers.tl.port,
                           "/estimateForAnonymous/i3/nope")[1]) == 0.0
    for path in ("/mostActiveUsers?howMany=4", "/allItemIDs"):
        (js, jb), (ts, tb) = (_get(p, path, "text/csv") for p in layers.ports)
        assert js == ts == 200 and tb == jb, path
    (js, jb), (ts, tb) = (_get(p, "/similarity/i2?howMany=3", "text/csv")
                          for p in layers.ports)
    assert [ln.split(",")[0] for ln in tb.decode().split()] == \
        [ln.split(",")[0] for ln in jb.decode().split()]


def test_console_page_and_missing_ids_answer_alike(layers):
    (js, jb), (ts, tb) = (_get(p, "/", "text/html") for p in layers.ports)
    assert js == ts == 200 and tb == jb and tb.startswith(b"<!DOCTYPE html>")
    for path in MISSING:
        codes = [_get(p, path)[0] for p in layers.ports]
        assert codes == [404, 404], (path, codes)
    for path in ("/mostActiveUsers?howMany=0", "/similarity/i1?offset=-1"):
        assert [_get(p, path)[0] for p in layers.ports] == [400, 400], path
    (_, jb, _), (_, tb, _) = layers.both("GET", "/error?code=418&message=x")
    assert tb == jb


def test_the_anonymous_routes_serve_the_folded_vector(layers):
    """/recommendToAnonymous answers the batched top-N of the vector the
    fold-in builds, excluding the context items."""
    model = layers.tl.model_manager.get_model()
    from oryx_tpu_torch.ops import als_fold_in
    ctx = [("i1", 1.0), ("i2", 2.5), ("i3", 1.0)]
    xu = als_fold_in.fold_in_sequential(
        model.get_yty_solver(), ctx, model.get_item_vector, None,
        model.implicit, model.features)
    want = model.top_n_batch(8, xu[None, :], [{"i1", "i2", "i3"}])[0]
    status, body = _get(layers.tl.port,
                        "/recommendToAnonymous/i1/i2=2.5/i3?howMany=8")
    assert status == 200
    got = _pairs(body)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6)


# -- the write path ----------------------------------------------------------

def _multipart(boundary: str, parts: list[tuple[str, str, bytes]]) -> bytes:
    body = b""
    for name, ctype, data in parts:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"; filename="{name}"\r\n'
                 f"Content-Type: {ctype}\r\n"
                 f"Content-Transfer-Encoding: binary\r\n\r\n").encode()
        body += data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode()


def _zip(files: dict[str, str]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, text in files.items():
            zf.writestr(name, text)
    return buf.getvalue()


WRITES = [
    ("POST", "/pref/u1/i2", b"2.5", {}),
    ("POST", "/pref/u3/i4", b"", {}),
    ("DELETE", "/pref/u5/i6", None, {}),
    ("POST", "/ingest", b"a,b,1\nc,d,2.0\n\n e,f,-1 \n[\"g\",\"h\",3]\n",
     {"Content-Type": "text/csv"}),
    ("POST", "/ingest", gzip.compress(b"k1,v1,1\nk2,v2,2,1700000000\n"),
     {"Content-Encoding": "gzip"}),
    ("POST", "/ingest", gzip.compress(b"gz1,gz2,1\n"),
     {"Content-Type": "application/gzip"}),
    ("POST", "/ingest", _zip({"a.csv": "z1,z2,1\n", "b.csv": "z3,z4,2\n"}),
     {"Content-Type": "application/zip"}),
    ("POST", "/ingest",
     _multipart("bnd42", [("a.csv", "text/csv", b"m1,n1,1\nm2,n2,2\n"),
                          ("b.csv.gz", "application/octet-stream",
                           gzip.compress(b"m3,n3,3\n"))]),
     {"Content-Type": "multipart/form-data; boundary=bnd42"}),
]

WRITTEN = ["u1,i2,2.5", "u3,i4,1", "u5,i6,", "a,b,1", "c,d,2.0", "e,f,-1",
           '["g","h",3]', "k1,v1,1", "k2,v2,2,1700000000", "gz1,gz2,1",
           "z1,z2,1", "z3,z4,2", "m1,n1,1", "m2,n2,2", "m3,n3,3"]


def test_writes_land_alike_in_the_input_topics(layers):
    for method, path, body, headers in WRITES:
        (js, jb, _), (ts, tb, _) = layers.both(method, path, body, headers)
        assert js == ts and js in (200, 204), (path, js, ts, tb[:300])
        if path == "/ingest":
            assert json.loads(tb) == json.loads(jb)
    jlog, tlog = layers.log(JAX_INPUT), layers.log(TORCH_INPUT)
    assert len(tlog) == len(jlog) == 4  # input_topic_partitions
    for p, (jrecs, trecs) in enumerate(zip(jlog, tlog)):
        assert [r[:2] for r in trecs] == [r[:2] for r in jrecs], p
        for key, message, headers in trecs:
            assert set(headers) == {"ts"} and headers["ts"].isdigit()
            assert partition_for_key(key, 4) == p
    assert all(tlog)  # every partition got records
    # every line exactly once
    got = [m for recs in tlog for _, m, _ in recs]
    assert sorted(got) == sorted(WRITTEN)


def test_a_bad_line_appends_nothing(layers):
    before = (layers.log(JAX_INPUT), layers.log(TORCH_INPUT))
    for body in (b"a,b,1\nnot-enough-fields\n", b"a,b,1\nu,i,1,2,3\n"):
        codes = [r[0] for r in layers.both("POST", "/ingest", body)]
        assert codes == [400, 400]
    codes = [r[0] for r in layers.both("POST", "/pref/u1/i1", b"many")]
    assert codes == [400, 400]
    assert (layers.log(JAX_INPUT), layers.log(TORCH_INPUT)) == before


def test_broker_faults_map_to_503_alike(layers):
    """An injected broker error on every attempt exhausts the retries:
    503, and no record lands."""
    before = layers.log(TORCH_INPUT)
    for mod in (jfaults, tfaults):
        mod.inject("inproc-send", mode="error", times=None)
    for layer in (layers.jl, layers.tl):
        layer.input_producer._retry.backoff.initial = 0.0
    codes = [r[0] for r in layers.both("POST", "/ingest", b"x,y,1\nz,w,2\n")]
    assert codes == [503, 503]
    assert layers.log(TORCH_INPUT) == before


def test_read_only_layers_refuse_writes(tmp_path):
    made = Layers(tmp_path, **{"oryx.serving.api.read-only": True})
    try:
        made.start()
        assert made.tl.input_producer is None
        assert not os.path.exists(os.path.join(
            made.broker_dir, f"{TORCH_INPUT}.meta.json"))
        for method, path, body, headers in WRITES[:4]:
            codes = [r[0] for r in made.both(method, path, body, headers)]
            assert codes == [403, 403], path
    finally:
        made.close()


def test_without_an_input_topic_writes_are_403(tmp_path):
    made = Layers(tmp_path, input_topics=False)
    try:
        made.start()
        assert made.tl.input_producer is None
        _publish(made)
        _ready(made)
        for method, path, body, headers in WRITES[:4]:
            codes = [r[0] for r in made.both(method, path, body, headers)]
            assert codes == [403, 403], path
    finally:
        made.close()


def test_example_config_creates_the_input_topic(tmp_path):
    """A layer started from the example config creates its input topic
    with ``oryx.input-topic.partitions`` partitions, as the reference's
    does."""
    uri = f"file://{tmp_path / 'broker'}"
    cfg = tconfig.overlay_on(
        {"oryx.update-topic.broker": uri, "oryx.input-topic.broker": uri},
        tconfig.from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                       "als-example.conf")))
    assert cfg.get_int("oryx.input-topic.partitions") == 4
    layer = TorchLayer(cfg, port=0, device="cpu")
    try:
        layer.start()
        topic = cfg.get_string("oryx.input-topic.message.topic")
        broker = tinproc.resolve_broker(uri)
        assert broker.topic_exists(topic)
        assert broker.num_partitions(topic) == 4
        with open(tmp_path / "broker" / f"{topic}.meta.json") as f:
            assert json.load(f) == {"partitions": 4}
    finally:
        layer.close()
        tinproc.drop_broker(f"file:{os.path.abspath(tmp_path / 'broker')}")


# -- rescorer providers ------------------------------------------------------

def test_rescorer_providers_filter_and_reorder_alike(tmp_path):
    made = Layers(tmp_path, **{"oryx.als.rescorer-provider-class":
                               "provider"})
    try:
        made.start()
        assert isinstance(made.tl.model_manager.rescorer_provider,
                          TorchProvider)
        _publish(made)
        _ready(made)
        for path in ("/recommend/u2?howMany=8",
                     "/recommendToAnonymous/i1/i2?howMany=6",
                     "/recommendWithContext/u4/i3?howMany=5",
                     "/similarity/i5/i6?howMany=6"):
            (js, jb), (ts, tb) = (_get(p, path) for p in made.ports)
            assert js == ts == 200, (path, tb[:300])
            _same_pairs(path, jb, tb)
            ids = [i for i, _ in _pairs(tb)]
            assert ids and not any(i.endswith("3") for i in ids), path
        plain = made.tl.model_manager.get_model()
        u2 = plain.get_user_vector("u2")
        unfiltered = [i for i, _ in plain.top_n(
            8, user_vector=u2, exclude=plain.get_known_items("u2"))]
        got = [i for i, _ in _pairs(_get(made.tl.port,
                                         "/recommend/u2?howMany=8")[1])]
        assert got != unfiltered  # the provider reordered and filtered
        for path in ("/mostPopularItems?howMany=20",
                     "/mostActiveUsers?howMany=20"):
            (js, jb), (ts, tb) = (_get(p, path) for p in made.ports)
            assert js == ts == 200 and json.loads(tb) == json.loads(jb)
            assert not any(d["id"].endswith("3") for d in json.loads(tb))
    finally:
        made.close()


def test_providers_compose_and_jax_package_classes_are_refused():
    name = f"{__name__}.TorchProvider"
    multi = trescorer.load_rescorer_providers(f"{name}, {name}")
    assert isinstance(multi, trescorer.MultiRescorerProvider)
    r = multi.get_recommend_rescorer("u", [])
    assert isinstance(r, trescorer.MultiRescorer)
    assert r.rescore("i1", 1.0) == _reorder("i1", _reorder("i1", 1.0))
    assert r.is_filtered("i13") and not r.is_filtered("i12")
    assert trescorer.load_rescorer_providers(None) is None
    assert trescorer.load_rescorer_providers(" , ") is None
    overlay = {"oryx.update-topic.broker": None,
               "oryx.input-topic.broker": None}
    for bad, match in (
            ("oryx_tpu.app.als.rescorer.MultiRescorerProvider",
             "JAX package"),
            (f"{__name__}.NoSuchProvider", "does not load"),
            ("NoDots", "not a qualified class name")):
        with pytest.raises(ValueError, match=match):
            ALSServingModelManager(tconfig.from_dict(
                {**overlay, "oryx.als.rescorer-provider-class": bad}),
                device="cpu")


# -- popularity counters -----------------------------------------------------

def test_item_popularity_counts_incremental():
    """The counter follows known-items writes and MODEL-swap pruning
    exactly, in both packages (the reference's case, tests/test_als.py)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4, 4)).astype(np.float32)
    Y = rng.standard_normal((4, 4)).astype(np.float32)
    counts = []
    for model in (jsm.ALSServingModel(4, implicit=True),
                  tsm.ALSServingModel(4, implicit=True, device="cpu")):
        for j in range(4):
            model.set_user_vector(f"u{j}", X[j])
            model.set_item_vector(f"i{j}", Y[j])
        model.add_known_items("u0", ["i1", "i2"])
        model.add_known_items("u1", ["i1"])
        model.add_known_items("u1", ["i1"])  # a repeat counts once
        assert model.get_item_popularity_counts() == {"i1": 2, "i2": 1}
        assert model.get_known_item_counts() == {"u0": 2, "u1": 1}
        model.X._recent.clear()
        model.Y._recent.clear()
        model.retain_recent_and_known_items(["u0"], ["i1"])
        counts.append((model.get_item_popularity_counts(),
                       model.get_known_item_counts()))
    assert counts[0] == counts[1] == ({"i1": 1}, {"u0": 1})


def test_popularity_counters_across_model_swaps(fresh_layers):
    """Two more MODEL documents with fewer users and items: the second
    prunes (the first keeps what the UP stream touched since the last
    swap), and both layers count alike after each."""
    y_ids, _, x_ids, _, _ = _catalog()
    producer = jinproc.InProcTopicProducer(fresh_layers.uri,
                                           fresh_layers.topic)
    keep_x, keep_y = x_ids[:20], y_ids[:20] + y_ids[40:]
    for _ in range(2):
        gen = [layer.model_manager.generation
               for layer in (fresh_layers.jl, fresh_layers.tl)]
        producer.send("MODEL", _model_doc(keep_x, keep_y))
        for layer, g in zip((fresh_layers.jl, fresh_layers.tl), gen):
            _wait(lambda: layer.model_manager.generation > g, "the MODEL")
        for path in ("/mostPopularItems?howMany=100",
                     "/mostActiveUsers?howMany=100", "/user/allIDs"):
            (js, jb), (ts, tb) = (_get(p, path) for p in fresh_layers.ports)
            assert js == ts == 200 and json.loads(tb) == json.loads(jb), path
    model = fresh_layers.tl.model_manager.get_model()
    pop = model.get_item_popularity_counts()
    assert pop and set(pop) <= set(keep_y)
    assert set(model.get_known_item_counts()) <= set(keep_x)


# -- the ingest gate and the producer ---------------------------------------

def _gate(**extra) -> tingest.IngestGate:
    return tingest.IngestGate(tconfig.from_dict(
        {f"oryx.serving.ingest.{k}": v for k, v in extra.items()}))


class _Counter:
    def __init__(self):
        self.counts = {}

    def inc(self, name):
        self.counts[name] = self.counts.get(name, 0) + 1


def test_gate_disabled_by_default():
    assert not _gate().enabled
    assert tingest.IngestGate(tconfig.from_dict({})).enabled is False


def test_inflight_cap_sheds_fast_503_with_retry_after():
    g = _gate(**{"max-inflight-sends": 1, "retry-after-sec": 7})
    metrics = _Counter()
    adm = g.admitted(metrics)
    with pytest.raises(OryxServingException) as ei:
        g.admitted(metrics)
    assert ei.value.status == 503
    assert ei.value.headers == {"Retry-After": "7"}
    assert g.sheds == 1 and metrics.counts == {"ingest_sheds": 1}
    with adm:
        pass
    with g.admitted(metrics):
        pass
    assert g.sheds == 1
    assert g.stats()["inflight"] == 0


def test_measured_lag_ewma_sheds_and_recovers(monkeypatch):
    t = [0.0]
    monkeypatch.setattr(tingest.clockmod, "monotonic", lambda: t[0])
    g = _gate(**{"send-lag-high-ms": 50})

    def send_taking(sec):
        with g.admitted():
            t[0] += sec

    for _ in range(4):
        send_taking(0.200)
    assert g.send_lag_ms() > 50
    hold = g.admitted()  # a send in flight: the convoy to join
    with pytest.raises(OryxServingException) as ei:
        g.admitted()
    assert ei.value.status == 503
    with hold:
        t[0] += 0.2
    assert g.inflight == 0  # nothing in flight: admitted as probes
    for _ in range(20):
        send_taking(0.001)
    assert g.send_lag_ms() < 50
    with g.admitted():
        pass


def test_admission_releases_on_produce_failure():
    g = _gate(**{"max-inflight-sends": 2})
    with pytest.raises(RuntimeError):
        with g.admitted():
            raise RuntimeError("broker went away mid-send")
    assert g.inflight == 0


class _CapturingProducer:
    def __init__(self):
        self.send_calls = []
        self.send_many_calls = []

    def send(self, key, message, headers=None):
        self.send_calls.append((key, message, headers))

    def send_many(self, entries):
        self.send_many_calls.append(list(entries))


def _req(producer, **ctx):
    return SimpleNamespace(context={"input_producer": producer, **ctx})


def test_send_input_keys_and_batches_like_the_reference():
    lines = ["a,b,1", "c,d,2", "e,f,3"]
    got, want = _CapturingProducer(), _CapturingProducer()
    tframework.send_input_many(_req(got), lines)
    jframework.send_input_many(_req(want), lines)
    assert not got.send_calls and len(got.send_many_calls) == 1
    assert [e[:2] for e in got.send_many_calls[0]] == \
        [e[:2] for e in want.send_many_calls[0]]
    entries = got.send_many_calls[0]
    for _, _, h in entries:
        assert set(h) == {"ts"} and h["ts"].isdigit()
    assert len({id(h) for _, _, h in entries}) == len(entries)
    one = _CapturingProducer()
    tframework.send_input(_req(one), "a,b,1")
    assert len(one.send_calls) == 1 and not one.send_many_calls
    assert one.send_calls[0][0] == entries[0][0]


def test_send_input_error_mapping():
    with pytest.raises(OryxServingException) as ei:
        tframework.send_input(_req(None), "a,b,1")
    assert ei.value.status == 403
    p = _CapturingProducer()
    g = _gate(**{"max-inflight-sends": 1})
    hold = g.admitted()
    with pytest.raises(OryxServingException) as ei:
        tframework.send_input_many(_req(p, ingest_gate=g), ["a,b,1", "c,d,2"])
    assert ei.value.status == 503 and ei.value.headers["Retry-After"]
    assert not p.send_calls and not p.send_many_calls
    with hold:
        pass

    class Failing:
        def __init__(self, exc):
            self.exc = exc

        def send(self, key, message, headers=None):
            raise self.exc

        def send_many(self, entries):
            raise self.exc

    for exc, frag in ((CircuitOpenError("open"), "input unavailable"),
                      (OSError("wire torn"), "input send failed")):
        with pytest.raises(OryxServingException) as ei:
            tframework.send_input_many(_req(Failing(exc)), ["a,b,1", "c,d,2"])
        assert ei.value.status == 503 and frag in str(ei.value)


def test_pipelined_send_keeps_per_record_faults(tmp_path):
    """send_many classifies every record through the inproc-send seam
    before any append: drop loses one record, duplicate doubles one,
    error lands nothing; order within a partition is kept."""
    uri = f"file://{tmp_path / 'b'}"
    broker = tinproc.resolve_broker(uri)
    try:
        broker.create_topic("T", 1)
        producer = tinproc.InProcTopicProducer(uri, "T")
        entries = [(f"k{j}", f"m{j}", {"ts": "1"}) for j in range(4)]
        tfaults.inject("inproc-send", mode="error", times=1)
        with pytest.raises(tfaults.InjectedFault):
            producer.send_many(entries)
        assert broker.latest_offsets("T") == [0]
        tfaults.inject("inproc-send", mode="duplicate", times=1)
        producer.send_many(entries)
        tfaults.inject("inproc-send", mode="drop", times=1)
        producer.send_many(entries)
        with open(tmp_path / "b" / "T.topic.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert [r[1] for r in recs] == ["m0", "m0", "m1", "m2", "m3",
                                        "m1", "m2", "m3"]
        assert all(r[2] == {"ts": "1"} for r in recs)
    finally:
        tinproc.drop_broker(f"file:{os.path.abspath(tmp_path / 'b')}")


def test_resilient_producer_retries_then_opens_the_breaker():
    calls = []

    class Flaky:
        def send(self, key, message, headers=None):
            calls.append(message)
            raise OSError("down")

        def send_many(self, entries):
            calls.append(len(entries))
            raise OSError("down")

        def close(self):
            pass

    t = [0.0]
    breaker = CircuitBreaker("b", failure_threshold=2,
                             reset_timeout_sec=1.0, clock=lambda: t[0])
    retry = Retry("r", max_attempts=3, sleep=lambda s: None)
    p = ResilientTopicProducer(Flaky(), retry, breaker)
    for _ in range(2):
        with pytest.raises(OSError):
            p.send_many([("k", "m", None), ("k2", "m2", None)])
    assert calls == [2] * 6 and retry.retries == 4 and retry.give_ups == 2
    assert breaker.state == "open"
    with pytest.raises(CircuitOpenError):
        p.send("k", "m")
    assert breaker.rejected == 1
    t[0] = 1.5  # half-open: one probe, which fails and re-opens
    with pytest.raises(OSError):
        p.send("k", "m")
    assert breaker.state == "open" and breaker.opens == 2
    t[0] = 3.0
    ok = ResilientTopicProducer(_CapturingProducer(), retry, breaker)
    ok.send("k", "m")
    assert breaker.state == "closed"


# -- the cosine scores -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [1.0, 0.3], ids=["exact", "lsh"])
def test_cosine_top_n_matches_the_reference(dtype, rate):
    """``top_n(cosine_to=...)`` on a lane-padded store, float32 or bf16
    (norms accumulated in float32), exact or under the LSH ball of the
    columns' mean."""
    from oryx_tpu_torch.convert import serving_model_from_arrays
    rng = np.random.default_rng(9)
    Y = rng.standard_normal((700, 12)).astype(np.float32)
    jm = jsm.ALSServingModel(12, implicit=True, sample_rate=rate,
                             dtype=dtype)
    jm.Y.bulk_load([f"i{j}" for j in range(len(Y))], Y)
    yh, _, yr = jm.Y.host_arrays()
    tm = serving_model_from_arrays(
        12, True, x_ids=[], X=np.zeros((0, 12), np.float32), y_ids=yr,
        Y=np.asarray(yh, np.float32), known_items={},
        lsh_hyperplanes=jm.lsh.hyperplanes if jm.lsh else None,
        sample_rate=rate, dtype=dtype, device="cpu")
    for ids in (["i1"], ["i2", "i3"], ["i4", "i5", "i6", "i7", "i8"]):
        V = np.stack([jm.get_item_vector(i) for i in ids], axis=1)
        for kw in ({}, {"lowest": True}):
            want = jm.top_n(9, cosine_to=V, exclude=set(ids), **kw)
            got = tm.top_n(9, cosine_to=V, exclude=set(ids), **kw)
            assert want and [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=RTOL)
    with pytest.raises(ValueError, match="exactly one"):
        tm.top_n(3, user_vector=V[:, 0], cosine_to=V)
    with pytest.raises(ValueError, match="exactly one"):
        tm.top_n(3)


def test_popularity_counters_hold_under_concurrent_writes():
    """Writers on several threads add overlapping known items while a
    reader polls: every count ends equal to the number of distinct
    users that know the item."""
    import sys
    import threading
    model = tsm.ALSServingModel(4, implicit=True, device="cpu")
    n_threads, per_thread = 8, 300
    errors = []

    def writer(t):
        rng = np.random.default_rng(t)
        try:
            for j in range(per_thread):
                items = [f"i{k}" for k in rng.integers(0, 40, 3)]
                model.add_known_items(f"u{j % 50}", items)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for _ in range(200):
            assert all(c > 0 for c in
                       model.get_item_popularity_counts().values())
        for th in threads:
            th.join(WAIT_S)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    want: dict[str, int] = {}
    for u in range(50):
        for i in model.get_known_items(f"u{u}"):
            want[i] = want.get(i, 0) + 1
    assert model.get_item_popularity_counts() == want
