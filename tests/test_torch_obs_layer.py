"""The port's ServingLayer with every observability key on, held against
the reference's under the same config, over one ``file://`` update
topic, on the CPU.

After the same MODEL + UP replay and the same ``/recommend`` requests,
both layers answer alike: the same ``/recommend`` ids (obs on changes
no answer), the same ``/metrics`` JSON keys, Prometheus metric names and
route counts, the same span names and parentage with the batcher's
queue-wait/device-execute split under each request span, the same
status on every ``/admin/*`` route, and the same ``/admin/profile``
gating (404 without ``oryx.obs.profile-dir``, 503 while a capture
runs).  The port's device-time accounting books the requests to its
routed kind, and its ``/admin/profile`` writes a Chrome trace."""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import os
import re
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as jpmml
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.http import Request as JRequest
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu.obs import profile as jprofile
from oryx_tpu.obs import server as jserver
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.api.serving import OryxServingException
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.http import Request as TRequest
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer
from oryx_tpu_torch.obs import profile as tprofile
from oryx_tpu_torch.obs import server as tserver
from oryx_tpu_torch.resilience import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, N_USERS, F = 300, 24, 6
N_REQUESTS = 24
WAIT_S = 60.0


def _obs(root: str) -> dict:
    return {
        "oryx.obs.tracing.enabled": True,
        "oryx.obs.tracing.sample-ratio": 1.0,
        "oryx.obs.slo.enabled": True,
        "oryx.obs.slo.objectives": {
            "availability": {"kind": "availability", "target": 0.999},
            "latency": {"kind": "latency", "target": 0.99,
                        "threshold-ms": 200}},
        "oryx.obs.events.dir": os.path.join(root, "events"),
        "oryx.obs.flight.dir": os.path.join(root, "flight"),
        "oryx.obs.flight.dump-on-exit": False,
        "oryx.obs.profile-dir": os.path.join(root, "profile"),
    }


def _request(port, method, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, headers={"Accept": "application/json",
                                            **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _model_doc(x_ids, y_ids):
    doc = jpmml.build_skeleton_pmml()
    jpmml.add_extension(doc, "features", F)
    jpmml.add_extension(doc, "implicit", True)
    jpmml.add_extension_content(doc, "XIDs", x_ids)
    jpmml.add_extension_content(doc, "YIDs", y_ids)
    return jpmml.to_string(doc)


def _solvers_current(model) -> bool:
    """Both Gramian solvers solved from the stores as they stand (see
    tests/test_torch_serving_routes.py::_solvers_current)."""
    for get, cache in ((model.get_xtx_solver, model.cached_xtx_solver),
                       (model.get_yty_solver, model.cached_yty_solver)):
        get(blocking=False)
        with cache._cond:
            if cache._dirty or cache._in_flight or cache._solver is None:
                return False
    return True


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_layer")
    broker_dir = str(root / "broker")
    uri = f"file://{broker_dir}"
    common = {"oryx.update-topic.broker": uri,
              "oryx.input-topic.broker": None}
    jcfg = jconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu.serving.als",
        **common, **_obs(str(root / "jax"))})
    tcfg = tconfig.overlay_on(
        {**common, **_obs(str(root / "torch"))},
        tconfig.from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                       "als-example.conf")))
    jl, tl = JaxLayer(jcfg, port=0), TorchLayer(tcfg, port=0,
                                                device="cpu")
    started = []
    try:
        for layer in (jl, tl):
            layer.start()
            started.append(layer)
        rng = np.random.default_rng(7)
        y_ids = [f"i{j}" for j in range(N_ITEMS)]
        x_ids = [f"u{j}" for j in range(N_USERS)]
        Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
        X = rng.standard_normal((N_USERS, F)).astype(np.float32)
        producer = jinproc.InProcTopicProducer(
            uri, tcfg.get_string("oryx.update-topic.message.topic"))
        producer.send("MODEL", _model_doc(x_ids, y_ids))
        for i, row in zip(y_ids, Y):
            producer.send("UP", json.dumps(["Y", i, [float(v) for v in row]]))
        for u, row in zip(x_ids, X):
            producer.send("UP", json.dumps(
                ["X", u, [float(v) for v in row],
                 [f"i{j}" for j in rng.integers(0, 40, 4)]]))
        for layer in (jl, tl):
            def loaded(layer=layer):
                m = layer.model_manager.get_model()
                return (m is not None and len(m.X) == N_USERS
                        and len(m.Y) == N_ITEMS
                        and len(m.get_known_items(f"u{N_USERS - 1}")) > 0)
            _wait(loaded, "the replay")
            model = layer.model_manager.get_model()
            _wait(lambda: _solvers_current(model), "the solvers")
            _wait(lambda: _request(layer.port, "GET", "/ready")[0] == 204,
                  "/ready")
        paths = [f"/recommend/u{u % N_USERS}?howMany=5"
                 for u in range(N_REQUESTS)]
        answers = []
        for layer in (jl, tl):
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers.append(list(pool.map(
                    lambda p, port=layer.port: _request(port, "GET", p),
                    paths)))
        yield jl, tl, paths, answers, root
    finally:
        for layer in started:
            layer.close()
        jinproc.drop_broker(f"file:{os.path.abspath(broker_dir)}")
        tinproc.drop_broker(f"file:{os.path.abspath(broker_dir)}")


def _both(layers, path, method="GET"):
    jl, tl = layers[:2]
    return [_request(layer.port, method, path) for layer in (jl, tl)]


def test_answers_are_unchanged_with_obs_on(layers):
    _, _, paths, (jans, tans), _ = layers
    for path, (js, jb, jh), (ts, tb, th) in zip(paths, jans, tans):
        assert js == ts == 200, (path, jb, tb)
        want = [(d["id"], d["value"]) for d in json.loads(jb)]
        got = [(d["id"], d["value"]) for d in json.loads(tb)]
        assert [i for i, _ in got] == [i for i, _ in want], path
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=1e-4,
                                   atol=1e-6)
        # every request is sampled at ratio 1.0: its trace id comes back
        assert re.fullmatch(r"[0-9a-f]{32}", th["X-Oryx-Trace"])
        assert re.fullmatch(r"[0-9a-f]{32}", jh["X-Oryx-Trace"])


def _metrics(layers):
    (js, jb, _), (ts, tb, _) = _both(layers, "/metrics")
    assert js == ts == 200
    return json.loads(jb), json.loads(tb)


def test_metrics_json_keys_and_route_counts_match(layers):
    jm, tm = _metrics(layers)
    assert set(tm) == set(jm)
    route = "GET /recommend/{userID}"
    assert tm["routes"][route]["count"] == jm["routes"][route]["count"] \
        == N_REQUESTS
    assert set(tm["routes"][route]) == set(jm["routes"][route])
    assert set(tm["freshness"]) == set(jm["freshness"])
    assert set(tm["device_time"]) == set(jm["device_time"])
    assert set(tm["scoring_batcher"]) == set(jm["scoring_batcher"])
    model = layers[1].model_manager.get_model()
    label = model.kernel_route_label.replace("+", "_")
    serve = [r for r in tm["device_time"]["by_route"]
             if r["route_class"] == "serve"]
    assert serve and serve[0]["kernel_route"] == label
    assert any(r["route_class"] == "measure"
               for r in tm["device_time"]["by_route"])
    assert 0.0 < tm["freshness"]["device_busy_fraction"] <= 1.0


def _names(text: str) -> set[str]:
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
            # the per-kind counters name each package's own routed kind
            names.add(re.sub(r"^(oryx_device_time_us_[a-z]+)_.+_total$",
                             r"\1_<kind>_total", name))
    return names


@pytest.mark.parametrize("fmt", ["prometheus", "openmetrics"])
def test_prometheus_names_match(layers, fmt):
    (js, jb, jh), (ts, tb, th) = _both(layers, f"/metrics?format={fmt}")
    assert js == ts == 200
    assert th["Content-Type"] == jh["Content-Type"]
    jt, tt = jb.decode(), tb.decode()
    assert _names(tt) == _names(jt)
    label = layers[1].model_manager.get_model().kernel_route_label
    assert f"oryx_device_time_us_serve_{label.replace('+', '_')}_total" \
        in tt
    if fmt == "openmetrics":
        # every exemplar names a trace the port's ring holds
        held = json.loads(_both(layers, "/admin/traces?limit=256")[1][1])
        ids = re.findall(r'# \{trace_id="([0-9a-f]{32})"\}', tt)
        assert ids and set(ids) <= set(held["traces"])
    (js, jb, _), (ts, tb, _) = _both(layers, "/metrics?format="
                                     "prometheus-json")
    assert set(json.loads(tb)) == set(json.loads(jb))


def _tree(trace: list[dict]) -> list[tuple]:
    by_id = {s["span_id"]: s["name"] for s in trace}
    return sorted((s["name"], by_id.get(s["parent_id"]), s["status"],
                   tuple(sorted(k for k in s["attrs"])))
                  for s in trace)


def test_span_names_and_parentage_match(layers):
    (js, jb, _), (ts, tb, _) = _both(layers, "/admin/traces?limit=256")
    assert js == ts == 200
    jtraces, ttraces = json.loads(jb)["traces"], json.loads(tb)["traces"]
    recommend = [t for t in ttraces.values() if any(
        s["attrs"].get("route") == "GET /recommend/{userID}" for s in t)]
    jrecommend = [t for t in jtraces.values() if any(
        s["attrs"].get("route") == "GET /recommend/{userID}" for s in t)]
    assert len(recommend) == len(jrecommend) == N_REQUESTS
    assert {tuple(_tree(t)) for t in recommend} == \
        {tuple(_tree(t)) for t in jrecommend}
    label = layers[1].model_manager.get_model().kernel_route_label
    for trace in recommend:
        names = {s["name"]: s for s in trace}
        assert set(names) == {"serving.request", "serving.queue_wait",
                              "serving.device_execute"}
        ex = names["serving.device_execute"]["attrs"]
        assert ex["kernel_route"] == label and ex["batch_size"] >= 1


def test_admin_routes_answer_alike(layers):
    for path in ("/admin/tail", "/admin/slo", "/admin/region",
                 "/admin/flight", "/admin/diagnose"):
        (js, jb, _), (ts, tb, _) = _both(layers, path)
        assert js == ts == 200, (path, jb, tb)
        assert set(json.loads(tb)) == set(json.loads(jb)), path
    tail = json.loads(_both(layers, "/admin/tail")[1][1])
    for entry in tail["top"]:
        assert sum(entry["stages"].values()) == pytest.approx(
            entry["total_ms"], abs=0.005)
    (js, jb, _), (ts, tb, _) = _both(layers, "/admin/flight/dump", "POST")
    assert js == ts == 200
    jd, td = json.loads(jb), json.loads(tb)
    assert jd["dumped"] and td["dumped"]
    with open(td["path"], encoding="utf-8") as f:
        bundle = json.load(f)
    assert bundle["device_time"]["by_route"]
    with open(jd["path"], encoding="utf-8") as f:
        assert set(json.load(f)) == set(bundle)


def test_event_lines_carry_the_batch_fields(layers):
    root = layers[4]
    lines = {}
    for pkg in ("jax", "torch"):
        d = os.path.join(root, pkg, "events")
        (name,) = os.listdir(d)
        with open(os.path.join(d, name), encoding="utf-8") as f:
            lines[pkg] = [json.loads(x) for x in f]
    route = "GET /recommend/{userID}"
    for pkg, events in lines.items():
        rec = [e for e in events if e["route"] == route]
        assert len(rec) == N_REQUESTS, pkg
        assert all(e["sampled"] and e["batch_size"] >= 1
                   and "kernel_route" in e and "queue_wait_ms" in e
                   for e in rec), pkg
    assert {frozenset(e) for e in lines["torch"] if e["route"] == route} \
        == {frozenset(e) for e in lines["jax"] if e["route"] == route}


def test_profile_gating_matches(layers, tmp_path):
    # 404 without oryx.obs.profile-dir
    for mod, req_cls, exc, cfg in (
            (jserver, JRequest, Exception, jconfig.from_dict({})),
            (tserver, TRequest, OryxServingException,
             tconfig.from_dict({}))):
        req = req_cls("GET", "/admin/profile", {}, {}, b"", {},
                      {"config": cfg})
        with pytest.raises(exc) as e:
            mod.admin_profile(req)
        assert e.value.status == 404
    # 503 while another capture holds the profiler
    with jprofile._capture_lock:
        (js, _, _), _ = _both(layers, "/admin/profile?ms=10")
    with tprofile.capture_lock():
        _, (ts, tb, _) = _both(layers, "/admin/profile?ms=10")
    assert js == ts == 503, tb


def test_port_profile_writes_a_chrome_trace(layers):
    tl = layers[1]
    status, body, _ = _request(tl.port, "GET", "/admin/profile?ms=30")
    assert status == 200, body
    out = json.loads(body)
    assert out["requested_ms"] == 30 and out["devices"] == []
    assert out["activities"] == ["CPU"]
    with open(out["trace_file"], encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)
    assert os.path.dirname(out["trace_file"]).startswith(
        tl.config.get_string("oryx.obs.profile-dir"))


def test_a_failed_capture_is_a_500(layers, monkeypatch):
    tl = layers[1]

    def broken(*a, **kw):
        raise RuntimeError("profiler backend down")

    monkeypatch.setattr(tprofile, "capture_profile", broken)
    status, body, _ = _request(tl.port, "GET", "/admin/profile?ms=5")
    assert status == 500 and b"profiler backend down" in body


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    jfaults.clear()
    tfaults.clear()


def test_open_loop_run_names_its_worst_sampled_traces(layers):
    from oryx_tpu_torch.bench import load as tload
    tl = layers[1]
    out = tload.run_recommend_open_loop(
        f"http://127.0.0.1:{tl.port}", [f"u{u}" for u in range(N_USERS)],
        rate_qps=40.0, duration_sec=1.0, workers=8)
    assert out["errors"] == 0
    worst = out["worst_sampled"]
    assert len(worst) == 5
    assert [w["ms"] for w in worst] == sorted((w["ms"] for w in worst),
                                              reverse=True)
    held = json.loads(_request(tl.port, "GET",
                               "/admin/traces?limit=256")[1])["traces"]
    assert all(w["trace"] in held for w in worst)
