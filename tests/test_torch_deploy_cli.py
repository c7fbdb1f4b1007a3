"""The port's operator CLI (``python -m oryx_tpu_torch``) against the
reference's (``python -m oryx_tpu``): its example confs parse, the topic
commands and ``config-to-properties`` print what the reference prints
for the same conf, ``mirror`` and ``autoscale`` run from the CLI on
``file://`` brokers with ``--device cpu`` members, a serving layer
started from the CLI on the CPU answers ``/recommend`` as the
reference's layer does on the same ``file://`` update topic, then exits
0 on SIGINT, and two ``serving --shard i/2`` replicas behind a
``router`` started from the CLI answer ``/recommend`` as the single
layer does.  Every wait is bounded."""

from __future__ import annotations

import glob
import http.client
import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import pmml as pmml_io
from oryx_tpu.deploy.main import main as jmain
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.lambda_rt.serving import ServingLayer as JaxLayer
from oryx_tpu_torch.common.config import from_file
from oryx_tpu_torch.deploy.main import main as tmain
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.lambda_rt.serving import ServingLayer as TorchLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFS = sorted(glob.glob(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                           "*.conf")))
N_ITEMS, N_USERS, F = 600, 30, 10
WAIT_S = 90.0


def test_port_conf_files_parse():
    assert len(PORT_CONFS) == 3
    for path in PORT_CONFS:
        cfg = from_file(path)
        assert cfg.get_string("oryx.input-topic.broker") == \
            cfg.get_string("oryx.update-topic.broker")
        assert cfg.get_string("oryx.serving.model-manager-class") \
            .startswith("oryx_tpu_torch.")
        assert cfg.get_int("oryx.serving.api.port") == 8080


def _write_conf(tmp_path, broker_uri, **extra):
    conf = tmp_path / "app.conf"
    lines = [f'  input-topic.broker = "{broker_uri}"',
             f'  update-topic.broker = "{broker_uri}"',
             '  input-topic.message.topic = "CliIn"',
             '  update-topic.message.topic = "CliUp"']
    lines += [f"  {k} = {json.dumps(v)}" for k, v in extra.items()]
    conf.write_text("oryx {\n" + "\n".join(lines) + "\n}\n")
    return str(conf)


def _drop(broker_dir):
    name = f"file:{os.path.abspath(broker_dir)}"
    jinproc.drop_broker(name)
    tinproc.drop_broker(name)


def test_kafka_commands_match_reference(tmp_path, capsys):
    """On one file:// broker, each CLI's kafka-setup prints the same
    lines, and each one's kafka-tail --once prints the same lines after
    both have sent lines with kafka-input."""
    broker_dir = tmp_path / "broker"
    conf = _write_conf(tmp_path, f"file://{broker_dir}")
    try:
        outs = []
        for main in (jmain, tmain):
            assert main(["kafka-setup", "--conf", conf]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "CliIn" in outs[0] and "exists" in outs[0]

        for j, main in enumerate((tmain, jmain)):
            data = tmp_path / f"lines{j}.csv"
            data.write_text(f"u{j},i1,1.0\nu{j},i2,2.0\n\n")
            assert main(["kafka-input", "--conf", conf,
                         "--file", str(data)]) == 0
            assert capsys.readouterr().err.endswith(
                "Sent 2 lines to CliIn\n")

        tails = []
        for main in (jmain, tmain):
            assert main(["kafka-tail", "--once", "--conf", conf]) == 0
            tails.append(capsys.readouterr().out)
        assert tails[0] == tails[1]
        # partition by partition, so in the order both CLIs read them
        assert sorted(tails[0].splitlines()) == [
            "CliIn\tNone\tu0,i1,1.0", "CliIn\tNone\tu0,i2,2.0",
            "CliIn\tNone\tu1,i1,1.0", "CliIn\tNone\tu1,i2,2.0"]
    finally:
        _drop(broker_dir)


@pytest.mark.parametrize("conf_name", ["user"] + [
    os.path.basename(p) for p in PORT_CONFS])
def test_config_to_properties_same_bytes(tmp_path, capsys, conf_name):
    if conf_name == "user":
        conf = tmp_path / "t.conf"
        conf.write_text('oryx.id = "props-test"\n'
                        'oryx.als.hyperparams.features = [8, 16]\n'
                        'oryx.serving.api.read-only = true\n')
        conf = str(conf)
    else:
        conf = os.path.join(REPO, "oryx_tpu_torch", "conf", conf_name)
    outs = []
    for main in (jmain, tmain):
        assert main(["config-to-properties", "--conf", conf]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "oryx.compile-cache-dir=/tmp/oryx-tpu-compile-cache" in outs[1]


def test_cli_rejects_unknown_command():
    with pytest.raises(SystemExit) as e:
        tmain(["no-such-command"])
    assert e.value.code != 0


def _mirror_cli(tmp_path, env):
    """``mirror`` replays region A's ``file://`` update topic into
    region B's with origin headers and a checkpoint, and exits 0 on
    SIGINT."""
    a_uri, b_uri = (f"file://{tmp_path / d}" for d in ("a", "b"))
    conf = _write_conf(tmp_path, b_uri, **{
        "cluster.region.name": "east",
        "cluster.region.mirror.checkpoint-dir": str(tmp_path / "ckpt"),
        "cluster.region.mirror.poll-interval-ms": 100})
    producer = tinproc.InProcTopicProducer(a_uri, "CliUp")
    for j in range(5):
        producer.send("UP", json.dumps(["X", f"u{j}", [1.0, 2.0], []]))
    producer.send("HB", '{"replica":"r"}')
    producer.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch", "mirror", "--conf", conf,
         "--source-broker", a_uri, "--source-region", "west"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    dest = tinproc.resolve_broker(b_uri)
    try:
        def replayed():
            return sum(dest.latest_offsets("CliUp")) == 5
        _wait(replayed, "the mirror's replay")
        recs = list(dest.read_ranges("CliUp", [0],
                                     dest.latest_offsets("CliUp")))
        assert [(km.key, km.headers["origin-region"],
                 km.headers["origin-offset"]) for km in recs] == [
            ("UP", "west", str(j)) for j in range(5)]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0, proc.stderr.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        _drop(tmp_path / "a")
        _drop(tmp_path / "b")
    doc = json.loads((tmp_path / "ckpt" / "mirror-checkpoint.json")
                     .read_text())
    assert doc["source"] == {"0": 6}
    assert doc["watermarks"] == {"west|0": 4}


class _PressuredRouter(http.server.BaseHTTPRequestHandler):
    """A router's ``/metrics``: one shard with no ready replica, and a
    data-plane route whose slow bucket grows on every scrape."""
    scrapes = [0]

    def do_GET(self):
        if "prometheus-json" in self.path:
            self.scrapes[0] += 1
            # the (200, 500] ms bucket of the 14
            buckets = [0] * 8 + [10 * self.scrapes[0]] + [0] * 5
            doc = {"routes": {"GET /recommend/{userID}": {
                "latency_ms": {"buckets": buckets}}}}
        else:
            doc = {"cluster": {"membership": {"shards": 1, "replicas": {}},
                               "scatter": {}}}
        body = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def _autoscale_cli(tmp_path, env):
    """``autoscale --device cpu`` against a router under pressure spawns
    one ``serving --shard 0/1 --device cpu`` member (its heartbeat lands
    on the update topic), and on SIGINT stops it and exits 0."""
    uri = f"file://{tmp_path / 'broker'}"
    router = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             _PressuredRouter)
    threading.Thread(target=router.serve_forever, daemon=True).start()
    work = tmp_path / "asg"
    conf = _write_conf(tmp_path, uri, **{
        "serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "serving.application-resources": "oryx_tpu_torch.serving.als",
        "cluster.heartbeat-interval-ms": 200,
        "cluster.autoscale.poll-interval-ms": 200,
        "cluster.autoscale.p99-high-ms": 100,
        "cluster.autoscale.cooldown-ms": 600000,
        "cluster.autoscale.work-dir": str(work),
        "compile-cache-dir": str(tmp_path / "cache")})
    proc = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch", "autoscale", "--conf",
         conf, "--router-url",
         f"http://127.0.0.1:{router.server_address[1]}", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    broker = tinproc.resolve_broker(uri)
    try:
        def heartbeat():
            ends = broker.latest_offsets("CliUp")
            return next((json.loads(km.message) for km in
                         broker.read_ranges("CliUp", [0] * len(ends), ends)
                         if km.key == "HB"), None)
        _wait(lambda: heartbeat() is not None, "the member's heartbeat")
        hb = heartbeat()
        assert (hb["replica"], hb["shard"], hb["of"]) == ("asg-0of1-1", 0, 1)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0, proc.stderr.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        router.shutdown()
        _drop(tmp_path / "broker")
    member_log = (work / "asg-0of1-1.log").read_text()
    # the member ran on the host and was stopped by SIGINT
    assert "serving: kernel launches=" in member_log
    assert "--device" not in member_log
    assert (work / "asg-0of1-1.conf").read_text().count(
        'oryx.cluster.shard = "0/1"') == 1


@pytest.mark.parametrize("command", ["autoscale", "mirror"])
def test_lifted_commands_run_from_the_cli(tmp_path, command):
    env = dict(os.environ, PYTHONPATH=REPO)
    {"mirror": _mirror_cli, "autoscale": _autoscale_cli}[command](
        tmp_path, env)


def test_help_lists_the_reference_subcommands(capsys):
    for main in (jmain, tmain):
        with pytest.raises(SystemExit):
            main(["--help"])
    ref, port = capsys.readouterr().out.split("usage: oryx_tpu_torch")
    choices = ref[ref.index("{") + 1:ref.index("}")].split(",")
    assert len(choices) == 11
    for name in choices:
        assert name in port[:port.index("}")]


@pytest.mark.parametrize("argv, extra, key", [
    (["serving", "--shard", "0/2"], {
        "serving.api.item-shards": 2,
        "serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager"},
     "oryx.serving.api.item-shards"),
    (["speed", "--shard", "1/2"], {}, "oryx.speed.shard"),
])
def test_shard_flags_reach_the_layers_refusals(tmp_path, argv, extra, key):
    """--shard passes the reference's overlay; the layer refuses a key it does not serve yet at once, before the
    supervisor's restart budget."""
    broker_dir = tmp_path / "broker"
    conf = _write_conf(tmp_path, f"file://{broker_dir}", **extra)
    try:
        with pytest.raises(ValueError, match=key):
            tmain([*argv, "--conf", conf, "--device", "cpu"])
    finally:
        _drop(broker_dir)


def test_layer_without_device_flag_needs_the_card(tmp_path, monkeypatch):
    """--device defaults to the card: without one, the layer raises
    instead of running on the host."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    broker_dir = tmp_path / "broker"
    conf = _write_conf(tmp_path, f"file://{broker_dir}", **{
        "serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager"})
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain(["serving", "--conf", conf])
    finally:
        _drop(broker_dir)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path, headers={"Accept": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _publish(uri, topic):
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
    producer = tinproc.InProcTopicProducer(uri, topic)
    producer.send("MODEL", pmml_io.to_string(doc))
    for i, row in zip(y_ids, Y):
        producer.send("UP", json.dumps(["Y", i, [float(v) for v in row]]))
    for u, row in zip(x_ids, X):
        known = [f"i{j}" for j in rng.integers(0, N_ITEMS, 6)]
        producer.send("UP", json.dumps(["X", u, [float(v) for v in row],
                                        known]))
    producer.close()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_serving_answers_as_reference_and_exits_on_sigint(tmp_path):
    broker_dir = tmp_path / "broker"
    uri = f"file://{broker_dir}"
    port = _free_port()
    conf = tmp_path / "serving.conf"
    conf.write_text(
        open(os.path.join(REPO, "oryx_tpu_torch", "conf",
                          "als-example.conf"), encoding="utf-8").read()
        + f'\noryx.update-topic.broker = "{uri}"\n'
        f'oryx.input-topic.broker = "{uri}"\n'
        f"oryx.serving.api.port = {port}\n"
        f'oryx.compile-cache-dir = "{tmp_path / "cache"}"\n')
    topic = from_file(str(conf)).get_string("oryx.update-topic.message.topic")
    _publish(uri, topic)
    jl = JaxLayer(jconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu.serving.als",
        "oryx.input-topic.broker": None,
        "oryx.update-topic.broker": uri,
        "oryx.update-topic.message.topic": topic}), port=0)
    log = tmp_path / "serving.log"
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(log, "w", encoding="utf-8") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch", "serving", "--conf",
             str(conf), "--device", "cpu"], cwd=REPO, env=env,
            stdout=log_f, stderr=subprocess.STDOUT)
    try:
        jl.start()

        def ready(p):
            try:
                status, _ = _get(p, f"/knownItems/u{N_USERS - 1}")
            except OSError:
                return False
            return status == 200 and json.loads(_get(
                p, f"/knownItems/u{N_USERS - 1}")[1])

        _wait(lambda: proc.poll() is None and ready(port),
              "the CLI's serving layer")
        _wait(lambda: ready(jl.port), "the reference's serving layer")
        for u in range(N_USERS):
            path = f"/recommend/u{u}?howMany=7"
            got, want = (_get(p, path) for p in (port, jl.port))
            assert got[0] == want[0] == 200, path
            got = [(d["id"], d["value"]) for d in json.loads(got[1])]
            want = [(d["id"], d["value"]) for d in json.loads(want[1])]
            assert [i for i, _ in got] == [i for i, _ in want], path
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=1e-5)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        jl.close()
        _drop(broker_dir)
    text = log.read_text()
    assert "serving: kernel launches=" in text
    # the layer read its cache directory from the conf
    assert f"kernel library cache at {tmp_path / 'cache'}" in text


def test_cli_cluster_replicas_and_router_answer_as_one_layer(tmp_path):
    """``serving --shard 0/2`` and ``1/2`` start two replicas, ``router``
    merges them: its /recommend equals a single layer's on the same
    topic (ids in order, scores within rtol 1e-5), and every process
    exits 0 on SIGINT."""
    broker_dir = tmp_path / "broker"
    uri = f"file://{broker_dir}"
    base = open(os.path.join(REPO, "oryx_tpu_torch", "conf",
                             "als-example.conf"), encoding="utf-8").read()
    ports = [_free_port() for _ in range(3)]
    confs = []
    for j, port in enumerate(ports):
        conf = tmp_path / f"node{j}.conf"
        conf.write_text(
            base + f'\noryx.update-topic.broker = "{uri}"\n'
            f'oryx.input-topic.broker = "{uri}"\n'
            f"oryx.serving.api.port = {port}\n"
            "oryx.cluster.heartbeat-interval-ms = 100\n"
            f'oryx.compile-cache-dir = "{tmp_path / "cache"}"\n')
        confs.append(str(conf))
    topic = from_file(confs[0]).get_string("oryx.update-topic.message.topic")
    _publish(uri, topic)
    single = TorchLayer(from_file(confs[0]), port=0, device="cpu")
    env = dict(os.environ, PYTHONPATH=REPO)
    argvs = [["serving", "--shard", "0/2", "--conf", confs[0]],
             ["serving", "--shard", "1/2", "--conf", confs[1]],
             ["router", "--conf", confs[2]]]
    procs, logs = [], []
    try:
        for j, argv in enumerate(argvs):
            logs.append(tmp_path / f"node{j}.log")
            with open(logs[-1], "w", encoding="utf-8") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "oryx_tpu_torch", *argv,
                     "--device", "cpu"], cwd=REPO, env=env, stdout=log_f,
                    stderr=subprocess.STDOUT))
        single.start()

        def ready(p):
            try:
                return _get(p, "/ready")[0] in (200, 204)
            except OSError:
                return False

        def loaded(layer):
            model = layer.model_manager.get_model()
            return model is not None and model.get_fraction_loaded() >= 1.0

        def replayed():
            # the router is ready once both replicas cross the load
            # fraction; their heartbeats say when the replay is whole
            replicas = json.loads(_get(ports[2], "/metrics")[1])[
                "cluster"]["membership"]["replicas"].values()
            return len(replicas) == 2 and all(
                r["fraction"] >= 1.0 and r["live"] for r in replicas)

        _wait(lambda: all(p.poll() is None for p in procs)
              and ready(ports[2]), "the CLI's router")
        _wait(replayed, "the replicas' replay")
        _wait(lambda: loaded(single), "the single layer")
        for u in range(0, N_USERS, 3):
            path = f"/recommend/u{u}?howMany=7"
            got, want = (_get(p, path) for p in (ports[2], single.port))
            assert got[0] == want[0] == 200, (path, got)
            got = [(d["id"], d["value"]) for d in json.loads(got[1])]
            want = [(d["id"], d["value"]) for d in json.loads(want[1])]
            assert [i for i, _ in got] == [i for i, _ in want], path
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=1e-5)
        for proc, log in zip(procs, logs):
            proc.send_signal(signal.SIGINT)
            assert proc.wait(60) == 0, log.read_text()[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        single.close()
        _drop(broker_dir)
    assert "Router listening on port" in logs[2].read_text()
