"""The port's gauge-driven autoscaler (``oryx_tpu_torch/cluster/
autoscaler.py``) held against the reference's.

The same ``Signals`` sequences through both packages' ``Autoscaler.step``
give the same actions, streaks and gauges; ``from_config`` reads the
same values; ``_interval_p99`` works on the same bucket deltas (a
counter reset included); ``poll_signals`` parses the port router's
``/metrics`` as the reference's autoscaler does; and
``ProcessReplicaLauncher`` builds ``-m oryx_tpu_torch serving --shard
i/N`` with the caller's ``--device`` and passes no ``JAX_*`` variable."""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

from oryx_tpu.cluster import autoscaler as jauto
from oryx_tpu.common import config as jconfig
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JMetrics
from oryx_tpu_torch.cluster import autoscaler as tauto
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TMetrics
from oryx_tpu_torch.obs.prom import LATENCY_BUCKETS_MS

PKGS = {"ref": (jauto, jconfig, JMetrics), "port": (tauto, tconfig, TMetrics)}


def _launcher(mod):
    class FakeLauncher(mod.ReplicaLauncher):
        def __init__(self):
            self.log: list = []
            self._owned: dict = {}

        def spawn(self, shard, of):
            self._owned[(shard, of)] = self._owned.get((shard, of), 0) + 1
            self.log.append(("spawn", shard, of))
            return f"fake-{shard}of{of}-{len(self.log)}"

        def retire(self, shard, of):
            if self._owned.get((shard, of), 0) <= 0:
                return None
            self._owned[(shard, of)] -= 1
            self.log.append(("retire", shard, of))
            return f"fake-{shard}of{of}"

        def owned(self, of):
            return {s: n for (s, o), n in self._owned.items()
                    if o == of and n > 0}

    return FakeLauncher()


def _policy(mod, **kw):
    base = dict(p99_high_ms=500, p99_low_ms=50, queue_wait_high_ms=200,
                update_lag_high_records=100, slo_burn_high=2.0,
                scale_up_after=2, scale_down_after=3, cooldown_sec=10.0,
                min_replicas_per_shard=1, max_replicas_per_shard=3)
    base.update(kw)
    return mod.AutoscalePolicy(**base)


def _sig(mod, p99=None, qw=None, lag=None, burn=None, groups=None, of=2,
         ok=True):
    return mod.Signals(ok=ok, merged_of=of,
                       group_sizes=dict(groups or {0: 1, 1: 1}),
                       p99_ms=p99, queue_wait_ms=qw,
                       update_lag_records=lag, slo_burn_rate=burn)


# (now, signal fields) sequences: pressure streaks and the thinnest
# group, cooldown, blind polls, every pressure signal, calm and the
# owned-only scale-down with its live floor, the per-shard cap
SEQUENCES = {
    "p99_then_thinnest": [
        (0.0, dict(p99=800, groups={0: 2, 1: 1})),
        (1.0, dict(p99=800, groups={0: 2, 1: 1})),
        (2.0, dict(p99=800, groups={0: 2, 1: 2})),
        (5.0, dict(p99=900)), (11.5, dict(p99=900)),
        (12.5, dict(p99=900)), (13.5, dict(p99=900))],
    "one_bad_poll": [
        (0.0, dict(p99=800)), (1.0, dict(p99=30)), (2.0, dict(p99=800)),
        (3.0, dict(p99=120)), (4.0, dict(p99=800))],
    "blind_then_signals": [
        (0.0, dict(qw=450)), (1.0, dict(ok=False, qw=450)),
        (2.0, dict(qw=450)), (3.0, dict(lag=500)), (4.0, dict(lag=500)),
        (20.0, dict(burn=3.5)), (21.0, dict(burn=3.5)),
        (40.0, dict(burn=1.0, p99=600)), (41.0, dict(p99=600))],
    "calm_retires_owned_only": [
        (0.0, dict(p99=800)), (1.0, dict(p99=800)),
        (20.0, dict(p99=None, groups={0: 2, 1: 1})),
        (21.0, dict(p99=10, groups={0: 2, 1: 1})),
        (22.0, dict(p99=None, groups={0: 2, 1: 1})),
        (40.0, dict(p99=None, groups={0: 1, 1: 1})),
        (41.0, dict(p99=None, groups={0: 1, 1: 1})),
        (42.0, dict(p99=None, groups={0: 1, 1: 1})),
        (43.0, dict(p99=None, groups={0: 1, 1: 1}))],
    "cap_per_shard": [
        (0.0, dict(p99=800, groups={0: 3, 1: 3})),
        (1.0, dict(p99=800, groups={0: 3, 1: 3})),
        (2.0, dict(p99=800, groups={0: 3, 1: 2})),
        (3.0, dict(p99=800, groups={0: 3, 1: 2}))],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_signals_give_same_actions_and_gauges(name):
    out = {}
    for pkg, (mod, _, metrics_cls) in PKGS.items():
        metrics = metrics_cls()
        scaler = mod.Autoscaler(_policy(mod), _launcher(mod), "http://r/",
                                metrics=metrics)
        steps = []
        for now, fields in SEQUENCES[name]:
            action = scaler.step(_sig(mod, **fields), now=now)
            steps.append((action, scaler.up_streak, scaler.down_streak,
                          scaler.cooldown_until,
                          metrics.gauges_snapshot()))
        out[pkg] = (steps, scaler.launcher.log, scaler.actions)
    assert out["port"] == out["ref"]
    # one slow poll between calm ones never scales; every other
    # sequence acts
    assert any(a is not None for a, *_ in out["port"][0]) \
        == (name != "one_bad_poll")


@pytest.mark.parametrize("overlay", [
    {},
    {"oryx.cluster.autoscale.p99-high-ms": 250,
     "oryx.cluster.autoscale.p99-low-ms": 0,
     "oryx.cluster.autoscale.queue-wait-high-ms": 80,
     "oryx.cluster.autoscale.update-lag-high-records": 400,
     "oryx.cluster.autoscale.slo-burn-high": 6.5,
     "oryx.cluster.autoscale.scale-up-after": 0,
     "oryx.cluster.autoscale.scale-down-after": 5,
     "oryx.cluster.autoscale.cooldown-ms": 2500,
     "oryx.cluster.autoscale.min-replicas-per-shard": 0,
     "oryx.cluster.autoscale.max-replicas-per-shard": 6},
])
def test_from_config_reads_the_same_values(overlay):
    got = [vars(mod.AutoscalePolicy.from_config(config.from_dict(overlay)))
           for mod, config, _ in PKGS.values()]
    assert got[0] == got[1]


def _prom(buckets):
    return {"routes": {
        "GET /recommend/{userID}": {"latency_ms": {"buckets": buckets}},
        "GET /metrics": {"latency_ms": {"buckets": [9] * len(buckets)}}}}


def test_interval_p99_on_bucket_deltas_and_counter_resets():
    n = len(LATENCY_BUCKETS_MS) + 1
    polls = [[0] * n, [5] * n, [5] * n, [3] * n, [4] * n,
             [4] * (n - 1) + [90]]
    out = []
    for mod, _, metrics_cls in PKGS.values():
        metrics = metrics_cls()
        scaler = mod.Autoscaler(_policy(mod), _launcher(mod), "http://r",
                                metrics=metrics)
        out.append(([scaler._interval_p99(_prom(b)) for b in polls],
                    scaler.counter_resets, metrics.counters_snapshot()))
    assert out[0] == out[1]
    p99s, resets, _ = out[1]
    assert p99s[0] is None and p99s[2] is None and p99s[3] is None
    assert resets == 1


class _FakeReplica(http.server.BaseHTTPRequestHandler):
    """A replica's ``/metrics``: its update-topic lag."""

    def do_GET(self):
        body = json.dumps({"freshness": {"update_lag_records": 7}}
                          if self.path == "/metrics" else
                          {"routes": {}, "counters": {}}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_poll_signals_parses_the_port_routers_metrics():
    """A port router (CPU) whose membership holds one fake replica:
    both packages' ``poll_signals`` read the same signals off it."""
    from oryx_tpu_torch.cluster.membership import Heartbeat
    from oryx_tpu_torch.cluster.router import RouterLayer
    from oryx_tpu_torch.kafka.inproc import get_broker
    name = f"tas-{uuid.uuid4().hex[:8]}"
    replica = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeReplica)
    threading.Thread(target=replica.serve_forever, daemon=True).start()
    router = RouterLayer(tconfig.from_dict({
        "oryx.update-topic.broker": f"memory://{name}",
        "oryx.input-topic.broker": f"memory://{name}",
        "oryx.cluster.heartbeat-ttl-ms": 60000}), port=0, device="cpu")
    router.start()
    stop = threading.Event()

    def beat():
        hb = Heartbeat(replica="fake-0", shard=0, of=1,
                       url=f"http://127.0.0.1:{replica.server_address[1]}",
                       generation=1, ready=True, fraction=1.0)
        while not stop.is_set():
            get_broker(name).send("OryxUpdate", "HB", hb.to_json())
            stop.wait(0.1)

    beater = threading.Thread(target=beat, daemon=True)
    beater.start()
    url = f"http://127.0.0.1:{router.port}"
    try:
        scalers = {pkg: mod.Autoscaler(_policy(mod), _launcher(mod), url)
                   for pkg, (mod, _, _) in PKGS.items()}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if scalers["port"].poll_signals().merged_of == 1:
                break
            time.sleep(0.1)
        first = {pkg: vars(s.poll_signals()) for pkg, s in scalers.items()}
        # data-plane traffic between the polls: the router answers
        # without a real shard, and every answer lands in its buckets
        for u in range(5):
            try:
                urllib.request.urlopen(f"{url}/recommend/u{u}", timeout=10)
            except urllib.error.HTTPError:
                pass
        second = {pkg: vars(s.poll_signals()) for pkg, s in scalers.items()}
    finally:
        stop.set()
        beater.join(5)
        router.close()
        replica.shutdown()
    assert first["port"] == first["ref"]
    assert second["port"] == second["ref"]
    assert first["port"]["ok"] and first["port"]["merged_of"] == 1
    assert first["port"]["group_sizes"] == {0: 1}
    assert first["port"]["update_lag_records"] == 7.0
    assert first["port"]["p99_ms"] is None
    assert second["port"]["p99_ms"] is not None


@pytest.mark.parametrize("device, flag", [(None, []),
                                          ("cpu", ["--device", "cpu"])])
def test_launcher_spawns_port_members_with_the_callers_device(
        tmp_path, monkeypatch, device, flag):
    """The member's command line and environment, with the process
    start faked: ``-m oryx_tpu_torch serving --shard i/N``, the caller's
    device, the member conf's keys, and no ``JAX_*`` variable."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    seen = []

    class FakeProcess:
        def __init__(self, argv, log_path, env):
            seen.append((argv, env))
            self.stopped = threading.Event()

        def start(self):
            pass

        def await_(self):
            self.stopped.wait(10)

        def close(self):
            self.stopped.set()

    monkeypatch.setattr(tauto, "_MemberProcess", FakeProcess)
    launcher = tauto.ProcessReplicaLauncher(
        tconfig.from_dict({}), "base = 1\n", str(tmp_path), python="py",
        device=device)
    try:
        member = launcher.spawn(1, 2)
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert launcher.owned(2) == {1: 1}
    finally:
        launcher.close()
    argv, env = seen[0]
    conf = str(tmp_path / f"{member}.conf")
    assert argv == ["py", "-m", "oryx_tpu_torch", "serving", "--shard",
                    "1/2", "--conf", conf, *flag]
    assert not [k for k in env if k.startswith("JAX_")]
    text = open(conf, encoding="utf-8").read()
    assert text.startswith("base = 1\n")
    for line in ('oryx.cluster.shard = "1/2"',
                 f'oryx.cluster.replica-id = "{member}"',
                 "oryx.serving.api.port = 0"):
        assert line in text
    assert launcher.owned(2) == {}
    assert os.path.exists(conf)
