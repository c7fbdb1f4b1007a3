"""The port's SLO engine (``oryx_tpu_torch/obs/slo.py``) and
device-time accountant (``obs/device_time.py``) against the
reference's, on the CPU, under the same injected clock.

The same seeded request stream, fed over simulated hours (5 min to 6 h
windows, no sleeps), gives the same burn rates, alert states,
transitions, page callbacks and gauges; the accountant gives the same
counters, busy fraction and snapshot."""

from __future__ import annotations

import numpy as np
import pytest

from oryx_tpu.common.config import from_dict as jfrom_dict
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JRegistry
from oryx_tpu.obs import device_time as jdevice_time
from oryx_tpu.obs import slo as jslo
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.common.config import from_dict as tfrom_dict
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TRegistry
from oryx_tpu_torch.obs import device_time as tdevice_time
from oryx_tpu_torch.obs import slo as tslo
from oryx_tpu_torch.resilience import faults as tfaults

OBJECTIVES = {
    "availability": {"kind": "availability", "target": 0.999},
    "latency": {"kind": "latency", "target": 0.99, "threshold-ms": 50},
    "recommend": {"kind": "availability", "target": 0.99,
                  "route-prefix": "GET /recommend"},
    "lag": {"kind": "gauge", "target": 0.9, "gauge": "update_lag_records",
            "max-value": 10}}


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class Clock:
    def __init__(self, t: float = 5000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _engines(clock, **cfg):
    base = {"oryx.obs.slo.enabled": True,
            "oryx.obs.slo.objectives": OBJECTIVES,
            "oryx.obs.slo.resolution-sec": 15, **cfg}
    out = []
    for from_dict, registry, slo in ((jfrom_dict, JRegistry(), jslo),
                                     (tfrom_dict, TRegistry(), tslo)):
        engine = slo.engine_from_config(from_dict(base), registry)
        engine._clock = clock
        pages = []
        engine.on_page = lambda name, st, pages=pages: pages.append(
            (name, st["state"], st["fast_burn"]))
        out.append((engine, registry, pages))
    return out


def _traffic(registries, rng, n: int, bad_rate: float, slow_rate: float,
             lag: int) -> None:
    routes = ("GET /recommend/{userID}", "GET /similarity/{itemID:+}",
              "GET /metrics")
    for _ in range(n):
        route = routes[int(rng.integers(0, len(routes)))]
        status = 503 if rng.random() < bad_rate else 200
        ms = 400.0 if rng.random() < slow_rate else float(
            rng.uniform(1.0, 40.0))
        for r in registries:
            r.record(route, status, ms / 1000.0)
    for r in registries:
        r.set_gauge("update_lag_records", lag)


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_rates_and_alert_states_are_equal(seed):
    clock = Clock()
    (je, jr, jpages), (te, tr, tpages) = _engines(clock)
    rng = np.random.default_rng(seed)
    # a quiet hour, a 30-minute incident, then six hours of recovery, in
    # one-minute steps: every window and both alert kinds move
    phases = [(60, 0.0005, 0.002, 2), (30, 0.2, 0.3, 40),
              (360, 0.0005, 0.002, 2)]
    states = set()
    for minutes, bad, slow, lag in phases:
        for _ in range(minutes):
            _traffic([jr, tr], rng, 40, bad, slow, lag)
            clock.t += 60.0
            got, want = te.status(), je.status()
            assert got == want
            states |= {o["state"] for o in got["objectives"].values()}
            assert te.burn_gauge() == je.burn_gauge()
            assert te.budget_gauge() == je.budget_gauge()
    assert {"page", "ok"} <= states
    assert tpages == jpages and tpages
    assert te.last_status() == je.last_status()


def test_evaluation_is_rate_limited_and_failures_freeze_alike():
    clock = Clock()
    (je, jr, _), (te, tr, _) = _engines(clock)
    rng = np.random.default_rng(3)
    _traffic([jr, tr], rng, 50, 0.1, 0.1, 3)
    clock.t += 60.0
    first = te.evaluate()
    je.evaluate()
    _traffic([jr, tr], rng, 50, 0.5, 0.1, 3)
    clock.t += 5.0  # inside resolution-sec: the same status comes back
    assert te.evaluate() is first
    assert je.evaluate() == first
    clock.t += 60.0
    jfaults.inject("obs-slo-eval-error", mode="error", times=1)
    tfaults.inject("obs-slo-eval-error", mode="error", times=1)
    assert te.status() == je.status()
    assert te.eval_failures == je.eval_failures == 1
    assert tr.counters_snapshot() == jr.counters_snapshot() == \
        {"slo_eval_failures": 1}


@pytest.mark.parametrize("bad", [
    {"kind": "latency", "target": 0.99, "threshold-ms": 42},
    {"kind": "nope", "target": 0.99},
    {"kind": "availability", "target": 1.5},
    {"kind": "gauge", "target": 0.9, "gauge": "slo_burn_rate"}])
def test_bad_objectives_raise_alike(bad):
    cfg = {"oryx.obs.slo.enabled": True,
           "oryx.obs.slo.objectives": {"x": bad}}
    with pytest.raises(ValueError):
        jslo.engine_from_config(jfrom_dict(cfg), JRegistry())
    with pytest.raises(ValueError):
        tslo.engine_from_config(tfrom_dict(cfg), TRegistry())


def test_disabled_engine_is_none_alike():
    assert tslo.engine_from_config(tfrom_dict({}), TRegistry()) is None
    assert jslo.engine_from_config(jfrom_dict({}), JRegistry()) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_device_time_accountants_are_equal(seed):
    clock = Clock(100.0)
    jr, tr = JRegistry(), TRegistry()
    ja = jdevice_time.DeviceTimeAccountant(jr, clock=clock)
    ta = tdevice_time.DeviceTimeAccountant(tr, clock=clock)
    rng = np.random.default_rng(seed)
    routes = ("i8", "i8+lsh", "pallas", None, "i8_fold")
    for _ in range(300):
        clock.t += float(rng.exponential(0.5))
        cls = "serve" if rng.random() < 0.9 else "measure"
        kr = routes[int(rng.integers(0, len(routes)))]
        gen = int(rng.integers(1, 3))
        sec = float(rng.exponential(0.05))
        ja.note(cls, kr, gen, sec)
        ta.note(cls, kr, gen, sec)
    for junk in (float("nan"), float("inf"), -1.0, "x", None):
        ja.note("serve", "i8", 1, junk)
        ta.note("serve", "i8", 1, junk)
    assert ta.snapshot() == ja.snapshot()
    assert tr.counters_snapshot() == jr.counters_snapshot()
    assert "device_time_us_serve_i8_lsh" in tr.counters_snapshot()
    frac = tr.gauges_snapshot()["device_busy_fraction"]
    assert frac == jr.gauges_snapshot()["device_busy_fraction"]
    assert 0.0 < frac <= 1.0
    # the window slides on the next note: after an idle minute only the
    # new interval is in it
    clock.t += 61.0
    ja.note("serve", "i8", 1, 0.5)
    ta.note("serve", "i8", 1, 0.5)
    assert ta.busy_fraction() == ja.busy_fraction()
    assert ta.snapshot() == ja.snapshot()


def test_process_accountant_hook():
    acct = tdevice_time.DeviceTimeAccountant()
    prev = tdevice_time.process_accountant()
    try:
        assert tdevice_time.install_process_accountant(acct) is acct
        assert tdevice_time.process_accountant() is acct
    finally:
        tdevice_time.install_process_accountant(prev)
