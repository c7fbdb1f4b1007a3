"""The port's Prometheus exposition (``oryx_tpu_torch/obs/prom.py``) and
metrics registry (``lambda_rt/metrics.py``) against the reference's, on
the CPU: the same seeded observations give equal histogram snapshots,
quantiles and merges, and byte-equal Prometheus 0.0.4 and OpenMetrics
text.  Both packages' clocks are pinned to one ManualClock start, so
exemplar stamps agree."""

from __future__ import annotations

import numpy as np
import pytest

from oryx_tpu.common import clock as jclock
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JRegistry
from oryx_tpu.obs import prom as jprom
from oryx_tpu_torch.common import clock as tclock
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TRegistry
from oryx_tpu_torch.obs import prom as tprom

ROUTES = ("GET /recommend/{userID}", "GET /similarity/{itemID:+}",
          "POST /pref/{userID}/{itemID}", "unmatched")


@pytest.fixture
def clocks():
    """Both packages on one frozen clock (exemplar stamps read it)."""
    with jclock.installed(jclock.ManualClock(1000.0, 1.7e9)) as jc, \
            tclock.installed(tclock.ManualClock(1000.0, 1.7e9)) as tc:
        yield jc, tc


def _latencies(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # a lognormal body with a tail past the last bound (+Inf bucket)
    ms = rng.lognormal(mean=2.5, sigma=1.4, size=n)
    ms[rng.integers(0, n, max(1, n // 50))] = 20_000.0
    return ms


def _trace_id(rng) -> str:
    return f"{int(rng.integers(1, 2**62)):032x}"


def _feed(registry, seed: int, n: int = 600) -> None:
    """The same seeded request stream into a registry: routes, statuses,
    latencies, a sampled trace id on every 7th request, counters and a
    set gauge."""
    rng = np.random.default_rng(seed)
    ms = _latencies(seed, n)
    statuses = rng.choice([200, 200, 200, 204, 404, 503, 0], size=n)
    for i in range(n):
        trace = _trace_id(rng) if i % 7 == 0 else None
        registry.record(ROUTES[i % len(ROUTES)], int(statuses[i]),
                        float(ms[i]) / 1000.0, trace_id=trace)
    registry.inc("partial_answers", int(rng.integers(1, 9)))
    registry.inc("device_time_us_serve_i8", 12345)
    registry.set_gauge("update_lag_records", int(rng.integers(0, 50)))
    registry.set_gauge("model_generation_age_sec", 12.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_snapshots_are_equal(clocks, seed):
    jh, th = jprom.Histogram(), tprom.Histogram()
    rng = np.random.default_rng(seed + 100)
    for v in _latencies(seed, 400):
        trace = _trace_id(rng) if rng.random() < 0.1 else None
        jh.observe(float(v), trace)
        th.observe(float(v), trace)
    assert th.snapshot() == jh.snapshot()
    assert tprom.LATENCY_BUCKETS_MS == jprom.LATENCY_BUCKETS_MS


@pytest.mark.parametrize("seed", range(4))
def test_bucket_quantiles_are_equal(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, len(jprom.LATENCY_BUCKETS_MS) + 1)
    counts[rng.integers(0, len(counts), 3)] = 0
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 0.999):
        assert tprom.bucket_quantile(counts, q) == \
            jprom.bucket_quantile(counts, q)
    zero = [0] * len(counts)
    assert tprom.bucket_quantile(zero, 0.5) is None
    assert jprom.bucket_quantile(zero, 0.5) is None


def test_merges_are_equal(clocks):
    jc, tc = clocks
    jregs, tregs = [], []
    for seed in range(3):
        jr, tr = JRegistry(), TRegistry()
        _feed(jr, seed)
        _feed(tr, seed)
        jregs.append(jr)
        tregs.append(tr)
        jc.advance(1.0)
        tc.advance(1.0)
    jsnaps = [r.prometheus_snapshot() for r in jregs]
    tsnaps = [r.prometheus_snapshot() for r in tregs]
    assert tsnaps == jsnaps
    hists = [s["routes"][ROUTES[0]]["latency_ms"] for s in tsnaps]
    assert tprom.merge_histograms(hists) == jprom.merge_histograms(hists)
    assert tprom.merge_snapshots(tsnaps) == jprom.merge_snapshots(jsnaps)


@pytest.mark.parametrize("seed", [3, 4])
def test_exposition_bytes_are_equal(clocks, seed):
    jr, tr = JRegistry(), TRegistry()
    _feed(jr, seed)
    _feed(tr, seed)
    js, ts = jr.prometheus_snapshot(), tr.prometheus_snapshot()
    assert ts == js
    labels = {"tier": "replica", "shard": '0/"1"'}
    assert tprom.render_prometheus(ts) == jprom.render_prometheus(js)
    assert tprom.render_prometheus(ts, labels) == \
        jprom.render_prometheus(js, labels)
    om = tprom.render_openmetrics(ts)
    assert om == jprom.render_openmetrics(js)
    assert om.endswith("# EOF\n") and ' # {trace_id="' in om
    blocks = [(ts, {"tier": "router"}), (ts, {"tier": "replica"})]
    jblocks = [(js, {"tier": "router"}), (js, {"tier": "replica"})]
    assert tprom.render_prometheus_blocks(blocks) == \
        jprom.render_prometheus_blocks(jblocks)
    assert tprom.render_openmetrics_blocks(blocks) == \
        jprom.render_openmetrics_blocks(jblocks)


def test_registry_views_are_equal(clocks):
    jr, tr = JRegistry(), TRegistry()
    _feed(jr, 9, n=300)
    _feed(tr, 9, n=300)
    jr.gauge_fn("flaky", lambda: 1 / 0)
    tr.gauge_fn("flaky", lambda: 1 / 0)
    assert tr.snapshot() == jr.snapshot()
    assert tr.counters_snapshot() == jr.counters_snapshot()
    assert tr.gauges_snapshot() == jr.gauges_snapshot()
    assert tr.gauges_snapshot()["flaky"] is None
    assert tr.gauge_value("model_generation_age_sec") == 12.5
    assert tr.prometheus_snapshot(gauges=False) == \
        jr.prometheus_snapshot(gauges=False)
    route = tr.snapshot()[ROUTES[0]]
    assert route["errors"] == route["client_errors"] + \
        route["server_errors"]


def test_reservoir_wraps_alike(clocks):
    jr, tr = JRegistry(), TRegistry()
    ms = _latencies(5, 9000)
    for v in ms:
        jr.record("GET /r", 200, float(v) / 1000.0)
        tr.record("GET /r", 200, float(v) / 1000.0)
    assert tr.snapshot() == jr.snapshot()
