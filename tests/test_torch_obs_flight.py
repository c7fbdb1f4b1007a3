"""The port's wide-event log (``oryx_tpu_torch/obs/events.py``), flight
recorder (``obs/flight.py``), diagnosis engine (``obs/diagnose.py``) and
freshness gauges (``obs/freshness.py``) against the reference's, on the
CPU, under the same injected clocks.

Event lines and flight bundles are equal field by field once the
fields that name the moment or the process are masked (the wall-clock
stamps, the pid, the trigger id that carries both, and the resilience
block, which lists each package's own process-wide retries and
breakers); the diagnosis is equal on the same surfaces."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JRegistry
from oryx_tpu.obs import events as jevents
from oryx_tpu.obs import flight as jflight
from oryx_tpu.obs import freshness as jfreshness
from oryx_tpu.obs.slo import SloEngine as JSloEngine
from oryx_tpu.obs.slo import SloObjective as JSloObjective
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka.api import KeyMessage as TKeyMessage
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TRegistry
from oryx_tpu_torch.obs import events as tevents
from oryx_tpu_torch.obs import flight as tflight
from oryx_tpu_torch.obs import freshness as tfreshness
from oryx_tpu_torch.obs.slo import SloEngine as TSloEngine
from oryx_tpu_torch.obs.slo import SloObjective as TSloObjective
from oryx_tpu_torch.resilience import faults as tfaults

# the packages re-export the function ``diagnose`` over the submodule
jdiagnose = importlib.import_module("oryx_tpu.obs.diagnose")
tdiagnose = importlib.import_module("oryx_tpu_torch.obs.diagnose")


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _spans(rng, trace_id: str) -> list[dict]:
    qw, dx = float(rng.exponential(2.0)), float(rng.exponential(4.0))
    return [{"name": "serving.request", "duration_ms": qw + dx + 0.5,
             "trace_id": trace_id, "status": "ok", "attrs": {}},
            {"name": "serving.queue_wait", "duration_ms": round(qw, 3),
             "trace_id": trace_id, "status": "ok", "attrs": {}},
            {"name": "serving.device_execute", "duration_ms": round(dx, 3),
             "trace_id": trace_id, "status": "ok",
             "attrs": {"batch_size": int(rng.integers(1, 64)),
                       "kernel_route": "i8+lsh"}},
            {"name": "router.shard_call", "duration_ms": 1.0,
             "trace_id": trace_id, "status": "error", "attrs": {}}]


def _requests(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for i in range(n):
        sampled = i % 3 == 0
        trace = f"{i:032x}" if sampled else None
        status = int(rng.choice([200, 200, 404, 500, 0]))
        yield ("GET /recommend/{userID}", status,
               float(rng.exponential(20.0)), trace,
               _spans(rng, trace) if sampled else None)


def _lines(directory: str) -> dict:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), encoding="utf-8") as f:
            lines = [json.loads(x) for x in f]
        for e in lines:
            e.pop("ts_ms")
        out[name] = lines
    return out


@pytest.mark.parametrize("max_bytes", [1 << 20, 600])
def test_event_lines_are_equal(tmp_path, max_bytes):
    logs = []
    for mod, name in ((jevents, "j"), (tevents, "t")):
        log = mod.WideEventLog(str(tmp_path / name), "serving",
                               max_bytes=max_bytes, max_files=3,
                               always_slow_ms=60,
                               static_fields={"speed_shard": "0/1"})
        log.context_fn = lambda: {"ann_index_fallbacks": 2}
        logs.append(log)
    for route, status, ms, trace, spans in _requests(0, 80):
        for log in logs:
            if log.should_emit(status, ms, trace is not None):
                log.emit(route, status, ms, trace, spans)
    for log in logs:
        log.close()
        log.emit("GET /late", 500, 1.0, None)  # after close: dropped
    jlog, tlog = logs
    assert (tlog.emitted, tlog.dropped) == (jlog.emitted, jlog.dropped)
    assert tlog.emitted > 0 and tlog.dropped == 1
    got, want = _lines(str(tmp_path / "t")), _lines(str(tmp_path / "j"))
    assert got == want
    assert set(tevents.FIELDS) >= {k for lines in got.values()
                                   for e in lines for k in e}


def test_event_disk_full_drops_the_line_alike(tmp_path):
    for mod, faults, registry in ((jevents, jfaults, JRegistry()),
                                  (tevents, tfaults, TRegistry())):
        log = mod.WideEventLog(str(tmp_path / mod.__name__), "serving",
                               registry=registry)
        faults.inject("obs-event-disk-full", mode="error", times=1)
        log.emit("GET /r", 500, 1.0, None)
        log.emit("GET /r", 500, 1.0, None)
        assert (log.emitted, log.dropped) == (1, 1)
        assert registry.counters_snapshot() == {"event_write_failures": 1}
        log.close()


def _masked_bundles(directory: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(directory)):
        assert not name.endswith(".tmp")
        with open(os.path.join(directory, name), encoding="utf-8") as f:
            bundle = json.load(f)
        for key in ("pid", "trigger_id", "resilience"):
            bundle.pop(key)
        out.append(bundle)
    return out


def _recorders(tmp_path, clock):
    out = []
    for mod, reg_cls, slo_obj, slo_eng, name in (
            (jflight, JRegistry, JSloObjective, JSloEngine, "j"),
            (tflight, TRegistry, TSloObjective, TSloEngine, "t")):
        registry = reg_cls()
        slo = slo_eng([slo_obj("availability", "availability", 0.99)],
                      registry, resolution_sec=1.0, clock=clock)
        diag = (jdiagnose if mod is jflight else tdiagnose).diagnose_bundle
        rec = mod.FlightRecorder(
            "serving", registry, dir=str(tmp_path / name), slo=slo,
            diagnose_fn=diag, ring_events=16, ring_spans=8, ring_ticks=4,
            tick_sec=2.0, debounce_sec=30.0, burst_errors=6,
            burst_window_sec=10.0, dump_on_exit=False, clock=clock,
            wall=clock)
        out.append((rec, registry, slo))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_bundles_are_equal(tmp_path, seed):
    clock = Clock()
    recs = _recorders(tmp_path, clock)
    try:
        results = ([], [])
        for i, (route, status, ms, trace, spans) in enumerate(
                _requests(seed, 120)):
            clock.t += 0.37
            for (rec, registry, slo), res in zip(recs, results):
                registry.record(route, status, ms / 1000.0, trace)
                registry.inc("mirror_link_failures", i % 2)
                registry.set_gauge("update_lag_records", i)
                rec.observe_request(route, status, ms, trace, spans)
                if i % 40 == 39:
                    slo.evaluate()
                    res.append(rec.trigger("manual", {"at": i}))
        for (rec, _, _), res in zip(recs, results):
            res.append(rec.trigger("slo-page", trigger_id="fan-1"))
            res.append(rec.trigger("slo-page", trigger_id="fan-1"))
        for res in results:
            for r in res:
                r.pop("trigger_id", None)
                r.pop("path", None)
        assert results[1] == results[0]
        got = _masked_bundles(str(tmp_path / "t"))
        assert got == _masked_bundles(str(tmp_path / "j"))
        assert got and set(got[0]) | {"pid", "trigger_id", "resilience"} \
            >= set(tflight.BUNDLE_FIELDS)
        assert any(b["trigger_reason"] == "error-burst" for b in got)
        jstatus, tstatus = (rec.status() for rec, _, _ in recs)
        for st in (jstatus, tstatus):
            st.pop("dir")
            st.pop("last_dump")
        assert tstatus == jstatus
    finally:
        for rec, _, _ in recs:
            rec.close()


def test_chaos_fault_is_a_trigger_alike(tmp_path):
    clock = Clock()
    recs = _recorders(tmp_path, clock)
    try:
        for faults in (jfaults, tfaults):
            faults.inject("speed-publish", mode="drop", times=1)
            assert faults.fire("speed-publish") == "drop"
        got = _masked_bundles(str(tmp_path / "t"))
        assert got == _masked_bundles(str(tmp_path / "j"))
        (bundle,) = got
        assert bundle["trigger_reason"] == "chaos-fault"
        assert bundle["trigger_detail"] == {"point": "speed-publish",
                                            "mode": "drop"}
    finally:
        for rec, _, _ in recs:
            rec.close()
    # a closed recorder no longer listens
    tfaults.inject("speed-publish", mode="drop", times=1)
    tfaults.fire("speed-publish")
    assert len(os.listdir(tmp_path / "t")) == 1


def test_dump_disk_full_discards_the_partial_bundle(tmp_path):
    clock = Clock()
    (jrec, jreg, _), (trec, treg, _) = _recorders(tmp_path, clock)
    try:
        for rec, faults in ((jrec, jfaults), (trec, tfaults)):
            faults.inject("flight-dump-disk-full", mode="error", times=1)
            out = rec.trigger("manual")
            assert out["dumped"] is False and out["path"] is None
        assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == []
        assert treg.counters_snapshot() == jreg.counters_snapshot() == \
            {"flight_dump_failures": 1}
    finally:
        jrec.close()
        trec.close()


def _surfaces(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(12):
        routes = {"GET /recommend/{userID}": {
            "count": int(rng.integers(0, 500)),
            "client_errors": int(rng.integers(0, 20)),
            "server_errors": int(rng.integers(0, 80))}}
        gauges = {name: float(rng.uniform(0, hi)) for name, hi in (
            ("device_busy_fraction", 1.0), ("update_lag_records", 5000),
            ("model_generation_age_sec", 9000),
            ("cross_region_staleness_ms", 20000),
            ("cluster_queue_wait_ms", 400),
            ("ann_index_fallbacks", 2), ("slice_load_fallbacks", 2),
            ("speed_checkpoint_age_sec", 900)) if rng.random() < 0.6}
        counters = {name: int(rng.integers(0, 50)) for name in (
            "mirror_link_failures", "ingest_sheds", "admission_rejects",
            "speed_shard_dedup_skips", "cache_stale_feed_stalls",
            "trace_record_failures", "event_write_failures",
            "flight_dump_failures", "slo_eval_failures")
            if rng.random() < 0.4}
        resilience = {"serving-input": {
            "kind": "breaker",
            "state": str(rng.choice(["closed", "open", "half_open"])),
            "opens": int(rng.integers(0, 4)), "rejected": 3, "calls": 9,
            "consecutive_failures": 2}}
        device = {"busy_fraction": gauges.get("device_busy_fraction", 0.2),
                  "by_route": [{"route_class": "serve",
                                "kernel_route": "i8", "generation": 1,
                                "device_s": 1.5, "share": 1.0}]}
        out.append({"counters": counters, "gauges": gauges,
                    "routes": routes, "resilience": resilience,
                    "device_time": device})
    return out


@pytest.mark.parametrize("seed", range(3))
def test_diagnoses_are_equal(seed):
    surfaces = _surfaces(seed)
    for s in surfaces:
        assert tdiagnose.diagnose(s) == jdiagnose.diagnose(s)
    merged = tdiagnose.merge_surfaces(surfaces)
    assert merged == jdiagnose.merge_surfaces(surfaces)
    assert tdiagnose.diagnose(merged) == jdiagnose.diagnose(merged)
    bundle = {**surfaces[0], "slo": None}
    assert tdiagnose.diagnose_bundle(bundle) == \
        jdiagnose.diagnose_bundle(bundle)
    assert [r.name for r in tdiagnose.RULES] == \
        [r.name for r in jdiagnose.RULES]
    assert tdiagnose.diagnose({}) == jdiagnose.diagnose({})


def test_freshness_gauges_are_equal():
    names = [f"memory://obs-fresh-{p}" for p in ("j", "t")]
    jb, tb = jinproc.resolve_broker(names[0]), tinproc.resolve_broker(
        names[1])
    for b in (jb, tb):
        b.create_topic("Up", 1)
        b.create_topic("In", 2)
        for i in range(7):
            b.send("Up", "MODEL" if i == 2 else "UP", f"m{i}")
        for i in range(9):
            b.send("In", None, f"u{i},i{i},1")
        b.set_offsets("G", "In", [2, 1])
    jtap, ttap = jfreshness.UpdateStreamTap(), tfreshness.UpdateStreamTap()
    assert ttap.model_age_sec() is None
    list(jtap.wrap(jb.consume("Up", from_beginning=True,
                              max_idle_sec=0.1)))
    list(ttap.wrap(tb.consume("Up", from_beginning=True,
                              max_idle_sec=0.1)))
    assert ttap.consumed == jtap.consumed == 7
    assert ttap.model_age_sec() >= 0.0
    assert tfreshness.topic_lag_fn(names[1], "Up", lambda: 3)() == \
        jfreshness.topic_lag_fn(names[0], "Up", lambda: 3)() == 4
    assert tfreshness.group_lag_fn(names[1], "In", "G")() == \
        jfreshness.group_lag_fn(names[0], "In", "G")()
    recs = [(None, "a", {"ts": "1700000000500"}), (None, "b", None),
            (None, "c", {"ts": "oops"}), (None, "d", {"ts": "1700000000100"})]
    assert tfreshness.oldest_ingest_ts_ms(
        [TKeyMessage(k, m, h) for k, m, h in recs]) == \
        jfreshness.oldest_ingest_ts_ms(
            [JKeyMessage(k, m, h) for k, m, h in recs]) == 1700000000100
    for name in names:
        (jinproc if name.endswith("j") else tinproc).drop_broker(name)
