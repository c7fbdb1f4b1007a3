"""The port's observability hooks against the reference's, on the CPU:
the batcher's queue-wait/device-execute spans, serve-class device-time
booking and ``serving-scan-dispatch`` chaos point; the named resilience
counters; the fault-fire listeners; the clock seam; the profiler lock
shared by ``/admin/profile`` and the batch tier's generation trace; a
sampled ``/pref`` followed to the speed layer's ``speed.fold_in`` span;
and the hot-path overhead bench's report."""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from oryx_tpu.bench import obs_overhead as jobs_overhead
from oryx_tpu.obs import trace as jtrace
from oryx_tpu.obs.device_time import DeviceTimeAccountant as JAccountant
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu.resilience import policy as jpolicy
from oryx_tpu.serving.batcher import TopNBatcher as JBatcher
from oryx_tpu_torch.bench import obs_overhead as tobs_overhead
from oryx_tpu_torch.common import clock as tclock
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt.http import Request
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry
from oryx_tpu_torch.lambda_rt.serving import ServingLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.ml import mlupdate
from oryx_tpu_torch.obs import profile as tprofile
from oryx_tpu_torch.obs import trace as ttrace
from oryx_tpu_torch.obs.device_time import DeviceTimeAccountant as TAccountant
from oryx_tpu_torch.obs.server import ObsServer
from oryx_tpu_torch.resilience import faults as tfaults
from oryx_tpu_torch.resilience import policy as tpolicy
from oryx_tpu_torch.serving import framework
from oryx_tpu_torch.serving.batcher import TopNBatcher as TBatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class FakeModel:
    """A model whose batched top-N is a fixed function of the query,
    with the route label and generation the batcher books against."""

    kernel_route_label = "i8+lsh"
    generation = 3

    def top_n_batch(self, how_many, vectors, exclude):
        time.sleep(0.002)
        return [[(f"i{int(v[0])}", float(v[0]))] for v in vectors]


def _drive(batcher_cls, tracer_mod, accountant_cls, n: int = 12):
    tracer = tracer_mod.Tracer("serving", sample_ratio=1.0, max_traces=64)
    acct = accountant_cls()
    batcher = batcher_cls(max_batch=64, pipeline=2, idle_wait_s=0.01,
                          tracer=tracer, accountant=acct)
    model = FakeModel()
    results = [None] * n

    def one(i):
        span = tracer.begin_request("serving.request")
        try:
            results[i] = batcher.top_n(model, 1,
                                       np.array([i, 0.0], np.float32))
        finally:
            tracer.end_request(span, status=200, route="GET /r")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    return tracer, acct, batcher, results


def _span_set(tracer) -> list[tuple]:
    out = []
    for trace in tracer.traces_snapshot(limit=256).values():
        by_id = {s["span_id"]: s["name"] for s in trace}
        out.append(tuple(sorted(
            (s["name"], by_id.get(s["parent_id"]), s["status"],
             tuple(sorted(k for k in s["attrs"] if k != "batch_size")))
            for s in trace)))
    return sorted(out)


def test_batcher_spans_and_booking_match_the_reference():
    jt, ja, jb, jres = _drive(JBatcher, jtrace, JAccountant)
    tt, ta, tb, tres = _drive(TBatcher, ttrace, TAccountant)
    assert tres == jres
    assert _span_set(tt) == _span_set(jt)
    for trace in tt.traces_snapshot().values():
        (ex,) = [s for s in trace if s["name"] == "serving.device_execute"]
        assert ex["attrs"]["kernel_route"] == "i8+lsh"
        assert 1 <= ex["attrs"]["batch_size"] <= 12
    for acct in (ja, ta):
        (row,) = acct.snapshot()["by_route"]
        assert (row["route_class"], row["kernel_route"],
                row["generation"]) == ("serve", "i8_lsh", 3)
        assert row["device_s"] >= 0.002
    assert set(tb.stats()) == set(jb.stats())


def test_scan_dispatch_chaos_fails_the_drain_per_job_alike():
    for batcher_cls, faults in ((JBatcher, jfaults), (TBatcher, tfaults)):
        batcher = batcher_cls(max_batch=8, pipeline=1, idle_wait_s=0.0)
        faults.inject("serving-scan-dispatch", mode="error", times=1)
        with pytest.raises(faults.InjectedFault):
            batcher.top_n(FakeModel(), 1, np.array([1.0, 0.0], np.float32))
        # the dispatcher survived: the next request is answered
        assert batcher.top_n(FakeModel(), 1,
                             np.array([2.0, 0.0], np.float32)) == \
            [("i2", 2.0)]
        assert faults.fired("serving-scan-dispatch") == 1
        batcher.close()


def test_resilience_snapshots_match():
    def run(policy, faults, tag):
        retry = policy.Retry(f"obs-retry-{tag}", max_attempts=3,
                             backoff=policy.Backoff(initial=0.0,
                                                    maximum=0.0))
        calls = iter([faults.InjectedFault("x"), faults.InjectedFault("x"),
                      None, faults.InjectedFault("y"),
                      faults.InjectedFault("y"), faults.InjectedFault("y")])

        def flaky():
            e = next(calls)
            if e is not None:
                raise e
            return 1

        retry.call(flaky)
        with pytest.raises(faults.InjectedFault):
            retry.call(flaky)
        breaker = policy.CircuitBreaker(f"obs-breaker-{tag}",
                                        failure_threshold=2)
        for _ in range(2):
            with pytest.raises(ValueError):
                breaker.call(lambda: (_ for _ in ()).throw(ValueError()))
        with pytest.raises(policy.CircuitOpenError):
            breaker.call(lambda: 1)
        snap = policy.resilience_snapshot()
        return retry, breaker, {snap[f"obs-retry-{tag}"]["kind"]:
                                snap[f"obs-retry-{tag}"],
                                "breaker": snap[f"obs-breaker-{tag}"]}

    *_, jsnap = run(jpolicy, jfaults, "j")
    *_, tsnap = run(tpolicy, tfaults, "t")
    assert tsnap == jsnap
    assert tsnap["breaker"]["state"] == "open"
    assert tsnap["retry"]["retries"] == 4 and tsnap["retry"]["give_ups"] == 1


def test_fault_listeners_see_each_activation():
    seen = []

    def listener(point, mode):
        seen.append((point, mode))

    def raising(point, mode):
        raise RuntimeError("observers never alter the seam")

    tfaults.add_fire_listener(listener)
    tfaults.add_fire_listener(raising)
    try:
        tfaults.inject("speed-publish", mode="drop", times=2)
        assert tfaults.fire("speed-publish") == "drop"
        assert tfaults.fire("speed-publish") == "drop"
        assert tfaults.fire("speed-publish") is None
    finally:
        tfaults.remove_fire_listener(listener)
        tfaults.remove_fire_listener(raising)
    tfaults.inject("speed-publish", mode="drop", times=1)
    tfaults.fire("speed-publish")
    assert seen == [("speed-publish", "drop")] * 2


def test_manual_clock_moves_only_when_advanced():
    with tclock.installed(tclock.ManualClock(10.0, 100.0)) as mc:
        assert (tclock.monotonic(), tclock.now()) == (10.0, 100.0)
        woke = threading.Event()

        def sleeper():
            tclock.sleep(5.0)
            woke.set()

        t = threading.Thread(target=sleeper)
        t.start()
        assert not woke.wait(0.1)
        mc.advance(5.0)
        assert woke.wait(5.0)
        t.join()
        ev = threading.Event()
        assert tclock.wait(ev, 0.0) is False
        ev.set()
        assert tclock.wait(ev, 100.0) is True
        with pytest.raises(ValueError):
            mc.advance(-1.0)
    assert tclock.get() is tclock.SYSTEM


def test_profile_lock_is_shared_with_the_generation_trace(tmp_path):
    entered, release = threading.Event(), threading.Event()

    def generation():
        with mlupdate._profile(str(tmp_path)):
            entered.set()
            release.wait(10.0)

    t = threading.Thread(target=generation)
    t.start()
    try:
        assert entered.wait(30.0)
        with pytest.raises(tprofile.ProfileBusyError):
            tprofile.capture_profile(str(tmp_path / "admin"), 10)
    finally:
        release.set()
        t.join(30.0)
    assert os.path.exists(tmp_path / "trace.json")
    out = tprofile.capture_profile(str(tmp_path / "admin"), 10)
    assert os.path.exists(out["trace_file"])


def test_profile_slow_seam_stretches_only_the_capture(tmp_path,
                                                     monkeypatch):
    tfaults.inject("obs-profile-slow", mode="delay", times=1,
                   delay_sec=0.2)
    out = tprofile.capture_profile(str(tmp_path), 10)
    assert out["captured_ms"] >= 200.0
    assert out["requested_ms"] == 10
    # the window is capped at the reference's ceiling
    slept = []
    monkeypatch.setattr(tprofile.clockmod, "sleep", slept.append)
    out = tprofile.capture_profile(str(tmp_path), 10_000_000)
    assert out["requested_ms"] == tprofile._MAX_CAPTURE_MS == 60_000
    assert slept == [60.0]


def test_side_door_refuses_digest_credentials_by_name():
    """With DIGEST credentials the side door refuses a request that
    does not carry them (401 and a challenge), as the main serving port
    does; tests/test_torch_http_auth.py answers the challenge."""
    cfg = tconfig.from_dict({"oryx.obs.metrics-port": 0,
                             "oryx.serving.api.user-name": "oryx",
                             "oryx.serving.api.password": "pw"})
    side = ObsServer(cfg, MetricsRegistry(), None)
    assert side.app.user_name == "oryx" and side.app.password == "pw"
    side.start()
    try:
        status, _, headers = _http(side.port, "GET", "/metrics")
        assert status == 401
        assert headers["WWW-Authenticate"].startswith('Digest realm="Oryx"')
    finally:
        side.close()
    # no side door, nothing to guard
    off = tconfig.from_dict({"oryx.serving.api.user-name": "oryx"})
    assert not ObsServer(off, None, None).enabled


def _http(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def test_sampled_pref_reaches_the_speed_fold_in_span(tmp_path):
    """A ``/pref`` sent with a sampled ``traceparent`` carries the trace
    into its input record's headers, and the speed layer's micro-batch
    records a ``speed.fold_in`` span under the same trace id, served on
    its side door's ``/admin/traces``."""
    broker = f"file://{tmp_path}/broker"
    base = tconfig.overlay_on(
        {"oryx.update-topic.broker": broker,
         "oryx.input-topic.broker": broker,
         "oryx.obs.tracing.enabled": True,
         "oryx.obs.tracing.sample-ratio": 0.0,
         "oryx.batch.storage.data-dir": str(tmp_path / "data"),
         "oryx.batch.storage.model-dir": str(tmp_path / "model"),
         "oryx.speed.streaming.generation-interval-sec": 3600},
        tconfig.from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                                       "als-example.conf")))
    trace_id, parent = "c" * 32, "d" * 16
    serving = ServingLayer(base, port=0, device="cpu")
    speed = SpeedLayer(tconfig.overlay_on({"oryx.obs.metrics-port": 0},
                                          base), device="cpu")
    with serving:
        speed.start()
        try:
            # no model is loaded, so /pref would answer 503: call the
            # write path it ends in inside a request span continued from
            # a sampled traceparent, as the dispatcher opens it
            span = serving.tracer.begin_request(
                "serving.request", f"00-{trace_id}-{parent}-01")
            try:
                framework.send_input(
                    Request("POST", "/pref/u1/i2", {}, {}, b"", {},
                            serving.app.context), "u1,i2,1.0")
            finally:
                serving.tracer.end_request(span, status=202)
            topic = base.get_string("oryx.input-topic.message.topic")
            records = []
            for name in os.listdir(tmp_path / "broker"):
                if name.startswith(topic) and name.endswith(".jsonl"):
                    with open(tmp_path / "broker" / name,
                              encoding="utf-8") as f:
                        records += [json.loads(x) for x in f]
            (rec,) = records
            tp = ttrace.parse_traceparent(rec[2]["traceparent"])
            assert tp[0] == trace_id and tp[2] is True
            speed.run_one_micro_batch()
            status, body, _ = _http(speed.obs_server.port, "GET",
                                    "/admin/traces")
            assert status == 200
            spans = json.loads(body)["traces"][trace_id]
            (fold,) = [s for s in spans if s["name"] == "speed.fold_in"]
            assert fold["parent_id"] == tp[1]
            assert fold["attrs"]["batch_records"] == 1
            status, body, _ = _http(speed.obs_server.port, "GET",
                                    "/metrics")
            fresh = json.loads(body)["freshness"]
            assert fresh["micro_batch_records"] == 1
            assert fresh["ingest_to_servable_ms"] >= 0
        finally:
            speed.close()


def test_overhead_bench_reports_the_reference_cells():
    tout = tobs_overhead.run_bench(iterations=200)
    jout = jobs_overhead.run_bench(iterations=200)
    assert set(tout) == set(jout)
    assert set(tout["microbench_ns_per_request"]) == \
        set(jout["microbench_ns_per_request"])
    assert all(v > 0 for v in tout["microbench_ns_per_request"].values())
