"""The port's tracer (``oryx_tpu_torch/obs/trace.py``) and tail anatomy
(``obs/anatomy.py``) against the reference's, on the CPU.

``traceparent`` parsing and formatting agree on seeded ids and on
malformed headers; the two tracers build the same span trees (names,
parentage, attributes, status) for the same calls; and the anatomy's
stage decomposition and ``/admin/tail`` report are equal on the same
span dicts, with every trace's stages summing to its root (exactly, up
to the 3-decimal rounding of each reported figure)."""

from __future__ import annotations

import numpy as np
import pytest

from oryx_tpu.obs import anatomy as janatomy
from oryx_tpu.obs import trace as jtrace
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.obs import anatomy as tanatomy
from oryx_tpu_torch.obs import trace as ttrace
from oryx_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _ids(rng):
    return (f"{int(rng.integers(1, 2**62)):016x}"
            f"{int(rng.integers(0, 2**62)):016x}",
            f"{int(rng.integers(1, 2**62)):016x}")


@pytest.mark.parametrize("seed", range(3))
def test_traceparent_round_trips_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        trace_id, span_id = _ids(rng)
        sampled = bool(rng.integers(0, 2))
        tp = ttrace.format_traceparent(trace_id, span_id, sampled)
        assert tp == jtrace.format_traceparent(trace_id, span_id, sampled)
        assert ttrace.parse_traceparent(tp) == \
            jtrace.parse_traceparent(tp) == (trace_id, span_id, sampled)


@pytest.mark.parametrize("bad", [
    None, "", "00-abc", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "zz-" + "1" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01"])
def test_malformed_traceparent_starts_fresh_alike(bad):
    assert ttrace.parse_traceparent(bad) is None
    assert jtrace.parse_traceparent(bad) is None
    unsampled = ttrace.parse_traceparent(ttrace.unsampled_traceparent())
    assert unsampled is not None and unsampled[2] is False


def _shape(trace: list[dict]) -> list[tuple]:
    """A trace's spans with ids replaced by their parent's name: the
    tree's shape, free of the random ids."""
    by_id = {s["span_id"]: s["name"] for s in trace}
    return sorted((s["name"], s["service"], by_id.get(s["parent_id"]),
                   tuple(sorted(s["attrs"].items())), s["status"])
                  for s in trace)


def _drive(mod, inbound: str | None):
    tracer = mod.Tracer("serving", sample_ratio=1.0, max_traces=4)
    span = tracer.begin_request("serving.request", inbound)
    with tracer.span("serving.parse") as child:
        child.set_attr("rows", 3)
    ctx = (span.trace_id, span.span_id)
    tracer.record_span("serving.queue_wait", ctx, span.t_start,
                       span.t_start + 0.002)
    tracer.record_span("serving.device_execute", ctx, span.t_start + 0.002,
                       span.t_start + 0.005,
                       {"batch_size": 4, "kernel_route": "i8+lsh"})
    tracer.end_request(span, status=200, route="GET /recommend/{userID}")
    return tracer, span


@pytest.mark.parametrize("inbound", [
    None, "00-" + "a" * 32 + "-" + "b" * 16 + "-01"])
def test_tracers_build_the_same_tree(inbound):
    jt, jspan = _drive(jtrace, inbound)
    tt, tspan = _drive(ttrace, inbound)
    (jtrace_spans,) = jt.traces_snapshot().values()
    (ttrace_spans,) = tt.traces_snapshot().values()
    assert _shape(ttrace_spans) == _shape(jtrace_spans)
    if inbound:
        assert tspan.trace_id == jspan.trace_id == "a" * 32
        assert tspan.parent_id == "b" * 16
    assert tt.spans_for(tspan.trace_id) == ttrace_spans


def test_unsampled_and_ring_and_fault_alike():
    for mod, faults in ((jtrace, jfaults), (ttrace, tfaults)):
        off = mod.Tracer("serving", sample_ratio=0.0)
        assert off.begin_request("serving.request") is mod.NOOP_SPAN
        honored = mod.Tracer("serving", sample_ratio=1.0)
        assert honored.begin_request(
            "serving.request",
            "00-" + "a" * 32 + "-" + "b" * 16 + "-00") is mod.NOOP_SPAN
        ring = mod.Tracer("serving", sample_ratio=1.0, max_traces=3)
        ids = []
        for _ in range(5):
            span = ring.begin_request("serving.request")
            ring.end_request(span, status=0)
            ids.append(span.trace_id)
        snap = ring.traces_snapshot()
        assert list(snap) == ids[-3:]
        assert all(s[0]["status"] == "error" for s in snap.values())
        faults.inject("obs-trace-drop", mode="error", times=2)
        span = ring.begin_request("serving.request")
        ring.end_request(span, status=200)
        assert ring.record_failures == 1


def _span(name, trace, sid, parent, start, dur, **attrs):
    return {"name": name, "service": name.split(".")[0], "trace_id": trace,
            "span_id": sid, "parent_id": parent, "start_ms": start,
            "duration_ms": dur, "attrs": attrs, "status": "ok"}


def _traces(seed: int, n: int = 40) -> dict:
    """Seeded span trees of both shapes the anatomy knows: a serving
    replica's request (queue wait + device execute) and a routed one
    (router request -> shard calls -> serving request -> batcher, plus
    the merge and a cache lookup), with some fragments and orphans."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in range(n):
        tid = f"{t:032x}"
        qw, dx = rng.exponential(3.0), rng.exponential(5.0)
        serve = qw + dx + rng.exponential(1.0)
        if t % 3:
            spans = [
                _span("serving.request", tid, "s0", None, 0.0, serve,
                      route="GET /recommend/{userID}"),
                _span("serving.queue_wait", tid, "s1", "s0", 0.5, qw),
                _span("serving.device_execute", tid, "s2", "s0",
                      0.5 + qw, dx, batch_size=int(rng.integers(1, 64)),
                      kernel_route="i8")]
        else:
            calls = int(rng.integers(1, 4))
            merge = rng.exponential(0.5)
            wait = serve + rng.exponential(2.0)
            total = wait + merge + rng.exponential(1.5)
            spans = [_span("router.request", tid, "r0", None, 0.0, total,
                           route="GET /recommend/{userID}"),
                     _span("router.cache_lookup", tid, "r9", "r0", 0.1,
                           0.05, cache="miss"),
                     _span("router.merge", tid, "rm", "r0", wait, merge)]
            for c in range(calls):
                spans.append(_span("router.shard_call", tid, f"c{c}", "r0",
                                   0.2, wait * (1.0 - 0.1 * c)))
            spans += [
                _span("serving.request", tid, "s0", "c0", 0.3, serve),
                _span("serving.queue_wait", tid, "s1", "s0", 0.4, qw),
                _span("serving.device_execute", tid, "s2", "s0",
                      0.4 + qw, dx, batch_size=8, kernel_route="pallas")]
        if t % 11 == 0:
            spans.append(_span("serving.queue_wait", tid, "o1", "gone",
                               0.0, 1.0))
        if t % 13 == 5:
            spans = spans[1:]  # a fragment without its root
        out[tid] = spans
    return out


@pytest.mark.parametrize("seed", range(3))
def test_anatomy_stages_are_equal_and_sum_to_the_root(seed):
    traces = _traces(seed)
    assert tanatomy.STAGES == janatomy.STAGES
    for spans in traces.values():
        got, want = tanatomy.analyze_trace(spans), \
            janatomy.analyze_trace(spans)
        assert got == want
        if got is not None:
            # exact before each stage and the total round to 3 decimals
            assert sum(got["stages"].values()) == pytest.approx(
                got["total_ms"], abs=0.0005 * (len(tanatomy.STAGES) + 1))


@pytest.mark.parametrize("prefix", [None, "GET /recommend", "POST"])
def test_tail_reports_are_equal(prefix):
    traces = _traces(7, n=60)
    assert tanatomy.tail_report(traces, top_k=5, route_prefix=prefix) == \
        janatomy.tail_report(traces, top_k=5, route_prefix=prefix)
