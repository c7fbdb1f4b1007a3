"""Critical-path attribution: which stage owns a request's latency?

Counterpart of ``oryx_tpu/obs/anatomy.py``, whole.  The tracer makes
one request explain itself (a span tree on ``/admin/traces``); this
module makes the TAIL explain itself.  A pure
analyzer decomposes each finished span tree into named *stage*
contributions along the request's critical path — for a routed request
the path is

    router.request
      └ router.shard_call (slowest shard — every scatter waits for it)
          └ serving.request
              ├ serving.queue_wait
              └ serving.device_execute
      └ router.merge

so the stages are: router-side dispatch work (parse, fold-in/vector
gathers, serialization), the scatter transport's wait beyond what the
slowest replica itself spent, the replica's handler overhead, the
batcher's queue-wait / device-execute split, the exact merge, and an
``untraced`` residue that absorbs whatever no span covered.  Stage
durations are clamped to their parents and always sum EXACTLY to the
root's duration — the residue is defined as the remainder — so a
``/admin/tail`` breakdown is an accounting identity, not an estimate.

Everything here is pure over span dicts (the ``/admin/traces`` wire
shape): no clocks, no I/O, unit-testable without a cluster.  Stage
names are catalogued in docs/OBSERVABILITY.md and linted by
tests/test_torch_obs_catalog.py.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from .prom import Histogram

__all__ = ["STAGES", "analyze_trace", "tail_report"]

# the stage taxonomy, in display order; linted against the
# docs/OBSERVABILITY.md stage table
STAGES = ("router.dispatch", "router.cache_lookup", "scatter.wait",
          "serving.request", "serving.queue_wait",
          "serving.device_execute", "router.merge", "untraced")


def _dur(span: Mapping | None) -> float:
    return float(span.get("duration_ms") or 0.0) if span else 0.0


def _children(spans, parent_id: str, name: str) -> list[dict]:
    return [s for s in spans
            if s.get("name") == name and s.get("parent_id") == parent_id]


def _serving_split(spans, serving_req: Mapping | None,
                   budget: float) -> dict[str, float]:
    """queue_wait / device_execute / handler-residue under one
    ``serving.request`` span, clamped so the three sum to ``budget``
    (the serving.request duration, itself clamped to its parent)."""
    out = {"serving.queue_wait": 0.0, "serving.device_execute": 0.0,
           "serving.request": 0.0}
    if serving_req is None:
        return out
    sid = serving_req.get("span_id")
    qw = min(budget, sum(_dur(s) for s in
                         _children(spans, sid, "serving.queue_wait")))
    de = min(budget - qw, sum(_dur(s) for s in
                              _children(spans, sid,
                                        "serving.device_execute")))
    out["serving.queue_wait"] = qw
    out["serving.device_execute"] = de
    out["serving.request"] = max(0.0, budget - qw - de)
    return out


def analyze_trace(spans: Iterable[Mapping]) -> dict | None:
    """Decompose one trace's span list into stage contributions.

    Returns ``{"trace_id", "total_ms", "route", "status", "stages"}``
    where ``stages`` maps every name in :data:`STAGES` to milliseconds
    summing to ``total_ms``; ``None`` when the trace has no root
    request span (a fragment another tier's ring aged out)."""
    spans = [s for s in spans if isinstance(s, Mapping)]
    ids = {s.get("span_id") for s in spans}
    root = None
    orphans = []
    for s in spans:
        if not str(s.get("name", "")).endswith(".request"):
            continue
        if s.get("parent_id") is None:
            root = s
            break
        if s.get("parent_id") not in ids:
            # an orphan root: its parent lives in another tier's ring
            # (a replica analyzing its own ring sees serving.request
            # spans parented under the router's shard_call) — still a
            # perfectly analyzable local root
            orphans.append(s)
    if root is None:
        root = max(orphans, key=_dur) if orphans else None
    if root is None:
        return None
    total = _dur(root)
    stages = {name: 0.0 for name in STAGES}
    root_id = root.get("span_id")
    if root.get("name") == "router.request":
        merge = min(total, sum(_dur(s) for s in
                               _children(spans, root_id, "router.merge")))
        calls = _children(spans, root_id, "router.shard_call")
        slowest = max(calls, key=_dur) if calls else None
        scatter = min(max(0.0, total - merge), _dur(slowest))
        serving_req = None
        if slowest is not None:
            under = _children(spans, slowest.get("span_id"),
                              "serving.request")
            serving_req = max(under, key=_dur) if under else None
        r_budget = min(scatter, _dur(serving_req))
        stages.update(_serving_split(spans, serving_req, r_budget))
        stages["scatter.wait"] = max(0.0, scatter - r_budget)
        stages["router.merge"] = merge
        # pre-scatter router work (parse, fold-in solve, vector
        # gathers) is MEASURED from the timeline: root start to the
        # first child span's start — both router-local spans sharing
        # the router's clock anchor
        children = calls + _children(spans, root_id, "router.merge")
        lead = 0.0
        if children:
            first = min(float(s.get("start_ms") or 0.0)
                        for s in children)
            lead = first - float(root.get("start_ms") or 0.0)
        budget = max(0.0, total - scatter - merge)
        # the result-cache probe (a root-child span, present on router
        # hits AND misses when the cache is armed) sits inside the
        # pre-scatter window: carve it out of the dispatch lead so a
        # cache-served request's time is attributed to the lookup, not
        # smeared into untraced residue
        lookup = min(budget, sum(_dur(s) for s in
                                 _children(spans, root_id,
                                           "router.cache_lookup")))
        stages["router.cache_lookup"] = lookup
        stages["router.dispatch"] = min(max(0.0, lead - lookup),
                                        budget - lookup)
        # whatever no span accounts for (post-merge serialization,
        # hedge bookkeeping, gaps): the honest remainder
        stages["untraced"] = budget - lookup - stages["router.dispatch"]
    else:
        # single-node (or replica-local) request: the batcher split
        # hangs directly under the serving.request root; the root's
        # own share is handler overhead, not a nested replica call —
        # same stage name, same meaning
        stages.update(_serving_split(spans, root, total))
    return {"trace_id": root.get("trace_id"),
            "total_ms": round(total, 3),
            "route": (root.get("attrs") or {}).get("route"),
            "status": root.get("status"),
            "stages": {k: round(v, 3) for k, v in stages.items()}}


def tail_report(traces: Mapping[str, list], top_k: int = 10,
                route_prefix: str | None = None) -> dict:
    """Aggregate a ring of traces into the ``/admin/tail`` report.

    - per-stage histograms over EVERY analyzed trace (the fixed
      latency buckets from obs/prom.py, so reports merge if anyone
      ever wants to),
    - the share of total latency mass in the p99 tail attributed to
      each stage (which stage to fix to move the p99), and
    - the ``top_k`` slowest traces with their full breakdowns — each
      one resolvable on ``/admin/traces``.

    ``route_prefix`` restricts the report to one route class (matched
    against the path part of the root span's route attr) — the ring
    also holds admin/profile/scrape traces whose tails would otherwise
    drown the route an operator is actually hunting."""
    analyzed = []
    skipped = 0
    for spans in traces.values():
        b = analyze_trace(spans)
        if b is None:
            skipped += 1
        elif route_prefix is not None and not str(
                b.get("route") or "").split(" ", 1)[-1].startswith(
                    route_prefix):
            skipped += 1
        else:
            analyzed.append(b)
    if not analyzed:
        return {"analyzed": 0, "skipped": skipped, "p99_ms": None,
                "tail": {"count": 0, "stage_share": {}},
                "stages": {}, "top": []}
    totals = sorted(b["total_ms"] for b in analyzed)
    p99 = totals[min(len(totals) - 1, int(0.99 * len(totals)))]
    tail = [b for b in analyzed if b["total_ms"] >= p99] or analyzed[-1:]
    tail_mass = sum(b["total_ms"] for b in tail) or 1.0
    stage_share = {
        name: round(sum(b["stages"][name] for b in tail) / tail_mass, 4)
        for name in STAGES}
    hists = {name: Histogram() for name in STAGES}
    for b in analyzed:
        for name in STAGES:
            hists[name].observe(b["stages"][name])
    stages = {}
    for name in STAGES:
        snap = hists[name].snapshot()
        snap["mean_ms"] = round(snap["sum_ms"] / len(analyzed), 3)
        stages[name] = snap
    top = sorted(analyzed, key=lambda b: b["total_ms"],
                 reverse=True)[:max(1, top_k)]
    return {"analyzed": len(analyzed), "skipped": skipped,
            "p99_ms": p99,
            "tail": {"count": len(tail), "stage_share": stage_share},
            "stages": stages, "top": top}
