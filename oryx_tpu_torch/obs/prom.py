"""Prometheus text exposition over mergeable fixed-bucket histograms.

Counterpart of ``oryx_tpu/obs/prom.py``, whole: the same buckets, the
same merge and the same bytes for the same snapshot.

The serving tier's original latency surface is a percentile reservoir
(lambda_rt/metrics.py): exact for one process, but percentiles cannot
be combined across replicas — the router fronting N shard replicas had
no honest cluster-wide latency view.  Borgmon/Prometheus solved this
with fixed-bucket histograms: bucket counts are plain counters, so the
router can sum each bucket across replicas and the merged histogram is
EXACTLY the histogram a single process observing all requests would
have recorded.  This module owns the bucket layout, the merge, and the
text exposition (`/metrics?format=prometheus`); the JSON reservoir
percentiles stay the per-process default.

All metric names are catalogued in docs/OBSERVABILITY.md and linted by
tests/test_torch_obs_catalog.py.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterable, Mapping
from ..common import clock as clockmod

__all__ = ["LATENCY_BUCKETS_MS", "Histogram", "bucket_quantile",
           "merge_histograms", "merge_snapshots", "render_prometheus",
           "render_prometheus_blocks", "render_openmetrics",
           "render_openmetrics_blocks"]

# Fixed latency bucket upper bounds (milliseconds).  Fixed — never
# per-process adaptive — because exact cross-replica merging requires
# every process to bucket identically; the range spans a local cache
# hit (~1 ms) to the 10 s shard-timeout ceiling.
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-bucket latency histogram.  Not thread-safe by itself — the
    owning MetricsRegistry serializes observes under its lock.

    A bucket increment may optionally carry an *exemplar*: the sampled
    request's trace id (plus the observed value and a wall-clock
    stamp), so any bucket of the cluster-wide p99 resolves to one
    concrete trace on ``/admin/traces``.  One exemplar per bucket,
    newest wins — the OpenMetrics contract — and the unsampled hot
    path (``trace_id=None``, the overwhelmingly common case) pays one
    branch and no clock read."""

    __slots__ = ("counts", "sum_ms", "exemplars")

    def __init__(self):
        # one count per bucket plus the +Inf overflow bucket; counts are
        # PER-bucket here and cumulated only at exposition time
        self.counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        self.sum_ms = 0.0
        # bucket index -> (trace_id, observed_ms, unix_ts); lazily
        # allocated so exemplar-free histograms cost nothing extra
        self.exemplars: dict[int, tuple[str, float, float]] | None = None

    def observe(self, ms: float, trace_id: str | None = None) -> None:
        i = bisect_left(LATENCY_BUCKETS_MS, ms)
        self.counts[i] += 1
        self.sum_ms += ms
        if trace_id is not None:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[i] = (trace_id, ms, clockmod.now())

    def snapshot(self) -> dict:
        out = {"buckets": list(self.counts),
               "sum_ms": round(self.sum_ms, 3)}
        if self.exemplars:
            # JSON-friendly: string bucket keys, list triples — the
            # shape that rides ?format=prometheus-json to the router
            out["exemplars"] = {
                str(i): [t, round(v, 3), round(ts, 3)]
                for i, (t, v, ts) in sorted(self.exemplars.items())}
        return out


def bucket_quantile(buckets: "Iterable[int]", q: float,
                    bounds: "tuple[float, ...]" = LATENCY_BUCKETS_MS
                    ) -> float | None:
    """Estimate the q-quantile (0 < q < 1) from PER-bucket counts —
    the standard Prometheus histogram_quantile: linear interpolation
    inside the bucket the target rank falls in, with the +Inf overflow
    bucket reporting its lower bound (there is nothing to interpolate
    toward).  None on an empty histogram.  This is how the autoscaler
    turns the cluster's exactly-merged latency buckets into the p99 it
    compares against its thresholds — mergeable where reservoir
    percentiles never were."""
    counts = [int(c) for c in buckets]
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= rank:
            if i >= len(bounds):
                return float(bounds[-1])  # +Inf bucket: lower bound
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            if c <= 0:
                return hi
            return lo + (hi - lo) * (rank - prev) / c
    return float(bounds[-1])


def merge_histograms(snaps: Iterable[Mapping]) -> dict:
    """Sum histogram snapshots bucket-wise — the exact merge reservoir
    percentiles cannot provide.  Exemplars survive the merge exactly:
    per bucket, the exemplar with the newest wall-clock stamp wins
    across all inputs, so the cluster-wide exposition still names a
    live trace for every populated bucket."""
    counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)
    total = 0.0
    exemplars: dict[int, list] = {}
    for s in snaps:
        for i, c in enumerate(s.get("buckets") or ()):
            counts[i] += int(c)
        total += float(s.get("sum_ms") or 0.0)
        for k, ex in (s.get("exemplars") or {}).items():
            i = int(k)
            cur = exemplars.get(i)
            if cur is None or float(ex[2]) > float(cur[2]):
                exemplars[i] = list(ex)
    out = {"buckets": counts, "sum_ms": round(total, 3)}
    if exemplars:
        out["exemplars"] = {str(i): exemplars[i]
                            for i in sorted(exemplars)}
    return out


def merge_snapshots(snaps: Iterable[Mapping]) -> dict:
    """Merge per-process ``MetricsRegistry.prometheus_snapshot()`` dicts
    (route counts, error counts, latency buckets, named counters) into
    one cluster-wide snapshot.  Gauges do not merge (they are
    per-process instantaneous values) and are dropped."""
    routes: dict[str, dict] = {}
    counters: dict[str, int] = {}
    for snap in snaps:
        for route, r in (snap.get("routes") or {}).items():
            agg = routes.get(route)
            if agg is None:
                agg = routes[route] = {
                    "count": 0, "client_errors": 0, "server_errors": 0,
                    "latency_ms": {"buckets": [0] * (
                        len(LATENCY_BUCKETS_MS) + 1), "sum_ms": 0.0}}
            agg["count"] += int(r.get("count") or 0)
            agg["client_errors"] += int(r.get("client_errors") or 0)
            agg["server_errors"] += int(r.get("server_errors") or 0)
            agg["latency_ms"] = merge_histograms(
                [agg["latency_ms"], r.get("latency_ms") or {}])
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + int(v)
    return {"routes": dict(sorted(routes.items())),
            "counters": dict(sorted(counters.items()))}


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(pairs: dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs.items())
    return "{" + inner + "}"


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snap: Mapping,
                      labels: dict[str, str] | None = None) -> str:
    """Render one snapshot (a process's own, or a merged cluster view)
    in the Prometheus text exposition format (0.0.4)."""
    return render_prometheus_blocks([(snap, labels or {})])


def render_prometheus_blocks(
        blocks: list[tuple[Mapping, dict[str, str]]]) -> str:
    """Render several ``(snapshot, base_labels)`` blocks as ONE
    exposition — the router scrape carries its own samples
    (``tier="router"``) and the merged replica view
    (``tier="replica"``) together.  The text format allows exactly one
    ``# TYPE`` line per metric name and requires all of a metric's
    samples to form one contiguous group, so each family is emitted
    once across all blocks, never per block."""
    return _render_blocks(blocks, om=False)


# -- OpenMetrics --------------------------------------------------------------

def _om_num(v) -> str:
    """Canonical OpenMetrics float rendering (``1.0``, not ``1``)."""
    return repr(float(v))


def _om_exemplar(ex) -> str:
    """`` # {trace_id="..."} value timestamp`` — the OpenMetrics
    exemplar clause carried on a ``_bucket`` sample line."""
    return (f' # {{trace_id="{_escape(ex[0])}"}} '
            f"{_om_num(ex[1])} {_om_num(ex[2])}")


def render_openmetrics(snap: Mapping,
                       labels: dict[str, str] | None = None) -> str:
    return render_openmetrics_blocks([(snap, labels or {})])


def render_openmetrics_blocks(
        blocks: list[tuple[Mapping, dict[str, str]]]) -> str:
    """The OpenMetrics 1.0 form of the exposition
    (``/metrics?format=openmetrics``): same sample values as the
    Prometheus 0.0.4 text, plus what 0.0.4 cannot say — histogram
    bucket exemplars (``# {trace_id="..."} value timestamp``) naming
    the sampled trace that landed in each bucket, and the mandatory
    ``# EOF`` terminator.  Family naming follows the spec: a counter's
    ``# TYPE`` line names the family WITHOUT the ``_total`` suffix its
    samples carry.  Like the 0.0.4 renderer, several ``(snapshot,
    base_labels)`` blocks emit each family exactly once."""
    return _render_blocks(blocks, om=True)


def _render_blocks(blocks: list[tuple[Mapping, dict[str, str]]],
                   om: bool) -> str:
    """The one block walker both text formats render through, so they
    can never disagree on what a snapshot contains.  ``om`` switches
    the dialect: counter ``# TYPE`` lines without the ``_total``
    suffix, canonical-float ``le`` labels, bucket exemplars, and the
    ``# EOF`` terminator."""
    num = _om_num if om else _num
    out: list[str] = []

    def counter_type(family: str) -> str:
        return f"# TYPE {family} counter" if om \
            else f"# TYPE {family}_total counter"

    with_routes = [(snap.get("routes") or {}, dict(base))
                   for snap, base in blocks if snap.get("routes")]
    if with_routes:
        out.append(counter_type("oryx_requests"))
        for routes, base in with_routes:
            for route, r in routes.items():
                out.append("oryx_requests_total"
                           + _labels({**base, "route": route})
                           + f" {int(r.get('count') or 0)}")
        out.append(counter_type("oryx_request_errors"))
        for routes, base in with_routes:
            for route, r in routes.items():
                for cls, key in (("client", "client_errors"),
                                 ("server", "server_errors")):
                    out.append("oryx_request_errors_total"
                               + _labels({**base, "route": route,
                                          "class": cls})
                               + f" {int(r.get(key) or 0)}")
        out.append("# TYPE oryx_request_latency_ms histogram")
        for routes, base in with_routes:
            for route, r in routes.items():
                hist = r.get("latency_ms") or {}
                counts = hist.get("buckets") or []
                exemplars = hist.get("exemplars") or {} if om else {}
                cum = 0
                for i in range(len(LATENCY_BUCKETS_MS) + 1):
                    le = "+Inf" if i >= len(LATENCY_BUCKETS_MS) \
                        else num(LATENCY_BUCKETS_MS[i])
                    cum += int(counts[i]) if i < len(counts) else 0
                    line = ("oryx_request_latency_ms_bucket"
                            + _labels({**base, "route": route,
                                       "le": le}) + f" {cum}")
                    ex = exemplars.get(str(i))
                    if ex:
                        line += _om_exemplar(ex)
                    out.append(line)
                out.append("oryx_request_latency_ms_sum"
                           + _labels({**base, "route": route})
                           + f" {num(hist.get('sum_ms') or 0.0)}")
                out.append("oryx_request_latency_ms_count"
                           + _labels({**base, "route": route})
                           + f" {cum}")
    for kind, suffix in (("counters", "_total"), ("gauges", "")):
        names: list[str] = []
        for snap, _ in blocks:
            for n in (snap.get(kind) or {}):
                if n not in names:
                    names.append(n)
        for name in sorted(names):
            samples = []
            for snap, base in blocks:
                v = (snap.get(kind) or {}).get(name)
                if v is None:
                    continue
                v = int(v) if kind == "counters" else num(v)
                samples.append(f"oryx_{name}{suffix}"
                               f"{_labels(dict(base))} {v}")
            if samples:
                out.append(counter_type(f"oryx_{name}")
                           if kind == "counters"
                           else f"# TYPE oryx_{name} gauge")
                out.extend(samples)
    if om:
        out.append("# EOF")
        return "\n".join(out) + "\n"
    return "\n".join(out) + "\n" if out else ""
