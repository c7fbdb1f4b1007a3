"""Auto-triage — a pure rule engine over the catalogued metric surface.

Counterpart of ``oryx_tpu/obs/diagnose.py``, whole: the same rules,
scores and runbook anchors for the same surface.

``GET /admin/diagnose`` (obs/server.py) answers the operator's first
question — *what is most likely wrong* — by evaluating a fixed rule
set against a **surface**: one plain dict of the catalogued
observability exports (counters, gauges, per-route request stats, the
SLO status, the resilience/breaker snapshot, device-time accounting).
Every rule declares the metric names it reads, each of them in the
docs/OBSERVABILITY.md catalog, so a renamed metric fails the catalog
test instead of silently blinding a rule.

The engine is deliberately pure: surface in, ranked cause list out —
no registry, no locks, no I/O — so rules are unit-testable as plain
functions and the flight recorder can embed the diagnosis computed at
trigger time from the bundle it just assembled.  On the router the
endpoint joins every replica's surface through the scatter registry
(counters sum, gauges take the worst reading, breaker states union)
and diagnoses the merged view.

Each cause carries a score in (0, 1], the evidence that fired it, and
a runbook anchor into docs/ for the operator's next step.
"""

from __future__ import annotations

__all__ = ["Rule", "RULES", "diagnose", "build_surface",
           "surface_from_bundle", "merge_surfaces", "diagnose_bundle"]


class Rule:
    """One triage rule.  ``reads`` names every counter/gauge the check
    consults — linted against the OBSERVABILITY.md catalog; ``check``
    maps a surface to ``(score, evidence)`` or None."""

    __slots__ = ("name", "reads", "runbook", "summary", "check")

    def __init__(self, name: str, *, reads: tuple, runbook: str,
                 summary: str, check):
        self.name = name
        self.reads = reads
        self.runbook = runbook
        self.summary = summary
        self.check = check


# -- surface accessors (None-safe: a sparse surface is normal) ---------------

def _counter(surface: dict, name: str) -> int:
    try:
        return int((surface.get("counters") or {}).get(name) or 0)
    except (TypeError, ValueError):
        return 0


def _gauge(surface: dict, name: str) -> float | None:
    v = (surface.get("gauges") or {}).get(name)
    try:
        return None if v is None else float(v)
    except (TypeError, ValueError):
        return None


def _clamp(x: float, lo: float = 0.0, hi: float = 1.0) -> float:
    return max(lo, min(hi, x))


# -- rule checks -------------------------------------------------------------

def _check_error_burst(surface: dict):
    """Data-plane 5xx ratio — the induced-fault signature: requests
    are arriving and failing server-side."""
    total = errors = 0
    for r in (surface.get("routes") or {}).values():
        if not isinstance(r, dict):
            continue
        total += int(r.get("count") or 0)
        errors += int(r.get("server_errors") or 0)
    if total < 5 or errors == 0:
        return None
    ratio = errors / total
    if ratio < 0.02:
        return None
    return (_clamp(0.6 + 4.0 * ratio, hi=0.98),
            {"server_errors": errors, "requests": total,
             "ratio": round(ratio, 4)})


def _check_breaker_open(surface: dict):
    """An open circuit breaker IS a named failing dependency."""
    open_names = []
    half = []

    def walk(node):
        if isinstance(node, dict):
            state = node.get("state")
            if state == "open":
                open_names.append(node.get("name") or "breaker")
            elif state == "half_open":
                half.append(node.get("name") or "breaker")
            for k, v in node.items():
                if isinstance(v, (dict, list)) and k != "name":
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(surface.get("resilience") or {})
    if not open_names and not half:
        return None
    score = 0.85 if open_names else 0.45
    return (score, {"open": sorted(set(open_names)),
                    "half_open": sorted(set(half))})


def _check_mirror_stalled(surface: dict):
    """Cross-region staleness past its bound, or a failing
    replication link: the mirror is not draining."""
    stale = _gauge(surface, "cross_region_staleness_ms")
    lag = _gauge(surface, "mirror_lag_records")
    link = _counter(surface, "mirror_link_failures")
    if (stale is None or stale < 2000.0) and link == 0:
        return None
    score = 0.5
    if stale is not None:
        score = _clamp(0.5 + stale / 60000.0, hi=0.95)
    if link > 0:
        score = _clamp(score + 0.1, hi=0.95)
    return (score, {"cross_region_staleness_ms": stale,
                    "mirror_lag_records": lag,
                    "mirror_link_failures": link})


def _check_ingest_overload(surface: dict):
    """Admission control shedding writes: offered load exceeds the
    region's ingest budget."""
    sheds = _counter(surface, "ingest_sheds")
    rejects = _counter(surface, "admission_rejects")
    if sheds == 0 and rejects == 0:
        return None
    return (_clamp(0.4 + 0.05 * min(sheds + rejects, 8), hi=0.75),
            {"ingest_sheds": sheds, "admission_rejects": rejects})


def _check_ann_fallback(surface: dict):
    """ANN/slice artifacts failing closed — serving silently degraded
    to the slower exact path (latency SLOs at risk)."""
    ann = _gauge(surface, "ann_index_fallbacks") or 0
    slices = _gauge(surface, "slice_load_fallbacks") or 0
    if ann == 0 and slices == 0:
        return None
    return (0.7, {"ann_index_fallbacks": ann,
                  "slice_load_fallbacks": slices})


def _check_device_saturated(surface: dict):
    """Device occupancy near 1.0 with queueing behind it: the fleet is
    compute-bound, not failing."""
    busy = _gauge(surface, "device_busy_fraction")
    if busy is None:
        dev = surface.get("device_time") or {}
        busy = dev.get("busy_fraction") if isinstance(dev, dict) \
            else None
    if busy is None or busy < 0.85:
        return None
    wait = _gauge(surface, "cluster_queue_wait_ms")
    dev = surface.get("device_time") or {}
    top = (dev.get("by_route") or [{}])[0] \
        if isinstance(dev, dict) else {}
    return (_clamp(0.55 + 0.4 * busy, hi=0.9),
            {"device_busy_fraction": round(float(busy), 4),
             "cluster_queue_wait_ms": wait, "top_route": top})


def _check_speed_replay(surface: dict):
    """A speed shard recently crash-recovered (dedup fence skipping
    replayed folds) or its checkpoint is not advancing."""
    skips = _counter(surface, "speed_shard_dedup_skips")
    age = _gauge(surface, "speed_checkpoint_age_sec")
    if skips == 0 and (age is None or age < 60.0):
        return None
    return (0.5, {"speed_shard_dedup_skips": skips,
                  "speed_checkpoint_age_sec": age})


def _check_update_lag(surface: dict):
    """Replicas falling behind the update topic: the served model is
    aging while the batch layer keeps publishing."""
    lag = _gauge(surface, "update_lag_records")
    if lag is None or lag < 50:
        return None
    return (_clamp(0.45 + lag / 2000.0, hi=0.8),
            {"update_lag_records": lag,
             "model_generation_age_sec":
                 _gauge(surface, "model_generation_age_sec")})


def _check_cache_degraded(surface: dict):
    """The stale-while-revalidate feed is stalling refreshes — hit
    traffic is being served increasingly stale answers."""
    stalls = _counter(surface, "cache_stale_feed_stalls")
    if stalls == 0:
        return None
    return (0.4, {"cache_stale_feed_stalls": stalls})


def _check_obs_degraded(surface: dict):
    """The observability plane itself is losing data — ranked low,
    but an operator debugging with half-blind tooling should know."""
    failures = {name: _counter(surface, name) for name in (
        "trace_record_failures", "event_write_failures",
        "slo_eval_failures", "flight_dump_failures")}
    if not any(failures.values()):
        return None
    return (0.3, {k: v for k, v in failures.items() if v})


RULES = (
    Rule("error-burst",
         reads=(),
         runbook="docs/OBSERVABILITY.md#operator-runbook",
         summary="data-plane requests are failing server-side "
                 "(5xx/status-0 burst)",
         check=_check_error_burst),
    Rule("breaker-open",
         reads=(),
         runbook="docs/RESILIENCE.md#policy-layer-oryx_tpuresiliencepolicypy",
         summary="a circuit breaker is open — a named dependency is "
                 "failing fast",
         check=_check_breaker_open),
    Rule("mirror-stalled",
         reads=("cross_region_staleness_ms", "mirror_lag_records",
                "mirror_link_failures"),
         runbook="docs/SCALING.md#failover-runbook",
         summary="cross-region replication is stalled — the remote "
                 "region is serving stale state",
         check=_check_mirror_stalled),
    Rule("ingest-overload",
         reads=("ingest_sheds", "admission_rejects"),
         runbook="docs/SCALING.md#admission-control",
         summary="admission control is shedding writes — offered "
                 "load exceeds the ingest budget",
         check=_check_ingest_overload),
    Rule("ann-fallback",
         reads=("ann_index_fallbacks", "slice_load_fallbacks"),
         runbook="docs/SCALING.md#ann-serving-path-ivf-large-catalogs--issue-18",
         summary="ANN/slice artifacts failed closed — serving "
                 "degraded to the slower exact path",
         check=_check_ann_fallback),
    Rule("device-saturated",
         reads=("device_busy_fraction", "cluster_queue_wait_ms"),
         runbook="docs/OBSERVABILITY.md#device-time-accounting",
         summary="the device is saturated — requests queue behind "
                 "compute, not failures",
         check=_check_device_saturated),
    Rule("speed-replay",
         reads=("speed_shard_dedup_skips",
                "speed_checkpoint_age_sec"),
         runbook="docs/SCALING.md#sharded-speed-layer",
         summary="a speed shard crash-recovered or its checkpoint is "
                 "stuck",
         check=_check_speed_replay),
    Rule("update-lag",
         reads=("update_lag_records", "model_generation_age_sec"),
         runbook="docs/OBSERVABILITY.md#metric-catalog",
         summary="replicas are falling behind the update topic",
         check=_check_update_lag),
    Rule("cache-degraded",
         reads=("cache_stale_feed_stalls",),
         runbook="docs/SCALING.md#result-cache--coalescing-the-routers-fast-path",
         summary="the stale-while-revalidate feed is stalling",
         check=_check_cache_degraded),
    Rule("obs-degraded",
         reads=("trace_record_failures", "event_write_failures",
                "slo_eval_failures", "flight_dump_failures"),
         runbook="docs/OBSERVABILITY.md#operator-runbook",
         summary="the observability plane is losing data",
         check=_check_obs_degraded),
)


def diagnose(surface: dict) -> dict:
    """Evaluate every rule against one surface; ranked causes, worst
    first (ties break on rule name for determinism)."""
    causes = []
    for rule in RULES:
        try:
            hit = rule.check(surface)
        except Exception:  # noqa: BLE001 — one bad rule must not mute the rest
            continue
        if hit is None:
            continue
        score, evidence = hit
        causes.append({"cause": rule.name,
                       "score": round(float(score), 4),
                       "summary": rule.summary,
                       "evidence": evidence,
                       "runbook": rule.runbook})
    causes.sort(key=lambda c: (-c["score"], c["cause"]))
    return {"causes": causes, "rules_evaluated": len(RULES),
            "healthy": not causes}


# -- surface construction ----------------------------------------------------

def build_surface(registry=None, slo_status=None, resilience=None,
                  device=None) -> dict:
    """Assemble a live surface from a tier's registry + side
    structures.  Evaluates gauge fns — callers must not hold the SLO
    engine's lock (flight bundles use :func:`surface_from_bundle`
    instead, which never evaluates anything)."""
    surface = {"counters": {}, "gauges": {}, "routes": {}}
    if registry is not None:
        surface["counters"] = registry.counters_snapshot()
        surface["gauges"] = registry.gauges_snapshot()
        surface["routes"] = registry.snapshot()
    if slo_status is not None:
        surface["slo"] = slo_status
    if resilience is not None:
        surface["resilience"] = resilience
    if device is not None:
        surface["device_time"] = device
    return surface


def surface_from_bundle(bundle: dict) -> dict:
    """The flight-dump view of the same surface: everything was
    already collected when the bundle was assembled, so this is a
    pure re-keying (safe inside page callbacks)."""
    return {"counters": bundle.get("counters") or {},
            "gauges": bundle.get("gauges") or {},
            "routes": bundle.get("routes") or {},
            "slo": bundle.get("slo"),
            "resilience": bundle.get("resilience"),
            "device_time": bundle.get("device_time")}


def diagnose_bundle(bundle: dict) -> dict:
    """The flight recorder's default ``diagnose_fn``."""
    return diagnose(surface_from_bundle(bundle))


def merge_surfaces(surfaces: list) -> dict:
    """Cluster-wide join: counters sum, gauges keep the WORST (max)
    reading, per-route stats sum their counts, resilience snapshots
    union (colliding breaker names keep the open one), device time
    keeps the busiest process."""
    out: dict = {"counters": {}, "gauges": {}, "routes": {},
                 "resilience": {}}
    busiest = None
    for s in surfaces:
        if not isinstance(s, dict):
            continue
        for k, v in (s.get("counters") or {}).items():
            try:
                out["counters"][k] = out["counters"].get(k, 0) + int(v)
            except (TypeError, ValueError):
                continue
        for k, v in (s.get("gauges") or {}).items():
            if v is None:
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            prev = out["gauges"].get(k)
            if prev is None or v > prev:
                out["gauges"][k] = v
        for route, r in (s.get("routes") or {}).items():
            if not isinstance(r, dict):
                continue
            dst = out["routes"].setdefault(route, {})
            for k in ("count", "client_errors", "server_errors"):
                dst[k] = dst.get(k, 0) + int(r.get(k) or 0)
        for k, v in (s.get("resilience") or {}).items():
            prev = out["resilience"].get(k)
            if prev is None or (isinstance(v, dict)
                                and v.get("state") == "open"):
                out["resilience"][k] = v
        if s.get("slo") is not None and "slo" not in out:
            out["slo"] = s["slo"]
        dev = s.get("device_time")
        if isinstance(dev, dict):
            frac = dev.get("busy_fraction") or 0
            if busiest is None or frac > (busiest.get("busy_fraction")
                                          or 0):
                busiest = dev
    if busiest is not None:
        out["device_time"] = busiest
    return out
