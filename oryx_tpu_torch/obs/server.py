"""Shared observability HTTP resources + the side-door metrics server.

Counterpart of ``oryx_tpu/obs/server.py``.  The handlers every tier
mounts (the serving tier and the router on their main port, via
serving/framework.py and cluster/router.py):

- ``GET /metrics`` — JSON by default; ``?format=prometheus`` renders
  the text exposition, ``?format=openmetrics`` the exemplar-carrying
  form, ``?format=prometheus-json`` the structured mergeable snapshot.
- ``GET /admin/traces``, ``/admin/tail``, ``/admin/slo``,
  ``/admin/region``, ``/admin/flight``, ``/admin/diagnose``, and
  ``POST /admin/flight/dump``.  On the router (a context with a
  ``scatter``), ``?join=1`` on the traces, the tail and the diagnosis
  scrapes every live replica and merges its answer in.
- ``GET /admin/profile?ms=N`` — on-demand ``torch.profiler`` capture
  (obs/profile.py); 404 unless ``oryx.obs.profile-dir`` is set, and a
  mutating route, so read-only gating and DIGEST auth apply.

The speed and batch layers serve no public HTTP, so their freshness
gauges and fold-in traces would otherwise be invisible;
:class:`ObsServer` is the side door — a minimal HttpApp hosting exactly
these routes on ``oryx.obs.metrics-port`` (null = off, 0 = ephemeral).
"""

from __future__ import annotations

import logging
import threading

from ..api.serving import OryxServingException
from ..lambda_rt.http import (HttpApp, Request, Route, TextResponse,
                              make_server)
from ..resilience.policy import resilience_snapshot
from . import anatomy
from . import profile as profile_mod
from .prom import render_openmetrics, render_prometheus

_log = logging.getLogger(__name__)

__all__ = ["admin_traces", "admin_tail", "admin_slo", "admin_profile",
           "admin_region", "admin_flight", "admin_flight_dump",
           "admin_diagnose", "registry_metrics",
           "own_prometheus_snapshot", "prometheus_response",
           "gather_traces", "ObsServer", "OPENMETRICS_CTYPE", "OBS_ROUTES"]

# the OpenMetrics media type a conforming scraper negotiates for
OPENMETRICS_CTYPE = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")


def own_prometheus_snapshot(req: Request, registry) -> dict:
    """This process's mergeable snapshot, with the tracer's degraded-
    recording counter folded in — the shape every tier exposes as
    ``?format=prometheus-json``."""
    snap = registry.prometheus_snapshot()
    tracer = req.context.get("tracer")
    if tracer is not None:
        snap["counters"]["trace_record_failures"] = \
            tracer.record_failures
    return snap


def prometheus_response(req: Request, registry):
    """The non-JSON ``/metrics`` forms shared by every tier, or None
    when the request wants the tier's own JSON view.
    ``format=openmetrics`` is the exemplar-carrying exposition
    (``# EOF`` terminated); ``prometheus`` stays the 0.0.4 text."""
    fmt = req.q1("format", "json")
    if fmt not in ("prometheus", "prometheus-json", "openmetrics"):
        return None
    snap = own_prometheus_snapshot(req, registry)
    if fmt == "prometheus-json":
        return snap
    if fmt == "openmetrics":
        return TextResponse(render_openmetrics(snap),
                            content_type=OPENMETRICS_CTYPE)
    return TextResponse(render_prometheus(snap))


def registry_metrics(req: Request):
    """Registry-only ``/metrics`` (the ObsServer's view: the speed and
    batch tiers have no model manager or batcher to report on)."""
    registry = req.context.get("metrics")
    if registry is None:
        raise OryxServingException(404, "metrics not enabled")
    prom = prometheus_response(req, registry)
    if prom is not None:
        return prom
    out = {"routes": registry.snapshot(),
           "counters": registry.counters_snapshot(),
           # named retry / circuit-breaker stats: the headless tiers run
           # producers behind retries too, and an operator must see them
           # wherever /metrics is served
           "resilience": resilience_snapshot()}
    gauges = registry.gauges_snapshot()
    if gauges:
        out["freshness"] = gauges
    tracer = req.context.get("tracer")
    if tracer is not None:
        out["obs"] = {"trace_record_failures": tracer.record_failures}
    acct = req.context.get("device_time")
    if acct is not None:
        out["device_time"] = acct.snapshot()
    return out


def _tracer(req: Request):
    tracer = req.context.get("tracer")
    if tracer is None:
        raise OryxServingException(
            404, "tracing not enabled (oryx.obs.tracing.enabled)")
    return tracer


# joined-ring payload caps: a cluster-complete trace dump must not grow
# without bound with the replica count
_JOIN_MAX_TRACES_FACTOR = 4
_JOIN_MAX_SPANS_PER_TRACE = 2048


def gather_traces(req: Request, tracer, limit: int,
                  join: bool) -> tuple[dict, int | None]:
    """This process's trace ring, optionally joined (``join``) with
    every live replica's ring through the scatter registry — the router
    only; on a tier without a scatter path ``join`` is a no-op.  Returns
    ``(traces, replicas_joined)``; the payload is capped at ``4 x
    limit`` traces and 2048 spans per trace."""
    traces = {tid: list(spans) for tid, spans
              in tracer.traces_snapshot(limit=limit).items()}
    sg = req.context.get("scatter")
    if not join or sg is None:
        return traces, None
    scraped = 0
    for _, payload in sg.scrape_replicas(
            f"/admin/traces?limit={limit}", deadline=req.deadline):
        scraped += 1
        for tid, spans in (payload.get("traces") or {}).items():
            if tid not in traces \
                    and len(traces) >= _JOIN_MAX_TRACES_FACTOR * limit:
                continue
            merged = traces.setdefault(tid, [])
            room = _JOIN_MAX_SPANS_PER_TRACE - len(merged)
            if room > 0:
                merged.extend(spans[:room])
    return traces, scraped


def _wants_join(req: Request, default: str) -> bool:
    return req.q1("join", default) not in ("0", "false", "")


def admin_traces(req: Request):
    """Finished traces from this process's bounded ring; a span tree is
    reassembled client-side from parent ids.  On the router, ``?join=1``
    merges every live replica's ring by trace id."""
    tracer = _tracer(req)
    traces, joined = gather_traces(req, tracer, req.q_int("limit", 64),
                                   _wants_join(req, "0"))
    out = {"service": tracer.service,
           "record_failures": tracer.record_failures,
           "traces": traces}
    if joined is not None:
        out["joined_replicas"] = joined
    return out


def admin_tail(req: Request):
    """Tail anatomy (obs/anatomy.py): per-stage histograms, the share
    of p99 mass each stage owns, and the top-k slowest traces with
    stage breakdowns.  On the router the report joins the replicas'
    rings by default (``?join=0`` keeps it local), so the serving-side
    stages are attributed."""
    tracer = _tracer(req)
    traces, joined = gather_traces(req, tracer, req.q_int("limit", 256),
                                   _wants_join(req, "1"))
    report = anatomy.tail_report(traces, top_k=req.q_int("k", 10),
                                 route_prefix=req.q1("route"))
    report["service"] = tracer.service
    if joined is not None:
        report["joined_replicas"] = joined
    acct = req.context.get("device_time")
    if acct is not None:
        # device occupancy alongside the stage taxonomy: which kernel
        # route owned the card over the accounting window
        report["device_time"] = acct.snapshot()
    return report


def admin_slo(req: Request):
    """The SLO burn-rate engine's alert surface (obs/slo.py)."""
    engine = req.context.get("slo")
    if engine is None:
        raise OryxServingException(
            404, "SLO engine not enabled (oryx.obs.slo.enabled)")
    return engine.status()


def admin_region(req: Request):
    """Region identity, from ``oryx.cluster.region.name``; a process
    with richer region state (the router's membership view) merges it
    in through the ``region_info`` context hook."""
    config = req.context.get("config")
    name = config.get_optional_string("oryx.cluster.region.name") \
        if config is not None else None
    out = {"region": name}
    info = req.context.get("region_info")
    if callable(info):
        out.update(info())
    return out


def admin_profile(req: Request):
    """On-demand device profile capture (obs/profile.py); 503 while
    another capture runs."""
    config = req.context.get("config")
    profile_dir = config.get_optional_string("oryx.obs.profile-dir") \
        if config is not None else None
    if not profile_dir:
        raise OryxServingException(
            404, "profiling not enabled (oryx.obs.profile-dir)")
    try:
        return profile_mod.capture_profile(profile_dir,
                                           req.q_int("ms", 500))
    except profile_mod.ProfileBusyError as e:
        raise OryxServingException(503, str(e)) from e


def _flight(req: Request):
    flight = req.context.get("flight")
    if flight is None:
        raise OryxServingException(
            404, "flight recorder not enabled (oryx.obs.flight.dir)")
    return flight


def admin_flight(req: Request):
    """The flight recorder's status: ring occupancy, dump counts, the
    last bundle published (obs/flight.py)."""
    return _flight(req).status()


def admin_flight_dump(req: Request):
    """Manual trigger: snapshot the rings into a bundle now.  Debounced
    and deduped exactly like automatic triggers."""
    return _flight(req).trigger(req.q1("reason", "manual"),
                                detail={"source": "admin"},
                                trigger_id=req.q1("trigger", None))


def admin_diagnose(req: Request):
    """Auto-triage (obs/diagnose.py): the rule engine over this
    process's metric surface, a ranked cause list with runbook anchors.
    On the router ``?join=1`` (its default there) scrapes every live
    replica's surface and diagnoses the merged view."""
    # `from . import diagnose` would resolve to the function the package
    # re-exports over the submodule of the same name
    from .diagnose import build_surface, diagnose, merge_surfaces
    registry = req.context.get("metrics")
    if registry is None:
        raise OryxServingException(404, "metrics not enabled")
    engine = req.context.get("slo")
    acct = req.context.get("device_time")
    surface = build_surface(
        registry=registry,
        slo_status=engine.last_status() if engine is not None else None,
        resilience=resilience_snapshot(),
        device=acct.snapshot() if acct is not None else None)
    sg = req.context.get("scatter")
    joined = None
    if sg is not None and _wants_join(req, "1"):
        surfaces = [surface]
        joined = 0
        for _, payload in sg.scrape_replicas(
                "/admin/diagnose?join=0", deadline=req.deadline):
            replica_surface = payload.get("surface")
            if isinstance(replica_surface, dict):
                surfaces.append(replica_surface)
                joined += 1
        surface = merge_surfaces(surfaces)
    out = diagnose(surface)
    out["surface"] = surface
    if joined is not None:
        out["joined_replicas"] = joined
    return out


# the admin routes every tier mounts beside its own /metrics
ADMIN_ROUTES = [
    Route("GET", "/admin/traces", admin_traces),
    Route("GET", "/admin/tail", admin_tail),
    Route("GET", "/admin/slo", admin_slo),
    Route("GET", "/admin/region", admin_region),
    Route("GET", "/admin/flight", admin_flight),
    Route("GET", "/admin/diagnose", admin_diagnose),
    # mutating: captures device state to disk — read-only mode and
    # DIGEST auth (when configured) both gate it
    Route("GET", "/admin/profile", admin_profile, mutates=True),
    # mutating for the same reason: writes a bundle to the store
    Route("POST", "/admin/flight/dump", admin_flight_dump,
          mutates=True),
]

OBS_ROUTES = [Route("GET", "/metrics", registry_metrics), *ADMIN_ROUTES]


class ObsServer:
    """Minimal metrics/traces HTTP server for the headless tiers.  It
    honors the main serving port's gates: read-only mode and DIGEST
    credentials (``oryx.serving.api.user-name``/``password``) guard the
    mutating ``/admin/profile`` here too."""

    def __init__(self, config, registry, tracer,
                 port: int | None = None,
                 extra_context: dict | None = None):
        self.port = port if port is not None \
            else config.get_optional_int("oryx.obs.metrics-port")
        self._server = None
        self._thread = None
        api = "oryx.serving.api"
        self.app = HttpApp(OBS_ROUTES, context={
            "metrics": registry,
            "tracer": tracer,
            "config": config,
            **(extra_context or {}),
        }, read_only=config.get_bool(f"{api}.read-only"),
           user_name=config.get_optional_string(f"{api}.user-name"),
           password=config.get_optional_string(f"{api}.password"))

    @property
    def enabled(self) -> bool:
        return self.port is not None

    def start(self) -> None:
        if not self.enabled or self._server is not None:
            return
        if self.app.context["config"].get_optional_string(
                "oryx.obs.profile-dir"):
            # /admin/profile captures on a handler's thread
            profile_mod.prime()
        self._server = make_server(self.app, self.port)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ObsServerHTTP")
        self._thread.start()
        _log.info("Observability server listening on port %d", self.port)

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
