"""End-to-end observability for the lambda runtime (docs/OBSERVABILITY.md).

Counterpart of ``oryx_tpu/obs/``, with the reference's exports:

- ``trace``   — sampled span tracer, W3C traceparent propagation
- ``prom``    — mergeable fixed-bucket histograms + Prometheus text +
  OpenMetrics exposition with bucket exemplars
- ``anatomy`` — critical-path stage attribution over finished span
  trees (the /admin/tail report)
- ``slo``     — declarative SLOs, multi-window multi-burn-rate alerts
  (/admin/slo)
- ``events``  — wide-event JSONL request log, size-rotated
- ``profile`` — on-demand ``torch.profiler`` capture
- ``flight``  — anomaly-triggered black-box flight recorder (bounded
  rings, trigger-correlated JSON bundles)
- ``device_time`` — continuous per-route device-execute accounting
  (``device_busy_fraction``)
- ``diagnose`` — pure rule engine ranking likely causes over the
  catalogued metric surface (/admin/diagnose)
- ``freshness`` — the lambda freshness gauges
- ``server``  — shared /metrics + /admin/* resources and the headless
  tiers' side-door metrics server
"""

from .device_time import (DeviceTimeAccountant, install_process_accountant,
                          process_accountant)
from .diagnose import (build_surface, diagnose, diagnose_bundle,
                       merge_surfaces, surface_from_bundle)
from .events import events_from_config
from .flight import FlightRecorder, flight_from_config
from .prom import (LATENCY_BUCKETS_MS, Histogram, bucket_quantile,
                   merge_histograms, merge_snapshots,
                   render_openmetrics, render_openmetrics_blocks,
                   render_prometheus, render_prometheus_blocks)
from .slo import engine_from_config
from .trace import (NOOP_SPAN, Span, Tracer, format_traceparent,
                    parse_traceparent, tracer_from_config)

__all__ = ["LATENCY_BUCKETS_MS", "Histogram", "bucket_quantile",
           "merge_histograms", "merge_snapshots", "render_prometheus",
           "render_prometheus_blocks", "render_openmetrics",
           "render_openmetrics_blocks", "NOOP_SPAN", "Span",
           "Tracer", "format_traceparent", "parse_traceparent",
           "tracer_from_config", "engine_from_config",
           "events_from_config", "FlightRecorder", "flight_from_config",
           "DeviceTimeAccountant", "install_process_accountant",
           "process_accountant", "build_surface", "diagnose",
           "diagnose_bundle", "merge_surfaces", "surface_from_bundle"]
