"""Declarative SLOs evaluated as multi-window multi-burn-rate alerts.

Counterpart of ``oryx_tpu/obs/slo.py``, whole.

The Google SRE workbook's alerting discipline, sized for this runtime:
an objective declares a target fraction of *good* requests
(availability: non-5xx; latency: under a fixed bucket bound), and the
engine turns the registry's cumulative counters into **burn rates** —
the ratio of the observed error rate to the error budget ``1 -
target``.  Burn 1.0 consumes the budget exactly over the SLO period;
burn 14.4 exhausts a 30-day budget in 2 days.  Alerts require TWO
windows to breach together (a long window for significance, a short
one so recovered incidents stop alerting fast):

- **page**:   burn(5m)  >= fast-burn  AND  burn(1h) >= fast-burn
- **ticket**: burn(30m) >= slow-burn  AND  burn(6h) >= slow-burn

Counting is pure arithmetic over the SAME fixed-bucket counters that
merge exactly (lambda_rt/metrics.py): a latency objective's
good count is the cumulative count at its threshold bucket, so the SLO
view can never disagree with the histogram view.  The engine keeps a
bounded ring of periodic counter snapshots and computes each window as
a counter delta — no per-request work at all; evaluation happens at
most once per ``resolution-sec`` and is triggered lazily by whoever
reads the gauges (``/metrics`` scrapes, ``/admin/slo``, the
autoscaler's poll).

Strictly best-effort like the rest of ``oryx.obs.*``: a raising
evaluator (chaos point ``obs-slo-eval-error``) freezes the last alert
state, bumps ``slo_eval_failures``, and never touches a request.
Config lives under ``oryx.obs.slo.*`` (docs/OBSERVABILITY.md has a
worked example).
"""

from __future__ import annotations

import json
import threading
from collections import deque

from ..common import clock as clockmod
from ..resilience import faults
from .prom import LATENCY_BUCKETS_MS

__all__ = ["SloObjective", "SloEngine", "engine_from_config",
           "is_data_plane"]

# evaluation windows (seconds): (short, long) per alert severity
FAST_WINDOWS = (300.0, 3600.0)      # page:   5m / 1h
SLOW_WINDOWS = (1800.0, 21600.0)    # ticket: 30m / 6h
# the SLO period the burn thresholds are calibrated against (the SRE
# workbook's 30-day window): burn 1.0 sustained for the WHOLE period
# consumes the budget exactly
SLO_PERIOD_SEC = 30.0 * 24 * 3600.0
_WINDOW_LABELS = {300.0: "5m", 3600.0: "1h",
                  1800.0: "30m", 21600.0: "6h"}

# routes that never vote on an SLO unless explicitly targeted: the
# health/metrics/admin surface the control plane itself hits
_CONTROL_EXACT = frozenset({"GET /metrics", "GET /ready", "GET /error",
                            "GET /", "unmatched"})
_CONTROL_PREFIX = ("GET /admin", "GET /shard", "POST /shard")


def is_data_plane(route: str) -> bool:
    """True for the public data-plane routes that vote on SLOs (and on
    the autoscaler's interval p99) — not the health/metrics/admin/
    internal-shard surface."""
    return route not in _CONTROL_EXACT \
        and not route.startswith(_CONTROL_PREFIX)


class SloObjective:
    """One declared objective under ``oryx.obs.slo.objectives.<name>``.

    Kinds: ``availability`` (good = non-5xx) and ``latency`` (good =
    within a fixed bucket bound) count real requests; ``gauge`` counts
    evaluation *ticks* — each tick is good when the named registry
    gauge sits at or below ``max-value`` — turning a measured bound
    (e.g. the mirror's ``cross_region_staleness_ms``) into the same
    burn-rate alert discipline: a region allowed to be stale 1% of the
    time pages when staleness burns that budget 14.4x too fast.  Tick
    counters are cumulative and monotone, so the ring/baseline window
    math is unchanged."""

    __slots__ = ("name", "kind", "target", "threshold_ms",
                 "route_prefix", "gauge", "max_value",
                 "_ticks_good", "_ticks_total")

    def __init__(self, name: str, kind: str = "availability",
                 target: float = 0.999, threshold_ms: float = 0.0,
                 route_prefix: str | None = None,
                 gauge: str | None = None, max_value: float = 0.0):
        if kind not in ("availability", "latency", "gauge"):
            raise ValueError(f"SLO {name}: unknown kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO {name}: target must be in (0, 1)")
        if kind == "latency":
            if threshold_ms not in LATENCY_BUCKETS_MS:
                raise ValueError(
                    f"SLO {name}: threshold-ms {threshold_ms!r} must be "
                    f"one of the fixed bucket bounds "
                    f"{LATENCY_BUCKETS_MS} — the good-count is a bucket "
                    f"counter, so the threshold must sit on a bucket "
                    f"edge to stay exact")
        if kind == "gauge":
            if not gauge:
                raise ValueError(
                    f"SLO {name}: kind=gauge requires the `gauge` name")
            if gauge.startswith("slo_"):
                # the engine's own exports call evaluate() from their
                # gauge fns: watching one would deadlock evaluation on
                # its (non-reentrant) lock
                raise ValueError(
                    f"SLO {name}: kind=gauge cannot watch the "
                    f"engine's own {gauge!r} export")
            if not max_value > 0.0:
                # the implicit 0.0 default would count every positive
                # reading bad — a page that never clears
                raise ValueError(
                    f"SLO {name}: kind=gauge requires a positive "
                    f"`max-value` (the measured bound)")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.threshold_ms = float(threshold_ms)
        self.route_prefix = route_prefix
        self.gauge = gauge
        self.max_value = float(max_value)
        self._ticks_good = 0
        self._ticks_total = 0

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def matches(self, route: str) -> bool:
        if self.route_prefix is not None:
            return route.split(" ", 1)[-1].startswith(self.route_prefix)
        return is_data_plane(route)

    def gauge_tick(self, value: float | None) -> tuple[int, int]:
        """Advance and return the cumulative tick counters for a
        ``gauge`` objective: one (good-if-within-bound, total) sample
        per evaluation.  A None reading casts no vote — a mirror that
        has not polled yet must not page before it can measure."""
        if value is not None:
            self._ticks_total += 1
            if float(value) <= self.max_value:
                self._ticks_good += 1
        return self._ticks_good, self._ticks_total

    def counts(self, routes: dict) -> tuple[int, int]:
        """Cumulative ``(good, total)`` over the matching routes of one
        registry snapshot (``prometheus_snapshot(gauges=False)``)."""
        good = total = 0
        for route, r in routes.items():
            if not self.matches(route):
                continue
            if self.kind == "availability":
                c = int(r.get("count") or 0)
                total += c
                good += c - int(r.get("server_errors") or 0)
            else:
                buckets = (r.get("latency_ms") or {}).get("buckets") or ()
                for i, c in enumerate(buckets):
                    total += int(c)
                    if i < len(LATENCY_BUCKETS_MS) \
                            and LATENCY_BUCKETS_MS[i] <= self.threshold_ms:
                        good += int(c)
        return good, total


class SloEngine:
    """Snapshot ring + burn-rate math + the per-objective alert state
    machine, served at ``/admin/slo`` and exported as the
    ``slo_burn_rate`` / ``slo_error_budget_remaining`` gauges."""

    def __init__(self, objectives: list[SloObjective], registry,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 resolution_sec: float = 15.0,
                 clock=clockmod.monotonic):
        self.objectives = list(objectives)
        self._registry = registry
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.resolution_sec = float(resolution_sec)
        self._clock = clock
        self.eval_failures = 0
        # page-transition callback, set at wiring time (the flight
        # recorder's trigger).  Invoked WITH the engine lock held —
        # the callback must never call back into evaluate()/status()/
        # burn_gauge() (the lock is non-reentrant); the objective's
        # state dict is passed directly instead.
        self.on_page = None
        self._lock = threading.Lock()
        # (t, {objective: (good, total)}) — bounded to the longest
        # window plus one resolution step
        self._horizon = max(SLOW_WINDOWS) + self.resolution_sec
        self._ring: deque[tuple[float, dict]] = deque()
        self._last_eval = float("-inf")
        self._status: dict = {
            "objectives": {
                o.name: {"kind": o.kind, "target": o.target,
                         "threshold_ms": o.threshold_ms or None,
                         "gauge": o.gauge,
                         "max_value": o.max_value if o.kind == "gauge"
                         else None,
                         "state": "ok", "since": None,
                         "transitions": 0, "windows": {}}
                for o in self.objectives},
            "eval_failures": 0}

    # -- burn math -----------------------------------------------------------

    def _baseline(self, name: str, now: float,
                  window: float) -> tuple[int, int]:
        """Newest snapshot at-or-before the window start; a process
        younger than the window falls back to (0, 0) — i.e. process
        start is the baseline, which only ever OVER-counts the window
        (conservative at startup)."""
        base = (0, 0)
        for t, counts in self._ring:
            if now - t < window:
                break
            base = counts.get(name, base)
        return base

    def _burn(self, name: str, budget: float, cur: tuple[int, int],
              now: float, window: float) -> dict:
        g0, t0 = self._baseline(name, now, window)
        good = max(0, cur[0] - g0)
        total = max(0, cur[1] - t0)
        err = (total - good) / total if total > 0 else 0.0
        return {"burn": round(err / budget, 2),
                "error_rate": round(err, 6),
                "good": good, "total": total}

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: float | None = None) -> dict:
        """Advance the ring and the alert state machine (rate-limited
        to once per resolution-sec); returns the current status dict.
        A raising evaluator freezes the previous state — alerting must
        degrade to stale, never to wrong-and-churning."""
        with self._lock:
            now = self._clock() if now is None else now
            if now - self._last_eval < self.resolution_sec:
                return self._status
            self._last_eval = now
            try:
                # chaos seam: any internal failure (a poisoned
                # registry, arithmetic on corrupt state) must freeze
                # the alert surface, not take down /metrics
                faults.fire("obs-slo-eval-error")
                routes = self._registry.prometheus_snapshot(
                    gauges=False)["routes"]
                # gauge objectives sample their watched gauge by name
                # (never a full gauges_snapshot — the engine's own
                # slo_* exports would recurse straight back here;
                # SloObjective.__init__ rejects watching them)
                counts = {}
                for o in self.objectives:
                    if o.kind == "gauge":
                        counts[o.name] = o.gauge_tick(
                            self._registry.gauge_value(o.gauge))
                    else:
                        counts[o.name] = o.counts(routes)
                self._ring.append((now, counts))
                while self._ring and now - self._ring[0][0] > self._horizon:
                    self._ring.popleft()
                self._advance(counts, now)
            except Exception:  # noqa: BLE001 — strictly best-effort
                self.eval_failures += 1
                self._status["eval_failures"] = self.eval_failures
                if self._registry is not None:
                    try:
                        self._registry.inc("slo_eval_failures")
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
            return self._status

    def _advance(self, counts: dict, now: float) -> None:
        for o in self.objectives:
            st = self._status["objectives"][o.name]
            cur = counts[o.name]
            windows = {}
            for w in sorted({*FAST_WINDOWS, *SLOW_WINDOWS}):
                windows[_WINDOW_LABELS[w]] = self._burn(
                    o.name, o.budget, cur, now, w)
            fast = min(windows["5m"]["burn"], windows["1h"]["burn"])
            slow = min(windows["30m"]["burn"], windows["6h"]["burn"])
            if fast >= self.fast_burn:
                state = "page"
            elif slow >= self.slow_burn:
                state = "ticket"
            else:
                state = "ok"
            if state != st["state"]:
                st["transitions"] += 1
                st["since"] = round(now, 3)
                if state == "page":
                    cb = self.on_page
                    if cb is not None:
                        try:
                            cb(o.name, {**st, "state": state})
                        except Exception:  # noqa: BLE001 — best-effort hook
                            pass
            st["state"] = state
            st["windows"] = windows
            st["fast_burn"] = fast
            st["slow_burn"] = slow
            # budget consumed by the LAST 6h of traffic, scaled to the
            # 30-day period (burn 1.0 over 6h eats 6h/30d of budget,
            # not all of it).  A lower bound on real remaining budget:
            # consumption older than the 6h ring horizon is not
            # tracked — honest and horizon-bounded, never dramatic.
            consumed = windows["6h"]["burn"] \
                * (max(SLOW_WINDOWS) / SLO_PERIOD_SEC)
            st["error_budget_remaining"] = round(
                max(0.0, min(1.0, 1.0 - consumed)), 4)

    # -- gauge exports (obs catalog: slo_burn_rate / remaining) --------------

    def burn_gauge(self) -> float:
        """Worst objective's fast-window burn — min(5m, 1h) per
        objective (the page condition), max across objectives.  The
        autoscaler's SLO pressure signal."""
        status = self.evaluate()
        burns = [o.get("fast_burn", 0.0)
                 for o in status["objectives"].values()]
        return round(max(burns), 2) if burns else 0.0

    def budget_gauge(self) -> float:
        status = self.evaluate()
        rem = [o.get("error_budget_remaining", 1.0)
               for o in status["objectives"].values()]
        return min(rem) if rem else 1.0

    def last_status(self) -> dict:
        """The most recently computed status, WITHOUT evaluating —
        lock-free on purpose: the flight recorder reads this from
        inside the page callback (where the engine lock is held) and
        from fault listeners that may interleave with evaluation.  A
        torn read costs one slightly-stale field in a forensic
        bundle, never a deadlock."""
        try:
            return json.loads(json.dumps(self._status, default=str))
        except Exception:  # noqa: BLE001 — forensics are best-effort
            return {}

    def status(self) -> dict:
        """The ``/admin/slo`` view."""
        out = dict(self.evaluate())
        out["fast_burn_threshold"] = self.fast_burn
        out["slow_burn_threshold"] = self.slow_burn
        out["eval_failures"] = self.eval_failures
        return out


def engine_from_config(config, registry) -> SloEngine | None:
    """Build the tier's engine from ``oryx.obs.slo.*``; None when
    disabled (the /admin/slo endpoint then 404s and no gauges are
    registered)."""
    base = "oryx.obs.slo"
    if not config.get_bool(f"{base}.enabled"):
        return None
    raw = config.get(f"{base}.objectives") or {}
    objectives = []
    for name, spec in sorted(raw.items()):
        spec = spec or {}
        objectives.append(SloObjective(
            name,
            kind=str(spec.get("kind", "availability")),
            target=float(spec.get("target", 0.999)),
            threshold_ms=float(spec.get("threshold-ms", 0.0) or 0.0),
            route_prefix=spec.get("route-prefix"),
            gauge=spec.get("gauge"),
            max_value=float(spec.get("max-value", 0.0) or 0.0)))
    return SloEngine(
        objectives, registry,
        fast_burn=config.get_double(f"{base}.fast-burn"),
        slow_burn=config.get_double(f"{base}.slow-burn"),
        resolution_sec=config.get_double(f"{base}.resolution-sec"))
