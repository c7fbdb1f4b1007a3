"""The seed-swept scenarios and the failing-seed repro contract.

Each scenario is a pure function of its seed: build the topology,
derive a fault schedule from the scenario RNG, run to the horizon,
quiesce, then run the terminal invariants.  ``SimResult.trace_hash``
is the determinism witness — running the same (scenario, seed) twice
must produce identical hashes, which the sweep tests assert.

On any invariant violation (or scheduler failure) the runner raises
:class:`SimFailure` carrying the seed, the virtual time, the trace
hash and the one-line repro command:

    python -m oryx_tpu_torch.sim --scenario <name> --seed <N> --trace

which replays the identical run and dumps the decision trace.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .cluster import SimCluster
from .faults import FaultAction, FaultSchedule, random_schedule
from .invariants import InvariantViolation
from .sched import Sleep, SimError
from ..resilience.faults import InjectedCrash

__all__ = ["SimResult", "SimFailure", "run_scenario", "SCENARIOS"]

ENTITIES = [f"e{i:02d}" for i in range(16)]


@dataclass
class SimResult:
    scenario: str
    seed: int
    trace_hash: str
    steps: int
    virtual_sec: float
    stats: dict = field(default_factory=dict)
    summary: dict = field(default_factory=dict)
    trace: list | None = None


class SimFailure(Exception):
    """A seed exposed a violation.  The message IS the bug report:
    invariant, seed, virtual time, trace hash, repro command."""

    def __init__(self, scenario: str, seed: int, trace_hash: str,
                 steps: int, t: float, cause: BaseException):
        self.scenario = scenario
        self.seed = seed
        self.trace_hash = trace_hash
        self.cause = cause
        super().__init__(
            f"{type(cause).__name__}: {cause}\n"
            f"  scenario={scenario} seed={seed} steps={steps} "
            f"t={t:.3f}s trace={trace_hash[:16]}\n"
            f"  repro: python -m oryx_tpu_torch.sim --scenario {scenario} "
            f"--seed {seed} --trace")


def _finish(cx: SimCluster, scenario: str, seed: int,
            keep_trace: bool) -> SimResult:
    summary = cx.final_checks()
    return SimResult(
        scenario=scenario, seed=seed,
        trace_hash=cx.sched.trace_hash(), steps=cx.sched.step_no,
        virtual_sec=cx.clock.monotonic(), stats=dict(cx.stats),
        summary=summary,
        trace=list(cx.sched.trace) if keep_trace else None)


def _run(scenario: str, seed: int, keep_trace: bool, body) -> SimResult:
    cx = SimCluster(seed, keep_trace=keep_trace)
    try:
        body(cx)
        return _finish(cx, scenario, seed, keep_trace)
    except (InvariantViolation, SimError, InjectedCrash) as e:
        raise SimFailure(scenario, seed, cx.sched.trace_hash(),
                         cx.sched.step_no, cx.clock.monotonic(),
                         e) from e
    finally:
        cx.close()


# -- scenario: mirror partition / heal replay --------------------------------

def run_mirror_partition(seed: int, shards: int = 2,
                         per_shard: int = 1, ops: int = 22,
                         horizon: float = 6.0,
                         keep_trace: bool = False) -> SimResult:
    """Active-active two-region pair; the replication link is cut and
    healed at seeded instants (every seed gets at least one
    partition), with extra seeded chaos on top — mirror crashes in
    the mid-replay fence window, replica/speed/router kills, link
    delays, duplicate deliveries, stalls.  After heal + drain both
    regions must hold byte-identical state with exactly-once
    replay."""

    def body(cx: SimCluster):
        rng = cx.rng
        for r in ("A", "B"):
            cx.add_region(r)
            cx.add_replica_fleet(r, shards, per_shard)
        cx.publish_model("A")
        cx.add_mirror("A", source_region="B")
        cx.add_mirror("B", source_region="A")
        for r in ("A", "B"):
            cx.add_client(r, 0, ops, ENTITIES)
        # every seed partitions at least one replication link; which
        # one, when, and for how long is the seed's choice
        link = ("A.mirror", "B.broker") if rng.random() < 0.5 \
            else ("B.mirror", "A.broker")
        t_cut = rng.uniform(0.6, horizon * 0.5)
        t_heal = t_cut + rng.uniform(0.5, 2.5)
        forced = [FaultAction(t_cut, "cut", *link),
                  FaultAction(t_heal, "heal", *link)]
        components = ([f"{r}.rep{shards}x{s}.{i}"
                       for r in ("A", "B") for s in range(shards)
                       for i in range(per_shard)]
                      + ["A.speed", "B.speed", "A.router", "B.router",
                         "A.mirror", "B.mirror"])
        links = [("A.mirror", "B.broker"), ("B.mirror", "A.broker"),
                 ("A.router", "A.rep"), ("B.router", "B.rep")]
        extra = random_schedule(
            rng, horizon, n=2 + rng.randrange(4),
            components=components, links=links,
            crashable=["A.mirror", "B.mirror"])
        sched = FaultSchedule(forced + extra.actions)
        cx.sched.spawn("fault-driver", sched.driver(cx))
        cx.sched.run_until(horizon)
        cx.quiesce()

    return _run("mirror-partition", seed, keep_trace, body)


# -- scenario: live reshard cutover ------------------------------------------

def _reshard_driver(cx: SimCluster, region: str, new_of: int,
                    per_shard: int, start_at: float):
    """The reconciling control plane: declare the reshard target,
    spawn the warming fleet once, and re-assert the declaration after
    router restarts until the registry commits the atomic cutover."""
    yield Sleep(start_at)
    cx.sched.note(f"reshard.begin|{region}|{new_of}")
    while True:
        r = cx.router(region)
        if r is not None:
            st = r.registry.topology_status()
            if st["merged_of"] == new_of:
                cx.stats["cutover"] = 1
                cx.sched.note(f"reshard.cutover|{region}")
                return
            if st["reshard_target"] != new_of:
                r.registry.begin_reshard(new_of)
                if not cx.stats.get("reshard_declared"):
                    cx.stats["reshard_declared"] = 1
                    for shard in range(new_of):
                        for i in range(per_shard):
                            cx.add_replica(region, shard, new_of, i)
        yield Sleep(0.3)


def _probe(cx: SimCluster, region: str, n: int):
    """Query-only probe of the post-cutover ring; unlike a client it
    never writes, so "no complete 200 in n tries" is a real liveness
    failure and not the luck of a write-heavy op mix."""
    from .net import NetError, RemoteError
    for _ in range(n):
        try:
            resp = yield from cx.net.call(
                f"{region}.probe", f"{region}.router",
                {"op": "query"}, timeout=1.2)
        except (NetError, RemoteError):
            continue
        if resp.get("status") == 200 and not resp.get("partial"):
            cx.stats["probe_full"] += 1


def run_reshard_cutover(seed: int, old_of: int = 2,
                        new_of: int = 3, per_shard: int = 2,
                        new_per_shard: int = 1, ops: int = 30,
                        horizon: float = 6.0,
                        keep_trace: bool = False) -> SimResult:
    """A live 2→3 reshard under continuous client load with seeded
    chaos: replica/speed/router kills and restarts, router↔replica
    partitions, delays, duplicate deliveries, stalls — landing at
    every point of the warming/cutover window across seeds.  The
    single-snapshot and no-silently-partial invariants run on every
    response; after quiesce the cutover must have committed and a
    probe scan must return a complete 200 on the new ring."""

    def body(cx: SimCluster):
        rng = cx.rng
        cx.add_region("A")
        cx.add_replica_fleet("A", old_of, per_shard)
        cx.publish_model("A")
        cx.add_client("A", 0, ops, ENTITIES)
        t_reshard = rng.uniform(0.8, 2.0)
        cx.sched.spawn("reshard-driver",
                       _reshard_driver(cx, "A", new_of,
                                       new_per_shard, t_reshard))
        components = ([f"A.rep{old_of}x{s}.{i}"
                       for s in range(old_of)
                       for i in range(per_shard)]
                      + [f"A.rep{new_of}x{s}.{i}"
                         for s in range(new_of)
                         for i in range(new_per_shard)]
                      + ["A.speed", "A.router"])
        links = ([("A.router", f"A.rep{old_of}x{s}.{i}")
                  for s in range(old_of) for i in range(per_shard)]
                 + [("A.router", f"A.rep{new_of}")]
                 + [("A.client0", "A.router")])
        sched = random_schedule(
            rng, horizon, n=2 + rng.randrange(4),
            components=components, links=links,
            allow=("kill", "cut", "delay", "duplicate", "stall"))
        cx.sched.spawn("fault-driver", sched.driver(cx))
        cx.sched.run_until(horizon)
        cx.quiesce()
        # liveness: once healed, the reconciler must drive the
        # cutover home
        cx.await_condition(
            lambda: cx.stats.get("cutover") == 1, 12.0,
            f"reshard to {new_of} never cut over after quiesce")
        cx.quiesce()
        # probe the new ring: a complete (non-partial) 200 at the new
        # topology
        cx.sched.spawn("A.probe", _probe(cx, "A", 4))
        cx.sched.run_until(cx.clock.monotonic() + 2.0)
        if cx.stats.get("probe_full", 0) < 1:
            raise InvariantViolation(
                "liveness",
                "no complete 200 served on the new ring after "
                "cutover + quiesce")
        r = cx.router("A")
        if r is None or r.registry.shard_count != new_of:
            raise InvariantViolation(
                "liveness",
                f"routed topology is not {new_of} after cutover")

    return _run("reshard-cutover", seed, keep_trace, body)


# -- scenario: sharded speed layer crash / recover ---------------------------

def run_speed_shard_crash(seed: int, speed_shards: int = 2,
                          shards: int = 2, per_shard: int = 1,
                          ops: int = 34, horizon: float = 6.0,
                          keep_trace: bool = False) -> SimResult:
    """Single region running the sharded crash-safe speed layer under
    continuous client load.  Every seed kills one speed worker — via a
    raw process kill (landing anywhere, including between a batch's
    publishes) or the production ``speed-crash-mid-batch`` seam (after
    every publish, before the commit) — and restarts it through the
    real ``recover_pending`` fence, with extra seeded chaos on top.
    After quiesce, every ACKED write must appear exactly once in the
    update log, stamped by its owner shard: zero lost, zero
    double-folded, through any interleaving."""

    def body(cx: SimCluster):
        rng = cx.rng
        cx.add_region("A", speed_shards=speed_shards)
        cx.add_replica_fleet("A", shards, per_shard)
        cx.publish_model("A")
        cx.add_client("A", 0, ops, ENTITIES)
        speeds = [f"A.speed{speed_shards}x{s}"
                  for s in range(speed_shards)]
        # every seed downs at least one speed worker; which one, when,
        # and whether it is a kill or the mid-batch crash seam is the
        # seed's choice
        victim = speeds[rng.randrange(len(speeds))]
        # inside the client's write window, so an armed mid-batch
        # seam has live batches to land in before quiesce
        t = rng.uniform(0.3, 1.4)
        kind = "crash" if rng.random() < 0.6 else "kill"
        forced = [FaultAction(t, kind, victim),
                  FaultAction(t + rng.uniform(0.3, 1.5), "restart",
                              victim)]
        components = ([f"A.rep{shards}x{s}.{i}"
                       for s in range(shards)
                       for i in range(per_shard)]
                      + speeds + ["A.router"])
        links = [("A.router", "A.rep"), ("A.client0", "A.router")]
        extra = random_schedule(
            rng, horizon, n=1 + rng.randrange(3),
            components=components, links=links, crashable=speeds)
        sched = FaultSchedule(forced + extra.actions)
        cx.sched.spawn("fault-driver", sched.driver(cx))
        cx.sched.run_until(horizon)
        cx.quiesce()

    return _run("speed-shard-crash", seed, keep_trace, body)


# -- scenario: ingest overload / backpressure --------------------------------

def _burst_writer(cx: SimCluster, region: str, n: int,
                  start_at: float):
    """A hot producer: back-to-back writes far past the region's
    admission budget.  Sheds are expected and retryable; what must
    NEVER happen is a 200 whose record the pipeline then loses — the
    terminal fold invariant audits exactly that."""
    from .net import NetError
    yield Sleep(start_at)
    st = cx.stats
    for i in range(n):
        yield Sleep(0.02)
        try:
            resp = yield from cx.net.call(
                f"{region}.burst", f"{region}.router",
                {"op": "write",
                 "e": ENTITIES[i % len(ENTITIES)]},
                timeout=1.2)
        except NetError:
            st["burst_errors"] += 1
            continue
        if resp.get("status") == 503:
            st["burst_sheds"] += 1
        else:
            st["burst_ok"] += 1


def run_ingest_overload(seed: int, speed_shards: int = 2,
                        shards: int = 2, per_shard: int = 1,
                        ops: int = 16, horizon: float = 6.0,
                        keep_trace: bool = False) -> SimResult:
    """A write burst against a region whose router admits at most
    ``cap`` writes per sliding window, over the sharded speed layer
    with seeded crash chaos.  The backpressure contract under test:
    overload produces explicit 503 sheds (never queue collapse), a
    shed is never an ack, and every 200 that WAS returned survives
    the overload + crashes to exactly one fold on its owner shard."""

    def body(cx: SimCluster):
        rng = cx.rng
        cx.add_region("A", speed_shards=speed_shards)
        cx.add_replica_fleet("A", shards, per_shard)
        cx.publish_model("A")
        # the admission budget lives on the cluster, so a restarted
        # router keeps shedding
        cap = 3 + rng.randrange(3)
        cx.ingest_limits["A"] = (cap, 1.5)
        cx.add_client("A", 0, ops, ENTITIES)
        burst_n = 18 + rng.randrange(8)
        cx.sched.spawn(
            "A.burst",
            _burst_writer(cx, "A", burst_n,
                          rng.uniform(0.3, 1.0)))
        speeds = [f"A.speed{speed_shards}x{s}"
                  for s in range(speed_shards)]
        # chaos on the fold path only: the router must stay up so the
        # burst exercises admission, not unreachability
        extra = random_schedule(
            rng, horizon, n=1 + rng.randrange(3),
            components=speeds, links=[("A.client0", "A.router")],
            crashable=speeds,
            allow=("kill", "crash", "delay", "stall"))
        cx.sched.spawn("fault-driver", extra.driver(cx))
        cx.sched.run_until(horizon)
        cx.quiesce()
        if cx.stats.get("ingest_sheds", 0) < 1:
            raise InvariantViolation(
                "backpressure",
                f"a burst of {burst_n} writes against an admission "
                f"budget of {cap}/1.5s produced zero sheds")

    return _run("ingest-overload", seed, keep_trace, body)


# -- scenario: SLO page -> flight dump -> auto-triage ------------------------

def _flight_monitor(cx: SimCluster, mirror_name: str, reg, engine,
                    flight):
    """The alerting sidecar, cooperatively scheduled: bridge the
    mirror's staleness surface into the host registry, feed the flight
    recorder's tick ring, evaluate the SLO engine.  Ordering matters —
    the tick lands BEFORE evaluate(), so the bundle a page snapshots
    carries the gauge reading that paged."""
    last_link = 0
    while True:
        yield Sleep(0.05)
        m = cx.live.get(mirror_name)
        if m is not None:
            stale = m.layer.metrics.gauge_value(
                "cross_region_staleness_ms")
            if stale is not None:
                reg.set_gauge("cross_region_staleness_ms",
                              float(stale))
            link = m.layer.link_failures
            if link > last_link:
                reg.inc("mirror_link_failures", link - last_link)
                last_link = link
        flight.observe_request("GET /sim/probe", 200, 1.0)
        engine.evaluate()


def run_slo_page_flight(seed: int, ops: int = 18,
                        horizon: float = 6.0,
                        keep_trace: bool = False) -> SimResult:
    """The diagnosis loop, end to end and deterministic: an
    un-healed replication-link cut stalls one mirror, its staleness
    gauge burns a kind=gauge SLO objective into ``page``, the page
    callback triggers a flight dump, and the bundle's embedded
    diagnosis must rank the injected cause (``mirror-stalled``)
    first.  A second trigger inside the debounce window must be
    counted and dropped, not dumped.  The SLO engine runs on a scaled
    sim clock (1 virtual s = 720 SLO-s) and the recorder on the raw
    sim clock, so every seed replays to the same trace hash."""
    import json as jsonmod
    import os as osmod

    from ..lambda_rt.metrics import MetricsRegistry
    from ..obs.diagnose import diagnose_bundle
    from ..obs.flight import FlightRecorder
    from ..obs.slo import SloEngine, SloObjective

    def body(cx: SimCluster):
        rng = cx.rng
        for r in ("A", "B"):
            cx.add_region(r)
            cx.add_replica_fleet(r, 2, 1)
        cx.publish_model("A")
        cx.add_mirror("A", source_region="B")
        cx.add_mirror("B", source_region="A")
        for r in ("A", "B"):
            cx.add_client(r, 0, ops, ENTITIES)
        # the alerting sidecar: host registry + gauge-kind objective
        # over the bridged staleness reading + armed recorder
        reg = MetricsRegistry()
        scale = 720.0  # 1 virtual s = 720 SLO-s: a 5m window is 0.42s
        engine = SloEngine(
            [SloObjective("staleness", kind="gauge", target=0.9,
                          gauge="cross_region_staleness_ms",
                          max_value=500.0)],
            reg, fast_burn=5.0, slow_burn=3.0, resolution_sec=15.0,
            clock=lambda: cx.clock.monotonic() * scale)
        fdir = osmod.path.join(cx.checkpoint_dir("A"), "flight")
        flight = FlightRecorder(
            "sim", reg, dir=fdir, slo=engine,
            diagnose_fn=diagnose_bundle,
            tick_sec=0.05, debounce_sec=3.0, dump_on_exit=False,
            clock=cx.clock.monotonic, wall=cx.clock.time)

        def on_page(name, st):
            cx.stats["slo_pages"] += 1
            cx.sched.note(f"slo.page|{name}")
            flight.trigger("slo-page", {"objective": name})

        engine.on_page = on_page
        try:
            # the injected cause: cut B.mirror off its source and do
            # NOT heal — staleness must climb until the page fires
            t_cut = rng.uniform(0.8, 1.4)
            forced = [FaultAction(t_cut, "cut", "B.mirror",
                                  "A.broker")]
            # flavor chaos on the OTHER replication direction only:
            # the paging path itself stays deterministic
            extra = random_schedule(
                rng, horizon, n=1 + rng.randrange(2),
                components=[], links=[("A.mirror", "B.broker")],
                allow=("delay", "duplicate"))
            sched = FaultSchedule(forced + extra.actions)
            cx.sched.spawn("fault-driver", sched.driver(cx))
            cx.sched.spawn("slo-monitor",
                           _flight_monitor(cx, "B.mirror", reg,
                                           engine, flight))
            cx.await_condition(
                lambda: cx.stats.get("slo_pages", 0) >= 1, horizon,
                f"staleness SLO never paged after the {t_cut:.2f}s "
                f"link cut")
            if flight.dumps != 1:
                raise InvariantViolation(
                    "flight", f"page produced {flight.dumps} bundles "
                    f"(want exactly 1)")
            names = sorted(n for n in osmod.listdir(fdir)
                           if n.endswith(".json"))
            if len(names) != 1:
                raise InvariantViolation(
                    "flight", f"bundle dir holds {names} "
                    f"(want exactly one published bundle)")
            with open(osmod.path.join(fdir, names[0]),
                      encoding="utf-8") as fh:
                bundle = jsonmod.load(fh)
            if bundle.get("trigger_reason") != "slo-page":
                raise InvariantViolation(
                    "flight", f"bundle trigger_reason="
                    f"{bundle.get('trigger_reason')!r} "
                    f"(want 'slo-page')")
            causes = (bundle.get("diagnosis") or {}).get("causes") \
                or []
            if not causes or causes[0]["cause"] != "mirror-stalled":
                raise InvariantViolation(
                    "triage", "diagnosis did not rank the injected "
                    f"cause first: {[c['cause'] for c in causes]}")
            cx.stats["diagnosis_top_mirror_stalled"] = 1
            # a page storm inside the debounce window collapses: the
            # second trigger is counted, never dumped
            res = flight.trigger("slo-page-repeat")
            if not res.get("debounced"):
                raise InvariantViolation(
                    "flight", f"trigger inside the debounce window "
                    f"was not debounced: {res}")
            cx.stats["flight_debounced"] = \
                int(reg.counters_snapshot().get(
                    "flight_trigger_debounced", 0))
            cx.sched.run_until(horizon)
        finally:
            flight.close()
        cx.quiesce()

    return _run("slo-page-flight", seed, keep_trace, body)


SCENARIOS = {
    "mirror-partition": run_mirror_partition,
    "reshard-cutover": run_reshard_cutover,
    "speed-shard-crash": run_speed_shard_crash,
    "ingest-overload": run_ingest_overload,
    "slo-page-flight": run_slo_page_flight,
}


def run_scenario(name: str, seed: int, keep_trace: bool = False,
                 **kwargs) -> SimResult:
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return fn(seed, keep_trace=keep_trace, **kwargs)
