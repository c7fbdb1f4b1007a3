"""Cluster assembly: a whole region pair in one process.

:class:`SimCluster` owns the scheduler, the loopback net, the
per-region inproc brokers (unique ``memory://`` names per run, so
parallel runs never share a log), the component registry with
restart factories, and the fault-application switch the fault driver
calls.  The quiesce protocol heals every link, restarts every dead
component, and runs the world until the whole pipeline reports
drained twice in a row — only then do the terminal invariants
(convergence, exactly-once) run, because both are *eventual*
properties: they may be legitimately false mid-partition.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
from collections import defaultdict

from ..kafka import inproc
from ..resilience import faults as prod_faults
from .components import (INPUT_TOPIC, UPDATE_TOPIC, SimClient,
                         SimMirror, SimReplica, SimRouter, SimSpeed,
                         SimSpeedShard)
from .faults import (FaultAction, arm_crash_mid_batch,
                     arm_crash_mid_replay)
from .invariants import Checkers, InvariantViolation
from .net import SimNet
from .sched import Scheduler
from ..kafka.api import KEY_MODEL

__all__ = ["SimCluster"]

_RUN_COUNTER = itertools.count()


class SimCluster:
    def __init__(self, seed: int, keep_trace: bool = False):
        # a leftover armed fault from a previous run would leak chaos
        # across seeds and break seed -> trace determinism
        prod_faults.clear()
        self.sched = Scheduler(seed, keep_trace=keep_trace)
        self.clock = self.sched.clock
        self.rng = self.sched.rng
        self.net = SimNet(self.sched)
        self.checkers = Checkers(self)
        self.stats: dict[str, int] = defaultdict(int)
        self._tag = f"oryx-sim-{next(_RUN_COUNTER)}"
        self._ckpt_base: str | None = None
        self.regions: list[str] = []
        self._brokers: dict[str, inproc.InProcBroker] = {}
        self._factories: dict[str, object] = {}
        self.live: dict[str, object] = {}
        self.dead: set[str] = set()
        self._rec_seq: dict[str, int] = {}
        # region -> shard count when the region runs the sharded
        # crash-safe speed layer (SimSpeedShard) instead of SimSpeed
        self.speed_sharded: dict[str, int] = {}
        # every write the router ACKED (region, entity, rec): the
        # ledger the exactly-once-fold invariant audits after drain
        self.acked_writes: list[tuple[str, str, str]] = []
        # region -> (capacity, window_sec) write-admission budget; on
        # the cluster, not the router, so restarts keep the limit
        self.ingest_limits: dict[str, tuple[int, float]] = {}

    # -- infrastructure -------------------------------------------------------

    def broker_name(self, region: str) -> str:
        return f"{self._tag}-{region}"

    def broker(self, region: str) -> inproc.InProcBroker:
        return self._brokers[region]

    def checkpoint_dir(self, region: str) -> str:
        if self._ckpt_base is None:
            self._ckpt_base = tempfile.mkdtemp(prefix="oryx-sim-ckpt-")
        return os.path.join(self._ckpt_base, region)

    def next_rec(self, region: str) -> str:
        # survives router restarts: a restarted front end must never
        # re-issue an already-used record id
        n = self._rec_seq.get(region, 0) + 1
        self._rec_seq[region] = n
        return f"{region}-{n:05d}"

    # -- assembly -------------------------------------------------------------

    def _start(self, name: str, factory) -> object:
        comp = factory()
        self._factories[name] = factory
        self.live[name] = comp
        self.dead.discard(name)
        if hasattr(comp, "handler"):
            self.net.register(name, comp.handler)
        self.sched.spawn(name, comp.run())
        return comp

    def add_region(self, region: str, speed_shards: int = 1) -> None:
        """Broker + topics + router + speed layer for one region.
        ``speed_shards > 1`` runs the sharded crash-safe speed layer:
        N :class:`SimSpeedShard` workers over the one input topic,
        each folding only its item slice through the real durable
        fence."""
        self.regions.append(region)
        b = inproc.get_broker(self.broker_name(region))
        b.create_topic(UPDATE_TOPIC, partitions=1)
        b.create_topic(INPUT_TOPIC, partitions=1)
        self._brokers[region] = b
        self._start(f"{region}.router",
                    lambda r=region: SimRouter(self, r))
        if speed_shards > 1:
            self.speed_sharded[region] = speed_shards
            for s in range(speed_shards):
                self._start(
                    f"{region}.speed{speed_shards}x{s}",
                    lambda r=region, i=s, n=speed_shards:
                    SimSpeedShard(self, r, i, n))
        else:
            self._start(f"{region}.speed",
                        lambda r=region: SimSpeed(self, r))

    def add_replica(self, region: str, shard: int, of: int,
                    idx: int) -> SimReplica:
        name = f"{region}.rep{of}x{shard}.{idx}"
        return self._start(
            name, lambda r=region, s=shard, o=of, i=idx:
            SimReplica(self, r, s, o, i))

    def add_replica_fleet(self, region: str, of: int,
                          per_shard: int) -> None:
        for shard in range(of):
            for i in range(per_shard):
                self.add_replica(region, shard, of, i)

    def add_mirror(self, region: str, source_region: str) -> None:
        self._start(f"{region}.mirror",
                    lambda r=region, s=source_region:
                    SimMirror(self, r, s))

    def add_client(self, region: str, idx: int, ops: int,
                   entities: list[str]) -> None:
        self._start(f"{region}.client{idx}",
                    lambda r=region, i=idx:
                    SimClient(self, r, i, ops, entities))

    def publish_model(self, region: str) -> None:
        self.broker(region).send(UPDATE_TOPIC, KEY_MODEL,
                                 '{"gen":1}')

    # -- component lifecycle / fault switch -----------------------------------

    def kill_component(self, name: str) -> bool:
        if name not in self.live:
            return False
        self.sched.kill(name)
        self.net.unregister(name)
        del self.live[name]
        self.dead.add(name)
        return True

    def on_component_crashed(self, name: str) -> None:
        """A component died from inside its own task (the production
        crash seam) — same bookkeeping as a kill, without close()."""
        self.net.unregister(name)
        self.live.pop(name, None)
        self.dead.add(name)

    def restart_component(self, name: str) -> bool:
        if name not in self.dead or name not in self._factories:
            return False
        self._start(name, self._factories[name])
        return True

    def apply_fault(self, act: FaultAction) -> None:
        if act.kind == "kill":
            self.kill_component(act.a)
        elif act.kind == "restart":
            self.restart_component(act.a)
        elif act.kind == "cut":
            self.net.cut(act.a, act.b)
        elif act.kind == "heal":
            self.net.heal(act.a, act.b)
        elif act.kind == "delay":
            self.net.add_delay(act.a, act.b, float(act.arg))
        elif act.kind == "duplicate":
            self.net.duplicate(act.a, act.b, int(act.arg))
        elif act.kind == "stall":
            self.sched.stall(act.a, float(act.arg))
        elif act.kind == "crash":
            # arm the matching production crash seam once; the next
            # batch in the fence's window anywhere in the sim dies
            # there (mirror: after sends, before checkpoint save;
            # speed: after UP publishes, before the batch commit)
            if act.a in self.live:
                if ".speed" in act.a:
                    arm_crash_mid_batch()
                else:
                    arm_crash_mid_replay()
        else:
            raise ValueError(f"unknown fault kind {act.kind!r}")

    # -- introspection --------------------------------------------------------

    def router(self, region: str) -> SimRouter | None:
        return self.live.get(f"{region}.router")

    def replicas(self) -> list[SimReplica]:
        return [c for c in self.live.values()
                if isinstance(c, SimReplica)]

    def mirrors(self) -> list[SimMirror]:
        return [c for c in self.live.values()
                if isinstance(c, SimMirror)]

    # -- quiesce + terminal checks --------------------------------------------

    def _drained(self) -> bool:
        for r in self.regions:
            router = self.router(r)
            if router is None or not router.drained():
                return False
            speed = self.live.get(f"{r}.speed")
            if speed is not None and not speed.drained():
                return False
            n = self.speed_sharded.get(r, 0)
            for s in range(n):
                w = self.live.get(f"{r}.speed{n}x{s}")
                if w is None or not w.drained():
                    return False
        for rep in self.replicas():
            if not rep.drained():
                return False
        for m in self.mirrors():
            if not m.caught_up():
                return False
        return True

    def quiesce(self, max_extra: float = 30.0) -> None:
        """Heal everything, restart the dead, run until the pipeline
        drains (stable for two consecutive probes)."""
        self.net.heal_all()
        prod_faults.clear()
        for name in sorted(self.dead):
            self.restart_component(name)
        self.sched.note("quiesce")
        deadline = self.clock.monotonic() + max_extra
        stable = 0
        while True:
            now = self.clock.monotonic()
            if now >= deadline:
                raise InvariantViolation(
                    "liveness",
                    f"pipeline failed to drain within {max_extra}s "
                    f"of quiesce")
            self.sched.run_until(min(now + 0.25, deadline))
            if self._drained():
                stable += 1
                if stable >= 2:
                    self.sched.note("drained")
                    return
            else:
                stable = 0

    def await_condition(self, cond, timeout: float,
                        what: str) -> None:
        """Run the world until ``cond()`` holds — a bounded liveness
        assertion (e.g. "the cutover completes once healed")."""
        deadline = self.clock.monotonic() + timeout
        while not cond():
            now = self.clock.monotonic()
            if now >= deadline:
                raise InvariantViolation("liveness", what)
            self.sched.run_until(min(now + 0.25, deadline))

    def final_checks(self) -> dict:
        return self.checkers.final(self.regions, self.replicas())

    # -- teardown -------------------------------------------------------------

    def close(self) -> None:
        for r in self.regions:
            inproc.drop_broker(self.broker_name(r))
        self._brokers.clear()
        if self._ckpt_base is not None:
            shutil.rmtree(self._ckpt_base, ignore_errors=True)
        prod_faults.clear()
