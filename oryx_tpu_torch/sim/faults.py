"""The fault-schedule DSL: what breaks, when, driven by the seed.

A schedule is a sorted list of :class:`FaultAction`; the schedule
runs as its OWN sim task (the fault driver), so injection instants
interleave with everything else under the seeded scheduler — the same
seed that picks the interleaving picks the faults.

Actions (``kind``):

- ``kill`` / ``restart`` — component crash and (cold) restart: a
  replica restarts empty and replays the update topic from offset 0;
  a mirror restarts onto its durable checkpoint and runs the REAL
  ``recover()`` fence re-derivation; a router restarts with an empty
  membership registry and re-taps the topic.
- ``cut`` / ``heal`` — bidirectional link partition by endpoint-name
  prefix (router↔replica links, or a region's mirror↔remote-broker
  replication link).
- ``delay`` — extra one-way latency on a link.
- ``duplicate`` — the next N deliveries on a link delivered twice
  (at-least-once redelivery).
- ``stall`` — freeze one component for a duration (GC/VM pause): it
  stays "alive" (its heartbeats just stop flowing) but takes no
  steps.
- ``crash`` — arm the production crash seam matching the named
  component once (resilience/faults.py): a mirror dies at
  ``mirror-crash-mid-replay`` (after its sends, before its checkpoint
  save); a speed worker dies at ``speed-crash-mid-batch`` (after its
  UP publishes, before its batch commit) — in each case the exact
  window the exactly-once fence exists for.

``random_schedule`` derives a schedule from the scenario's RNG — the
same seeded stream the scheduler picks tasks with — so seed → faults
is deterministic too.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..resilience import faults as prod_faults
from .sched import Sleep, Step

__all__ = ["FaultAction", "FaultSchedule", "random_schedule",
           "KINDS"]

KINDS = ("kill", "cut", "delay", "duplicate", "stall", "crash")


@dataclass(frozen=True)
class FaultAction:
    at: float               # virtual seconds from scenario start
    kind: str               # see module docstring
    a: str                  # component, or link end A
    b: str | None = None    # link end B (cut/heal/delay/duplicate)
    arg: float | None = None  # stall/delay seconds, duplicate count

    def __str__(self) -> str:
        tail = f"|{self.b}" if self.b else ""
        argp = f"|{self.arg:.3f}" if self.arg is not None else ""
        return f"{self.kind}|{self.a}{tail}{argp}@{self.at:.3f}"


class FaultSchedule:
    def __init__(self, actions: list[FaultAction]):
        self.actions = sorted(actions,
                              key=lambda x: (x.at, x.kind, x.a))

    def driver(self, cluster):
        """The fault-driver sim task: sleeps to each action's instant
        and applies it through the cluster."""
        for act in self.actions:
            now = cluster.sched.clock.monotonic()
            if act.at > now:
                yield Sleep(act.at - now)
            cluster.sched.note(f"fault|{act}")
            cluster.apply_fault(act)
            yield Step()


def random_schedule(rng, horizon: float, n: int,
                    components: list[str],
                    links: list[tuple[str, str]],
                    crashable: list[str] | None = None,
                    allow: tuple[str, ...] = KINDS) -> FaultSchedule:
    """Derive ``n`` faults from ``rng``.  Destructive actions are
    paired with their recovery (kill→restart, cut→heal) inside the
    first 80% of the horizon so the quiesce phase converges; anything
    still broken at quiesce is healed/restarted wholesale there —
    partitions that outlive the horizon are part of the test."""
    allow = tuple(k for k in allow
                  if (k not in ("kill", "stall", "crash")
                      or components)
                  and (k not in ("cut", "delay", "duplicate")
                       or links))
    acts: list[FaultAction] = []
    for _ in range(n):
        if not allow:
            break
        kind = allow[rng.randrange(len(allow))]
        t = rng.uniform(0.2, horizon * 0.8)
        if kind == "kill":
            c = components[rng.randrange(len(components))]
            dt = rng.uniform(0.3, 1.5)
            acts.append(FaultAction(t, "kill", c))
            acts.append(FaultAction(t + dt, "restart", c))
        elif kind == "cut":
            a, b = links[rng.randrange(len(links))]
            dt = rng.uniform(0.3, 2.0)
            acts.append(FaultAction(t, "cut", a, b))
            acts.append(FaultAction(t + dt, "heal", a, b))
        elif kind == "delay":
            a, b = links[rng.randrange(len(links))]
            acts.append(FaultAction(t, "delay", a, b,
                                    rng.uniform(0.02, 0.25)))
        elif kind == "duplicate":
            a, b = links[rng.randrange(len(links))]
            acts.append(FaultAction(t, "duplicate", a, b,
                                    float(rng.randrange(1, 4))))
        elif kind == "stall":
            c = components[rng.randrange(len(components))]
            acts.append(FaultAction(t, "stall", c,
                                    arg=rng.uniform(0.1, 1.2)))
        elif kind == "crash":
            pool = crashable if crashable else components
            c = pool[rng.randrange(len(pool))]
            dt = rng.uniform(0.3, 1.5)
            acts.append(FaultAction(t, "crash", c))
            acts.append(FaultAction(t + dt, "restart", c))
    return FaultSchedule(acts)


def arm_crash_mid_replay() -> None:
    """Arm the production mid-replay crash seam once (see module
    docstring); the next mirror replay anywhere in the sim dies in
    the fence's window."""
    prod_faults.inject("mirror-crash-mid-replay", mode="crash",
                       times=1)


def arm_crash_mid_batch() -> None:
    """Arm the production speed fold-in crash seam once: the next
    speed micro-batch anywhere in the sim dies AFTER its UP
    publishes, BEFORE its checkpoint commit — the window the
    SpeedCheckpoint fence's replay dedup exists for."""
    prod_faults.inject("speed-crash-mid-batch", mode="crash",
                       times=1)


def reset_production_faults() -> None:
    """Scrub the process-global fault registry between sim runs —
    leftover armed faults would leak one run's chaos into the next
    and break seed → trace determinism."""
    prod_faults.clear()
