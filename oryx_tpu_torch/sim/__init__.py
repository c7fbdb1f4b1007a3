"""Deterministic cluster simulation — a whole region pair in one
process, every chaos IT at thousands of interleavings.

The counterpart of the JAX package's ``oryx_tpu.sim``, standing up the
port's own modules (``cluster/{membership,mirror,sharding}``,
``lambda_rt/speed_checkpoint``, ``kafka/inproc``, ``resilience/faults``,
``common/clock`` and ``obs/{diagnose,flight,slo}``); a seed gives the
same trace hash here as there.  It is FoundationDB-style testing:
instead of spawning real processes and real sockets and exploring exactly ONE
scheduling interleaving per run, the simulation stands up the full
two-region topology — routers, R-way replica groups, speed layers,
mirrors — inside one process under a virtual clock and a *seeded*
cooperative scheduler.  Every scheduling decision, network delay and
fault-injection instant derives from one integer seed, so a failing
seed replays its exact event trace (asserted by trace-hash equality)
and a sweep of hundreds of seeds explores hundreds of interleavings
in less wall-clock than one real-process IT.

Layers (bottom up):

- ``sched``    — virtual clock + seeded cooperative scheduler + trace
- ``net``      — in-memory loopback transport: partitions, delays,
                 duplicate deliveries, no sockets
- ``faults``   — the fault-schedule DSL (kill/restart, partition/heal,
                 delay, duplicate, stall), seed-derived schedules
- ``components`` — sim replicas/routers/speed/clients plus the REAL
                 MembershipRegistry and MirrorLayer driven under the
                 virtual clock
- ``invariants`` — the continuously-checked correctness properties
- ``cluster``  — region/cluster assembly and the quiesce protocol
- ``scenarios``  — the seed-swept scenarios (reshard cutover, mirror
                 partition/heal) and the repro entry point

Reproduce a failing seed:

    python -m oryx_tpu_torch.sim --scenario <name> --seed <N> --trace

See docs/SIMULATION.md for the scheduler model and the clock seam
contract.
"""

from .sched import (Scheduler, SimClock, SimEvent, Sleep, WaitEvent,
                    Step, SimError, SimDeadlock)
from .scenarios import run_scenario, SCENARIOS, SimResult, SimFailure

__all__ = ["Scheduler", "SimClock", "SimEvent", "Sleep", "WaitEvent",
           "Step", "SimError", "SimDeadlock", "run_scenario",
           "SCENARIOS", "SimResult", "SimFailure"]
