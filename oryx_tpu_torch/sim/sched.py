"""Virtual clock + seeded deterministic cooperative scheduler.

The simulation's concurrency model is discrete-event: every
sim-managed "thread" is a Python generator that yields a directive —
:class:`Sleep`, :class:`WaitEvent`, or :class:`Step` — whenever it
reaches a point where a real thread could be preempted, block, or
take a network hop.  The scheduler owns all of them; at each step it
collects the runnable set and picks ONE by PRNG (``random.Random
(seed)``), runs it until its next yield, and records the decision in
the trace.  When nothing is runnable, virtual time jumps straight to
the earliest deadline — no wall-clock ever passes waiting.

Determinism contract (what makes seed → trace a pure function):

- the runnable set is ordered by task spawn order (a plain list), and
  the pick is ``rng.randrange(len(runnable))`` — no iteration over
  sets or other salted-hash containers;
- ALL randomness (scheduling picks, network jitter, fault schedules,
  client workloads) draws from the one seeded stream owned here;
- no sim code reads wall time: production code reused inside the sim
  gets the :class:`SimClock` injected through the ``common.clock``
  seam, under which ``sleep`` *advances* virtual time immediately
  (there is exactly one runnable context — a nested sleep inside
  reused code models an atomic step of that duration) and never
  blocks the process.

The trace is hashed incrementally (sha256); ``trace_hash()`` is the
replay-equality witness: re-running the same scenario with the same
seed must produce the same hash, byte for byte.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from ..common import clock as clockmod

__all__ = ["SimClock", "SimEvent", "Sleep", "WaitEvent", "Step",
           "Task", "Scheduler", "SimError", "SimDeadlock",
           "SimTaskFailed"]


class SimError(Exception):
    """Scheduler-level failure (step budget blown, bad directive)."""


class SimDeadlock(SimError):
    """Every live task is blocked on an event with no timeout and no
    timer is pending — virtual time can never advance again."""


class SimTaskFailed(SimError):
    """A sim task raised; carries the task name and virtual time."""

    def __init__(self, task: str, t: float, cause: BaseException):
        super().__init__(f"task {task!r} failed at t={t:.3f}s: "
                         f"{type(cause).__name__}: {cause}")
        self.task = task
        self.t = t
        self.cause = cause


class SimClock(clockmod.Clock):
    """The cooperative virtual clock.  Monotonic starts at 0; the wall
    clock is a fixed epoch plus the monotonic reading, so record
    timestamps are deterministic too.  Only the scheduler calls
    :meth:`advance_to`; ``sleep`` from inside reused production code
    advances time directly — legal because the caller is the one
    runnable context in the whole process."""

    def __init__(self, start_wall: float = 1_700_000_000.0):
        self._mono = 0.0
        self._wall0 = start_wall

    def time(self) -> float:
        return self._wall0 + self._mono

    def monotonic(self) -> float:
        return self._mono

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._mono += seconds

    def wait(self, event, timeout: float | None = None) -> bool:
        # an un-timed wait inside reused code would hang virtual time
        # forever; sim-covered modules only wait with timeouts
        if event.is_set():
            return True
        if timeout is None:
            raise SimError("untimed Event.wait under SimClock")
        self.sleep(timeout)
        return event.is_set()

    def advance_to(self, t: float) -> None:
        if t < self._mono:
            raise SimError(f"clock rewind: {t} < {self._mono}")
        self._mono = t


class SimEvent:
    """Cooperative event: no locks, no threads.  Tasks park on it via
    ``yield WaitEvent(ev, timeout)``; the scheduler wakes them when it
    is set (or their deadline passes — the yield's send-value tells
    the task which)."""

    __slots__ = ("_set",)

    def __init__(self):
        self._set = False

    def set(self) -> None:
        self._set = True

    def clear(self) -> None:
        self._set = False

    def is_set(self) -> bool:
        return self._set


@dataclass(frozen=True)
class Sleep:
    """Yield: runnable again after ``seconds`` of virtual time."""
    seconds: float


@dataclass(frozen=True)
class WaitEvent:
    """Yield: runnable when ``event`` is set or ``timeout`` virtual
    seconds pass (timeout=None waits forever — deadlock-detected).
    The resumed ``yield`` evaluates to ``event.is_set()``."""
    event: SimEvent
    timeout: float | None = None


class Step:
    """Yield: a bare preemption point — immediately runnable again,
    but another task may be scheduled in between.  ``yield None``
    means the same thing."""


# task states
_RUNNABLE, _SLEEPING, _WAITING, _DONE, _KILLED, _FAILED = range(6)
_STATE_NAMES = ("runnable", "sleeping", "waiting", "done", "killed",
                "failed")


class Task:
    __slots__ = ("name", "gen", "state", "wake_at", "event",
                 "ev_deadline", "stall_until")

    def __init__(self, name: str, gen):
        self.name = name
        self.gen = gen
        self.state = _RUNNABLE
        self.wake_at = 0.0          # valid when _SLEEPING
        self.event: SimEvent | None = None      # valid when _WAITING
        self.ev_deadline: float | None = None   # valid when _WAITING
        self.stall_until = 0.0      # fault DSL: no steps before this

    @property
    def alive(self) -> bool:
        return self.state in (_RUNNABLE, _SLEEPING, _WAITING)

    def state_name(self) -> str:
        return _STATE_NAMES[self.state]


class Scheduler:
    """Owns every sim task; see the module docstring for the model.

    ``keep_trace=True`` retains the full decision list (for dumping a
    repro); the sha256 running hash is always maintained — it is the
    cheap replay-equality witness the sweeps assert on."""

    def __init__(self, seed: int, clock: SimClock | None = None,
                 keep_trace: bool = False):
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock if clock is not None else SimClock()
        self.tasks: list[Task] = []
        self._by_name: dict[str, Task] = {}
        self.step_no = 0
        self._hash = hashlib.sha256()
        self.trace: list[str] | None = [] if keep_trace else None

    # -- trace ----------------------------------------------------------------

    def note(self, entry: str) -> None:
        """Record one deterministic event.  Entries must never embed
        process-unique values (object ids, pids, wall time)."""
        line = f"{self.step_no}|{self.clock.monotonic():.6f}|{entry}"
        self._hash.update(line.encode())
        self._hash.update(b"\n")
        if self.trace is not None:
            self.trace.append(line)

    def trace_hash(self) -> str:
        return self._hash.hexdigest()

    # -- task lifecycle -------------------------------------------------------

    def spawn(self, name: str, gen) -> Task:
        """Register a generator as a sim task.  A name can be reused
        only after the previous holder died (restart semantics)."""
        prev = self._by_name.get(name)
        if prev is not None and prev.alive:
            raise SimError(f"task name {name!r} already alive")
        t = Task(name, gen)
        self.tasks.append(t)
        self._by_name[name] = t
        self.note(f"spawn|{name}")
        return t

    def spawn_once(self, name: str, fn, delay: float = 0.0) -> Task:
        """One-shot timer: run ``fn()`` after ``delay`` virtual
        seconds (the network's delivery primitive)."""
        def _once():
            if delay > 0:
                yield Sleep(delay)
            fn()
        return self.spawn(name, _once())

    def kill(self, name: str) -> bool:
        """Hard-kill a task (component crash): its generator is closed
        so ``finally`` blocks run, and it never runs again."""
        t = self._by_name.get(name)
        if t is None or not t.alive:
            return False
        t.state = _KILLED
        self.note(f"kill|{name}")
        t.gen.close()
        return True

    def stall(self, name: str, seconds: float) -> bool:
        """Fault DSL: freeze a task (GC/VM pause) — it takes no steps
        until the stall passes, whatever its wake conditions say."""
        t = self._by_name.get(name)
        if t is None or not t.alive:
            return False
        t.stall_until = max(t.stall_until,
                            self.clock.monotonic() + seconds)
        self.note(f"stall|{name}|{seconds:.3f}")
        return True

    def task(self, name: str) -> Task | None:
        return self._by_name.get(name)

    # -- the loop -------------------------------------------------------------

    def _ready(self, t: Task, now: float) -> bool:
        if not t.alive or t.stall_until > now:
            return False
        if t.state == _RUNNABLE:
            return True
        if t.state == _SLEEPING:
            return t.wake_at <= now
        # _WAITING
        assert t.event is not None
        return t.event.is_set() or (t.ev_deadline is not None
                                    and t.ev_deadline <= now)

    def _next_deadline(self, now: float) -> float | None:
        nd: float | None = None
        for t in self.tasks:
            if not t.alive:
                continue
            cands: list[float] = []
            if t.state == _SLEEPING:
                cands.append(t.wake_at)
            elif t.state == _WAITING and t.ev_deadline is not None:
                cands.append(t.ev_deadline)
            elif t.state == _RUNNABLE:
                # runnable but stalled: wakes when the stall lifts
                cands.append(t.stall_until)
            if t.stall_until > now and cands:
                cands = [max(c, t.stall_until) for c in cands]
            for c in cands:
                if nd is None or c < nd:
                    nd = c
        return nd

    def _step(self, t: Task) -> None:
        send_val = None
        if t.state == _WAITING:
            assert t.event is not None
            send_val = t.event.is_set()
        t.state = _RUNNABLE
        t.event = None
        t.ev_deadline = None
        self.note(f"run|{t.name}")
        try:
            d = t.gen.send(send_val)
        except StopIteration:
            t.state = _DONE
            self.note(f"done|{t.name}")
            return
        except Exception as e:
            t.state = _FAILED
            self.note(f"fail|{t.name}|{type(e).__name__}")
            raise SimTaskFailed(t.name, self.clock.monotonic(),
                                e) from e
        now = self.clock.monotonic()
        if d is None or isinstance(d, Step):
            return
        if isinstance(d, Sleep):
            t.state = _SLEEPING
            t.wake_at = now + max(0.0, d.seconds)
            return
        if isinstance(d, WaitEvent):
            t.state = _WAITING
            t.event = d.event
            t.ev_deadline = (None if d.timeout is None
                             else now + max(0.0, d.timeout))
            return
        raise SimError(f"task {t.name!r} yielded {d!r}")

    def run_until(self, t_end: float, max_steps: int = 2_000_000,
                  stop_when=None) -> None:
        """Run the world until virtual ``t_end`` (or ``stop_when()``
        returns True, checked at time-advance points).  Raises
        :class:`SimDeadlock` if no task can ever run again while any
        is still waiting forever."""
        while True:
            now = self.clock.monotonic()
            if now >= t_end:
                return
            runnable = [t for t in self.tasks if self._ready(t, now)]
            if not runnable:
                if stop_when is not None and stop_when():
                    return
                nd = self._next_deadline(now)
                if nd is None:
                    if any(t.alive for t in self.tasks):
                        if stop_when is not None:
                            # quiesce probe: world is idle, let the
                            # caller decide whether that is success
                            return
                        raise SimDeadlock(
                            f"all tasks blocked forever at t={now:.3f}")
                    return  # everything finished
                self.clock.advance_to(min(nd, t_end))
                self.note("advance")
                continue
            self.step_no += 1
            if self.step_no > max_steps:
                raise SimError(f"step budget {max_steps} exhausted at "
                               f"t={now:.3f}")
            t = runnable[self.rng.randrange(len(runnable))]
            self._step(t)
            # reap dead tasks occasionally so the runnable scan stays
            # proportional to the live set (delivery timers churn)
            if self.step_no % 256 == 0 and len(self.tasks) > 64:
                self.tasks = [x for x in self.tasks if x.alive]


def gather(sched: Scheduler, name: str, gens: list):
    """Run sub-generators concurrently as child tasks; return their
    results in order (exceptions captured in-place).  The scatter
    fan-out's concurrency primitive: each child is independently
    schedulable, so deliveries interleave across shards."""
    n = len(gens)
    results: list = [None] * n
    done = SimEvent()
    remaining = [n]

    def _child(i: int, g):
        def run():
            try:
                results[i] = ("ok", (yield from g))
            except Exception as e:
                results[i] = ("err", e)
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
        return run()

    if n == 0:
        return results
    for i, g in enumerate(gens):
        sched.spawn(f"{name}.{i}", _child(i, g))
    # children always terminate (network calls are timeout-bounded),
    # so an untimed wait here cannot deadlock
    yield WaitEvent(done, timeout=None)
    return results
