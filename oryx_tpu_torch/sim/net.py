"""In-memory loopback transport — the router's network without
sockets.

Every component registers a named endpoint; a caller task issues
``resp = yield from net.call(src, dst, req)``.  The call schedules a
delivery timer (base latency + seeded jitter + any fault-injected
extra delay); at delivery the handler runs — atomically if it returns
a value, or as its own schedulable task if it returns a generator
(the router's scatter handler does, so its per-shard fan-out
interleaves with everything else).  The reply wakes the caller
through a :class:`SimEvent`.

Fault surface (driven by the fault-schedule DSL, sim/faults.py):

- ``cut(a, b)`` / ``heal(a, b)``: bidirectional partition, matched by
  endpoint-name prefix — new sends fail after a connect-timeout
  stall, in-flight deliveries are dropped at delivery time (the
  packet died on the wire);
- ``add_delay(a, b, sec)``: extra one-way latency on a link;
- ``duplicate(a, b, times)``: the next ``times`` deliveries on the
  link are delivered twice (Kafka-style at-least-once redelivery) —
  the handler runs twice, the first reply wins;
- an unregistered destination refuses fast (connection refused); a
  destination whose component died mid-flight never replies and the
  caller times out.

``reachable(a, b)`` is also consulted by components that model their
own transport (the mirror's source-broker tail), so one partition
fact serves both RPC and replication links.
"""

from __future__ import annotations

from .sched import Scheduler, SimEvent, Sleep, WaitEvent

__all__ = ["SimNet", "NetError", "RemoteError"]


class NetError(Exception):
    """Unreachable, refused, or timed out — the caller's failover
    trigger, the sim analogue of ConnectionError/socket.timeout."""


class RemoteError(Exception):
    """The remote handler raised — an HTTP 500, not a dead host."""


class SimNet:
    def __init__(self, sched: Scheduler, base_delay: float = 0.002,
                 jitter: float = 0.002, connect_timeout: float = 0.05):
        self.sched = sched
        self.base_delay = base_delay
        self.jitter = jitter
        self.connect_timeout = connect_timeout
        self._endpoints: dict[str, object] = {}
        # unordered prefix pairs; a link (a, b) is cut when any pair
        # matches {a, b} by prefix in either orientation
        self._cuts: list[tuple[str, str]] = []
        self._extra_delay: list[tuple[str, str, float]] = []
        self._dup: dict[tuple[str, str], int] = {}
        self._n = 0
        self.deliveries = 0
        self.drops = 0

    # -- endpoints ------------------------------------------------------------

    def register(self, name: str, handler) -> None:
        self._endpoints[name] = handler

    def unregister(self, name: str) -> None:
        self._endpoints.pop(name, None)

    # -- fault surface --------------------------------------------------------

    @staticmethod
    def _pair_matches(p: tuple[str, str], a: str, b: str) -> bool:
        x, y = p
        return ((a.startswith(x) and b.startswith(y))
                or (a.startswith(y) and b.startswith(x)))

    def cut(self, a: str, b: str) -> None:
        if (a, b) not in self._cuts:
            self._cuts.append((a, b))
            self.sched.note(f"net.cut|{a}|{b}")

    def heal(self, a: str, b: str) -> None:
        before = len(self._cuts)
        self._cuts = [p for p in self._cuts
                      if p != (a, b) and p != (b, a)]
        if len(self._cuts) != before:
            self.sched.note(f"net.heal|{a}|{b}")

    def heal_all(self) -> None:
        if self._cuts:
            self.sched.note("net.heal_all")
        self._cuts = []
        self._extra_delay = []

    def reachable(self, a: str, b: str) -> bool:
        return not any(self._pair_matches(p, a, b) for p in self._cuts)

    def add_delay(self, a: str, b: str, sec: float) -> None:
        self._extra_delay.append((a, b, sec))
        self.sched.note(f"net.delay|{a}|{b}|{sec:.3f}")

    def duplicate(self, a: str, b: str, times: int = 1) -> None:
        self._dup[(a, b)] = self._dup.get((a, b), 0) + times
        self.sched.note(f"net.dup|{a}|{b}|{times}")

    def _delay_for(self, a: str, b: str) -> float:
        d = self.base_delay + self.sched.rng.random() * self.jitter
        for (x, y, sec) in self._extra_delay:
            if self._pair_matches((x, y), a, b):
                d += sec
        return d

    def _take_dup(self, a: str, b: str) -> bool:
        for key in ((a, b), (b, a)):
            n = self._dup.get(key, 0)
            if n > 0:
                self._dup[key] = n - 1
                return True
        return False

    # -- RPC ------------------------------------------------------------------

    def call(self, src: str, dst: str, req, timeout: float = 0.5):
        """Generator: ``resp = yield from net.call(...)``.  Raises
        :class:`NetError` (unreachable/refused/timeout) or
        :class:`RemoteError` (handler raised)."""
        if not self.reachable(src, dst):
            # connect-timeout stall, then failure — a partition is
            # slow to diagnose, unlike a refused port
            yield Sleep(min(timeout, self.connect_timeout))
            raise NetError(f"{src} -> {dst}: unreachable (partition)")
        if dst not in self._endpoints:
            yield Sleep(self.base_delay)
            raise NetError(f"{src} -> {dst}: connection refused")
        self._n += 1
        n = self._n
        box: dict = {}
        reply = SimEvent()

        def deliver(copy="1"):
            # re-check at delivery time: the partition may have cut
            # (packet died on the wire) or the component died
            if not self.reachable(src, dst):
                self.drops += 1
                return
            handler = self._endpoints.get(dst)
            if handler is None:
                self.drops += 1
                return
            self.deliveries += 1
            try:
                res = handler(req)
            except Exception as e:  # remote 500
                if "resp" not in box and "err" not in box:
                    box["err"] = e
                    reply.set()
                return
            if hasattr(res, "send") and hasattr(res, "throw"):
                # async handler: runs as its own schedulable task so
                # its internal awaits interleave with the world
                def runner():
                    try:
                        out = yield from res
                    except Exception as e:
                        if "resp" not in box and "err" not in box:
                            box["err"] = e
                            reply.set()
                        return
                    if "resp" not in box and "err" not in box:
                        box["resp"] = out
                        reply.set()
                self.sched.spawn(f"net.h{copy}|{dst}|{n}", runner())
            else:
                if "resp" not in box and "err" not in box:
                    box["resp"] = res
                    reply.set()

        self.sched.spawn_once(f"net.d|{dst}|{n}", deliver,
                              self._delay_for(src, dst))
        if self._take_dup(src, dst):
            # at-least-once redelivery: the handler runs again later;
            # only the first reply is seen by the caller
            self.sched.spawn_once(f"net.d2|{dst}|{n}",
                                  lambda: deliver("2"),
                                  self._delay_for(src, dst))
        ok = yield WaitEvent(reply, timeout)
        if not ok:
            raise NetError(f"{src} -> {dst}: timeout after "
                           f"{timeout:.3f}s")
        if "err" in box:
            raise RemoteError(f"{dst}: {box['err']!r}") from box["err"]
        return box["resp"]
