"""The port's deterministic cluster simulation (``oryx_tpu_torch.sim``):
the substrate's unit tests (virtual clock, seeded cooperative
scheduler, loopback transport, fault-schedule DSL), one seed of every
scenario under a ``time.sleep``/``socket.socket`` tripwire, and parity
with the JAX package's ``oryx_tpu.sim``: on seeds 0-39 of each scenario
the port gives the reference's trace hash, step count and virtual
seconds.  The seed sweeps and the pinned corpus are in
tests/test_torch_sim_sweep.py.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time

import pytest

from oryx_tpu.sim import run_scenario as ref_run_scenario
from oryx_tpu_torch.sim import (SCENARIOS, Scheduler, SimClock,
                                SimDeadlock, SimError, SimEvent, Sleep,
                                Step, WaitEvent, run_scenario)
from oryx_tpu_torch.sim.faults import (FaultAction, FaultSchedule, KINDS,
                                       random_schedule)
from oryx_tpu_torch.sim.invariants import InvariantViolation
from oryx_tpu_torch.sim.net import NetError, RemoteError, SimNet
from oryx_tpu_torch.sim.scenarios import SimFailure, _run
from oryx_tpu_torch.sim.sched import SimTaskFailed, gather

# -- virtual clock ------------------------------------------------------------


class TestSimClock:
    def test_monotonic_starts_at_zero_and_sleep_advances(self):
        c = SimClock()
        assert c.monotonic() == 0.0
        c.sleep(1.5)
        assert c.monotonic() == 1.5
        c.sleep(-3.0)  # negative sleep is a no-op, never a rewind
        assert c.monotonic() == 1.5

    def test_wall_clock_is_epoch_plus_monotonic(self):
        c = SimClock(start_wall=1000.0)
        assert c.time() == 1000.0
        c.sleep(2.0)
        assert c.time() == 1002.0

    def test_advance_to_rejects_rewind(self):
        c = SimClock()
        c.advance_to(5.0)
        with pytest.raises(SimError, match="rewind"):
            c.advance_to(4.0)

    def test_wait_set_event_returns_true_without_advancing(self):
        c, ev = SimClock(), SimEvent()
        ev.set()
        assert c.wait(ev, timeout=9.0) is True
        assert c.monotonic() == 0.0

    def test_wait_unset_event_burns_the_timeout(self):
        c, ev = SimClock(), SimEvent()
        assert c.wait(ev, timeout=3.0) is False
        assert c.monotonic() == 3.0

    def test_untimed_wait_is_rejected(self):
        # an untimed Event.wait inside reused production code would
        # hang virtual time forever — the sim-clock contract bans it
        with pytest.raises(SimError, match="untimed"):
            SimClock().wait(SimEvent(), timeout=None)


# -- scheduler ----------------------------------------------------------------


def _trace_of(seed: int) -> tuple[str, list[str]]:
    """A small multi-task world: sleeps, event waits, preemption
    points — every directive kind the scheduler knows."""
    s = Scheduler(seed, keep_trace=True)
    ev = SimEvent()
    log: list[str] = []

    def ticker(name, period, n):
        for i in range(n):
            yield Sleep(period)
            log.append(f"{name}{i}")

    def setter():
        yield Sleep(0.25)
        ev.set()

    def waiter():
        got = yield WaitEvent(ev, timeout=10.0)
        log.append(f"waiter:{got}")
        yield Step()
        log.append("waiter:stepped")

    s.spawn("t1", ticker("a", 0.1, 3))
    s.spawn("t2", ticker("b", 0.07, 3))
    s.spawn("setter", setter())
    s.spawn("waiter", waiter())
    s.run_until(2.0)
    return s.trace_hash(), log


class TestScheduler:
    def test_same_seed_same_trace_and_order(self):
        h1, log1 = _trace_of(42)
        h2, log2 = _trace_of(42)
        assert h1 == h2
        assert log1 == log2

    def test_different_seed_different_interleaving(self):
        hashes = {_trace_of(seed)[0] for seed in range(8)}
        # 8 seeds of a contended world: at least two distinct traces,
        # or the scheduler is not actually exploring interleavings
        assert len(hashes) > 1

    def test_waiter_woken_by_set_sees_true(self):
        _, log = _trace_of(0)
        assert "waiter:True" in log
        assert "waiter:stepped" in log

    def test_event_wait_timeout_sends_false(self):
        s = Scheduler(0)
        ev = SimEvent()
        out = []

        def waiter():
            out.append((yield WaitEvent(ev, timeout=0.5)))

        s.spawn("w", waiter())
        s.run_until(2.0)
        assert out == [False]
        assert s.clock.monotonic() >= 0.5

    def test_time_jumps_to_next_deadline_without_busy_stepping(self):
        s = Scheduler(0)

        def lone():
            yield Sleep(100.0)

        s.spawn("lone", lone())
        steps_before = s.step_no
        s.run_until(100.0)
        # one spawn-step + one wake: the century of virtual idle time
        # costs O(1) steps, not a poll loop
        assert s.step_no - steps_before <= 2

    def test_kill_runs_finally_blocks_and_frees_the_name(self):
        s = Scheduler(0)
        closed = []

        def victim():
            try:
                while True:
                    yield Sleep(0.1)
            finally:
                closed.append(True)

        s.spawn("v", victim())
        s.run_until(0.5)
        assert s.kill("v") is True
        assert closed == [True]
        assert s.kill("v") is False  # already dead
        s.spawn("v", victim())  # restart semantics: name reusable

    def test_spawn_rejects_live_duplicate_name(self):
        s = Scheduler(0)
        s.spawn("x", iter(()))
        s.spawn("dup", (Sleep(1.0) for _ in range(1)))
        with pytest.raises(SimError, match="already alive"):
            s.spawn("dup", iter(()))

    def test_stall_freezes_a_task_past_its_wake_time(self):
        s = Scheduler(0)
        woke = []

        def sleeper():
            yield Sleep(0.1)
            woke.append(s.clock.monotonic())

        s.spawn("z", sleeper())
        assert s.stall("z", 1.0) is True
        s.run_until(5.0)
        # due at 0.1 but frozen until 1.0 — the GC-pause model
        assert woke and woke[0] >= 1.0

    def test_deadlock_detected(self):
        s = Scheduler(0)

        def stuck():
            yield WaitEvent(SimEvent(), timeout=None)

        s.spawn("stuck", stuck())
        with pytest.raises(SimDeadlock):
            s.run_until(10.0)

    def test_task_exception_surfaces_with_name_and_time(self):
        s = Scheduler(0)

        def bad():
            yield Sleep(0.2)
            raise ValueError("boom")

        s.spawn("bad", bad())
        with pytest.raises(SimTaskFailed, match="'bad'.*boom"):
            s.run_until(1.0)

    def test_gather_returns_in_order_with_errors_in_place(self):
        s = Scheduler(3)

        def child(i):
            yield Sleep(0.01 * (3 - i))  # finish out of spawn order
            if i == 1:
                raise RuntimeError("child down")
            return i * 10

        out = []

        def parent():
            res = yield from gather(s, "fan", [child(i)
                                               for i in range(3)])
            out.append(res)

        s.spawn("parent", parent())
        s.run_until(1.0)
        (res,) = out
        assert res[0] == ("ok", 0)
        assert res[2] == ("ok", 20)
        kind, err = res[1]
        assert kind == "err" and isinstance(err, RuntimeError)


# -- loopback transport -------------------------------------------------------


def _rpc(net, sched, req, out, timeout=0.5, src="cli", dst="srv"):
    def task():
        try:
            out.append(("ok", (yield from net.call(src, dst, req,
                                                   timeout=timeout))))
        except (NetError, RemoteError) as e:
            out.append(("err", e))
    sched.spawn(f"rpc{len(out)}-{sched.step_no}", task())


class TestSimNet:
    def test_roundtrip_and_virtual_latency(self):
        s = Scheduler(1)
        net = SimNet(s)
        net.register("srv", lambda req: {"echo": req})
        out = []
        _rpc(net, s, "hi", out)
        s.run_until(1.0)
        assert out == [("ok", {"echo": "hi"})]
        assert s.clock.monotonic() > 0.0  # the hop cost virtual time

    def test_unregistered_destination_refuses(self):
        s = Scheduler(1)
        net = SimNet(s)
        out = []
        _rpc(net, s, "hi", out)
        s.run_until(1.0)
        kind, err = out[0]
        assert kind == "err" and "refused" in str(err)

    def test_cut_times_out_heal_restores(self):
        s = Scheduler(1)
        net = SimNet(s)
        net.register("srv", lambda req: "pong")
        net.cut("cli", "srv")
        assert not net.reachable("cli", "srv")
        out = []
        _rpc(net, s, "a", out)
        s.run_until(1.0)
        assert out[0][0] == "err"
        net.heal("cli", "srv")
        assert net.reachable("cli", "srv")
        _rpc(net, s, "b", out)
        s.run_until(2.0)
        assert out[1] == ("ok", "pong")

    def test_cut_matches_by_prefix_both_orientations(self):
        s = Scheduler(1)
        net = SimNet(s)
        net.cut("A.router", "A.rep")
        assert not net.reachable("A.rep2x0.1", "A.router")
        assert not net.reachable("A.router", "A.rep3x2.0")
        assert net.reachable("A.router", "B.rep2x0.1")

    def test_add_delay_slows_the_link(self):
        s = Scheduler(1)
        net = SimNet(s)
        net.register("srv", lambda req: "pong")
        net.add_delay("cli", "srv", 0.2)
        out = []
        _rpc(net, s, "a", out, timeout=1.0)
        s.run_until(2.0)
        assert out == [("ok", "pong")]
        assert s.clock.monotonic() >= 0.2

    def test_duplicate_runs_handler_twice_first_reply_wins(self):
        s = Scheduler(1)
        net = SimNet(s)
        calls = []
        net.register("srv", lambda req: calls.append(req) or "pong")
        net.duplicate("cli", "srv", times=1)
        out = []
        _rpc(net, s, "a", out)
        s.run_until(1.0)
        assert out == [("ok", "pong")]
        assert calls == ["a", "a"]  # at-least-once redelivery

    def test_handler_exception_is_remote_error(self):
        s = Scheduler(1)
        net = SimNet(s)

        def boom(req):
            raise RuntimeError("500")

        net.register("srv", boom)
        out = []
        _rpc(net, s, "a", out)
        s.run_until(1.0)
        kind, err = out[0]
        assert kind == "err" and isinstance(err, RemoteError)

    def test_generator_handler_interleaves_as_its_own_task(self):
        s = Scheduler(1)
        net = SimNet(s)

        def slow_handler(req):
            yield Sleep(0.1)
            return f"done:{req}"

        net.register("srv", slow_handler)
        out = []
        _rpc(net, s, "x", out, timeout=1.0)
        s.run_until(2.0)
        assert out == [("ok", "done:x")]


# -- fault-schedule DSL -------------------------------------------------------


class TestFaultDSL:
    def test_random_schedule_is_a_pure_function_of_the_rng(self):
        import random
        comps = ["A.rep", "A.router"]
        links = [("A.router", "A.rep")]
        s1 = random_schedule(random.Random(7), 6.0, 5, comps, links)
        s2 = random_schedule(random.Random(7), 6.0, 5, comps, links)
        assert [str(a) for a in s1.actions] \
            == [str(a) for a in s2.actions]

    def test_destructive_actions_are_paired_with_recovery(self):
        import random
        comps = ["A.rep"]
        links = [("A.router", "A.rep")]
        sched = random_schedule(random.Random(3), 6.0, 12, comps,
                                links, crashable=["A.rep"])
        kinds = [a.kind for a in sched.actions]
        assert kinds.count("restart") \
            == kinds.count("kill") + kinds.count("crash")
        assert kinds.count("heal") == kinds.count("cut")
        for a in sched.actions:
            if a.kind in ("stall", "delay", "duplicate"):
                assert a.arg is not None  # the seed-0/3/7 regression
            assert a.kind in KINDS + ("restart", "heal")

    def test_allow_filter_restricts_kinds(self):
        import random
        sched = random_schedule(
            random.Random(5), 6.0, 10, ["c"], [("a", "b")],
            allow=("stall", "delay"))
        assert {a.kind for a in sched.actions} <= {"stall", "delay"}

    def test_driver_applies_actions_at_their_instants(self):
        s = Scheduler(0)
        applied = []

        class _Cx:
            sched = s

            def apply_fault(self, act):
                applied.append((round(s.clock.monotonic(), 3),
                                act.kind, act.a))

        sched = FaultSchedule([FaultAction(0.5, "kill", "x"),
                               FaultAction(0.2, "cut", "a", "b")])
        s.spawn("driver", sched.driver(_Cx()))
        s.run_until(2.0)
        # sorted by instant, each applied at its virtual time
        assert applied == [(0.2, "cut", "a"), (0.5, "kill", "x")]


# -- end-to-end: the whole region pair, one process, no real I/O --------------


@pytest.fixture
def _no_real_io(monkeypatch):
    """Tripwire: any real socket or real sleep inside the sim path is
    an immediate failure — the zero-sockets/zero-sleeps acceptance
    criterion, enforced rather than asserted after the fact."""

    def _no_sleep(seconds):
        raise AssertionError(
            f"real time.sleep({seconds!r}) inside the sim path")

    class _NoSocket(socket.socket):
        def __init__(self, *a, **kw):
            raise AssertionError("real socket inside the sim path")

    monkeypatch.setattr(time, "sleep", _no_sleep)
    monkeypatch.setattr(socket, "socket", _NoSocket)


class TestEndToEnd:
    def test_two_region_pair_converges_no_sockets_no_sleeps(
            self, _no_real_io):
        """The tentpole acceptance: routers, 2×2 replica fleets per
        region, speed layers, both mirrors — assembled over the
        inproc broker, run to quiesce under the virtual clock, all
        invariants green."""
        res = run_scenario("mirror-partition", seed=1)
        assert res.scenario == "mirror-partition"
        assert len(res.trace_hash) == 64
        # both regions took writes and the checkers actually ran
        assert res.summary["responses_checked"] > 0
        assert res.summary["mirror_polls_checked"] > 0
        assert res.summary["entities"] > 0
        # virtual hours may pass; wall-clock is whatever the CPU took
        assert res.virtual_sec > 6.0

    def test_reshard_cutover_completes_no_sockets_no_sleeps(
            self, _no_real_io):
        res = run_scenario("reshard-cutover", seed=1)
        assert res.stats.get("cutover") == 1
        assert res.stats.get("probe_full", 0) >= 1
        assert res.summary["responses_checked"] > 0

    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_every_scenario_runs_no_sockets_no_sleeps(self, scenario,
                                                      _no_real_io):
        res = run_scenario(scenario, seed=2)
        assert res.scenario == scenario and res.seed == 2
        assert len(res.trace_hash) == 64 and res.steps > 0
        assert res.virtual_sec > 0.0

    def test_failure_message_carries_the_repro_command(self):
        """A violated invariant must print seed + repro line — the
        sweep-to-bisect workflow's contract."""

        def body(cx):
            raise InvariantViolation("convergence", "synthetic")

        with pytest.raises(SimFailure) as ei:
            _run("mirror-partition", 77, False, body)
        msg = str(ei.value)
        assert "seed=77" in msg
        assert ("repro: python -m oryx_tpu_torch.sim "
                "--scenario mirror-partition --seed 77 --trace") in msg

    def test_cli_repro_replays_byte_identical_across_processes(self):
        """python -m oryx_tpu_torch.sim twice in FRESH interpreters: the
        trace hash must match across processes, not just within one —
        no process-unique value (pid, id(), tmpdir) may leak into the
        trace — and equal the reference's for the same seed."""
        cmd = [sys.executable, "-m", "oryx_tpu_torch.sim",
               "--scenario", "reshard-cutover", "--seed", "5"]
        outs = []
        for _ in range(2):
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=120, check=True)
            outs.append(json.loads(p.stdout))
        assert outs[0]["trace_hash"] == outs[1]["trace_hash"]
        assert outs[0]["steps"] == outs[1]["steps"]
        ref = ref_run_scenario("reshard-cutover", 5)
        assert (outs[0]["trace_hash"], outs[0]["steps"]) \
            == (ref.trace_hash, ref.steps)


# -- parity with the reference simulation -------------------------------------

_PARITY_SEEDS = range(40)


def test_the_same_five_scenarios_as_the_reference():
    from oryx_tpu.sim import SCENARIOS as REF_SCENARIOS
    assert sorted(SCENARIOS) == sorted(REF_SCENARIOS) == [
        "ingest-overload", "mirror-partition", "reshard-cutover",
        "slo-page-flight", "speed-shard-crash"]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trace_parity_with_the_reference(scenario):
    """The port's modules under the same seed take the reference's
    every scheduling decision: the sha256 over the whole trace, the
    step count and the virtual seconds are equal."""
    differ = []
    for seed in _PARITY_SEEDS:
        got = run_scenario(scenario, seed)
        want = ref_run_scenario(scenario, seed)
        if (got.trace_hash, got.steps, got.virtual_sec) \
                != (want.trace_hash, want.steps, want.virtual_sec):
            differ.append((seed, got.steps, want.steps))
        assert got.stats == want.stats and got.summary == want.summary
    assert not differ, f"{scenario}: seeds that left the reference's " \
        f"trace (seed, port steps, reference steps): {differ}"
