"""The port's ``Supervisor`` (resilience/policy.py) against the
reference's, on the reference's cases (tests/test_resilience.py): a
dead layer restarts with backoff, an exhausted budget raises, healthy
uptime resets the budget, and a failing factory counts as a crash.
Each case runs both supervisors with an injected clock and sleep and
compares what they did."""

from __future__ import annotations

import threading
import time

import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.resilience import policy as jpolicy
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.resilience import policy as tpolicy

IMPLS = {"reference": jpolicy, "port": tpolicy}


class _FakeLayer:
    def __init__(self, alive: bool):
        self._alive = alive
        self._stop = threading.Event()
        self.closed = False

    def start(self):
        pass

    def await_(self):
        if self._alive:
            self._stop.wait(10.0)

    def close(self):
        self.closed = True
        self._stop.set()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _restart_then_run(policy):
    created = []

    def factory():
        # the first two layers die at once; the third stays up until the
        # test stops the supervisor as the shutdown hook would
        layer = _FakeLayer(alive=len(created) >= 2)
        created.append(layer)
        return layer

    sleeps = []
    sup = policy.Supervisor(factory, "t-layer", max_restarts=5,
                            backoff=policy.Backoff(0.01, 0.04, jitter=0.0),
                            sleep=sleeps.append)
    runner = threading.Thread(target=sup.run)
    runner.start()
    deadline = time.monotonic() + 10.0
    while len(created) < 3 and time.monotonic() < deadline:
        time.sleep(0.001)
    sup.stop()
    sup.layer.close()
    runner.join(10.0)
    assert not runner.is_alive()
    return {"created": len(created), "restarts": sup.restarts,
            "sleeps": sleeps, "all_closed": all(x.closed for x in created)}


def _budget_exhausted(policy):
    sup = policy.Supervisor(lambda: _FakeLayer(alive=False), "t-layer-2",
                            max_restarts=2,
                            backoff=policy.Backoff(0.0, 0.0, jitter=0.0),
                            sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="exceeded 2 restarts") as e:
        sup.run()
    return {"restarts": sup.restarts, "error": str(e.value)}


def _factory_failures(policy):
    attempts = []

    def factory():
        attempts.append(1)
        if len(attempts) < 3:
            raise ConnectionError("broker still down")
        return _FakeLayer(alive=False)

    sup = policy.Supervisor(factory, "t-layer-3", max_restarts=3,
                            backoff=policy.Backoff(0.0, 0.0, jitter=0.0),
                            sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="exceeded 3 restarts"):
        sup.run()
    return {"attempts": len(attempts), "restarts": sup.restarts}


def _healthy_reset(policy):
    clock = _Clock()

    class _TimedLayer(_FakeLayer):
        def __init__(self):
            super().__init__(alive=False)

        def await_(self):
            clock.t += 1000.0  # ran healthily for a long time

    cycles = []
    sup = policy.Supervisor(_TimedLayer, "t-layer-4", max_restarts=2,
                            backoff=policy.Backoff(0.0, 0.0, jitter=0.0),
                            sleep=lambda s: None, healthy_reset_sec=300.0,
                            clock=clock)

    def counting_sleep(s):
        cycles.append(s)
        if len(cycles) >= 6:
            sup.stop()

    sup._sleep = counting_sleep
    sup.run()  # would raise after 2 restarts without the reset
    return {"cycles": len(cycles), "restarts": sup.restarts}


@pytest.mark.parametrize("case", [_restart_then_run, _budget_exhausted,
                                  _factory_failures, _healthy_reset],
                         ids=lambda f: f.__name__.strip("_"))
def test_supervisor_case_matches_reference(case):
    ref, port = (case(IMPLS[name]) for name in ("reference", "port"))
    assert port == ref
    if case is _restart_then_run:
        assert port == {"created": 3, "restarts": 2, "sleeps": [0.01, 0.02],
                        "all_closed": True}
    if case is _factory_failures:
        assert port["attempts"] == 4  # the first try and 3 restarts
    if case is _healthy_reset:
        assert port["restarts"] <= 1


def test_supervisor_from_config_reads_the_same_keys():
    overlay = {"oryx.resilience.supervisor.max-restarts": 7,
               "oryx.resilience.supervisor.initial-backoff-ms": 150,
               "oryx.resilience.supervisor.max-backoff-ms": 900}
    got = []
    for config, policy in ((jconfig, jpolicy), (tconfig, tpolicy)):
        sup = policy.Supervisor.from_config(
            lambda: None, "x", config.from_dict(overlay))
        got.append((sup.max_restarts, sup.backoff.initial,
                    sup.backoff.maximum))
    assert got[0] == got[1] == (7, 0.15, 0.9)
