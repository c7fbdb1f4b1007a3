"""The port's faults that oryx-lint found on its first run over
``oryx_tpu_torch/``, each held to its repair:

- the in-process broker's idle timer and offset-flush interval read
  the clock seam (``common/clock``), not the wall (``sim-clock``);
- the resubscribe loop's backoff waits through the seam, so a virtual
  clock ends it without real seconds (``sim-clock``);
- the RDF hyperparameters and the TLS key alias are read as literal
  keys, and the JAX-only compile-cache threshold is declared a
  compatibility key (``drift``).
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

import pytest

from oryx_tpu.common import clock as ref_clock
from oryx_tpu.common import config as ref_config
from oryx_tpu.resilience import policy as ref_policy
from oryx_tpu.sim.sched import SimClock as RefSimClock
from oryx_tpu_torch.analysis import drift as drift_pass
from oryx_tpu_torch.common import clock as clockmod
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc
from oryx_tpu_torch.resilience import policy
from oryx_tpu_torch.sim.sched import SimClock

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "oryx_tpu_torch" / "common" / "reference.conf"


# -- kafka/inproc.py reads the clock seam -------------------------------------

def _committed(path: pathlib.Path) -> int | None:
    if not path.exists():
        return None
    with open(path, encoding="utf-8") as f:
        return inproc._decode_offsets(json.load(f)).get(("g", "t", 0))


def test_offset_flush_interval_follows_the_virtual_clock(tmp_path):
    broker = inproc.InProcBroker("flush-clock", persist_dir=str(tmp_path))
    path = tmp_path / "offsets.json"
    interval = inproc._OFFSET_FLUSH_SEC
    with clockmod.installed(clockmod.ManualClock()) as mc:
        broker.set_offset("g", "t", 1)  # the first commit writes at once
        assert _committed(path) == 1
        broker.set_offset("g", "t", 2)
        # real seconds pass, virtual ones do not: the commit stays behind
        time.sleep(3 * interval)
        broker.set_offset("g", "t", 3)
        assert _committed(path) == 1
        mc.advance(2 * interval)  # past the interval, whatever the rounding
        broker.set_offset("g", "t", 4)
        assert _committed(path) == 4
    broker.close()


def test_consume_idle_timer_follows_the_virtual_clock():
    broker = inproc.InProcBroker("idle-clock")
    broker.send("t", None, "m0")
    got: list[str] = []
    with clockmod.installed(clockmod.ManualClock()) as mc:
        reader = threading.Thread(target=lambda: got.extend(
            km.message for km in broker.consume(
                "t", from_beginning=True, poll_timeout_sec=0.01,
                max_idle_sec=0.2)), daemon=True)
        reader.start()
        # three times the idle limit in real seconds: still consuming
        time.sleep(0.6)
        assert reader.is_alive()
        mc.advance(0.3)
        reader.join(10.0)
        assert not reader.is_alive()
    assert got == ["m0"]


# -- resilience/policy.py waits through the seam ------------------------------

def _flaky(clock_sleep, calls: list[float], now):
    """Fails on calls 1-3 and returns on the 4th; call 2 stays up 400
    virtual seconds first, long enough to reset the attempt count."""
    def fn():
        calls.append(now())
        if len(calls) == 2:
            clock_sleep(400.0)
        if len(calls) < 4:
            raise ConnectionError("broker down")
    return fn


def test_resubscribe_backoff_waits_on_the_virtual_clock():
    backoff = dict(initial=30.0, maximum=120.0, multiplier=2.0, jitter=0.0)

    port_calls: list[float] = []
    sim = SimClock()
    stop = threading.Event()
    with clockmod.installed(sim):
        t0 = time.monotonic()
        runner = threading.Thread(target=policy.run_with_resubscribe, args=(
            _flaky(sim.sleep, port_calls, sim.monotonic), stop, "update"),
            kwargs={"backoff": policy.Backoff(**backoff)}, daemon=True)
        runner.start()
        runner.join(10.0)
        wall = time.monotonic() - t0
        finished = not runner.is_alive()
        stop.set()  # ends a loop still sleeping on real seconds
    assert finished and wall < 1.0, f"backoff slept {wall:.1f} real s"

    ref_calls: list[float] = []
    ref_sim = RefSimClock()
    prev = ref_clock.install(ref_sim)
    try:
        ref_policy.run_with_resubscribe(
            _flaky(ref_sim.sleep, ref_calls, ref_sim.monotonic),
            threading.Event(), "update",
            backoff=ref_policy.Backoff(**backoff))
    finally:
        ref_clock.install(prev)
    # 30 s, then the healthy reset's 30 s again, then 60 s
    assert port_calls == ref_calls == [0.0, 30.0, 460.0, 520.0]
    assert sim.monotonic() == ref_sim.monotonic() == 520.0


# -- config drift: keys read as literals, the compat key declared ------------

_RDF = {
    "oryx.input-schema.feature-names": ["a", "color", "label"],
    "oryx.input-schema.categorical-features": ["color", "label"],
    "oryx.input-schema.target-feature": "label",
    "oryx.rdf.hyperparams.max-split-candidates": [8, 32],
    "oryx.rdf.hyperparams.max-depth": [3, 6],
    "oryx.rdf.hyperparams.impurity": ["gini", "entropy"],
}


def test_rdf_update_reads_the_three_hyperparameters():
    from oryx_tpu.app.rdf.update import RDFUpdate as RefUpdate
    from oryx_tpu_torch.app.rdf.update import RDFUpdate

    port = RDFUpdate(tconfig.from_dict(_RDF), device="cpu")
    ref = RefUpdate(ref_config.from_dict(_RDF))
    got = [v.get_trial_values(3) for v in port.get_hyper_parameter_values()]
    want = [v.get_trial_values(3) for v in ref.get_hyper_parameter_values()]
    assert got == want
    assert got[0][0] == 8 and got[1][-1] == 6
    assert got[2][:2] == ["gini", "entropy"]


@pytest.mark.parametrize("alias", [None, "oryx-tls"])
def test_serving_layer_reads_key_alias(alias):
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer

    layer = ServingLayer(tconfig.from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        "oryx.serving.api.key-alias": alias,
        "oryx.input-topic.broker": None, "oryx.update-topic.broker": None}),
        port=0, device="cpu")
    assert layer.key_alias == alias
    assert layer.scheme == "http"


def test_compile_cache_threshold_is_a_declared_compat_key():
    _, compat = drift_pass._conf_line_index(CONF)
    assert "oryx.compile-cache-min-compile-secs" in compat
    assert "JAX" in compat["oryx.compile-cache-min-compile-secs"]
    # the key stays declared and readable with its default
    cfg = tconfig.from_dict({})
    assert cfg.get_double("oryx.compile-cache-min-compile-secs") == 0.5
