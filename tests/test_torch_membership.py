"""The port's replica membership (``cluster/membership.py``) against the
reference's: heartbeat bytes both ways, TTL ageing and the topology
state machine on the same injected clock and the same heartbeat
sequence, ``without_heartbeats``, and the publisher's two chaos points
(``replica-heartbeat-drop`` and ``replica-group-flap``) armed in each
package's own fault registry.  Everything here is exact: the same
bytes, the same replicas in the same order, the same counters."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from oryx_tpu.cluster import membership as jmem
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.cluster import membership as tmem
from oryx_tpu_torch.kafka.api import KeyMessage as TKeyMessage
from oryx_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fields(rng, j):
    fields = dict(replica=f"r{j}", shard=int(rng.integers(0, 3)), of=3,
                  url=f"http://10.0.0.{j}:80{j:02d}",
                  generation=int(rng.integers(0, 5)),
                  ready=bool(rng.random() < 0.7),
                  fraction=float(np.round(rng.random(), 4)),
                  ts=float(1.7e9 + j))
    if j % 3 == 1:
        fields["region"] = "eu"
    if j % 4 == 2:
        fields["tport"] = 9000 + j
    return fields


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_bytes_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for j in range(12):
        f = _fields(rng, j)
        t, r = tmem.Heartbeat(**f), jmem.Heartbeat(**f)
        assert t.to_json() == r.to_json()
        # each package decodes the other's bytes to the same fields
        assert tmem.Heartbeat.from_json(r.to_json()).__dict__ == f | {
            "region": f.get("region"), "tport": f.get("tport")}
        assert jmem.Heartbeat.from_json(t.to_json()).__dict__ == \
            tmem.Heartbeat.from_json(t.to_json()).__dict__
    for bad in ("", "{}", '{"replica":"a","shard":"x"}', "nope"):
        assert tmem.Heartbeat.from_json(bad) is None
        assert jmem.Heartbeat.from_json(bad) is None


def _drive(registry_cls, heartbeat_cls, script):
    """Run one script of (advance seconds, heartbeat fields | None,
    declared reshard target | None) through a registry and record what
    routing sees after each step."""
    clock = _Clock()
    reg = registry_cls(ttl_sec=1.0, clock=clock)
    seen = []
    for dt, fields, target in script:
        clock.t += dt
        if target is not None:
            reg.begin_reshard(target)
        accepted = None
        if fields is not None:
            accepted = reg.note(heartbeat_cls(**fields))
        n = reg.shard_count
        seen.append((accepted, n, reg.covered_shards(),
                     [[h.replica for h in reg.candidates(s)]
                      for s in range(n)],
                     sorted(h.replica for h in reg.any_candidates()),
                     reg.generation_topology(),
                     reg.topology_status()))
    return seen, reg.snapshot()


def _hb(replica, shard, of, gen=1, ready=True):
    return dict(replica=replica, shard=shard, of=of,
                url=f"http://h/{replica}", generation=gen, ready=ready)


def test_registry_ttl_and_topology_state_machine_match_the_reference():
    script = [
        (0.0, _hb("a", 0, 2), None),
        (0.1, _hb("b", 1, 2, ready=False), None),   # bootstrap, partial
        (0.1, _hb("b", 1, 2), None),                # full: commit 2-way
        (0.1, _hb("c", 0, 2, gen=2), None),         # newer generation
        (0.1, _hb("rogue", 0, 1), None),            # foreign: rejected
        (0.1, _hb("bad", 3, 2), None),              # invalid coordinates
        (0.5, _hb("a", 0, 2), None),
        (0.6, None, None),                          # b ages out
        (0.1, _hb("b", 1, 2), None),                # rejoin
        (0.1, None, 3),                             # declare 3-way
        (0.1, _hb("n0", 0, 3), None),
        (0.1, _hb("n1", 1, 3), None),
        (0.1, _hb("n2", 2, 3), None),               # cutover
        (0.1, _hb("a", 0, 2), None),                # retired: dropped
        (3.0, None, None),                          # everything ages out
        (0.1, _hb("z", 0, 1), None),
        (5.0, _hb("z", 0, 1), None),                # grace over: takes over
    ]
    want, want_snap = _drive(jmem.MembershipRegistry, jmem.Heartbeat,
                             script)
    got, got_snap = _drive(tmem.MembershipRegistry, tmem.Heartbeat, script)
    assert got == want
    assert got_snap == want_snap


def test_candidates_rotate_within_the_newest_generation_like_the_reference():
    orders = []
    for mod in (jmem, tmem):
        reg = mod.MembershipRegistry(ttl_sec=10.0, clock=_Clock())
        for rid, gen in (("a", 2), ("b", 2), ("c", 1), ("d", 2)):
            reg.note(mod.Heartbeat(**_hb(rid, 0, 1, gen=gen)))
        orders.append([[h.replica for h in reg.candidates(0)]
                       for _ in range(5)]
                      + [[h.replica for h in reg.any_candidates()]
                         for _ in range(5)]
                      + [[[h.replica for h in c]
                          for c in reg.routing_plan()[1]]])
    assert orders[1] == orders[0]
    assert all(o[-1] == "c" for o in orders[1][:5])


def test_without_heartbeats_drops_only_the_heartbeat_key():
    keys = ["MODEL", "HB", "UP", "HB", "MODEL-REF", None, "UP"]
    tstream = [TKeyMessage(k, f"m{i}") for i, k in enumerate(keys)]
    jstream = [JKeyMessage(k, f"m{i}") for i, k in enumerate(keys)]
    got = [(km.key, km.message) for km in tmem.without_heartbeats(tstream)]
    want = [(km.key, km.message) for km in jmem.without_heartbeats(jstream)]
    assert got == want
    assert all(k != tmem.KEY_HEARTBEAT for k, _ in got) and len(got) == 5
    assert tmem.KEY_HEARTBEAT == jmem.KEY_HEARTBEAT == "HB"


class _Sink:
    def __init__(self):
        self.sent = []

    def send(self, key, message):
        self.sent.append((key, message))


class _Model:
    def get_fraction_loaded(self):
        return 0.9


class _Manager:
    generation = 3

    def get_model(self):
        return _Model()


def _publisher(mod, sink):
    return mod.HeartbeatPublisher(sink, shard=1, of=2, url="http://h:1",
                                  manager=_Manager(), min_fraction=0.8,
                                  replica_id="rep", region="eu")


@pytest.mark.parametrize("point", ["replica-heartbeat-drop",
                                   "replica-group-flap"])
def test_publisher_chaos_points_suppress_beats_like_the_reference(point):
    out = {}
    for mod, faults in ((jmem, jfaults), (tmem, tfaults)):
        sink = _Sink()
        pub = _publisher(mod, sink)
        faults.inject(point, mode="drop", times=2)
        sent = [pub.publish_once() for _ in range(4)]
        beats = [json.loads(m) for _, m in sink.sent]
        for b in beats:
            b.pop("ts")
        out[mod.__name__.split(".")[0]] = (sent, faults.fired(point),
                                           pub.published,
                                           [k for k, _ in sink.sent], beats)
    assert out["oryx_tpu_torch"] == out["oryx_tpu"]
    sent, fired, published, keys, beats = out["oryx_tpu_torch"]
    assert sent == [False, False, True, True] and fired == 2
    assert published == 2 and keys == ["HB", "HB"]
    assert beats[0] == {"replica": "rep", "shard": 1, "of": 2,
                        "url": "http://h:1", "generation": 3,
                        "ready": True, "fraction": 0.9, "region": "eu"}


def test_group_flap_delay_stretches_the_beat_gap():
    """mode=delay on replica-group-flap: the publisher sleeps before the
    send, so beats straggle past the TTL."""
    sink = _Sink()
    pub = _publisher(tmem, sink)
    tfaults.inject("replica-group-flap", mode="delay", times=1,
                   delay_sec=0.2)
    t0 = time.monotonic()
    assert pub.publish_once()
    assert time.monotonic() - t0 >= 0.2
    assert len(sink.sent) == 1 and tfaults.fired("replica-group-flap") == 1


def test_publisher_loop_starts_and_stops():
    sink = _Sink()
    pub = tmem.HeartbeatPublisher(sink, shard=0, of=1, url="http://h:2",
                                  manager=_Manager(), min_fraction=0.5,
                                  interval_sec=0.01)
    pub.start()
    deadline = time.monotonic() + 10
    while pub.published < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    pub.close()
    assert pub.published >= 3
    assert len(pub.replica_id) == 12
