"""The port's result caches (``oryx_tpu_torch/cluster/result_cache.py``)
held against the reference's: the same seeded operation sequences on
one injected clock (the port's ``ManualClock``) drive both packages'
``ResultCache`` and ``ShardResultCache``, and every step gives the same
verdict, the same stats, the same eviction order, the same quarantine
refusals and the same rendered bytes (JSON, CSV and gzip); the
coalescing protocol hands followers the leader's entry in both."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from oryx_tpu.cluster import result_cache as jrc
from oryx_tpu.common import config as jconfig
from oryx_tpu.lambda_rt import http as jhttp
from oryx_tpu.lambda_rt.metrics import MetricsRegistry as JMetrics
from oryx_tpu.serving.als import IDValue as JIDValue
from oryx_tpu_torch.cluster import result_cache as trc
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common.clock import ManualClock
from oryx_tpu_torch.lambda_rt import http as thttp
from oryx_tpu_torch.lambda_rt.metrics import MetricsRegistry as TMetrics
from oryx_tpu_torch.serving.als import IDValue as TIDValue

ROUTES = [("/recommend/{userID}", "/recommend/{u}", "userID"),
          ("/knownItems/{userID}", "/knownItems/{u}", "userID"),
          ("/similarity/{itemIDs:+}", "/similarity/{i}/{j}", "itemIDs"),
          ("/because/{userID}/{itemID}", "/because/{u}/{i}", None)]


class _Reg:
    """The membership registry's epoch surface."""

    def __init__(self):
        self.epoch = (2, (5, 5), False)

    def generation_topology(self):
        return self.epoch


class _Side:
    """One package's cache with its registry, metrics and renderer."""

    def __init__(self, rc_mod, config_mod, http_mod, metrics_cls, idv,
                 overlay, clock):
        self.reg = _Reg()
        self.metrics = metrics_cls()
        self.rc = rc_mod.ResultCache(config_mod.from_dict(overlay),
                                     self.metrics, self.reg, clock=clock)
        self.shard = rc_mod.ShardResultCache(
            config_mod.from_dict(overlay), self.metrics, clock=clock)
        self.render_kind = http_mod._render_kind
        self.idv = idv


def _pair(overlay):
    clock = ManualClock(start_monotonic=1000.0)
    port = _Side(trc, tconfig, thttp, TMetrics, TIDValue, overlay,
                 clock.monotonic)
    ref = _Side(jrc, jconfig, jhttp, JMetrics, JIDValue, overlay,
                clock.monotonic)
    return port, ref, clock


def _probe(side, route, u, i, j, how_many):
    pattern, template, _ = route
    path = template.format(u=u, i=i, j=j)
    params = {"userID": u, "itemID": i, "itemIDs": f"{i}/{j}"}
    params = {k: v for k, v in params.items() if "{" + k in pattern}
    return side.rc.probe(pattern, path, {"howMany": [str(how_many)]},
                         params)


def _entry_view(entry):
    return None if entry is None else (entry.status, entry.key)


def _step(side, op, clock):
    """Apply one operation to one side; what it returned, as plain
    data."""
    kind = op[0]
    rc = side.rc
    if kind in ("lookup", "store", "negative", "render") \
            and _probe(side, *op[1]) is None:
        return "unprobeable"  # a mixed generation group: uncacheable
    if kind == "lookup":
        return _entry_view(rc.lookup(_probe(side, *op[1])))
    if kind == "store":
        rows = [side.idv(f"i{a}", float(b)) for a, b in op[2]]
        entry = rc.store(_probe(side, *op[1]), 200, rows, op[3],
                         side.render_kind)
        return _entry_view(entry)
    if kind == "negative":
        return _entry_view(rc.store_negative(_probe(side, *op[1]), 404,
                                             f"{op[1][1]} not found"))
    if kind == "render":
        entry = rc.lookup_present(_probe(side, *op[1]))
        if entry is None or entry.status != 200:
            return None
        return rc.render(entry, op[2], op[3], side.render_kind)
    if kind == "up":
        rc.note_up(op[1])
        return None
    if kind == "publish":
        rc.note_generation_publish()
        return None
    if kind == "flush":
        return rc.flush("test")
    if kind == "epoch":
        side.reg.epoch = op[1]
        return None
    if kind == "shard_store":
        side.shard.store("GET", op[1], b"", side.shard.epoch(), op[2],
                         {"content-type": "application/json"}, op[3])
        return None
    if kind == "shard_lookup":
        return side.shard.lookup("GET", op[1], b"")
    if kind == "shard_record":
        side.shard.note_record()
        return None
    raise AssertionError(kind)


def _sequence(seed: int, n: int) -> list:
    """A seeded mix of reads, stores, renders, invalidations, epoch
    moves, clock advances and shard-cache traffic over a small key
    space, so that hits, evictions and refusals all occur."""
    rng = np.random.default_rng(seed)
    users = [f"u{k}" for k in range(3)]
    ops = []
    for _ in range(n):
        route = ROUTES[int(rng.integers(0, len(ROUTES)))]
        where = (route, users[int(rng.integers(0, len(users)))],
                 f"i{int(rng.integers(0, 3))}", f"i{int(rng.integers(0, 3))}",
                 10)
        r = rng.random()
        if r < 0.30:
            ops.append(("lookup", where))
        elif r < 0.50:
            rows = [(int(a), round(float(b), 3)) for a, b in zip(
                rng.integers(0, 50, int(rng.integers(1, 40))),
                rng.standard_normal(40))]
            extra = {"X-Oryx-Partial": "shards=1/2"} \
                if rng.random() < 0.1 else {}
            ops.append(("store", where, rows, extra))
        elif r < 0.54:
            ops.append(("negative", where))
        elif r < 0.70:
            ops.append(("render", where, bool(rng.random() < 0.4),
                        bool(rng.random() < 0.5)))
        elif r < 0.76:
            kind = "X" if rng.random() < 0.6 else "Y"
            who = users[int(rng.integers(0, 3))] if kind == "X" \
                else f"i{int(rng.integers(0, 3))}"
            extras = [users[int(rng.integers(0, 3))]] if kind == "Y" else []
            ops.append(("up", json.dumps([kind, who, [0.5, 0.25],
                                          extras])))
        elif r < 0.77:
            ops.append(("publish",))
        elif r < 0.78:
            ops.append(("flush",))
        elif r < 0.785:
            ops.append(("epoch", (2, (5 + int(rng.integers(0, 2)), 5),
                                  False)))
        elif r < 0.87:
            ops.append(("advance", float(rng.choice([0.05, 0.5, 3.0]))))
        elif r < 0.92:
            path = f"/shard/recommend/u{int(rng.integers(0, 3))}"
            ops.append(("shard_store", path,
                        int(rng.choice([200, 200, 503])),
                        json.dumps({"rows": rng.integers(0, 9, 5).tolist()}
                                   ).encode()))
        elif r < 0.98:
            ops.append(("shard_lookup",
                        f"/shard/recommend/u{int(rng.integers(0, 3))}"))
        else:
            ops.append(("shard_record",))
    return ops


@pytest.mark.parametrize("seed,overlay", [
    (1, {}),
    (2, {"oryx.cluster.cache.max-entries": 4,
         "oryx.cluster.replica-cache.max-entries": 2}),
    (3, {"oryx.cluster.cache.max-bytes": 4096,
         "oryx.cluster.replica-cache.max-bytes": 700}),
    (4, {"oryx.cluster.cache.negative-enabled": False}),
    (5, {"oryx.cluster.cache.enabled": False}),
])
def test_operation_sequences_agree(seed, overlay):
    overlay = {"oryx.cluster.cache.enabled": True,
               "oryx.cluster.coalesce.enabled": True,
               "oryx.cluster.replica-cache.enabled": True, **overlay}
    port, ref, clock = _pair(overlay)
    for n, op in enumerate(_sequence(seed, 400)):
        if op[0] == "advance":
            clock.advance(op[1])
            continue
        got, want = _step(port, op, clock), _step(ref, op, clock)
        assert got == want, (n, op)
        assert port.rc.stats() == ref.rc.stats(), (n, op)
        assert port.shard.stats() == ref.shard.stats(), (n, op)
        # the LRU order, oldest first
        assert list(port.rc._entries) == list(ref.rc._entries), (n, op)
        assert list(port.shard._entries) == list(ref.shard._entries)
    assert port.metrics.counters_snapshot() == \
        ref.metrics.counters_snapshot()


def test_quarantine_and_fence_refusals_agree():
    port, ref, clock = _pair({"oryx.cluster.cache.enabled": True,
                              "oryx.cluster.coalesce.enabled": True})
    where = (ROUTES[0], "u1", "i1", "i2", 10)
    for side in (port, ref):
        stale = _probe(side, *where)   # minted before the UP
        side.rc.note_up(json.dumps(["X", "u1", [0.1], []]))
        rows = [side.idv("i1", 1.0)]
        assert side.rc.store(stale, 200, rows, {},
                             side.render_kind) is None
        # within the quarantine a fresh probe is refused too
        assert side.rc.store(_probe(side, *where), 200, rows, {},
                             side.render_kind) is None
    assert port.rc.stats() == ref.rc.stats()
    assert port.rc.quarantine_sec == ref.rc.quarantine_sec
    # a mixed generation group is uncacheable in both
    for side in (port, ref):
        side.reg.epoch = (2, (5, 4), True)
        assert _probe(side, *where) is None
        side.reg.epoch = (2, (5, 5), False)
    clock.advance(port.rc.quarantine_sec + 0.01)
    stored = [side.rc.store(_probe(side, *where), 200,
                            [side.idv("i1", 1.0)], {}, side.render_kind)
              for side in (port, ref)]
    assert all(e is not None for e in stored)
    gz = [side.rc.render(e, False, True, side.render_kind)
          for side, e in zip((port, ref), stored)]
    assert gz[0] == gz[1]


def test_coalesced_followers_get_the_leaders_entry():
    """One leader; four followers parked on its flight in threads and
    two joined as completion callbacks (the asyncio front end's form):
    each package hands every follower the leader's stored entry, counts
    the same and renders the same bytes."""
    port, ref, _ = _pair({"oryx.cluster.cache.enabled": True,
                          "oryx.cluster.coalesce.enabled": True})
    out = []
    for side in (port, ref):
        where = (ROUTES[0], "u3", "i1", "i2", 10)
        kind, flight = side.rc.begin_flight(_probe(side, *where), None)
        assert kind == "lead"
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            side.rc.begin_flight(_probe(side, *where), None)))
            for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)  # the threads park on the flight's event
        joined = side.rc.flight_for(_probe(side, *where).key)
        woken = []
        assert joined is flight
        for _ in range(2):
            assert side.rc.add_flight_waiter(joined,
                                             lambda: woken.append(1))
            side.rc.count_coalesced()
        entry = side.rc.store(_probe(side, *where), 200,
                              [side.idv("i7", 2.0)], {}, side.render_kind)
        side.rc.finish_flight(flight, entry)
        side.rc.finish_flight(flight, None)  # idempotent
        for t in threads:
            t.join(10)
        assert [k for k, _ in got] == ["coalesced"] * 4
        assert all(e is entry for _, e in got)
        assert woken == [1, 1] and joined.entry is entry
        assert not side.rc.add_flight_waiter(joined, lambda: None)
        out.append((side.rc.stats(), side.rc.render(
            entry, False, False, side.render_kind)))
    assert out[0] == out[1]
    assert out[0][0]["coalesced_requests"] == 6
