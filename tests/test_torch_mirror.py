"""The port's cross-region mirror (``oryx_tpu_torch/cluster/mirror.py``)
held against the reference's on the same records, and the ``crash`` and
``hold`` fault modes it needs.

Each package runs its own ``MirrorLayer`` over its own ``memory://``
brokers (each package has its own registry) fed the same source
records: the destination records (key, message, headers), the counters
and ``mirror-checkpoint.json`` must be equal; a crash between the replay
and the checkpoint duplicates nothing; mirrors A⇄B never ping-pong; a
partitioned link holds its position while staleness climbs; config
validation names the same keys; malformed origin headers are
source-born.  The router accepts the mirror's keys and answers
``/admin/region`` as the reference's."""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid

import pytest

from oryx_tpu.cluster import mirror as jmirror
from oryx_tpu.common import clock as jclock
from oryx_tpu.common import config as jconfig
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.cluster import mirror as tmirror
from oryx_tpu_torch.common import clock as tclock
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka.api import KeyMessage as TKeyMessage
from oryx_tpu_torch.resilience import faults as tfaults

PKGS = {
    "ref": (jmirror, jconfig, jinproc, jfaults, jclock, JKeyMessage),
    "port": (tmirror, tconfig, tinproc, tfaults, tclock, TKeyMessage),
}

UP1 = '["X","u1",[1.0,2.0]]'
UP2 = '["Y","i1",[3.0,4.0],["u1"]]'
O_REGION, O_PART, O_OFF = ("origin-region", "origin-partition",
                           "origin-offset")


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _names() -> tuple[str, str]:
    tag = uuid.uuid4().hex[:8]
    return f"tmw-{tag}", f"tme-{tag}"


def _config(pkg: str, tmp_path, src: str, dst: str, src_region="west",
            dst_region="east", **extra):
    overlay = {
        "oryx.cluster.region.name": dst_region,
        "oryx.cluster.region.mirror.source-broker": f"memory://{src}",
        "oryx.cluster.region.mirror.source-region": src_region,
        "oryx.cluster.region.mirror.checkpoint-dir":
            str(tmp_path / pkg / f"ckpt-{dst}"),
        "oryx.update-topic.broker": f"memory://{dst}",
        "oryx.resilience.retry.max-attempts": 2,
        "oryx.resilience.retry.initial-backoff-ms": 1,
        "oryx.resilience.retry.max-backoff-ms": 2,
    }
    overlay.update(extra)
    return PKGS[pkg][1].from_dict(overlay)


def _records(pkg: str, name: str, topic: str = "OryxUpdate") -> list:
    broker = PKGS[pkg][2].get_broker(name)
    ends = broker.latest_offsets(topic)
    return [(km.key, km.message, km.headers) for km in
            broker.read_ranges(topic, [0] * len(ends), ends)]


def _checkpoint(pkg: str, tmp_path, dst: str) -> dict:
    path = tmp_path / pkg / f"ckpt-{dst}" / "mirror-checkpoint.json"
    return json.loads(path.read_text())


def _send_source(pkg: str, name: str) -> None:
    """The same source stream for both packages: a ts-stamped UP, an
    already-mirrored record (multi-hop), a heartbeat, a record born in
    the destination region, a malformed origin set and a model."""
    broker = PKGS[pkg][2].get_broker(name)
    broker.send("OryxUpdate", "UP", UP1, headers={"ts": "1700"})
    broker.send("OryxUpdate", "UP", UP2, headers={
        O_REGION: "south", O_PART: "0", O_OFF: "99"})
    broker.send("OryxUpdate", "HB", '{"replica":"r1"}')
    broker.send("OryxUpdate", "UP", UP1, headers={
        O_REGION: "east", O_PART: "0", O_OFF: "5"})
    broker.send("OryxUpdate", "UP", UP2, headers={
        O_REGION: "north", O_OFF: "not-a-number"})
    broker.send("OryxUpdate", "MODEL", "<PMML/>")


def test_same_records_give_same_destination_and_checkpoint(tmp_path):
    src, dst = _names()
    out = {}
    for pkg in PKGS:
        m = PKGS[pkg][0].MirrorLayer(_config(pkg, tmp_path, src, dst))
        try:
            m.recover()
            _send_source(pkg, src)
            replayed = m.poll_once()
            again = m.poll_once()
            out[pkg] = (replayed, again, _records(pkg, dst),
                        _checkpoint(pkg, tmp_path, dst),
                        m.metrics.counters_snapshot(), m.status())
        finally:
            m.close()
    assert out["port"] == out["ref"]
    replayed, again, recs, ckpt, counters, _ = out["port"]
    assert (replayed, again) == (4, 0)
    assert recs[0] == ("UP", UP1, {"ts": "1700", O_REGION: "west",
                                   O_PART: "0", O_OFF: "0"})
    assert recs[1][2][O_REGION] == "south"
    assert counters["mirror_heartbeat_drops"] == 1
    assert counters["mirror_loop_drops"] == 1
    assert ckpt["source"] == {"0": 6}


def test_crash_between_replay_and_checkpoint_duplicates_nothing(tmp_path):
    src, dst = _names()
    out = {}
    for pkg in PKGS:
        mod, _, inproc, faults = PKGS[pkg][:4]
        cfg = _config(pkg, tmp_path, src, dst)
        broker = inproc.get_broker(src)
        broker.send("OryxUpdate", "MODEL", "<PMML/>")
        broker.send("OryxUpdate", "UP", UP1)
        broker.send("OryxUpdate", "UP", UP2)
        m1 = mod.MirrorLayer(cfg)
        m1.recover()
        faults.inject("mirror-crash-mid-replay", mode="crash", times=1)
        with pytest.raises(faults.InjectedCrash):
            m1.poll_once()
        assert faults.fired("mirror-crash-mid-replay") == 1
        # every record sent, the source position not durably advanced
        sent = _records(pkg, dst)
        assert mod.MirrorCheckpoint(
            str(tmp_path / pkg / f"ckpt-{dst}")).source == {}
        m2 = mod.MirrorLayer(cfg)
        try:
            examined = m2.recover()
            polled = (m2.poll_once(), m2.poll_once())
            out[pkg] = (len(sent), examined, polled, _records(pkg, dst),
                        m2.metrics.counters_snapshot(),
                        _checkpoint(pkg, tmp_path, dst))
        finally:
            m2.close()
            m1.close()
    assert out["port"] == out["ref"]
    n_sent, examined, polled, recs, counters, _ = out["port"]
    assert (n_sent, examined, polled) == (3, 3, (0, 0))
    assert counters["mirror_dedup_skips"] == 3
    assert [r[1] for r in recs] == ["<PMML/>", UP1, UP2]


def test_two_mirrors_never_ping_pong(tmp_path):
    a, b = _names()
    out = {}
    for pkg in PKGS:
        mod, _, inproc = PKGS[pkg][:3]
        ab = mod.MirrorLayer(_config(pkg, tmp_path, a, b, "west", "east"))
        ba = mod.MirrorLayer(_config(pkg, tmp_path, b, a, "east", "west"))
        try:
            for i in range(5):
                inproc.get_broker(a).send("OryxUpdate", "UP",
                                          f'["X","u{i}",[1.0]]')
            inproc.get_broker(b).send("OryxUpdate", "UP",
                                      '["X","bu",[2.0]]')
            sizes = []
            for _ in range(4):  # several rounds: a loop would grow
                ab.poll_once()
                ba.poll_once()
                sizes.append((len(_records(pkg, a)),
                              len(_records(pkg, b))))
            out[pkg] = (sizes, _records(pkg, a), _records(pkg, b),
                        ab.metrics.counters_snapshot(),
                        ba.metrics.counters_snapshot())
        finally:
            ab.close()
            ba.close()
    assert out["port"] == out["ref"]
    sizes, a_recs, b_recs, ab_c, ba_c = out["port"]
    assert set(sizes) == {(6, 6)}
    assert ba_c["mirror_loop_drops"] == 5 and ab_c["mirror_loop_drops"] == 1
    assert {h[O_REGION] for _, _, h in b_recs if h and O_REGION in h} \
        == {"west"}


def test_partitioned_link_holds_position_while_staleness_climbs(tmp_path):
    src, dst = _names()
    out = {}
    for pkg in PKGS:
        mod, _, inproc, faults, clock = PKGS[pkg][:5]
        manual = clock.ManualClock(start_monotonic=0.0,
                                   start_time=1_700_000_000.0)
        m = mod.MirrorLayer(_config(pkg, tmp_path, src, dst), clock=manual)
        try:
            broker = inproc.get_broker(src)
            broker.send("OryxUpdate", "UP", UP1, headers={
                "ts": str(int(manual.time() * 1000) - 250)})
            steps = [m.poll_once(), m._last_batch_staleness_ms,
                     m.poll_once(), m.metrics.gauges_snapshot()]
            faults.inject("mirror-link-partition", mode="error",
                          times=None)
            broker.send("OryxUpdate", "UP", UP2)
            for _ in range(2):
                with pytest.raises(ConnectionError):
                    m.poll_once()
            manual.advance(0.04)
            steps += [dict(m.checkpoint.source),
                      m.metrics.gauges_snapshot()]
            faults.clear("mirror-link-partition")
            steps += [m.poll_once(), m.metrics.gauges_snapshot()]
            out[pkg] = steps
        finally:
            m.close()
    assert out["port"] == out["ref"]
    steps = out["port"]
    assert steps[:3] == [1, 250, 0]
    before, during = steps[3], steps[5]
    assert steps[4] == {0: 1}  # the position held
    assert during["mirror_lag_records"] == 1
    assert during["cross_region_staleness_ms"] \
        == before["cross_region_staleness_ms"] + 40
    assert steps[6] == 1 and steps[7]["mirror_lag_records"] == 0


@pytest.mark.parametrize("drop, extra", [
    ("oryx.cluster.region.name", {}),
    ("oryx.cluster.region.mirror.source-broker", {}),
    ("oryx.cluster.region.mirror.checkpoint-dir", {}),
    (None, {"oryx.update-topic.broker": "SAME"}),
])
def test_config_validation_names_the_same_keys(tmp_path, drop, extra):
    src, dst = _names()
    messages = []
    for pkg in PKGS:
        overlay = dict(extra)
        if drop is not None:
            overlay[drop] = None
        if overlay.get("oryx.update-topic.broker") == "SAME":
            overlay["oryx.update-topic.broker"] = f"memory://{src}"
        cfg = _config(pkg, tmp_path, src, dst, **overlay)
        with pytest.raises(ValueError) as e:
            PKGS[pkg][0].MirrorLayer(cfg)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert (drop or "same topic") in messages[1]


@pytest.mark.parametrize("headers", [
    None, {}, {"ts": "1"},
    {O_REGION: "south", O_PART: "2", O_OFF: "7"},
    {O_REGION: "south", O_OFF: "7"},
    {O_REGION: "south", O_PART: "x", O_OFF: "7"},
    {O_REGION: "south", O_PART: "1"},
    {O_REGION: "south", O_OFF: None},
])
def test_malformed_origin_headers_are_source_born(headers):
    got = [PKGS[pkg][0].origin_of(PKGS[pkg][5]("UP", UP1, headers),
                                  "west", 3, 11) for pkg in PKGS]
    assert got[0] == got[1]
    well_formed = headers and O_REGION in headers and O_OFF in headers \
        and str(headers.get(O_PART, 0)).isdigit() \
        and str(headers[O_OFF]).isdigit()
    assert got[1] == (("south", int(headers.get(O_PART, 0)), 7)
                      if well_formed else ("west", 3, 11))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_crash_mode_is_a_base_exception(pkg):
    faults = PKGS[pkg][3]
    assert issubclass(faults.InjectedCrash, BaseException)
    assert not issubclass(faults.InjectedCrash, Exception)
    faults.inject("p-crash", mode="crash", times=1)
    with pytest.raises(faults.InjectedCrash, match="p-crash"):
        faults.fire("p-crash")
    assert faults.fire("p-crash") is None  # times=1: spent
    assert faults.fired("p-crash") == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_hold_mode_parks_until_release(pkg):
    faults = PKGS[pkg][3]
    faults.inject("p-hold", mode="hold", times=None)
    done = []
    workers = [threading.Thread(
        target=lambda: done.append(faults.fire("p-hold"))) for _ in range(2)]
    for w in workers:
        w.start()
    time.sleep(0.2)
    assert done == [] and faults.fired("p-hold") == 2
    faults.release("p-hold")
    for w in workers:
        w.join(5)
    assert done == [None, None]
    t0 = time.monotonic()
    assert faults.fire("p-hold") is None  # the gate stays open
    assert time.monotonic() - t0 < 1.0
    faults.release("never-armed")  # a no-op


def test_unknown_mode_is_refused_by_both():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown fault mode"):
            PKGS[pkg][3].inject("p", mode="explode")


def test_router_accepts_the_mirror_keys_and_answers_admin_region(tmp_path):
    """The mirror's keys configure the mirror process that reads the
    same conf: the router ignores them, and ``/admin/region`` answers
    the region's name and the router's block, as the reference's
    does."""
    from oryx_tpu.cluster.router import RouterLayer as JRouter
    from oryx_tpu_torch.cluster.router import RouterLayer as TRouter
    tag = uuid.uuid4().hex[:8]
    answers = []
    for pkg, make in (("ref", lambda c: JRouter(c, port=0)),
                      ("port", lambda c: TRouter(c, port=0, device="cpu"))):
        cfg = PKGS[pkg][1].from_dict({
            "oryx.update-topic.broker": f"memory://tmr-{pkg}-{tag}",
            "oryx.input-topic.broker": f"memory://tmr-{pkg}-{tag}",
            "oryx.cluster.region.name": "east",
            "oryx.cluster.region.mirror.source-broker": "memory://far",
            "oryx.cluster.region.mirror.source-topic": "OryxUpdate",
            "oryx.cluster.region.mirror.checkpoint-dir": str(tmp_path),
        })
        router = make(cfg)
        router.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{router.port}/admin/region",
                    timeout=10) as r:
                answers.append(json.loads(r.read()))
        finally:
            router.close()
    assert answers[0] == answers[1]
    assert answers[1]["region"] == "east"
    assert answers[1]["role"] == "router"
