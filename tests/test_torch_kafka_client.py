"""The port's broker bindings against the reference's, on the CPU: the
broker contract of ``tests/test_kafka.py`` and ``tests/test_kafka_
client.py`` run on a port broker and a reference broker of the same
kind — ``memory://``, ``file://`` and a ``MiniKafkaBroker`` spoken to
by the wire client — with the same records, and the answers compared.

Also: each package's client against the other's ``MiniKafkaBroker``,
the five wire and mini-broker fault points armed in both packages, and
the ``kafka-setup``/``kafka-input``/``kafka-tail`` commands of both
CLIs against a ``MiniKafkaBroker`` address.  Record headers ride every
port binding; the reference's wire binding drops them, so there the
port's are held to what was sent."""

from __future__ import annotations

import threading
import time

import pytest

from oryx_tpu.deploy.main import main as jmain
from oryx_tpu.kafka import client as jclient
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.kafka import mini_broker as jmini
from oryx_tpu.kafka import utils as jutils
from oryx_tpu.kafka.produce import ConsumeTopic as JConsumeTopic
from oryx_tpu.kafka.produce import ProduceData as JProduceData
from oryx_tpu.kafka.produce import csv_datum_generator as jcsv
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.deploy.main import main as tmain
from oryx_tpu_torch.kafka import client as tclient
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka import mini_broker as tmini
from oryx_tpu_torch.kafka import utils as tutils
from oryx_tpu_torch.kafka.produce import ConsumeTopic, ProduceData, \
    csv_datum_generator
from oryx_tpu_torch.resilience import faults as tfaults

KINDS = ["memory", "file", "wire"]


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


@pytest.fixture
def pair(request, tmp_path):
    """(port broker, reference broker, idle seconds) of one kind."""
    kind = request.param
    tag = f"kc-{time.monotonic_ns()}"
    closers = []
    if kind == "memory":
        t = tinproc.resolve_broker(f"memory://{tag}")
        j = jinproc.resolve_broker(f"memory://{tag}")
        closers += [lambda: tinproc.drop_broker(tag),
                    lambda: jinproc.drop_broker(tag)]
        idle = 0.2
    elif kind == "file":
        tdir, jdir = tmp_path / "t", tmp_path / "j"
        t = tinproc.resolve_broker(f"file://{tdir}")
        j = jinproc.resolve_broker(f"file://{jdir}")
        closers += [lambda: tinproc.drop_broker(f"file:{tdir}"),
                    lambda: jinproc.drop_broker(f"file:{jdir}")]
        idle = 0.2
    else:
        tm, jm = tmini.MiniKafkaBroker(), jmini.MiniKafkaBroker()
        t = tclient.KafkaBroker(tm.bootstrap)
        j = jclient.KafkaBroker(jm.bootstrap)
        closers += [t.close, j.close, tm.close, jm.close]
        idle = 1.0
    yield kind, t, j, idle
    for close in closers:
        close()


def _both(pair, fn):
    """``fn(broker)`` on the port's and the reference's broker."""
    _, t, j, _ = pair
    return fn(t), fn(j)


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_topic_admin(pair):
    def run(b):
        out = [b.topic_exists("adm")]
        b.create_topic("adm", partitions=3)
        out += [b.topic_exists("adm"), b.num_partitions("adm")]
        b.create_topic("adm", partitions=3)  # idempotent
        b.delete_topic("adm")
        out.append(b.topic_exists("adm"))
        return out
    got, want = _both(pair, run)
    assert got == want == [False, True, 3, False]


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_produce_consume_replay(pair):
    idle = pair[3]

    def run(b):
        b.create_topic("rep", partitions=1)
        b.send("rep", "MODEL", "<PMML/>")
        b.send("rep", "UP", '["X","u1",[0.1]]')
        return [(m.key, m.message) for m in b.consume(
            "rep", from_beginning=True, max_idle_sec=idle)]
    got, want = _both(pair, run)
    assert got == want == [("MODEL", "<PMML/>"),
                           ("UP", '["X","u1",[0.1]]')]


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_group_offsets_commit_and_resume(pair):
    idle = pair[3]

    def run(b):
        b.create_topic("grp", partitions=1)
        for i in range(5):
            b.send("grp", None, f"m{i}")
        first = []
        for km in b.consume("grp", group="g", from_beginning=True,
                            max_idle_sec=idle):
            first.append(km.message)
            if len(first) == 3:
                break
        # m2 was in flight when the consumer broke: it comes again
        rest = [km.message for km in b.consume("grp", group="g",
                                               max_idle_sec=idle)]
        return first, rest, b.get_offset("g", "grp")
    got, want = _both(pair, run)
    assert got == want == (["m0", "m1", "m2"], ["m2", "m3", "m4"], 5)


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_fill_in_latest_offsets(pair):
    idle = pair[3]

    def run(b):
        b.create_topic("fill", partitions=2)
        for i in range(6):
            b.send("fill", f"k{i}", f"v{i}")
        b.set_offset("g", "fill", 1, partition=0)
        b.fill_in_latest_offsets("g", ["fill"])
        ends = b.latest_offsets("fill")
        offs = b.get_offsets("g", "fill")
        later = [km.message for km in b.consume("fill", group="g",
                                                max_idle_sec=idle)]
        return ends, offs, sorted(later)
    got, want = _both(pair, run)
    assert got == want
    ends, offs, later = got
    # the committed partition keeps its offset, the other starts now
    assert offs == [1, ends[1]] and len(later) == ends[0] - 1


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_keyed_partitions_and_read_ranges(pair):
    def run(b):
        b.create_topic("kp", partitions=4)
        for i in range(40):
            b.send("kp", f"key{i % 9}", f"m{i}")
        ends = b.latest_offsets("kp")
        b.set_offsets("g", "kp", ends)
        per_partition = [
            [(km.key, km.message) for km in b.read_ranges(
                "kp", [e if q != p else 0 for q, e in enumerate(ends)],
                ends)]
            for p in range(4)]
        return ends, b.get_offsets("g", "kp"), per_partition
    got, want = _both(pair, run)
    assert got == want
    assert sum(got[0]) == 40 and got[1] == got[0]


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_single_partition_reads_and_refusals(pair):
    def run(b):
        b.create_topic("one", partitions=1)
        b.create_topic("two", partitions=2)
        for i in range(3):
            b.send("one", None, f"s{i}")
        out = [b.latest_offset("one"),
               [km.message for km in b.read_range("one", 1, 3)]]
        with pytest.raises(ValueError, match="partitions"):
            b.latest_offset("two")
        return out
    got, want = _both(pair, run)
    assert got == want == [3, ["s1", "s2"]]


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_record_headers_round_trip(pair):
    kind, t, j, _ = pair
    sent = [("k0", "direct", {"ts": "1"}),
            ("k1", "traced", {"ts": "2", "traceparent": "00-x-y-01"}),
            (None, "bare", None)]

    def run(b, many):
        b.create_topic("hdr", partitions=1)
        if many:
            b.send_many("hdr", sent)
        else:
            for key, message, headers in sent:
                b.send("hdr", key, message, headers=headers)
        return [(km.key, km.message, km.headers)
                for km in b.read_range("hdr", 0, 3)]

    got = run(t, many=False)
    assert got == sent
    if kind == "wire":
        # the reference's wire binding drops headers
        assert run(j, many=False) == [(k, m, None) for k, m, _ in sent]
    else:
        assert run(j, many=False) == got
    # the pipelined send carries them too
    t.delete_topic("hdr")
    assert run(t, many=True) == sent


@pytest.mark.parametrize("pair", KINDS, indirect=True)
def test_send_many_matches_one_by_one_sends(pair):
    """A pipelined produce lands each record where one-by-one sends
    put it, in order (the reference's in-process send_many; its wire
    binding has none, so there it sends one by one)."""
    kind, t, j, _ = pair
    entries = [(f"k{i % 5}" if i % 3 else None, f"m{i}", {"i": str(i)})
               for i in range(30)]
    for b in (t, j):
        b.create_topic("many", partitions=4)
    assert t.send_many("many", entries) == 30
    if kind == "wire":
        for key, message, headers in entries:
            j.send("many", key, message, headers)
    else:
        j.send_many("many", entries)
    ends = t.latest_offsets("many")
    assert ends == j.latest_offsets("many")
    assert [(km.key, km.message) for km in t.read_ranges(
        "many", [0] * 4, ends)] == [(km.key, km.message) for km in
                                    j.read_ranges("many", [0] * 4, ends)]


def test_resolve_broker_binds_host_port_to_the_wire_client():
    mini = tmini.MiniKafkaBroker()
    try:
        b = tinproc.resolve_broker(mini.bootstrap)
        assert isinstance(b, tclient.KafkaBroker)
        assert b is tinproc.resolve_broker(mini.bootstrap)  # one per address
        assert isinstance(jinproc.resolve_broker("localhost:19092"),
                          jclient.KafkaBroker)
        # lazy: a dead address fails at first use, as the reference's
        dead = tinproc.resolve_broker("localhost:19092")
        with pytest.raises((ConnectionError, OSError)):
            dead.topic_exists("nope")
    finally:
        mini.close()


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_each_client_against_the_other_packages_broker(writer, reader):
    """Records and offsets written by one package's client to the other
    package's MiniKafkaBroker read back the same through both."""
    mini = tmini.MiniKafkaBroker() if writer == "ref" \
        else jmini.MiniKafkaBroker()
    clients = {"port": tclient.KafkaBroker(mini.bootstrap),
               "ref": jclient.KafkaBroker(mini.bootstrap)}
    try:
        w, r = clients[writer], clients[reader]
        w.create_topic("x", partitions=3)
        for i in range(25):
            w.send("x", f"key{i % 7}" if i % 4 else None, f"v{i}")
        ends = w.latest_offsets("x")
        assert r.latest_offsets("x") == ends and sum(ends) == 25
        w.set_offsets("g", "x", [1, 0, 2])
        assert r.get_offsets("g", "x") == [1, 0, 2]
        r.fill_in_latest_offsets("g2", ["x"])
        assert w.get_offsets("g2", "x") == ends
        got = [(km.key, km.message) for km in
               r.read_ranges("x", [0] * 3, ends)]
        assert got == [(km.key, km.message) for km in
                       w.read_ranges("x", [0] * 3, ends)]
        assert sorted(m for _, m in got) == sorted(f"v{i}"
                                                   for i in range(25))
    finally:
        for c in clients.values():
            c.close()
        mini.close()


@pytest.mark.parametrize("point,op", [
    ("wire-send", "send"), ("wire-read", "send"),
    ("mini-broker-drop", "send"), ("mini-broker-produce-error", "send"),
    ("mini-broker-fetch-error", "read")])
def test_fault_points_as_the_reference(point, op):
    """Each point armed once in both packages: the operation survives
    (reconnect, or the client's retry of a transient code) with the
    record written once, in both."""
    outcomes = []
    for faults, mini_mod, client_mod in (
            (tfaults, tmini, tclient), (jfaults, jmini, jclient)):
        mini = mini_mod.MiniKafkaBroker()
        b = client_mod.KafkaBroker(mini.bootstrap)
        try:
            b.create_topic("f", partitions=1)
            b.send("f", "k", "before")
            faults.inject(point, mode="drop", times=1)
            if op == "send":
                b.send("f", "k", "after")
            got = [km.message for km in b.read_range(
                "f", 0, b.latest_offset("f"))]
            outcomes.append((got, faults.fired(point)))
        finally:
            faults.clear()
            b.close()
            mini.close()
    assert outcomes[0] == outcomes[1]
    want = ["before", "after"] if op == "send" else ["before"]
    assert outcomes[0] == (want, 1)


def test_produce_data_and_consume_topic_over_the_wire():
    """The synthetic producer and tailer of both packages on their own
    MiniKafkaBroker: 25 CSV rows of the same shape."""
    got = []
    for produce, tail, gen, mini_mod, client_mod in (
            (ProduceData, ConsumeTopic, csv_datum_generator, tmini,
             tclient),
            (JProduceData, JConsumeTopic, jcsv, jmini, jclient)):
        mini = mini_mod.MiniKafkaBroker()
        try:
            client_mod.get_kafka_broker(mini.bootstrap).create_topic("T")
            t = tail(mini.bootstrap, "T").start()
            assert produce(gen(3), mini.bootstrap, "T", 25).start() == 25
            assert t.await_count(25, 20.0)
            msgs = t.close()
            got.append([m.message.split(",")[0] for m in msgs])
            fields = msgs[0].message.split(",")
            assert fields[1] in ("true", "false")
            float(fields[2])
        finally:
            mini.close()
    assert got[0] == got[1] == [str(i) for i in range(25)]


def test_utils_against_a_wire_address():
    for utils, mini_mod in ((tutils, tmini), (jutils, jmini)):
        mini = mini_mod.MiniKafkaBroker()
        uri = mini.bootstrap
        try:
            utils.maybe_create_topic(uri, "u1")
            assert utils.topic_exists(uri, "u1")
            utils.maybe_create_topic(uri, "u1")  # idempotent
            tinproc.resolve_broker(uri).send("u1", None, "x")
            utils.fill_in_latest_offsets(uri, "g", ["u1"])
            assert utils.get_offsets(uri, "g", ["u1"]) == {"u1": [1]}
            utils.set_offsets(uri, "g", {"u1": [0]})
            assert utils.get_offsets(uri, "g", ["u1"]) == {"u1": [0]}
            utils.delete_topic(uri, "u1")
            assert not utils.topic_exists(uri, "u1")
        finally:
            mini.close()


def _conf(tmp_path, name, broker):
    conf = tmp_path / f"{name}.conf"
    conf.write_text("oryx {\n"
                    f'  input-topic.broker = "{broker}"\n'
                    f'  update-topic.broker = "{broker}"\n'
                    '  input-topic.message.topic = "CliIn"\n'
                    '  update-topic.message.topic = "CliUp"\n}\n')
    return str(conf)


def test_kafka_commands_against_a_mini_broker(tmp_path, capsys):
    """kafka-setup, kafka-input and kafka-tail of both CLIs, each on a
    MiniKafkaBroker address of its own package: the same lines, the
    addresses aside."""
    outs = []
    for main, mini_mod, name in ((tmain, tmini, "t"),
                                 (jmain, jmini, "j")):
        mini = mini_mod.MiniKafkaBroker()
        try:
            conf = _conf(tmp_path, name, mini.bootstrap)
            assert main(["kafka-setup", "--conf", conf]) == 0
            setup = capsys.readouterr().out.replace(mini.bootstrap, "B")
            data = tmp_path / f"{name}.csv"
            data.write_text("u0,i1,1.0\nu0,i2,2.0\n\nu1,i1,0.5\n")
            assert main(["kafka-input", "--conf", conf,
                         "--file", str(data)]) == 0
            sent = capsys.readouterr().err.splitlines()[-1]
            assert main(["kafka-tail", "--once", "--conf", conf]) == 0
            tail = capsys.readouterr().out
            broker = tclient.KafkaBroker(mini.bootstrap)
            parts = (broker.num_partitions("CliIn"),
                     broker.num_partitions("CliUp"))
            broker.close()
            outs.append((setup, sent, sorted(tail.splitlines()), parts))
        finally:
            mini.close()
    assert outs[0] == outs[1]
    setup, sent, tail, parts = outs[0]
    assert setup.splitlines() == ["CliIn @ B: exists", "CliUp @ B: exists"]
    assert sent == "Sent 3 lines to CliIn" and parts == (4, 1)
    assert tail == ["CliIn\tNone\tu0,i1,1.0", "CliIn\tNone\tu0,i2,2.0",
                    "CliIn\tNone\tu1,i1,0.5"]


def test_consumer_and_producer_threads_share_one_client():
    """One KafkaBroker per address is shared by a tailing consumer (its
    own connection) and producers on other threads, as a speed worker's
    consume and micro-batch threads share it."""
    mini = tmini.MiniKafkaBroker()
    try:
        b = tinproc.resolve_broker(mini.bootstrap)
        b.create_topic("sh", partitions=2)
        stop = threading.Event()
        seen = []

        def tail():
            for km in b.consume("sh", from_beginning=True, stop=stop):
                seen.append(km.message)

        th = threading.Thread(target=tail, daemon=True)
        th.start()
        senders = [threading.Thread(target=lambda n=n: [
            b.send("sh", f"k{n}", f"{n}-{i}") for i in range(20)])
            for n in range(4)]
        for s in senders:
            s.start()
        for s in senders:
            s.join(30)
        deadline = time.monotonic() + 30
        while len(seen) < 80 and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        th.join(10)
        assert sorted(seen) == sorted(f"{n}-{i}" for n in range(4)
                                      for i in range(20))
        assert sum(b.latest_offsets("sh")) == 80
    finally:
        mini.close()
