"""The update topic and the model artifacts are shared between the
packages: the port's ``file://`` broker reads what the reference's
wrote and the reverse, ``publish_sliced`` writes the same bytes and
checksums in both, and the UP trust gate refuses the same records."""

from __future__ import annotations

import gzip
import os
import threading

import numpy as np
import pytest

from oryx_tpu.app.als import common as jcommon
from oryx_tpu.app.als import slices as jslices
from oryx_tpu.app.als import update as jupdate
from oryx_tpu.kafka import inproc as jinproc
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als import common as tcommon
from oryx_tpu_torch.app.als import slices as tslices
from oryx_tpu_torch.app.als import update as tupdate
from oryx_tpu_torch.kafka import inproc as tinproc
from oryx_tpu_torch.kafka.api import KeyMessage
from oryx_tpu_torch.resilience import faults as tfaults

RECORDS = [("MODEL", "<PMML/>", None),
           ("UP", '["Y","i1",[0.5,-1.25]]', None),
           ("UP", '["X","u1",[1.0,2.0],["i1"]]', {"ts": "123"}),
           (None, "keyless", None),
           ("MODEL-REF", '{"path":"/m/model.pmml.xml"}', None)]


def _write(inproc, uri, topic, partitions=1):
    broker = inproc.resolve_broker(uri)
    broker.create_topic(topic, partitions)
    for key, msg, headers in RECORDS:
        broker.send(topic, key, msg, headers)
    return broker


def _read(inproc, uri, topic):
    broker = inproc.resolve_broker(uri)
    return [tuple(km) for km in broker.consume(
        topic, from_beginning=True, max_idle_sec=0.3)]


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_broker_logs_are_shared(tmp_path, writer, partitions):
    uri = f"file://{tmp_path}/broker"
    topic = "OryxUpdate"
    w, r = (jinproc, tinproc) if writer == "reference" else \
        (tinproc, jinproc)
    try:
        _write(w, uri, topic, partitions)
        # the reader is a fresh broker on the same directory, as a
        # second process would be
        got = _read(r, uri, topic)
        want = _read(w, uri, topic)
        assert sorted(got, key=repr) == sorted(
            [tuple(KeyMessage(k, m, h)) for k, m, h in RECORDS], key=repr)
        assert got == want
        assert r.resolve_broker(uri).num_partitions(topic) == partitions
        assert r.resolve_broker(uri).latest_offsets(topic) == \
            w.resolve_broker(uri).latest_offsets(topic)
    finally:
        name = f"file:{os.path.abspath(f'{tmp_path}/broker')}"
        jinproc.drop_broker(name)
        tinproc.drop_broker(name)


def test_records_from_the_other_package_arrive_while_consuming(tmp_path):
    """A port consumer tailing the topic sees records the reference
    appends afterwards (another process's appends)."""
    uri = f"file://{tmp_path}/broker"
    name = f"file:{os.path.abspath(f'{tmp_path}/broker')}"
    try:
        tb = tinproc.resolve_broker(uri)
        tb.create_topic("t")
        jb = jinproc.resolve_broker(uri)
        jb.send("t", "UP", "first")
        seen = []
        for km in tb.consume("t", from_beginning=True, max_idle_sec=5.0):
            seen.append(km.message)
            if len(seen) == 1:
                jb.send("t", "UP", "second")
            else:
                break
        assert seen == ["first", "second"]
    finally:
        jinproc.drop_broker(name)
        tinproc.drop_broker(name)


def test_a_tailing_reader_keeps_its_place_beside_a_writer(tmp_path):
    """A reader refreshing while another writer appends sees every
    record once, in order: a write that lands between the reader's size
    check and its read must not be read twice or split."""
    path = str(tmp_path / "t.topic.jsonl")
    writer = tinproc._Partition(lambda: None, path)
    reader = tinproc._Partition(lambda: None, path)
    n = 3000
    errors = []

    def tail():
        try:
            while reader.size() < n:
                reader.refresh()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=tail, daemon=True)
    th.start()
    for i in range(n):
        writer.append("UP", f'["Y","i{i}",[{i}.5,-1.25]]')
    th.join(timeout=60)
    try:
        assert not th.is_alive() and not errors, errors
        assert [reader.get(i)[1] for i in range(reader.size())] == \
            [f'["Y","i{i}",[{i}.5,-1.25]]' for i in range(n)]
    finally:
        writer.close()
        reader.close()


def test_other_broker_schemes_are_refused():
    with pytest.raises(ValueError, match="not in this slice"):
        tinproc.resolve_broker("kafka://localhost:9092")
    with pytest.raises(ValueError, match="not in this slice"):
        tinproc.resolve_broker("localhost:9092")


def _catalog(seed=7, n_items=300, n_users=12, features=5):
    rng = np.random.default_rng(seed)
    y_ids = [f"i{j}" for j in range(n_items)]
    x_ids = [f"u{j}" for j in range(n_users)]
    Y = rng.standard_normal((n_items, features)).astype(np.float32)
    X = rng.standard_normal((n_users, features)).astype(np.float32)
    known = {u: sorted(y_ids[k] for k in rng.choice(n_items, 4,
                                                     replace=False))
             for u in x_ids}
    return y_ids, Y, x_ids, X, known


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("ring", [1, 8, 24])
def test_publish_sliced_writes_the_same_bytes(tmp_path, ring):
    y_ids, Y, x_ids, X, known = _catalog()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jslim = jslices.publish_sliced(jdir, y_ids, Y, x_ids, X, known, ring)
    tslim = tslices.publish_sliced(tdir, y_ids, Y, x_ids, X, known, ring)
    assert tslim == jslim
    assert _tree_bytes(tdir) == _tree_bytes(jdir)
    assert tslices.model_ref_message("/p", "/d", tslim) == \
        jslices.model_ref_message("/p", "/d", jslim)
    assert tslices.read_manifest(jdir) == jslices.read_manifest(tdir)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_slices(tmp_path, writer):
    y_ids, Y, x_ids, X, known = _catalog(seed=8)
    w, r = (jslices, tslices) if writer == "reference" else \
        (tslices, jslices)
    d = str(tmp_path / "m")
    slim = w.publish_sliced(d, y_ids, Y, x_ids, X, known, 8)
    path, mdir, manifest = r.parse_model_ref(
        w.model_ref_message(d + "/model.pmml.xml", d, slim))
    assert (path, mdir, manifest) == (d + "/model.pmml.xml", d, slim)
    got_ids, got_rows = [], []
    for entry in manifest["slices"]:
        ids, rows, ordinals = r.read_slice(d, entry, 5)
        want = w.read_slice(d, entry, 5)
        assert ids == want[0] and ordinals == want[2]
        assert np.array_equal(rows, want[1])
        got_ids += ids
        got_rows.append(rows)
    order = np.argsort([int(i[1:]) for i in got_ids])
    np.testing.assert_array_equal(
        np.concatenate(got_rows)[order],
        np.round(Y.astype(np.float64), 8).astype(np.float32))
    xi, xm, xk = r.read_x_known(d, manifest["x"], 5)
    assert xi == x_ids and xk == [known[u] for u in x_ids]
    assert r.owned_slices(8, 1, 4) == w.owned_slices(8, 1, 4) == [1, 5]
    assert r.owned_slices(8, 0, 3) is None


def test_corrupt_slices_fail_alike(tmp_path):
    y_ids, Y, x_ids, X, known = _catalog(seed=9)
    d = str(tmp_path / "m")
    slim = tslices.publish_sliced(d, y_ids, Y, x_ids, X, known, 4)
    entry = slim["slices"][1]
    p = os.path.join(d, entry["path"])
    with open(p, "rb") as f:
        payload = f.read()
    with open(p, "wb") as f:
        f.write(payload[:-7])
    for mod in (jslices, tslices):
        with pytest.raises(mod.SliceIntegrityError, match="checksum"):
            mod.read_slice(d, entry, 5)
    for faults, mod in ((jfaults, jslices), (tfaults, tslices)):
        faults.inject("store-slice-missing", mode="error", times=1)
        try:
            with pytest.raises(mod.SliceIntegrityError, match="injected"):
                mod.read_slice(d, slim["slices"][0], 5)
        finally:
            faults.clear()


def test_monolithic_artifacts_are_shared(tmp_path):
    y_ids, Y, _, _, _ = _catalog(seed=10)
    jupdate.save_features(str(tmp_path / "j"), y_ids, Y)
    tupdate.save_features(str(tmp_path / "t"), y_ids, Y)
    with open(tmp_path / "j" / "part-00000.gz", "rb") as a, \
            open(tmp_path / "t" / "part-00000.gz", "rb") as b:
        ja, tb = a.read(), b.read()
    assert gzip.decompress(ja) == gzip.decompress(tb)
    for d in ("j", "t"):
        ids, m = tupdate.load_features(str(tmp_path / d))
        jids, jm = jupdate.load_features(str(tmp_path / d))
        assert ids == jids == y_ids and np.array_equal(m, jm)


@pytest.mark.parametrize("message", [
    '["Y","i1",[0.5,1.5]]',
    '["X","u1",[0.5,1.5],["i1","i2"]]',
    '["X","u1",[0.5,1.5],[]]',
    '["Y","i1",[0.5]]',                    # wrong dimension
    '["Y","i1",[0.5,1.5,2.5]]',            # wrong dimension
    '["Y","i1",[0.5,NaN]]',                # non-finite
    '["Y","i1",[Infinity,1.0]]',           # non-finite
    '["Y","i1",[[0.5,1.5]]]',              # not a vector
    '["Y","i1",["a","b"]]',                # not numbers
    '["Y","i1"]',                          # truncated
    '{"kind":"Y","id":"i1"}',              # an object
    'not json',
    '',
    '["Y",7,[1,2]]',                       # numeric id
    '["Z","q",[1,2]]',                     # unknown kind passes the gate
])
def test_up_trust_gate_matches(message):
    want = jcommon.parse_up_update(message, 2)
    got = tcommon.parse_up_update(message, 2)
    if want is None:
        assert got is None
    else:
        assert got is not None
        assert got[:2] == want[:2] and got[3] == want[3]
        assert got[2].dtype == np.float32
        np.testing.assert_array_equal(got[2], want[2])
    assert (tcommon.parse_up_update(message) is None) == \
        (jcommon.parse_up_update(message) is None)
