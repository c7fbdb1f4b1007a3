"""The port's scheme-routed store (``oryx_tpu_torch/common/store.py``)
on ``memory://``, fsspec's in-process filesystem standing in for a
remote object store, against the reference's (``tests/test_store.py``'s
``memory://`` cases), on the CPU.

Both packages share the process's one memory filesystem, so each case
also reads through the other package what one package wrote.  A sliced
MODEL-REF published to ``memory://`` by the port's ALSUpdate loads end
to end in the port's serving and speed managers and in the reference's
serving manager.  No module of the port imports fsspec when it is
imported: only a ``memory://`` (or other remote) URI loads it."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

fsspec = pytest.importorskip("fsspec")

from oryx_tpu.common import store as jstore  # noqa: E402
from oryx_tpu.kafka.api import KeyMessage as JKeyMessage  # noqa: E402
from oryx_tpu.lambda_rt import data_store as jdata_store  # noqa: E402
from oryx_tpu_torch.common import store  # noqa: E402
from oryx_tpu_torch.kafka.api import KEY_MODEL_REF, KeyMessage  # noqa: E402
from oryx_tpu_torch.lambda_rt import data_store  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear_memory_fs():
    fs = fsspec.filesystem("memory")
    for p in list(fs.store):
        fs.store.pop(p, None)
    fs.pseudo_dirs[:] = [""]


@pytest.fixture(autouse=True)
def memory_fs():
    _clear_memory_fs()
    yield
    _clear_memory_fs()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_primitives_memory_scheme(writer):
    w, r = (store, jstore) if writer == "port" else (jstore, store)
    base = "memory://bucket/dir"
    p = w.join(base, "sub", "file.txt")
    assert p == r.join(base, "sub", "file.txt") == \
        "memory://bucket/dir/sub/file.txt"
    assert not w.exists(p) and not r.exists(p)
    with w.open_write(p) as f:
        f.write(b"hello")
    assert r.exists(p) and r.getsize(p) == w.getsize(p) == 5
    with r.open_read(p) as f:
        assert f.read() == b"hello"
    assert w.glob(w.join(base, "sub"), "*.txt") == \
        r.glob(r.join(base, "sub"), "*.txt") == [p]
    w.rename(p, w.join(base, "sub", "renamed.txt"))
    assert not r.exists(p)
    assert r.exists(r.join(base, "sub", "renamed.txt"))
    assert w.mkdirs("memory://bucket/made") == "memory://bucket/made"
    w.delete_recursively(w.join(base, "sub"))
    assert not r.exists(r.join(base, "sub", "renamed.txt"))
    assert store.is_local("file:///x") and not store.is_local("memory://x")


def test_generations_on_memory_store():
    """The batch layer's generations on a remote scheme: each package
    reads back what the other saved, and TTL deletion routes through
    the same store."""
    data_dir = "memory://lake/data"
    path = data_store.save_generation(
        data_dir, 1000, [KeyMessage("k", "1,2,3"), KeyMessage(None, "4,5,6")])
    assert path.startswith("memory://")
    jdata_store.save_generation(data_dir, 2000,
                                [JKeyMessage("z", "7,8,9")])
    want = ["1,2,3", "4,5,6", "7,8,9"]
    assert [km.message for km in data_store.read_all_data(data_dir)] == \
        [km.message for km in jdata_store.read_all_data(data_dir)] == want
    assert data_store.delete_old_data(data_dir, 0) == 2
    assert data_store.read_all_data(data_dir) == \
        jdata_store.read_all_data(data_dir) == []


def test_rename_rejects_cross_scheme_uris(tmp_path):
    src = "memory://bucket/a.txt"
    with store.open_write(src) as f:
        f.write(b"x")
    for s in (store, jstore):
        with pytest.raises(ValueError, match="matching URI schemes"):
            s.rename(src, f"file://{tmp_path}/a.txt")
        with pytest.raises(ValueError, match="matching URI schemes"):
            s.rename(f"file://{tmp_path}/a.txt", src)
    assert store.exists(src)


def test_missing_model_ref_is_tolerated():
    from oryx_tpu.app.pmml_utils import \
        read_pmml_from_update_key_message as jread
    from oryx_tpu_torch.app.pmml_utils import \
        read_pmml_from_update_key_message as tread
    uri = "memory://lake/model/nope.pmml.xml"
    assert tread(KEY_MODEL_REF, uri) is None
    assert jread(KEY_MODEL_REF, uri) is None


def test_sliced_model_ref_loads_end_to_end_from_memory():
    """The port's ALSUpdate on a memory:// model-dir with a tiny message
    size publishes a manifest-carrying MODEL-REF; the port's serving
    and speed managers, and the reference's serving manager, load every
    slice from memory:// alone and hold the same vectors."""
    from oryx_tpu.app.als.serving_manager import \
        ALSServingModelManager as JServingManager
    from oryx_tpu.common.config import from_dict as jfrom_dict
    from oryx_tpu_torch.app.als.serving_manager import \
        ALSServingModelManager
    from oryx_tpu_torch.app.als.slices import parse_model_ref
    from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.app.als.update import ALSUpdate, load_features
    from oryx_tpu_torch.common.config import from_dict

    cfg = from_dict({
        "oryx.update-topic.message.max-size": 1 << 7,  # force MODEL-REF
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.ml.eval.candidates": 1,
        "oryx.als.hyperparams.features": 4,
        "oryx.als.hyperparams.lambda": 0.001,
        "oryx.als.implicit": True,
        "oryx.als.publish.slices": 4,
    })
    rng = np.random.default_rng(7)
    data = [KeyMessage(None, f"u{rng.integers(20)},i{rng.integers(30)},1")
            for _ in range(300)]
    sent = []

    class Capture:
        def send(self, key, message, headers=None):
            sent.append((key, message))

    ALSUpdate(cfg, device="cpu").run_update(0, data, [],
                                            "memory://lake/model",
                                            Capture())
    refs = [m for k, m in sent if k == KEY_MODEL_REF]
    assert len(refs) == 1, [k for k, _ in sent]
    path, _, manifest = parse_model_ref(refs[0])
    assert path.startswith("memory://lake/model/")
    assert manifest is not None and len(manifest["slices"]) == 4
    # the staging directory is gone after the publish by rename
    assert store.glob("memory://lake/model", ".temporary/*") == []
    model_dir = path.rsplit("/", 1)[0]
    y_ids, Y = load_features(store.join(model_dir, "Y"))
    x_ids, X = load_features(store.join(model_dir, "X"))
    assert len(y_ids) == Y.shape[0] > 0 and Y.shape[1] == 4

    serving = ALSServingModelManager(from_dict(
        {"oryx.serving.model-manager-class": "unused"}), device="cpu")
    speed = ALSSpeedModelManager(cfg, device="cpu")
    ref = JServingManager(jfrom_dict(
        {"oryx.serving.model-manager-class": "unused"}))
    for mgr in (serving, speed, ref):
        mgr.consume_key_message(KEY_MODEL_REF, refs[0])
        assert mgr.slice_load_fallbacks == 0 and mgr.slice_loads == 4
    for model in (serving.model, speed.model, ref.model):
        assert sorted(model.Y.all_ids()) == sorted(y_ids)
        for j in (0, len(y_ids) // 2, len(y_ids) - 1):
            np.testing.assert_array_equal(
                np.asarray(model.get_item_vector(y_ids[j])), Y[j])
    for u in (0, len(x_ids) - 1):
        np.testing.assert_array_equal(
            np.asarray(speed.model.get_user_vector(x_ids[u])), X[u])


def test_no_module_imports_fsspec_until_a_remote_uri(tmp_path):
    """Every module of the port imports without fsspec; a remote URI
    with fsspec absent raises ImportError naming it, never a local
    fallback."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name == "fsspec" or name.startswith("fsspec."):
                    raise ImportError(f"No module named {name!r}")
                return None

        sys.meta_path.insert(0, _Block())
        import oryx_tpu_torch
        for m in pkgutil.walk_packages(oryx_tpu_torch.__path__,
                                       "oryx_tpu_torch."):
            if m.name != "oryx_tpu_torch.__main__":
                importlib.import_module(m.name)
        assert not [n for n in sys.modules if n.startswith("fsspec")]
        from oryx_tpu_torch.common import store
        for fn, arg in ((store.exists, "memory://b/x"),
                        (store.open_read, "memory://b/x"),
                        (store.open_write, "s3://b/x")):
            try:
                fn(arg)
            except ImportError as e:
                assert "fsspec" in str(e), e
            else:
                raise AssertionError(f"{fn.__name__}({arg}) passed")
        assert store.exists(sys.argv[1])
        print("ok")
    """)
    marker = tmp_path / "here.txt"
    marker.write_text("x")
    out = subprocess.run(
        [sys.executable, "-c", script, f"file://{marker}"], cwd=REPO,
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
