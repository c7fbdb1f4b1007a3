"""The port's HOCON parser and config loader resolve the same trees as
the reference's, and its plugin loader refuses classes of other
packages."""

from __future__ import annotations

import glob
import os

import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import hocon as jhocon
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import hocon as thocon
from oryx_tpu_torch.common.lang import load_class, load_instance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "*.conf")))


def _without_cache_comments(text: str) -> list[str]:
    """The lines of a reference.conf without the comments directly above
    the compile-cache keys and their trailing ``# compat:`` annotation:
    the port's describe its kernel library cache, the reference's JAX's
    compilation cache."""
    lines = text.splitlines()
    out: list[str] = []
    for line in lines:
        if line.strip().startswith("compile-cache-"):
            while out and out[-1].strip().startswith("#"):
                out.pop()
            line = line.split("  # compat:")[0]
        out.append(line)
    return out


def test_reference_conf_is_the_reference_copy():
    with open(os.path.join(REPO, "oryx_tpu", "common",
                           "reference.conf"), encoding="utf-8") as a, \
            open(os.path.join(REPO, "oryx_tpu_torch", "common",
                              "reference.conf"), encoding="utf-8") as b:
        assert _without_cache_comments(a.read()) == \
            _without_cache_comments(b.read())
    assert tconfig.get_default().as_dict() == \
        jconfig.get_default().as_dict()


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_conf_files_resolve_alike(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert thocon.loads_raw(text).keys() == jhocon.loads_raw(text).keys()
    assert tconfig.from_file(path).as_dict() == \
        jconfig.from_file(path).as_dict()


@pytest.mark.parametrize("text", [
    "a = 1\nb = ${a}\nc { d = ${b}, e = [1, 2, ${a}] }",
    "x.y.z = 3\nx { y { w = \"q\" } }\nx.y.z = 4",
    "a { b = 1 }\na { c = 2 }\na.b = 5 // override\n# comment",
    "s = \"quoted \\\"string\\\"\"\nt = unquoted words here\nu = null",
    "v = ${?missing}\nw = 1.5e3\nflag = true",
])
def test_substitutions_and_overrides_resolve_alike(text):
    assert thocon.loads(text) == jhocon.loads(text)


@pytest.mark.parametrize("text", [
    'include "other.conf"\na = 1',
    "a = ${nowhere}",
    "a = ${b}\nb = ${a}",
    "a { b = 1",
])
def test_unsupported_and_broken_documents_fail_alike(text):
    with pytest.raises(jhocon.HoconParseError) as want:
        jhocon.loads(text)
    with pytest.raises(thocon.HoconParseError) as got:
        thocon.loads(text)
    assert str(got.value) == str(want.value)


def test_overlay_strings_and_dicts_resolve_alike():
    overlay = {"oryx.serving.api.port": 0,
               "oryx.als.sample-rate": 0.3,
               "oryx.update-topic.broker": "file:///x/broker"}
    assert tconfig.from_dict(overlay).as_dict() == \
        jconfig.from_dict(overlay).as_dict()
    text = "oryx.als.hyperparams.features = 50\noryx.id = ${oryx.als.implicit}"
    assert tconfig.overlay_on(text, tconfig.get_default()).as_dict() == \
        jconfig.overlay_on(text, jconfig.get_default()).as_dict()


def test_port_example_conf_differs_only_in_its_classes():
    port = tconfig.from_file(os.path.join(
        REPO, "oryx_tpu_torch", "conf", "als-example.conf")).as_dict()
    ref = jconfig.from_file(os.path.join(REPO, "conf",
                                         "als-example.conf")).as_dict()
    assert port["oryx"]["serving"]["model-manager-class"] == \
        "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager"
    assert port["oryx"]["serving"]["application-resources"] == \
        "oryx_tpu_torch.serving.als"
    assert port["oryx"]["batch"]["update-class"] == \
        "oryx_tpu_torch.app.als.update.ALSUpdate"
    assert port["oryx"]["speed"]["model-manager-class"] == \
        "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager"
    for tree in (port, ref):
        for key in ("model-manager-class", "application-resources"):
            del tree["oryx"]["serving"][key]
        del tree["oryx"]["batch"]["update-class"]
        del tree["oryx"]["speed"]["model-manager-class"]
    assert port == ref


def test_port_kmeans_example_conf_differs_only_in_its_classes():
    port = tconfig.from_file(os.path.join(
        REPO, "oryx_tpu_torch", "conf", "kmeans-example.conf")).as_dict()
    ref = jconfig.from_file(os.path.join(REPO, "conf",
                                         "kmeans-example.conf")).as_dict()
    classes = {("serving", "model-manager-class"):
               "app.kmeans.serving.KMeansServingModelManager",
               ("serving", "application-resources"): "serving.clustering",
               ("batch", "update-class"): "app.kmeans.update.KMeansUpdate",
               ("speed", "model-manager-class"):
               "app.kmeans.speed.KMeansSpeedModelManager"}
    for (layer, key), name in classes.items():
        assert port["oryx"][layer][key] == f"oryx_tpu_torch.{name}"
        assert ref["oryx"][layer][key] == f"oryx_tpu.{name}"
        for tree in (port, ref):
            del tree["oryx"][layer][key]
    assert port == ref


def test_string_list_getters_match():
    overlay = {"oryx.input-schema.feature-names": ["a", 1],
               "oryx.input-schema.numeric-features": "a"}
    t = tconfig.from_dict(overlay)
    j = jconfig.from_dict(overlay)
    for path in ("oryx.input-schema.feature-names",
                 "oryx.input-schema.id-features"):
        assert t.get_string_list(path) == j.get_string_list(path)
    for path in ("oryx.input-schema.numeric-features",
                 "oryx.input-schema.categorical-features",
                 "oryx.input-schema.feature-names", "oryx.no.such.list"):
        assert t.get_optional_string_list(path) == \
            j.get_optional_string_list(path)
    with pytest.raises(TypeError):
        t.get_string_list("oryx.input-schema.num-features")


def test_typed_getters_match():
    t, j = tconfig.get_default(), jconfig.get_default()
    for path in ("oryx.serving.api.port", "oryx.serving.api.max-batch"):
        assert t.get_int(path) == j.get_int(path)
    for path in ("oryx.als.sample-rate",
                 "oryx.serving.min-model-load-fraction"):
        assert t.get_double(path) == j.get_double(path)
    assert t.get_string("oryx.serving.api.int8-selection") == "auto"
    assert t.get_optional_string("oryx.als.rescorer-provider-class") is None
    assert t.get_bool("oryx.serving.api.read-only") is False
    with pytest.raises(TypeError):
        t.get_int("oryx.als.factor-dtype")
    with pytest.raises(KeyError):
        t.get("oryx.no.such.key")


@pytest.mark.parametrize("name", [
    "oryx_tpu.app.als.serving_manager.ALSServingModelManager",
    "oryx_tpu.serving.als.ROUTES",
    "collections.OrderedDict",
])
def test_load_instance_refuses_other_packages(name):
    with pytest.raises(ValueError, match="not part of oryx_tpu_torch"):
        load_instance(name, tconfig.get_default())


def test_load_instance_loads_port_classes():
    mgr = load_instance(
        "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
        tconfig.get_default(), "cpu")
    assert mgr.device == "cpu" and mgr.get_model() is None
    with pytest.raises(ImportError):
        load_class("oryx_tpu_torch.common.lang.NoSuchClass")
