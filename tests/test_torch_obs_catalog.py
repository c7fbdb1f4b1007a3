"""Every metric, span and stage name the port exports appears in the
catalog of ``docs/OBSERVABILITY.md`` (read, never edited), under the
same naming rules as the reference's names
(``tests/test_obs_catalog.py`` lints those).

The walk is AST-based over ``oryx_tpu_torch/``: the literal names at
the call sites of MetricsRegistry (``inc``, ``set_gauge``, ``gauge_fn``)
and Tracer (``span``, ``child_span``, ``record_span``), the dynamic
per-tier request spans, the anatomy's stages, the wide-event fields and
the flight bundle's keys, and the per-route device-time counters the
accountant derives from the ``device_time_us_*`` prefix."""

from __future__ import annotations

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "oryx_tpu_torch"
DOC = REPO / "docs" / "OBSERVABILITY.md"

_SPAN_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_METHODS = {"span": ("span", 0), "child_span": ("span", 1),
            "record_span": ("span", 0), "inc": ("counter", 0),
            "set_gauge": ("gauge", 0), "gauge_fn": ("gauge", 0)}
# f"{service}.request" spans: one per tier of the port with HTTP
_REQUEST_SPANS = {"serving.request", "speed.request", "batch.request"}


def _collect() -> dict[str, dict[str, list[str]]]:
    found: dict[str, dict[str, list[str]]] = {
        "span": {}, "counter": {}, "gauge": {}}
    for path in sorted(SRC.rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METHODS):
                continue
            kind, index = _METHODS[node.func.attr]
            if len(node.args) > index:
                arg = node.args[index]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    found[kind].setdefault(arg.value, []).append(
                        f"{path.relative_to(REPO)}:{node.lineno}")
    return found


def _tuple(path: pathlib.Path, name: str) -> tuple[str, ...]:
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return tuple(el.value for el in node.value.elts)
    raise AssertionError(f"{name} not in {path}")


@pytest.fixture(scope="module")
def source():
    return _collect()


@pytest.fixture(scope="module")
def catalog():
    names = set()
    for line in DOC.read_text(encoding="utf-8").splitlines():
        if line.startswith("|"):
            m = re.fullmatch(r"`([^`]+)`", line.split("|")[1].strip())
            if m:
                names.add(m.group(1))
    assert names
    return names


def test_walk_sees_the_port_call_sites(source):
    assert {"serving.queue_wait", "serving.device_execute",
            "speed.fold_in"} <= set(source["span"])
    assert {"device_time_us", "flight_dumps",
            "event_write_failures"} <= set(source["counter"])
    assert {"update_lag_records", "device_busy_fraction",
            "ingest_to_servable_ms", "batch_generation_age_sec",
            "model_slice_bytes"} <= set(source["gauge"])


@pytest.mark.parametrize("kind", ["span", "counter", "gauge"])
def test_every_port_name_is_catalogued(source, catalog, kind):
    missing = [f"{name!r} ({', '.join(sites)})"
               for name, sites in sorted(source[kind].items())
               if name not in catalog]
    assert not missing, f"{kind}s not in the catalog: {missing}"
    rule = _SPAN_RE if kind == "span" else _NAME_RE
    assert all(rule.fullmatch(n) for n in source[kind])


def test_request_spans_and_device_time_family_are_catalogued(catalog):
    assert _REQUEST_SPANS <= catalog
    # the accountant's per-route counters are documented as the family
    # of the device_time_us row
    row = next(line for line in DOC.read_text(encoding="utf-8")
               .splitlines() if line.startswith("| `device_time_us` |"))
    assert "`device_time_us_<route-class>_<kernel-route>`" in row


@pytest.mark.parametrize("module,name", [
    ("anatomy.py", "STAGES"), ("events.py", "FIELDS"),
    ("flight.py", "BUNDLE_FIELDS")])
def test_stage_field_and_bundle_names_are_catalogued(catalog, module,
                                                     name):
    names = _tuple(SRC / "obs" / module, name)
    assert len(names) >= 5
    assert set(names) <= catalog, sorted(set(names) - catalog)
