"""diagnose-catalog — the auto-triage surface cross-check.

The ``/admin/diagnose`` rule engine (``obs/diagnose.py``) is only as
trustworthy as the names it reads: a metric renamed out from under a
rule silently degrades that rule to never-firing, and a flight-recorder
bundle field nobody documented is a black box an operator cannot read.
So this pass pins both surfaces to the catalog, in the same AST-walk
style as the obs-catalog lint (tests/test_obs_catalog.py):

- every metric name in a diagnosis ``Rule(...)``'s ``reads=`` tuple
  must exist as a backticked first-cell row in one of
  ``docs/OBSERVABILITY.md``'s tables, and
- every field in an ``obs/flight.py``-style module-level
  ``BUNDLE_FIELDS = (...)`` tuple must too.

Stale references fail CI; the fix is to rename the read, or to add the
catalog row the new name deserves.  Dynamically composed names are
invisible to this walk by design — diagnosis rules must read literal,
documented names only.
"""

from __future__ import annotations

import ast
import pathlib
import re

from .core import Finding, ModuleSource, SourceModel

__all__ = ["run"]

PASS = "diagnose-catalog"

_CELL_RE = re.compile(r"`([^`]+)`")


def _catalog_names(doc_path: pathlib.Path) -> set[str]:
    """Backticked first cells of every ``|`` table row in the doc —
    the same liberal parse the obs-catalog test uses, so one catalog
    serves metric rows, schema rows, and bundle-field rows alike."""
    names: set[str] = set()
    for line in doc_path.read_text(encoding="utf-8").splitlines():
        if not line.startswith("|"):
            continue
        first = line.split("|")[1].strip()
        m = _CELL_RE.fullmatch(first)
        if m:
            names.add(m.group(1))
    return names


def _rule_reads(mod: ModuleSource):
    """(name, lineno) for every string in a ``reads=`` keyword tuple of
    a ``Rule(...)`` call — the literal metric names a diagnosis rule
    consumes."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = mod.dotted_call_name(node.func)
        if name is None or not (name == "Rule" or name.endswith(".Rule")):
            continue
        for kw in node.keywords:
            if kw.arg != "reads" or not isinstance(kw.value, ast.Tuple):
                continue
            for elt in kw.value.elts:
                if (isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)):
                    yield elt.value, elt.lineno


def _bundle_fields(mod: ModuleSource):
    """(name, lineno) for every string in a module-level
    ``BUNDLE_FIELDS = (...)`` tuple — the flight bundle's documented
    field contract."""
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "BUNDLE_FIELDS"
                and isinstance(node.value, ast.Tuple)):
            continue
        for elt in node.value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                yield elt.value, elt.lineno


def run(model: SourceModel) -> list[Finding]:
    # the catalog lives next to the drift pass's RESILIENCE.md — one
    # docs/ directory carries the whole cross-surface contract
    if model.doc_path is None:
        return []
    doc_path = model.doc_path.parent / "OBSERVABILITY.md"
    if not doc_path.is_file():
        return []
    doc_rel = model.display_path(doc_path)
    catalog = _catalog_names(doc_path)
    findings: list[Finding] = []
    for mod in model.modules:
        for name, line in _rule_reads(mod):
            if name not in catalog:
                findings.append(Finding(
                    PASS, "uncatalogued-metric", mod.rel, line, name,
                    f"diagnosis rule reads metric {name!r} which has "
                    f"no {doc_rel} catalog row — the rule would "
                    f"silently never fire; rename the read or add "
                    f"the row"))
        for name, line in _bundle_fields(mod):
            if name not in catalog:
                findings.append(Finding(
                    PASS, "uncatalogued-flight-field", mod.rel, line,
                    name,
                    f"flight bundle field {name!r} has no {doc_rel} "
                    f"catalog row — document it in the bundle-format "
                    f"table or drop the field"))
    return findings
