"""Shared machinery for the analysis passes: the parsed-source model,
the finding type, the suppression ledger, and the pass registry.

Everything is pure AST + text — importing a scanned module is never
required (or allowed: the scanner must be able to lint a module whose
import would start threads, open sockets, or need a device).
"""

from __future__ import annotations

import ast
import io
import pathlib
import tokenize as _tokenize
from dataclasses import dataclass, field
from typing import Callable, Iterable

__all__ = ["Finding", "ModuleSource", "SourceModel", "Suppression",
           "load_suppressions", "apply_suppressions", "run_passes",
           "PASS_NAMES"]


@dataclass
class Finding:
    """One defect reported by a pass.

    ``symbol`` is the stable identity a suppression matches on
    (attribute, dotted call, config key, fault point, or cycle
    string); ``line`` is advisory and never part of the match key, so
    unrelated edits don't churn the ledger.
    """

    pass_name: str
    rule: str
    file: str
    line: int
    symbol: str
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return {"pass": self.pass_name, "rule": self.rule,
                "file": self.file, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "suppressed": self.suppressed}

    def sort_key(self):
        return (self.pass_name, self.file, self.line, self.rule,
                self.symbol)


class ModuleSource:
    """One parsed source file: AST, raw lines (for trailing-comment
    annotations the AST cannot see), and the import-alias map that
    resolves a call's dotted name."""

    def __init__(self, path: pathlib.Path, rel: str, dotted: str):
        self.path = path
        self.rel = rel        # display path: oryx_tpu_torch/cluster/x.py
        self.dotted = dotted  # module name: oryx_tpu_torch.cluster.x
        self.text = path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self.aliases = self._import_aliases()
        self.module_consts = _string_consts(self.tree.body)
        self.comments = self._comments()

    def _comments(self) -> dict[int, str]:
        """1-based line -> comment text, from real COMMENT tokens —
        a ``# guarded-by:`` mentioned inside a string or docstring is
        not an annotation."""
        out: dict[int, str] = {}
        try:
            for tok in _tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == _tokenize.COMMENT:
                    out[tok.start[0]] = tok.string.lstrip("#").strip()
        except _tokenize.TokenError:  # pragma: no cover
            pass
        return out

    def _import_aliases(self) -> dict[str, str]:
        """local name -> dotted target, from this module's imports.
        Relative imports resolve against the module's own package."""
        out: dict[str, str] = {}
        pkg_parts = self.dotted.split(".")[:-1]
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        out[root] = root
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                    mod = ".".join(base + ([node.module]
                                           if node.module else []))
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = f"{mod}.{a.name}" if mod \
                        else a.name
        return out

    def dotted_call_name(self, func: ast.expr) -> str | None:
        """Resolve a call's function expression to a dotted name using
        the import aliases: ``faults.fire`` imported via ``from
        ..resilience import faults`` -> ``oryx_tpu_torch.resilience
        .faults.fire``.  None when the chain is not rooted at a plain name
        (e.g. a method call on an object)."""
        parts: list[str] = []
        while isinstance(func, ast.Attribute):
            parts.append(func.attr)
            func = func.value
        if not isinstance(func, ast.Name):
            return None
        parts.append(self.aliases.get(func.id, func.id))
        return ".".join(reversed(parts))

    def trailing_comment(self, lineno: int) -> str:
        """The comment on a 1-based source line ('' when none) — real
        COMMENT tokens only, so a ``#`` inside a string never counts.
        The annotation grammar is single-line by rule
        (docs/ANALYSIS.md)."""
        return self.comments.get(lineno, "")


def _string_consts(body: Iterable[ast.stmt]) -> dict[str, str]:
    """``name = "literal"`` string assignments in a statement list —
    the constant-propagation scope used to resolve f-string config
    keys like ``f"{c}.max-connections"``."""
    out: dict[str, str] = {}
    for node in body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


class SourceModel:
    """Every ``*.py`` under ``root``, parsed once and shared by all
    passes, plus the cross-surface files the drift pass checks."""

    def __init__(self, root: pathlib.Path,
                 conf_path: pathlib.Path | None = None,
                 doc_path: pathlib.Path | None = None):
        self.root = root.resolve()
        self.conf_path = conf_path
        self.doc_path = doc_path
        self.modules: list[ModuleSource] = []
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(self.root)
            display = f"{self.root.name}/{rel.as_posix()}"
            dotted = ".".join(
                [self.root.name] + list(rel.with_suffix("").parts))
            if dotted.endswith(".__init__"):
                dotted = dotted[:-len(".__init__")]
            self.modules.append(ModuleSource(path, display, dotted))

    def display_path(self, path: pathlib.Path) -> str:
        """Stable display form for a non-module file (reference.conf,
        RESILIENCE.md): relative to the scan root's parent when
        inside it, else the plain path."""
        try:
            return path.resolve().relative_to(
                self.root.parent).as_posix()
        except ValueError:
            return path.as_posix()


@dataclass
class Suppression:
    """One ledger entry.  ``pass_name`` and ``justification`` are
    required; ``file`` / ``symbol`` / ``rule`` narrow the match (all
    given fields must equal the finding's).  ``hits`` counts matched
    findings so the test can fail stale entries."""

    pass_name: str
    justification: str
    file: str | None = None
    symbol: str | None = None
    rule: str | None = None
    hits: int = field(default=0, compare=False)

    def matches(self, f: Finding) -> bool:
        return (self.pass_name == f.pass_name
                and (self.file is None or self.file == f.file)
                and (self.symbol is None or self.symbol == f.symbol)
                and (self.rule is None or self.rule == f.rule))


def load_suppressions(path: pathlib.Path) -> list[Suppression]:
    import tomllib
    with open(path, "rb") as fh:
        data = tomllib.load(fh)
    out = []
    for i, entry in enumerate(data.get("suppression", [])):
        try:
            out.append(Suppression(
                pass_name=entry["pass"],
                justification=entry["justification"],
                file=entry.get("file"), symbol=entry.get("symbol"),
                rule=entry.get("rule")))
        except KeyError as e:
            raise ValueError(
                f"suppression #{i + 1} in {path}: missing {e}") from e
    return out


def apply_suppressions(findings: list[Finding],
                       suppressions: list[Suppression]) -> None:
    for f in findings:
        for s in suppressions:
            if s.matches(f):
                s.hits += 1
                f.suppressed = True


# populated lazily to keep core import-cycle-free
PASS_NAMES = ("guarded-by", "async-blocking", "lock-order", "drift",
              "sim-clock", "diagnose-catalog")


def _registry() -> dict[str, Callable[[SourceModel], list[Finding]]]:
    from . import (async_blocking, diagnose_catalog, drift, guarded,
                   lock_order, sim_clock)
    return {"guarded-by": guarded.run,
            "async-blocking": async_blocking.run,
            "lock-order": lock_order.run,
            "drift": drift.run,
            "sim-clock": sim_clock.run,
            "diagnose-catalog": diagnose_catalog.run}


def run_passes(model: SourceModel,
               passes: Iterable[str] | None = None) -> list[Finding]:
    registry = _registry()
    names = list(passes) if passes else list(PASS_NAMES)
    findings: list[Finding] = []
    for name in names:
        if name not in registry:
            raise ValueError(f"unknown pass {name!r}; "
                             f"known: {', '.join(PASS_NAMES)}")
        findings.extend(registry[name](model))
    findings.sort(key=Finding.sort_key)
    return findings
