"""drift — config-key and chaos-fault-point cross-surface checks.

**Config drift.**  Every ``oryx.*`` key passed to a ``Config`` getter
(``get_string``/``get_int``/.../``has_path``/``get``) must be a path
in ``common/reference.conf``; every leaf in ``reference.conf`` must be
read somewhere.  Key literals are collected by AST (multi-line calls
included), and the prevailing ``f"{c}.max-connections"`` prefix idiom
resolves through local/module string constants.  A prefix passed as a
plain call argument (``Retry.from_config(config, "oryx.resilience.
retry")``) marks that whole subtree as read — the helper's own
f-string reads are parameterized and invisible statically, which is
exactly what the prefix literal at the call site is for.

**Chaos drift** (the obs-catalog lint generalized, plus its inverse).
Every fault point fired via ``resilience/faults`` (literal
``fire("...")`` / ``_fault("...")`` arguments, plus
``# chaos-point: name`` trailing annotations for dynamically composed
point names) must have a row in the ``docs/RESILIENCE.md`` injection-
points table; every table row must correspond to a live fire site —
a deleted seam must take its documentation with it.
"""

from __future__ import annotations

import pathlib
import re
import ast

from ..common import hocon
from .core import Finding, ModuleSource, SourceModel

__all__ = ["run", "CONFIG_GETTERS", "FIRE_FUNCTIONS"]

PASS = "drift"

CONFIG_GETTERS = frozenset({
    "get", "get_string", "get_int", "get_double", "get_bool",
    "get_string_list", "get_double_list", "get_optional_string",
    "get_optional_int", "get_optional_double", "get_optional_bool",
    "get_optional_string_list", "has_path"})

# resolved dotted names that register a fault point at their call site
FIRE_FUNCTIONS = frozenset({"oryx_tpu_torch.resilience.faults.fire"})

_KEY_RE = re.compile(r"^oryx(\.[A-Za-z0-9_-]+)+$")
_POINT_RE = re.compile(r"^[a-z][a-z0-9-]*$")
_DOC_ROW_RE = re.compile(r"`([^`]+)`")


# -- config surface ---------------------------------------------------------

def _conf_paths(conf_path: pathlib.Path) -> tuple[set[str], set[str]]:
    """(leaf paths, all paths).  Null-valued leaves count (they are
    real optional keys); an empty object counts as a leaf (it is a
    declared-but-empty surface, like ``resilience.faults``)."""
    root = hocon.resolve(hocon.loads_raw(
        conf_path.read_text(encoding="utf-8")))
    leaves: set[str] = set()
    every: set[str] = set()

    def walk(node, path: str):
        if path:
            every.add(path)
        if isinstance(node, dict) and node:
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        else:
            leaves.add(path)

    walk(root, "")
    return leaves, every


_OPEN_RE = re.compile(r"^\s*([A-Za-z0-9_.-]+)\s*(?:=\s*)?\{\s*$")
_EMPTY_RE = re.compile(r"^\s*([A-Za-z0-9_.-]+)\s*=\s*\{\s*\}\s*$")
_VALUE_RE = re.compile(r"^\s*([A-Za-z0-9_.-]+)\s*=")


def _conf_line_index(
        conf_path: pathlib.Path) -> tuple[dict[str, int],
                                          dict[str, str]]:
    """Brace-tracking walk of the conf file: (dotted-path -> 1-based
    line, dotted-path -> ``# compat:`` justification).  A ``# compat:
    <why>`` trailing comment on a key's line declares the key — or,
    on a block/substitution line, its whole subtree — intentionally
    unread (reference-parity surface); the dead-key check honors it
    the way the race detector honors ``# guarded-by:``.
    reference.conf's regular one-key-per-line style keeps the line
    map exact; anything odd just maps to line 0."""
    lines: dict[str, int] = {}
    compat: dict[str, str] = {}
    stack: list[str] = []
    for i, raw in enumerate(
            conf_path.read_text(encoding="utf-8").splitlines(), 1):
        line = raw.split("#")[0].split("//")[0].rstrip()
        if not line.strip():
            continue
        path = None
        m = _OPEN_RE.match(line)
        if m:
            path = ".".join(stack + [m.group(1)])
            lines.setdefault(path, i)
            stack.append(m.group(1))
        else:
            m = _EMPTY_RE.match(line) or _VALUE_RE.match(line)
            if m:
                path = ".".join(stack + [m.group(1)])
                lines.setdefault(path, i)
            elif line.strip() == "}" and stack:
                stack.pop()
        if path is not None and "# compat:" in raw:
            compat[path] = raw.split("# compat:", 1)[1].strip()
    return lines, compat


class _KeyReads:
    def __init__(self):
        # key -> (file, line) first getter read
        self.getter_reads: dict[str, tuple[str, int]] = {}
        # oryx.* literals seen as plain call arguments: subtree reads
        self.prefix_reads: set[str] = set()
        self.dynamic_reads = 0  # unresolvable f-string getter args


def _fn_consts(fn) -> dict[str, str]:
    """String constants visible in a function scope: plain literal
    assignments, *default parameter values* (the ``path="oryx.
    resilience.retry"`` idiom), and — to a fixpoint — f-strings built
    from already-resolved constants (``m = f"{r}.mirror"``)."""
    out: dict[str, str] = {}
    a = fn.args
    pos = a.posonlyargs + a.args
    for arg, default in zip(pos[len(pos) - len(a.defaults):],
                            a.defaults):
        if isinstance(default, ast.Constant) and \
                isinstance(default.value, str):
            out[arg.arg] = default.value
    for arg, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None and isinstance(default, ast.Constant) \
                and isinstance(default.value, str):
            out[arg.arg] = default.value
    assigns = [
        (node.targets[0].id, node.value)
        for node in ast.walk(fn)
        if isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)]
    for _ in range(4):  # chained f-strings resolve in a few rounds
        changed = False
        for name, value in assigns:
            got = _resolve_str(value, out)
            if got is not None and out.get(name) != got:
                out[name] = got
                changed = True
        if not changed:
            break
    return out


def _resolve_str(node: ast.expr, consts: dict[str, str]) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue) and \
                    isinstance(v.value, ast.Name):
                got = consts.get(v.value.id)
                if got is None:
                    return None
                parts.append(got)
            else:
                return None
        return "".join(parts)
    return None


def _collect_key_reads(mod: ModuleSource, reads: _KeyReads) -> None:
    # every function is a scope overlaying module-level constants
    # (nested functions see their enclosing function's constants via
    # _fn_consts walking the whole outer function — close enough)
    scopes: list[tuple[object, dict[str, str]]] = [
        (mod.tree, mod.module_consts)]
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append(
                (node, {**mod.module_consts, **_fn_consts(node)}))
    for scope, consts in scopes:
        for node in _walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in CONFIG_GETTERS
                    and node.args):
                got = _resolve_str(node.args[0], consts)
                if got is not None and got.startswith("oryx."):
                    reads.getter_reads.setdefault(
                        got, (mod.rel, node.lineno))
                elif isinstance(node.args[0], (ast.JoinedStr,
                                               ast.Name)):
                    reads.dynamic_reads += 1
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        _KEY_RE.match(arg.value):
                    reads.prefix_reads.add(arg.value)


def _walk_scope(scope):
    """Walk one scope without descending into nested function
    definitions (each is visited as its own scope)."""
    stack = list(scope.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                stack.append(child)


# -- chaos surface ----------------------------------------------------------

def _collect_fire_points(mod: ModuleSource,
                         points: dict[str, tuple[str, int]]) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            dotted = mod.dotted_call_name(node.func)
            if dotted in FIRE_FUNCTIONS and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                points.setdefault(node.args[0].value,
                                  (mod.rel, node.lineno))
    for i, comment in sorted(mod.comments.items()):
        if comment.startswith("chaos-point:"):
            name = comment[len("chaos-point:"):].split("—")[0] \
                .split(" - ")[0].strip()
            if name:
                points.setdefault(name, (mod.rel, i))


def _doc_points(doc_path: pathlib.Path) -> dict[str, int]:
    out: dict[str, int] = {}
    for i, line in enumerate(
            doc_path.read_text(encoding="utf-8").splitlines(), 1):
        if not line.startswith("|"):
            continue
        first = line.split("|")[1].strip()
        m = re.fullmatch(r"`([^`]+)`", first)
        if m and _POINT_RE.match(m.group(1)):
            out.setdefault(m.group(1), i)
    return out


# -- the pass ---------------------------------------------------------------

def run(model: SourceModel) -> list[Finding]:
    findings: list[Finding] = []
    reads = _KeyReads()
    points: dict[str, tuple[str, int]] = {}
    for mod in model.modules:
        _collect_key_reads(mod, reads)
        _collect_fire_points(mod, points)

    if model.conf_path is not None and model.conf_path.is_file():
        conf_rel = model.display_path(model.conf_path)
        leaves, every = _conf_paths(model.conf_path)
        lines, compat = _conf_line_index(model.conf_path)
        for key, (file, line) in sorted(reads.getter_reads.items()):
            if key not in every and key not in leaves:
                findings.append(Finding(
                    PASS, "unknown-config-key", file, line, key,
                    f"code reads config key {key!r} which does not "
                    f"exist in {conf_rel} — add it with a default "
                    f"and a comment, or fix the key"))
        covered = set(reads.getter_reads) | reads.prefix_reads \
            | set(compat)
        for leaf in sorted(leaves):
            if leaf in covered:
                continue
            if any(leaf.startswith(p + ".") for p in covered):
                continue
            findings.append(Finding(
                PASS, "dead-config-key", conf_rel,
                lines.get(leaf, 0), leaf,
                f"config key {leaf!r} is declared in {conf_rel} but "
                f"never read by code — remove it, or annotate the "
                f"line with '# compat: <why>' if it is intentional "
                f"reference-parity surface"))
        reads_exact = set(reads.getter_reads) | reads.prefix_reads
        for path, why in sorted(compat.items()):
            if path in reads_exact:
                findings.append(Finding(
                    PASS, "stale-compat-annotation", conf_rel,
                    lines.get(path, 0), path,
                    f"config key {path!r} carries '# compat: {why}' "
                    f"but IS read by code — drop the annotation"))

    if model.doc_path is not None and model.doc_path.is_file():
        doc_rel = model.display_path(model.doc_path)
        documented = _doc_points(model.doc_path)
        for name, (file, line) in sorted(points.items()):
            if name not in documented:
                findings.append(Finding(
                    PASS, "undocumented-fault-point", file, line,
                    name,
                    f"chaos fault point {name!r} is fired in code "
                    f"but has no {doc_rel} injection-points row"))
        for name, line in sorted(documented.items()):
            if name not in points:
                findings.append(Finding(
                    PASS, "unregistered-fault-point", doc_rel, line,
                    name,
                    f"{doc_rel} documents fault point {name!r} but "
                    f"no code fires it — stale row"))
    return findings
