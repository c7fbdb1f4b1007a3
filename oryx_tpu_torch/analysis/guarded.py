"""guarded-by — shared-state race detector.

For every class that owns a lock, each ``self._x`` attribute is either
*guarded* or not:

- **declared**: the ``__init__`` assignment carries a trailing
  ``# guarded-by: _lock`` annotation (``# guarded-by: none`` opts an
  attribute out of inference — document why in the comment);
- **inferred**: the attribute is ever mutated inside a
  ``with self._lock:`` block outside ``__init__`` — if one mutation
  site needed the lock, they all do.

Every mutation (assignment, ``del``, subscript store, augmented
read-modify-write, or a mutating method call like ``.append``/
``.pop``/``.update``) of a guarded attribute must then be lexically
inside a ``with`` on a guarding lock, in ``__init__`` (construction
happens-before publication), or in a ``*_locked``-suffix method (the
caller-holds-the-lock convention).  Anything else is the torn-write /
lost-update class the torn topology snapshot belonged to.

Plain reads are NOT flagged — the annotation grammar deliberately
covers writes and compound read-modify-writes only, where lockless
access is wrong regardless of memory model.
"""

from __future__ import annotations

import ast

from .core import Finding, ModuleSource, SourceModel
from .locks import ClassLockInfo, class_locks, iter_methods, \
    with_item_self_attr

__all__ = ["run", "MUTATOR_METHODS"]

PASS = "guarded-by"

# method names that mutate their receiver in place (list/dict/set/deque
# surface used across the codebase)
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "update", "pop", "popleft",
    "popitem", "extend", "extendleft", "remove", "discard", "clear",
    "insert", "setdefault", "sort", "reverse"})


def _self_attr(node: ast.expr) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _parse_declarations(cls: ast.ClassDef, mod: ModuleSource,
                        findings: list[Finding],
                        locks: ClassLockInfo) -> dict[str, str]:
    """``self._x = ...  # guarded-by: _lock`` trailing annotations
    anywhere in the class -> {attr: lockname | "none"}."""
    decls: dict[str, str] = {}
    for meth in iter_methods(cls):
        for node in ast.walk(meth):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            attrs = [a for a in map(_self_attr, targets)
                     if a is not None]
            if not attrs:
                continue
            comment = mod.trailing_comment(node.lineno)
            if not comment.startswith("guarded-by:"):
                continue
            lock = comment[len("guarded-by:"):].split("—")[0] \
                .split(" - ")[0].strip()
            for attr in attrs:
                decls[attr] = lock
                if lock != "none" and lock not in locks.kinds:
                    findings.append(Finding(
                        PASS, "unknown-guard", mod.rel, node.lineno,
                        f"{cls.name}.{attr}",
                        f"annotation names lock {lock!r} but class "
                        f"{cls.name} has no such lock attribute"))
    return decls


class _Mutation:
    __slots__ = ("attr", "method", "line", "held", "kind")

    def __init__(self, attr, method, line, held, kind):
        self.attr = attr
        self.method = method
        self.line = line
        self.held = held      # frozenset of lock attrs held lexically
        self.kind = kind      # assign | augassign | delete | call


def _collect_mutations(meth, locks: ClassLockInfo) -> list[_Mutation]:
    out: list[_Mutation] = []

    def mutated_attr_of_target(t: ast.expr) -> str | None:
        # self._x = ... / self._x[k] = ... (the store mutates _x)
        attr = _self_attr(t)
        if attr is not None:
            return attr
        if isinstance(t, ast.Subscript):
            return _self_attr(t.value)
        return None

    def walk(node, held: frozenset):
        if isinstance(node, ast.With):
            acquired = set()
            for item in node.items:
                attr = with_item_self_attr(item)
                if attr is not None and attr in locks.kinds:
                    acquired |= locks.held_set(attr)
            inner = held | acquired
            for child in node.body:
                walk(child, frozenset(inner))
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if isinstance(node, ast.AnnAssign) and node.value is None:
                return  # bare `self._x: T` annotation — not a store
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            kind = "augassign" if isinstance(node, ast.AugAssign) \
                else "assign"
            for t in targets:
                attr = mutated_attr_of_target(t)
                if attr is not None:
                    out.append(_Mutation(attr, meth.name, t.lineno,
                                         held, kind))
            walk_children(node, held)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                attr = mutated_attr_of_target(t)
                if attr is not None:
                    out.append(_Mutation(attr, meth.name, t.lineno,
                                         held, "delete"))
            return
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                out.append(_Mutation(attr, meth.name, node.lineno,
                                     held, "call"))
            walk_children(node, held)
            return
        walk_children(node, held)

    def walk_children(node, held):
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in meth.body:
        walk(stmt, frozenset())
    return out


def _analyze_class(cls: ast.ClassDef, mod: ModuleSource,
                   findings: list[Finding]) -> None:
    locks = class_locks(cls, mod)
    if not locks.kinds:
        return
    decls = _parse_declarations(cls, mod, findings, locks)
    mutations: list[_Mutation] = []
    for meth in iter_methods(cls):
        mutations.extend(_collect_mutations(meth, locks))

    guards: dict[str, set[str]] = {}
    for attr, lock in decls.items():
        if lock != "none" and lock in locks.kinds:
            guards.setdefault(attr, set()).update(
                locks.held_set(lock))
    for m in mutations:
        if (m.method != "__init__" and m.held
                and decls.get(m.attr) != "none"
                and m.attr not in locks.kinds):
            guards.setdefault(m.attr, set()).update(m.held)

    for m in mutations:
        guard = guards.get(m.attr)
        if not guard:
            continue
        if m.method == "__init__" or m.method.endswith("_locked"):
            continue
        if m.held & guard:
            continue
        lock_names = "/".join(sorted(guard))
        findings.append(Finding(
            PASS, "unguarded-mutation", mod.rel, m.line,
            f"{cls.name}.{m.attr}",
            f"{m.kind} of {cls.name}.{m.attr} in {m.method}() without "
            f"holding {lock_names} (attribute is guarded — other "
            f"mutation sites hold it, or a # guarded-by: annotation "
            f"declares it)"))


def run(model: SourceModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                _analyze_class(node, mod, findings)
    return findings
