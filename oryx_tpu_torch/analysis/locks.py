"""Shared lock model for the guarded-by and lock-order passes.

What counts as a lock:

- an attribute assigned ``threading.Lock()`` / ``RLock()`` /
  ``Condition()`` / ``Semaphore()`` anywhere in the class (resolved
  through import aliases, so ``from threading import Lock`` works);
- an attribute used as a bare context manager (``with self._x:``) —
  in this codebase a bare ``with`` on a self attribute is always a
  lock, and this catches locks injected through ``__init__``
  parameters;
- ``threading.Condition(self._x)`` aliases the condition attribute to
  its underlying lock: holding either is holding both.

A method whose name ends in ``_locked`` is, by repo convention,
always called with the class's lock already held (see
``membership._ranked_locked``); both passes honor it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import ModuleSource

__all__ = ["ClassLockInfo", "class_locks", "module_locks",
           "with_item_self_attr", "iter_methods", "LOCK_FACTORIES"]

LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
}


@dataclass
class ClassLockInfo:
    """Per-class lock surface: attr -> kind, plus condition->lock
    aliases (both directions)."""

    kinds: dict[str, str] = field(default_factory=dict)
    aliases: dict[str, set[str]] = field(default_factory=dict)

    def held_set(self, attr: str) -> set[str]:
        """Holding ``attr`` means holding it plus everything aliased
        to it (a Condition and its wrapped lock)."""
        return {attr} | self.aliases.get(attr, set())

    def reentrant(self, attr: str) -> bool:
        return self.kinds.get(attr) == "rlock"


def _self_attr(node: ast.expr) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def with_item_self_attr(item: ast.withitem) -> str | None:
    """``with self._x:`` -> ``_x`` (bare attribute only — a call like
    ``with self.tracer.span(...)`` is not a lock acquisition)."""
    return _self_attr(item.context_expr)


def iter_methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def class_locks(cls: ast.ClassDef, mod: ModuleSource) -> ClassLockInfo:
    info = ClassLockInfo()
    for meth in iter_methods(cls):
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                attr = _self_attr(target)
                if attr is None:
                    continue
                value = node.value
                if isinstance(value, ast.Call):
                    dotted = mod.dotted_call_name(value.func)
                    kind = LOCK_FACTORIES.get(dotted or "")
                    if kind:
                        info.kinds[attr] = kind
                        if kind == "condition" and value.args:
                            under = _self_attr(value.args[0])
                            if under is not None:
                                info.aliases.setdefault(
                                    attr, set()).add(under)
                                info.aliases.setdefault(
                                    under, set()).add(attr)
    # bare `with self._x:` usage marks _x as a lock even when it was
    # injected rather than constructed here
    for meth in iter_methods(cls):
        for node in ast.walk(meth):
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = with_item_self_attr(item)
                    if attr is not None and attr not in info.kinds:
                        info.kinds[attr] = "lock"
    return info


def module_locks(mod: ModuleSource) -> dict[str, str]:
    """Module-level ``NAME = threading.Lock()`` style globals ->
    kind."""
    out: dict[str, str] = {}
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            dotted = mod.dotted_call_name(node.value.func)
            kind = LOCK_FACTORIES.get(dotted or "")
            if kind:
                out[node.targets[0].id] = kind
    return out
