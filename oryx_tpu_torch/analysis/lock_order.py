"""lock-order — static acquired-while-holding cycle detector.

Builds a directed graph whose nodes are lock identities
(``module.Class._attr`` for instance locks, ``module.NAME`` for
module-level locks) and whose edges mean "acquired B while holding
A", from:

- nested ``with self._a: ... with self._b:`` blocks (including the
  multi-item ``with self._a, self._b:`` form, which orders left to
  right);
- calls made while holding a lock, resolved one module at a time:
  ``self.method()``, bare module functions, and ``module.func()``
  imports within the scanned tree — each callee contributes every
  lock it may transitively acquire;
- the ``*_locked`` convention: a ``_locked``-suffix method of a
  single-lock class is analyzed as if that lock were already held
  (that is what the suffix asserts about its callers).

Any strongly connected component — including a self-edge on a
non-reentrant lock, the ``obs/slo.py`` gauge-callback self-deadlock
class — is a finding.  A self-edge on an ``RLock`` is legal
reentrancy and ignored.

The graph is an over-approximation (a call made while holding a lock
*may* acquire, not *will*), so a reported cycle is a lock-discipline
smell even when the interleaving is currently unreachable; suppress
with a justification if so.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Finding, ModuleSource, SourceModel
from .locks import ClassLockInfo, class_locks, iter_methods, \
    module_locks, with_item_self_attr

__all__ = ["run"]

PASS = "lock-order"


@dataclass(frozen=True)
class LockId:
    module: str          # short module name, e.g. "membership"
    owner: str | None    # class name, or None for a module global
    attr: str

    def display(self) -> str:
        mid = f"{self.owner}." if self.owner else ""
        return f"{self.module}.{mid}{self.attr}"


@dataclass
class _FnInfo:
    node: ast.FunctionDef
    mod: ModuleSource
    cls: str | None
    locks: ClassLockInfo | None
    # (lock, held-frozenset, lineno) direct acquisitions
    acquires: list = field(default_factory=list)
    # (callee-key, held-frozenset, lineno) resolvable calls
    calls: list = field(default_factory=list)
    entry_held: frozenset = frozenset()


def _short(mod: ModuleSource) -> str:
    return mod.dotted.rsplit(".", 1)[-1]


def _index(model: SourceModel):
    fns: dict[tuple, _FnInfo] = {}
    mod_locks: dict[str, dict[str, str]] = {}
    for mod in model.modules:
        mod_locks[mod.dotted] = module_locks(mod)
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                fns[(mod.dotted, None, node.name)] = _FnInfo(
                    node, mod, None, None)
            elif isinstance(node, ast.ClassDef):
                locks = class_locks(node, mod)
                for meth in iter_methods(node):
                    fns[(mod.dotted, node.name, meth.name)] = _FnInfo(
                        meth, mod, node.name, locks)
    return fns, mod_locks


def _lock_of_withitem(item: ast.withitem, info: _FnInfo,
                      mod_locks) -> tuple[set[LockId], bool] | None:
    """The lock node(s) a with-item acquires, or None if it is not a
    recognizable lock.  Returns ({ids}, reentrant)."""
    attr = with_item_self_attr(item)
    short = _short(info.mod)
    if attr is not None and info.locks and attr in info.locks.kinds:
        ids = {LockId(short, info.cls, a)
               for a in info.locks.held_set(attr)}
        return ids, info.locks.reentrant(attr)
    ce = item.context_expr
    if isinstance(ce, ast.Name):
        kinds = mod_locks.get(info.mod.dotted, {})
        if ce.id in kinds:
            return {LockId(short, None, ce.id)}, kinds[ce.id] == "rlock"
    return None


def _resolve_call(node: ast.Call, info: _FnInfo, fns) -> tuple | None:
    func = node.func
    if isinstance(func, ast.Attribute) and \
            isinstance(func.value, ast.Name):
        if func.value.id == "self" and info.cls is not None:
            key = (info.mod.dotted, info.cls, func.attr)
            if key in fns:
                return key
        else:
            target = info.mod.aliases.get(func.value.id)
            if target is not None:
                key = (target, None, func.attr)
                if key in fns:
                    return key
    elif isinstance(func, ast.Name):
        target = info.mod.aliases.get(func.id, func.id)
        if "." in target:  # from mod import fn
            mod_name, fn_name = target.rsplit(".", 1)
            key = (mod_name, None, fn_name)
            if key in fns:
                return key
        key = (info.mod.dotted, None, func.id)
        if key in fns:
            return key
    return None


def _summarize(info: _FnInfo, fns, mod_locks) -> None:
    held0 = info.entry_held

    def walk(node, held: frozenset):
        if isinstance(node, ast.With):
            cur = held
            for item in node.items:
                got = _lock_of_withitem(item, info, mod_locks)
                if got is not None:
                    ids, reentrant = got
                    for lid in sorted(ids, key=LockId.display):
                        info.acquires.append(
                            (lid, cur, item.context_expr.lineno,
                             reentrant))
                    cur = cur | frozenset(ids)
            for child in node.body:
                walk(child, cur)
            return
        if isinstance(node, ast.Call):
            key = _resolve_call(node, info, fns)
            if key is not None:
                info.calls.append((key, held, node.lineno))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in info.node.body:
        walk(stmt, held0)


def _closures(fns) -> dict:
    """Transitive lock-acquisition closure per function, computed to a
    fixpoint over the whole call graph at once.  Mutual recursion
    (A calls B calls A) converges every member of the cycle to the
    full union — a mid-recursion memo would cache a truncated set for
    whichever member happened to be entered second, silently dropping
    edges for later callers."""
    memo = {key: {lid for lid, _, _, _ in info.acquires}
            for key, info in fns.items()}
    changed = True
    while changed:
        changed = False
        for key, info in fns.items():
            acc = memo[key]
            before = len(acc)
            for callee, _, _ in info.calls:
                acc |= memo[callee]
            if len(acc) != before:
                changed = True
    return memo


def build_graph(model: SourceModel) -> dict:
    """(held, acquired) -> (file, line, function) edge map — the
    pass's whole world view, exposed so the tier-1 test can pin that
    the walk still sees the codebase's real nesting edges."""
    fns, mod_locks = _index(model)
    # the _locked convention: analyzed as already holding the class's
    # single lock (ambiguous with several locks -> no assumption)
    for (mod_name, cls, name), info in fns.items():
        if cls and name.endswith("_locked") and info.locks:
            roots = [a for a, k in info.locks.kinds.items()
                     if k != "condition"] or list(info.locks.kinds)
            if len(roots) == 1:
                attr = roots[0]
                info.entry_held = frozenset(
                    LockId(_short(info.mod), cls, a)
                    for a in info.locks.held_set(attr))
    for info in fns.values():
        _summarize(info, fns, mod_locks)

    # edges: held -> acquired, with one representative site each
    edges: dict[tuple[LockId, LockId], tuple[str, int, str]] = {}
    closures = _closures(fns)
    for key, info in fns.items():
        fn_name = f"{key[1]}.{key[2]}" if key[1] else key[2]
        for lid, held, lineno, reentrant in info.acquires:
            for h in held:
                if h == lid and reentrant:
                    continue
                edges.setdefault(
                    (h, lid), (info.mod.rel, lineno, fn_name))
        for callee, held, lineno in info.calls:
            if not held:
                continue
            for lid in closures[callee]:
                for h in held:
                    if h == lid and _is_rlock(h, fns, mod_locks):
                        continue
                    edges.setdefault(
                        (h, lid), (info.mod.rel, lineno, fn_name))
    return edges


def run(model: SourceModel) -> list[Finding]:
    return _cycles_to_findings(build_graph(model))


def _is_rlock(lid: LockId, fns, mod_locks) -> bool:
    if lid.owner is None:
        for kinds in mod_locks.values():
            if kinds.get(lid.attr) == "rlock":
                return True
        return False
    for (_, cls, _), info in fns.items():
        if cls == lid.owner and info.locks:
            return info.locks.reentrant(lid.attr)
    return False


def _cycles_to_findings(edges) -> list[Finding]:
    graph: dict[LockId, set[LockId]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    sccs = _tarjan(graph)
    findings = []
    for scc in sccs:
        if len(scc) == 1:
            n = scc[0]
            if n not in graph.get(n, set()):
                continue
            cycle = [n, n]
        else:
            cycle = _cycle_path(scc, graph)
        names = [n.display() for n in cycle]
        # canonical rotation for a stable suppression symbol
        body = names[:-1]
        k = body.index(min(body))
        body = body[k:] + body[:k]
        symbol = " -> ".join(body + [body[0]])
        site_file, site_line, site_fn = edges[(cycle[0], cycle[1])]
        findings.append(Finding(
            PASS, "lock-cycle", site_file, site_line, symbol,
            f"lock-order cycle {symbol} (one edge acquired in "
            f"{site_fn}); two threads taking these locks in opposite "
            f"orders deadlock — or, for a self-cycle on a "
            f"non-reentrant lock, one thread deadlocks itself"))
    findings.sort(key=Finding.sort_key)
    return findings


def _cycle_path(scc, graph) -> list:
    scc_set = set(scc)
    start = sorted(scc, key=LockId.display)[0]
    path, seen = [start], {start}
    node = start
    while True:
        nxt = sorted((n for n in graph[node]
                      if n in scc_set), key=LockId.display)
        step = next((n for n in nxt if n == start or n not in seen),
                    nxt[0])
        path.append(step)
        if step == start:
            return path
        if step in seen:
            # trim to the loop we closed
            i = path.index(step)
            return path[i:]
        seen.add(step)
        node = step


def _tarjan(graph) -> list[list]:
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list[list] = []
    counter = [0]

    def strongconnect(v):
        # iterative Tarjan (the graph is tiny, but recursion depth is
        # unbounded in theory)
        work = [(v, iter(sorted(graph[v], key=LockId.display)))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append(
                        (w, iter(sorted(graph[w], key=LockId.display))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                out.append(scc)

    for v in sorted(graph, key=LockId.display):
        if v not in index:
            strongconnect(v)
    return out
