"""async-blocking — event-loop blocking-call lint.

Inside any ``async def`` in the scanned tree — and, transitively, any
same-module sync function or method it calls directly — flag:

- ``time.sleep`` (the canonical sin);
- ``subprocess.*`` and blocking ``socket.*`` constructors/resolvers;
- builtin ``open()`` (file I/O on the loop);
- un-awaited ``.acquire()`` without ``blocking=False`` and un-awaited
  ``.wait()`` / ``.join()`` on threading primitives;
- calls resolving into the module deny-list (``DENY_CALLS``) or whose
  attribute name is in ``DENY_ATTRS`` — known-blocking framework
  entry points (the scatter fan-out, the threaded dispatcher);

unless the call is *wrapped*: passed as an argument to
``run_in_executor`` / ``asyncio.to_thread`` / an executor ``submit``
/ loop ``call_soon*``/``call_later`` — those run off-loop (or merely
schedule), which is exactly the bridge discipline
``cluster/async_http.py`` documents.

The walk is lexical + one level of same-module call resolution
(``self.helper()`` and module functions), so a blocking call hidden
in the sync helper an ``async def`` shares with the threaded path is
still caught; cross-module calls are covered by the deny-list, not
followed.
"""

from __future__ import annotations

import ast

from .core import Finding, ModuleSource, SourceModel

__all__ = ["run", "DENY_CALLS", "DENY_ATTRS"]

PASS = "async-blocking"

# dotted call names (resolved through import aliases) that block
DENY_CALLS = {
    "time.sleep": "sleeps the event loop",
    "oryx_tpu_torch.resilience.faults.fire":
        "fault seams may sleep (mode=delay) or raise on the loop",
}
# blocking call prefixes: any call into these modules
DENY_PREFIXES = {
    "subprocess.": "spawns and waits on a child process",
    "socket.": "blocking socket construction/resolution",
}
# attribute-call names that are blocking framework entry points no
# matter the receiver (method calls cannot be resolved statically)
DENY_ATTRS = {
    "scatter": "the shard fan-out blocks on worker-pool futures",
    "handle": "the full threaded dispatcher (bridge it instead)",
}
# loop/executor wrappers: call arguments are NOT on-loop work
WRAPPERS = {"run_in_executor", "to_thread", "submit",
            "call_soon", "call_soon_threadsafe", "call_later",
            "run_coroutine_threadsafe", "add_done_callback"}
# un-awaited sync-primitive calls
SYNC_PRIMS = {"acquire", "wait", "join"}


def _index_module(mod: ModuleSource):
    """(classname|None, funcname) -> FunctionDef for same-module call
    resolution."""
    table = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            table[(None, node.name)] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    table[(node.name, sub.name)] = sub
    return table


def _receiver_attr_chain(func: ast.expr) -> tuple[str | None, str | None]:
    """For ``a.b.c(...)`` returns (root name or None, final attr)."""
    if not isinstance(func, ast.Attribute):
        return None, None
    attr = func.attr
    node = func.value
    while isinstance(node, ast.Attribute):
        node = node.value
    root = node.id if isinstance(node, ast.Name) else None
    return root, attr


def _check_call(node: ast.Call, mod: ModuleSource, entry: str,
                awaited: bool, findings: list[Finding]) -> None:
    dotted = mod.dotted_call_name(node.func)
    where = f"(reachable from async {entry})"
    if dotted:
        if dotted in DENY_CALLS:
            findings.append(Finding(
                PASS, "blocking-call", mod.rel, node.lineno, dotted,
                f"{dotted} on the event loop — "
                f"{DENY_CALLS[dotted]} {where}"))
            return
        for prefix, why in DENY_PREFIXES.items():
            if dotted.startswith(prefix):
                findings.append(Finding(
                    PASS, "blocking-call", mod.rel, node.lineno,
                    dotted,
                    f"{dotted} on the event loop — {why} {where}"))
                return
        if dotted == "open":
            findings.append(Finding(
                PASS, "blocking-call", mod.rel, node.lineno, "open",
                f"builtin open() on the event loop — blocking file "
                f"I/O {where}"))
            return
    root, attr = _receiver_attr_chain(node.func)
    if attr in DENY_ATTRS:
        symbol = f".{attr}"
        findings.append(Finding(
            PASS, "blocking-call", mod.rel, node.lineno, symbol,
            f"call to blocking entry point .{attr}() on the event "
            f"loop — {DENY_ATTRS[attr]} {where}"))
        return
    if attr in SYNC_PRIMS and not awaited:
        if attr == "join":
            # distinguish Thread.join()/Thread.join(timeout) from the
            # ubiquitous str.join(iterable): a numeric-or-no-argument
            # join on a non-literal receiver is the thread form
            receiver = node.func.value
            str_literal = (isinstance(receiver, ast.Constant)
                           and isinstance(receiver.value, str))
            numericish = (not node.args or
                          (len(node.args) == 1
                           and isinstance(node.args[0], ast.Constant)
                           and isinstance(node.args[0].value,
                                          (int, float))))
            if str_literal or not numericish:
                return
        if attr == "acquire":
            nonblocking = any(
                kw.arg == "blocking"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in node.keywords) or (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value is False)
            if nonblocking:
                return
        findings.append(Finding(
            PASS, "sync-primitive", mod.rel, node.lineno,
            f".{attr}",
            f"un-awaited .{attr}() on the event loop — a threading "
            f"primitive here parks the whole loop, not one request "
            f"{where}"))


def _walk_on_loop(node, mod: ModuleSource, entry: str,
                  table, visited: set, findings: list[Finding],
                  awaited: bool = False) -> None:
    if isinstance(node, ast.Await):
        _walk_on_loop(node.value, mod, entry, table, visited,
                      findings, awaited=True)
        return
    if isinstance(node, ast.Call):
        _check_call(node, mod, entry, awaited, findings)
        # wrapped arguments run off-loop (or are merely scheduled)
        _, attr = _receiver_attr_chain(node.func)
        skip_args = attr in WRAPPERS or (
            isinstance(node.func, ast.Name)
            and node.func.id in WRAPPERS)
        _walk_on_loop(node.func, mod, entry, table, visited, findings)
        if not skip_args:
            for arg in node.args:
                _walk_on_loop(arg, mod, entry, table, visited,
                              findings)
            for kw in node.keywords:
                _walk_on_loop(kw.value, mod, entry, table, visited,
                              findings)
        # same-module resolution: self.helper() and module functions
        callee = None
        root, cattr = _receiver_attr_chain(node.func)
        if root == "self" and isinstance(node.func.value, ast.Name):
            callee = table.get((entry_class(entry), cattr))
        elif isinstance(node.func, ast.Name):
            callee = table.get((None, node.func.id))
        if callee is not None and not isinstance(
                callee, ast.AsyncFunctionDef) and \
                id(callee) not in visited:
            visited.add(id(callee))
            for stmt in callee.body:
                _walk_on_loop(stmt, mod, entry, table, visited,
                              findings)
        return
    for child in ast.iter_child_nodes(node):
        _walk_on_loop(child, mod, entry, table, visited, findings)


def entry_class(entry: str) -> str | None:
    return entry.split(".", 1)[0] if "." in entry else None


def run(model: SourceModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        table = _index_module(mod)
        for (cls, name), fn in table.items():
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            entry = f"{cls}.{name}" if cls else name
            visited: set = {id(fn)}
            for stmt in fn.body:
                _walk_on_loop(stmt, mod, entry, table, visited,
                              findings)
    return findings
