"""Minimal HOCON parser — the subset of Typesafe Config the framework needs.

Counterpart of ``oryx_tpu/common/hocon.py``, copied whole, so a config
file resolves to the same tree in both packages.

The reference configures everything through Typesafe Config HOCON files
(reference: framework/oryx-common/src/main/resources/reference.conf and
app/conf/*.conf).  This is an independent implementation of the subset
those files use:

* ``#`` and ``//`` comments
* nested objects with ``key = { ... }`` or ``key { ... }``, dotted path
  keys (``a.b.c = v``), and object merging (later keys deep-merge)
* values: quoted/unquoted strings, ints, floats, booleans, ``null``,
  lists ``[v, v, ...]``
* substitutions ``${a.b.c}`` resolved against the whole document
* overlay semantics (ConfigUtils.overlayOn parity: an overlay document
  deep-merges over a base)

Not supported (unused by the reference's conf files): includes,
+= appends, multi-line strings, durations/size units as typed values
(they parse as strings), concatenations beyond a single value per key.
"""

from __future__ import annotations

from typing import Any

__all__ = ["loads", "merge", "resolve", "HoconParseError"]


class HoconParseError(ValueError):
    pass


class _Subst:
    """Unresolved ``${path}`` substitution."""

    __slots__ = ("path", "optional")

    def __init__(self, path: str, optional: bool = False):
        self.path = path
        self.optional = optional

    def __repr__(self):  # pragma: no cover
        return f"${{{self.path}}}"


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # -- low-level ----------------------------------------------------------

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def _skip_ws(self, newlines: bool = True) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c.isspace() and (newlines or c not in "\r\n"):
                self.pos += 1
            else:
                break

    def _error(self, msg: str) -> HoconParseError:
        line = self.text.count("\n", 0, self.pos) + 1
        return HoconParseError(f"line {line}: {msg}")

    # -- grammar ------------------------------------------------------------

    def parse_document(self) -> dict:
        self._skip_ws()
        if self._peek() == "{":
            obj = self.parse_object()
        else:
            obj = self.parse_object_body(top_level=True)
        self._skip_ws()
        if self.pos != self.n:
            raise self._error(f"trailing content: {self.text[self.pos:self.pos+20]!r}")
        return obj

    def parse_object(self) -> dict:
        assert self._peek() == "{"
        self.pos += 1
        obj = self.parse_object_body(top_level=False)
        if self._peek() != "}":
            raise self._error("expected '}'")
        self.pos += 1
        return obj

    def parse_object_body(self, top_level: bool) -> dict:
        obj: dict = {}
        while True:
            self._skip_ws()
            c = self._peek()
            if not c:
                if top_level:
                    return obj
                raise self._error("unexpected end of input in object")
            if c == "}":
                if top_level:
                    raise self._error("unexpected '}'")
                return obj
            if c == ",":
                self.pos += 1
                continue
            key = self.parse_key()
            self._skip_ws(newlines=False)
            c = self._peek()
            if c == "{":
                value = self.parse_object()
            elif c in "=:":
                self.pos += 1
                self._skip_ws(newlines=False)
                value = self.parse_value()
            else:
                raise self._error(f"expected '=', ':' or '{{' after key {key!r}")
            _assign_path(obj, key.split("."), value)

    def parse_key(self) -> str:
        self._skip_ws()
        if self._peek() == '"':
            return self.parse_quoted_string()
        start = self.pos
        while self.pos < self.n and (self.text[self.pos].isalnum()
                                     or self.text[self.pos] in "._-"):
            self.pos += 1
        if self.pos == start:
            raise self._error(f"expected key, got {self._peek()!r}")
        return self.text[start:self.pos]

    def parse_value(self) -> Any:
        c = self._peek()
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self.parse_list()
        if c == '"':
            return self.parse_quoted_string()
        if c == "$":
            return self.parse_substitution()
        return self.parse_unquoted()

    def parse_list(self) -> list:
        assert self._peek() == "["
        self.pos += 1
        items: list = []
        while True:
            self._skip_ws()
            c = self._peek()
            if not c:
                raise self._error("unexpected end of input in list")
            if c == "]":
                self.pos += 1
                return items
            if c == ",":
                self.pos += 1
                continue
            items.append(self.parse_value())

    def parse_quoted_string(self) -> str:
        assert self._peek() == '"'
        self.pos += 1
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "\\" and self.pos + 1 < self.n:
                nxt = self.text[self.pos + 1]
                mapping = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/"}
                out.append(mapping.get(nxt, nxt))
                self.pos += 2
            elif c == '"':
                self.pos += 1
                return "".join(out)
            else:
                out.append(c)
                self.pos += 1
        raise self._error("unterminated string")

    def parse_substitution(self) -> _Subst:
        if not self.text.startswith("${", self.pos):
            raise self._error("expected '${'")
        self.pos += 2
        optional = self._peek() == "?"
        if optional:
            self.pos += 1
        end = self.text.find("}", self.pos)
        if end < 0:
            raise self._error("unterminated substitution")
        path = self.text[self.pos:end].strip()
        self.pos = end + 1
        return _Subst(path, optional)

    def parse_unquoted(self) -> Any:
        start = self.pos
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in "\r\n,}]#" or self.text.startswith("//", self.pos):
                break
            self.pos += 1
        raw = self.text[start:self.pos].strip()
        if not raw:
            raise self._error("expected a value")
        return _coerce_scalar(raw)


def _coerce_scalar(raw: str) -> Any:
    if raw == "null":
        return None
    if raw == "true":
        return True
    if raw == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _assign_path(obj: dict, path: list[str], value: Any) -> None:
    for part in path[:-1]:
        nxt = obj.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            obj[part] = nxt
        obj = nxt
    leaf = path[-1]
    if isinstance(value, dict) and isinstance(obj.get(leaf), dict):
        obj[leaf] = merge(obj[leaf], value)
    else:
        obj[leaf] = value


def _copy_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


def merge(base: dict, overlay: dict) -> dict:
    """Deep-merge ``overlay`` over ``base``; ConfigUtils.overlayOn parity
    (reference: framework/oryx-common/.../settings/ConfigUtils.java:69).

    The result shares no mutable structure with either input, so mutating
    a merged config can never corrupt the cached defaults.
    """
    out = _copy_tree(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _copy_tree(v)
    return out


def lookup(root: dict, path: str) -> Any:
    """Dotted-path lookup into a nested dict; KeyError on a missing path."""
    cur: Any = root
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(path)
        cur = cur[part]
    return cur


_lookup = lookup  # internal alias


def resolve(root: dict) -> dict:
    """Resolve all ``${path}`` substitutions against the document root."""

    def _res(node: Any, seen: tuple[str, ...]) -> Any:
        if isinstance(node, _Subst):
            if node.path in seen:
                raise HoconParseError(f"substitution cycle at ${{{node.path}}}")
            try:
                target = _lookup(root, node.path)
            except KeyError:
                if node.optional:
                    return None
                raise HoconParseError(f"unresolved substitution ${{{node.path}}}")
            return _res(target, seen + (node.path,))
        if isinstance(node, dict):
            return {k: _res(v, seen) for k, v in node.items()}
        if isinstance(node, list):
            return [_res(v, seen) for v in node]
        return node

    return _res(root, ())


def loads(text: str) -> dict:
    """Parse HOCON text into a plain nested dict (substitutions resolved)."""
    return resolve(_Parser(text).parse_document())


def loads_raw(text: str) -> dict:
    """Parse HOCON text WITHOUT resolving substitutions.

    Typesafe Config resolves substitutions only after all documents are
    merged, so an overlay file may reference keys defined in the base
    (e.g. ``config = ${oryx.default-streaming-config}``). Parse each
    document with this, merge, then call :func:`resolve` on the result.
    """
    return _Parser(text).parse_document()
