"""Text codecs for the framework's wire formats.

Counterpart of ``oryx_tpu/common/text.py`` (reference: TextUtils.java),
cut down to the forms the topics and the model documents use: JSON
arrays (``["X","userId",[0.1,...],["knownItem"]]``), PMML
space-delimited tokens, and the input topic's events, ``user,item,
strength,ts`` CSV or a JSON array (``parse_input_line``, with which
``/ingest`` validates its lines).
"""

from __future__ import annotations

import csv
import io
import json
import re
from typing import Any, Iterable, Sequence

__all__ = ["parse_delimited", "parse_pmml_delimited", "join_pmml_delimited",
           "join_pmml_delimited_numbers", "parse_json_array", "join_json", "read_json", "parse_input_line"]


def parse_delimited(line: str, delimiter: str = ",") -> list[str]:
    """Split one line of RFC-4180-style delimited text (quoted fields,
    doubled-quote escaping, plus backslash escape)."""
    reader = csv.reader(io.StringIO(line), delimiter=delimiter,
                        quotechar='"', doublequote=True, escapechar="\\")
    for row in reader:
        return row
    return [""]


def _render(e: Any) -> str:
    if isinstance(e, bool):
        return "true" if e else "false"
    if isinstance(e, float):
        return repr(e)
    return str(e)


def parse_pmml_delimited(line: str) -> list[str]:
    """PMML space-delimited values: quoted tokens may contain spaces and
    ``\\"``-escaped quotes; unquoted runs of spaces collapse
    (reference: TextUtils.parsePMMLDelimited)."""
    tokens: list[str] = []
    i, n = 0, len(line)
    while i < n:
        if line[i] == " ":
            i += 1
            continue
        if line[i] == '"':
            i += 1
            buf: list[str] = []
            while i < n:
                c = line[i]
                if c == "\\" and i + 1 < n and line[i + 1] == '"':
                    buf.append('"')
                    i += 2
                elif c == '"':
                    i += 1
                    break
                else:
                    buf.append(c)
                    i += 1
            tokens.append("".join(buf))
        else:
            j = line.find(" ", i)
            if j < 0:
                j = n
            tokens.append(line[i:j])
            i = j
    return tokens


def join_pmml_delimited(elements: Iterable[Any]) -> str:
    """Space-delimited with PMML quoting: tokens holding spaces or
    quotes (or empty ones) are quoted, with ``\\"`` escaping quotes
    inside (reference: TextUtils.joinPMMLDelimited)."""
    out = []
    for e in elements:
        tok = _render(e)
        if tok == "" or " " in tok or '"' in tok:
            tok = '"' + tok.replace('"', '\\"') + '"'
        out.append(tok)
    return " ".join(out)


def join_pmml_delimited_numbers(elements: Iterable[Any]) -> str:
    return " ".join(_render(e) for e in elements)


def parse_json_array(line: str) -> list:
    v = json.loads(line)
    if not isinstance(v, list):
        raise ValueError(f"not a JSON array: {line!r}")
    return v


def join_json(elements: Sequence[Any]) -> str:
    return json.dumps(list(elements), separators=(",", ":"))


def read_json(s: str) -> Any:
    return json.loads(s)


_JSON_START = re.compile(r"^\s*[\[{]")


def parse_input_line(line: str) -> list[str]:
    """Parse one input-topic event: JSON array if it looks like JSON,
    else CSV (reference: app/oryx-app-common/.../fn/MLFunctions.java:34-46
    PARSE_FN)."""
    if _JSON_START.match(line):
        # JSON null maps to the empty string, never the Python repr "None"
        return ["" if x is None else _render(x) for x in parse_json_array(line)]
    return parse_delimited(line)
