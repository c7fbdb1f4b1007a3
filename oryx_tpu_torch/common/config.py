"""Configuration access — ConfigUtils parity on a plain-dict HOCON model.

Counterpart of ``oryx_tpu/common/config.py`` (reference:
ConfigUtils.java: overlayOn :69, typed optional getters), cut down to
the typed getters, the loaders and ``to_properties``
(ConfigToProperties.java:29).  The packaged defaults are this
package's own copy of the reference's ``reference.conf``.
"""

from __future__ import annotations

import json
import os
from typing import Any

from . import hocon

__all__ = ["Config", "get_default", "overlay_on", "from_file", "from_dict",
           "refuse_configured"]

_DEFAULTS_PATH = os.path.join(os.path.dirname(__file__), "reference.conf")
_default_config: "Config | None" = None


def _render_scalar(v: Any) -> str:
    """HOCON booleans render as true/false, not Python's True/False."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _load_raw_defaults() -> dict:
    with open(_DEFAULTS_PATH, encoding="utf-8") as f:
        return hocon.loads_raw(f.read())


class Config:
    """Immutable view over a resolved nested config dict with typed
    getters.  Getters raise ``KeyError`` for missing paths and
    ``TypeError`` for wrong types; ``get_optional_*`` return None for
    missing or null."""

    def __init__(self, root: dict):
        self._root = root

    def get(self, path: str) -> Any:
        return hocon.lookup(self._root, path)

    def as_dict(self) -> dict:
        """Deep copy of the config tree."""
        return hocon._copy_tree(self._root)

    def get_string(self, path: str) -> str:
        v = self.get(path)
        if v is None or isinstance(v, (dict, list)):
            raise TypeError(f"{path}: expected string, got {v!r}")
        return _render_scalar(v)

    def get_int(self, path: str) -> int:
        v = self.get(path)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise TypeError(f"{path}: expected int, got {v!r}")
        return int(v)

    def get_double(self, path: str) -> float:
        v = self.get(path)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise TypeError(f"{path}: expected double, got {v!r}")
        return float(v)

    def get_bool(self, path: str) -> bool:
        v = self.get(path)
        if not isinstance(v, bool):
            raise TypeError(f"{path}: expected boolean, got {v!r}")
        return v

    def get_string_list(self, path: str) -> list[str]:
        v = self.get(path)
        if not isinstance(v, list):
            raise TypeError(f"{path}: expected list, got {v!r}")
        return [str(x) for x in v]

    def _optional(self, path: str, getter) -> Any:
        try:
            if self.get(path) is None:
                return None
        except KeyError:
            return None
        return getter(path)

    def get_optional_string(self, path: str) -> str | None:
        return self._optional(path, self.get_string)

    def get_optional_double(self, path: str) -> float | None:
        return self._optional(path, self.get_double)

    def get_optional_string_list(self, path: str) -> list[str] | None:
        """The list at ``path``; a single value stands for a one-element
        list (as the reference reads ``input-schema.numeric-features``)."""
        v = self._optional(path, self.get)
        if v is None:
            return None
        if isinstance(v, list):
            return [str(x) for x in v]
        return [str(v)]

    def to_properties(self, prefix: str = "") -> dict[str, str]:
        """Flatten to dotted key -> string value pairs, nulls left out
        and lists as JSON (reference: ConfigToProperties.java:29)."""
        out: dict[str, str] = {}

        def _walk(node: Any, path: str) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    _walk(v, f"{path}.{k}" if path else k)
            elif node is not None:
                out[path] = (json.dumps(node) if isinstance(node, list)
                             else _render_scalar(node))

        _walk(self._root, prefix)
        return out

    def __repr__(self):  # pragma: no cover
        return f"Config({sorted(self._root)})"


def get_default() -> Config:
    """The packaged defaults, overlaid with ``$ORYX_CONF_FILE`` if set
    (reference: deploy/bin/oryx-run.sh:87)."""
    global _default_config
    if _default_config is None:
        root = _load_raw_defaults()
        conf_file = os.environ.get("ORYX_CONF_FILE")
        if conf_file:
            with open(conf_file, encoding="utf-8") as f:
                root = hocon.merge(root, hocon.loads_raw(f.read()))
        _default_config = Config(hocon.resolve(root))
    return _default_config


def from_file(path: str) -> Config:
    """A user config file overlaid on the packaged defaults;
    substitutions resolve against the merged document, so a user file
    may reference base keys."""
    root = _load_raw_defaults()
    with open(path, encoding="utf-8") as f:
        merged = hocon.merge(root, hocon.loads_raw(f.read()))
    return Config(hocon.resolve(merged))


def from_dict(overlay: dict, base: Config | None = None) -> Config:
    """Overlay a nested or dotted-key dict on a base config."""
    return overlay_on(overlay, base if base is not None else get_default())


def overlay_on(overlay: dict | str, base: Config) -> Config:
    """ConfigUtils.overlayOn parity (reference: ConfigUtils.java:69):
    ``overlay`` is HOCON text, or a dict whose keys may be dotted
    paths."""
    if isinstance(overlay, str):
        root = hocon.loads_raw(overlay)
    else:
        root = {}
        for k, v in overlay.items():
            cur = root
            parts = k.split(".")
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = v
    return Config(hocon.resolve(hocon.merge(base._root, root)))


def refuse_configured(config: Config, paths, why: str) -> None:
    """Raise ``ValueError`` naming the first of ``paths`` that is set
    (neither missing, null nor false): a key of a feature this package
    does not have yet must not be quietly ignored."""
    for path in paths:
        try:
            v = config.get(path)
        except KeyError:
            continue
        if v is not None and v is not False:
            raise ValueError(f"{path}: {why}")
