"""The artifact store behind ``model-dir`` and the ``MODEL-REF``
convention.

Counterpart of ``oryx_tpu/common/store.py``, cut down to its local
branch: bare paths and ``file://`` URIs.  The reference reaches remote
schemes (``gs://``, ``s3://``, ``memory://``) through fsspec; here such
a URI raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import IO

from . import io_utils
from .io_utils import strip_scheme
from ..resilience.faults import fire as _fault

__all__ = ["is_local", "open_read", "open_write", "exists", "getsize",
           "glob", "mkdirs", "join", "delete_recursively", "rename"]


def _scheme(uri: str) -> str | None:
    i = uri.find("://")
    if i <= 0:
        return None
    scheme = uri[:i]
    return None if scheme == "file" else scheme


def is_local(uri: str) -> bool:
    return _scheme(uri) is None


def _local(uri: str) -> str:
    if not is_local(uri):
        raise ValueError(
            f"{uri}: only local and file:// stores are part of this "
            f"package; the {_scheme(uri)}:// store is not in this slice")
    return strip_scheme(uri)


def join(base: str, *parts: str) -> str:
    """URI-preserving path join (every scheme uses / separators)."""
    out = base.rstrip("/")
    for p in parts:
        out += "/" + str(p).strip("/")
    return out


def open_read(uri: str, mode: str = "rb") -> IO:
    return open(_local(uri), mode)


def open_write(uri: str, mode: str = "wb") -> IO:
    # chaos seam: transient write failure (full disk, flaky mount)
    _fault("store-write", error=lambda: OSError(
        f"injected write failure for {uri}"))
    path = _local(uri)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, mode)


def exists(uri: str) -> bool:
    return os.path.exists(_local(uri))


def getsize(uri: str) -> int:
    return os.path.getsize(_local(uri))


def glob(dir_uri: str, pattern: str = "*") -> list[str]:
    """Sorted entries under a directory matching a glob pattern."""
    _local(dir_uri)
    return io_utils.list_files(dir_uri, pattern)


def mkdirs(uri: str) -> str:
    """Ensure the directory exists; returns the bare path."""
    _local(uri)
    return io_utils.mkdirs(uri)


def delete_recursively(uri: str) -> None:
    io_utils.delete_recursively(_local(uri))


def rename(src_uri: str, dst_uri: str) -> None:
    """Publish by rename (reference: MLUpdate.java:205-211 renames the
    winning candidate into model-dir); atomic on POSIX."""
    # chaos seam: transient rename failure on the publish edge
    _fault("store-rename", error=lambda: OSError(
        f"injected rename failure for {dst_uri}"))
    os.replace(_local(src_uri), _local(dst_uri))
