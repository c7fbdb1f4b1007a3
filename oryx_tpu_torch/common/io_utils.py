"""Filesystem helpers.

Counterpart of ``oryx_tpu/common/io_utils.py`` (reference:
IOUtils.java), cut down to what the local artifact store uses.  Paths
may carry a ``file:`` scheme.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import os
import shutil

__all__ = ["strip_scheme", "list_files", "mkdirs", "delete_recursively"]


def strip_scheme(path: str) -> str:
    """``file:/tmp/x`` or ``file:///tmp/x`` -> ``/tmp/x``; other schemes
    kept."""
    if path.startswith("file://"):
        rest = path[len("file://"):]
        return rest if rest.startswith("/") else "/" + rest
    if path.startswith("file:"):
        return path[len("file:"):]
    return path


def list_files(dir_path: str, pattern: str = "*") -> list[str]:
    """Sorted glob under a directory (reference: IOUtils.listFiles)."""
    return sorted(_glob.glob(os.path.join(strip_scheme(dir_path), pattern)))


def mkdirs(path: str) -> str:
    path = strip_scheme(path)
    os.makedirs(path, exist_ok=True)
    return path


def delete_recursively(path: str) -> None:
    path = strip_scheme(path)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)
