"""The scheme-routed artifact store behind ``data-dir``, ``model-dir``
and the ``MODEL-REF`` convention.

Counterpart of ``oryx_tpu/common/store.py`` (reference: the batch layer
reads and writes a shared filesystem so that trainer and serving can
live on different hosts — SaveToHDFSFunction.java:35-86,
BatchUpdateFunction.java:103-130, MLUpdate.java:233-237, and
AppPMMLUtils.readPMMLFromUpdateKeyMessage :259).  Roles are routed by
URI scheme:

- ``file://`` or a bare path: ``os`` and ``glob`` directly, publish by
  ``os.replace``.
- any other scheme (``memory://``, ``gs://``, ``s3://`` ...): fsspec,
  imported only when such a URI is used.  ``memory://`` is fsspec's
  in-process filesystem, the remote-store fake of the tests; ``gs://``
  and ``s3://`` work where their fsspec drivers are installed.  Without
  fsspec such a URI raises ``ImportError`` naming it, never falling
  back to a local path.

Every function takes full URIs, so a ``MODEL-REF`` carries its scheme
end to end and a serving process resolves it knowing nothing of the
trainer's configuration.
"""

from __future__ import annotations

import contextlib
import os
from typing import IO

from . import io_utils
from .io_utils import strip_scheme
from ..resilience.faults import fire as _fault
from ..resilience.policy import Backoff, Retry

# a transient filesystem or object-store failure on a publish's rename
# must not cost a trained generation: the rename retries briefly.
# Deterministic outcomes (bad path, permissions) surface at once
_DETERMINISTIC_OS_ERRORS = (FileNotFoundError, PermissionError,
                            NotADirectoryError, IsADirectoryError)
_io_retry = Retry(
    "store-io",
    retryable=lambda e: (isinstance(e, OSError)
                         and not isinstance(e, _DETERMINISTIC_OS_ERRORS)),
    max_attempts=3, backoff=Backoff(initial=0.02, maximum=0.2))

__all__ = ["is_local", "open_read", "open_write", "exists", "getsize",
           "glob", "mkdirs", "join", "delete_recursively", "rename"]


def _scheme(uri: str) -> str | None:
    """The non-file scheme of a URI, or None for a local path (a bare
    path, or ``file:`` in any spelling)."""
    i = uri.find("://")
    if i <= 0:
        return None
    scheme = uri[:i]
    return None if scheme == "file" else scheme


def is_local(uri: str) -> bool:
    return _scheme(uri) is None


def _fsspec(uri: str):
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"{uri}: the {_scheme(uri)}:// store needs the fsspec "
            f"package, which is not installed") from e
    return fsspec


def _fs(uri: str):
    """(fsspec filesystem, bare path) of a remote URI."""
    return _fsspec(uri).core.url_to_fs(uri)


def _requote(uri: str, bare_path: str) -> str:
    """The URI's scheme put back on a bare fs path, so that listings
    keep their addressable form."""
    return f"{_scheme(uri)}://{bare_path.lstrip('/')}" \
        if _scheme(uri) else bare_path


def join(base: str, *parts: str) -> str:
    """URI-preserving path join (every scheme uses / separators)."""
    out = base.rstrip("/")
    for p in parts:
        out += "/" + str(p).strip("/")
    return out


def open_read(uri: str, mode: str = "rb") -> IO:
    if is_local(uri):
        return open(strip_scheme(uri), mode)
    return _fsspec(uri).open(uri, mode).open()


def open_write(uri: str, mode: str = "wb") -> IO:
    # chaos seam: transient write failure (full disk, flaky mount)
    _fault("store-write", error=lambda: OSError(
        f"injected write failure for {uri}"))
    if is_local(uri):
        path = strip_scheme(uri)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, mode)
    return _fsspec(uri).open(uri, mode).open()


def exists(uri: str) -> bool:
    if is_local(uri):
        return os.path.exists(strip_scheme(uri))
    fs, path = _fs(uri)
    return fs.exists(path)


def getsize(uri: str) -> int:
    if is_local(uri):
        return os.path.getsize(strip_scheme(uri))
    fs, path = _fs(uri)
    return fs.size(path)


def glob(dir_uri: str, pattern: str = "*") -> list[str]:
    """Sorted entries under a directory matching a glob pattern, in the
    directory's own URI form."""
    if is_local(dir_uri):
        return io_utils.list_files(dir_uri, pattern)
    fs, path = _fs(dir_uri)
    return sorted(_requote(dir_uri, p)
                  for p in fs.glob(path.rstrip("/") + "/" + pattern))


def mkdirs(uri: str) -> str:
    """Ensure the directory exists; returns the bare path of a local
    one, else the URI."""
    if is_local(uri):
        return io_utils.mkdirs(uri)
    fs, path = _fs(uri)
    fs.makedirs(path, exist_ok=True)
    return uri


def delete_recursively(uri: str) -> None:
    if is_local(uri):
        io_utils.delete_recursively(uri)
        return
    fs, path = _fs(uri)
    if fs.exists(path):
        with contextlib.suppress(FileNotFoundError):
            fs.rm(path, recursive=True)


def rename(src_uri: str, dst_uri: str) -> None:
    """Publish by rename (reference: MLUpdate.java:205-211 renames the
    winning candidate into model-dir).  Atomic on POSIX; on an object
    store fsspec's move is copy then delete, and readers learn the path
    from the update topic only after it completes."""
    # one filesystem serves both ends: a cross-scheme rename would act
    # on the wrong store
    if _scheme(src_uri) != _scheme(dst_uri):
        raise ValueError(
            f"rename requires matching URI schemes: {src_uri} -> {dst_uri}")

    def _do() -> None:
        # chaos seam: transient rename failure on the publish edge
        _fault("store-rename", error=lambda: OSError(
            f"injected rename failure for {dst_uri}"))
        try:
            if is_local(src_uri):
                os.replace(strip_scheme(src_uri), strip_scheme(dst_uri))
                return
            fs, src = _fs(src_uri)
            _, dst = _fs(dst_uri)
            fs.mv(src, dst, recursive=True)
        except FileNotFoundError:
            # a retried rename whose earlier attempt completed (its ack,
            # not the move, was lost): src gone and dst present is the
            # published state
            if not exists(src_uri) and exists(dst_uri):
                return
            raise

    _io_retry.call(_do)
