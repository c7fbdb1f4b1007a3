"""The kernel library cache shared by every layer.

Counterpart of ``oryx_tpu/common/compile_cache.py``.  The reference
points JAX's persistent compilation cache at ``oryx.compile-cache-dir``
so that XLA compiles each (program, shape) once per machine.  Here the
cost of a first start is ``nvcc``: one build per kernel source
(``ops/cuda_build``).  With ``oryx.compile-cache-dir`` set (the
default), every layer and the ``warmup`` command build and load the
libraries in ``<dir>/kernels``, so a restarted layer, a redeploy or a
recovery loads them from disk.

The directory is set process-wide the first time any layer starts; the
first configuration wins, and later layers in the same process inherit
it.  ``oryx.compile-cache-min-compile-secs`` has no counterpart: every
``nvcc`` output is kept, however quick its build.  The key stays
readable.
"""

from __future__ import annotations

import logging
import os
import threading

from ..ops import cuda_build

__all__ = ["enable_from_config"]

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_enabled_dir: str | None = None


def enable_from_config(config) -> str | None:
    """Build and load the kernel libraries in
    ``<oryx.compile-cache-dir>/kernels`` (no-op when the key is null).
    Returns the active cache directory, or None when disabled."""
    global _enabled_dir
    path = config.get_optional_string("oryx.compile-cache-dir")
    if path is None:
        return None
    with _lock:
        if _enabled_dir is not None:
            if _enabled_dir != path:
                _log.warning(
                    "compile cache already enabled at %s; ignoring %s "
                    "(one process-wide cache)", _enabled_dir, path)
            return _enabled_dir
        cuda_build.set_build_dir(os.path.join(path, "kernels"))
        _enabled_dir = path
        _log.info("kernel library cache at %s", path)
        return path
