"""Build the package's CUDA sources into shared libraries with a plain C
interface, for ``ctypes``.

Each source compiles with ``nvcc`` for ``sm_90a`` (Hopper) under a name
keyed by a hash of the source, the headers beside it (``*.cuh``, which
the sources share) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Sources are built from the
checkout at first use; nothing prebuilt is shipped.

The libraries go to ``build/kernels/`` at the repository root unless
``set_build_dir`` names another directory (``common/compile_cache``
points it at ``<oryx.compile-cache-dir>/kernels``).  A build writes a
file of its own and renames it into place, so processes that build the
same source into one directory at once each leave a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build", "build_dir", "load",
           "library_path", "set_build_dir", "check_operand", "LOGS"]

# where libraries go when no directory was set
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# every kernel source of the package
SOURCES = tuple(sorted((Path(__file__).resolve().parents[1]
                        / "csrc").glob("*.cu")))
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_log = logging.getLogger(__name__)

# compiler output (registers, shared memory, spills) of the builds this
# process ran, by source file name
LOGS: dict[str, str] = {}
# loaded libraries by source: one source may serve several wrappers
_libs: dict[Path, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_build_dir = BUILD_DIR
# nvcc runs this process started, and the seconds of the build() calls
# that started any
NVCC_RUNS = 0
BUILD_S = 0.0
_stats_lock = threading.Lock()


def build_dir() -> Path:
    """The directory later builds and loads use."""
    return _build_dir


def set_build_dir(path) -> None:
    """Build and load later libraries in ``path``.  A library this
    process already loaded stays loaded from where it was built: it is
    not loaded again."""
    global _build_dir
    path = Path(path)
    with _load_lock:
        if path != _build_dir and _libs:
            _log.warning(
                "kernel libraries already loaded stay loaded from %s: %s",
                _build_dir, ", ".join(sorted(s.name for s in _libs)))
        _build_dir = path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return str(path)


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is built: named by a hash of the
    source, every header of its directory and the flags."""
    text = source.read_bytes()
    for header in sorted(source.parent.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(text + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _build_dir / f"{source.stem}-{digest}.so"


def build(sources: list[Path]) -> list[Path]:
    """Compile every source whose library is missing — one ``nvcc`` per
    source, all started together — and return the library paths in the
    order of ``sources``.  Raises with the compiler's output if a build
    fails."""
    global NVCC_RUNS, BUILD_S
    t0 = time.perf_counter()
    outs = [library_path(s) for s in sources]
    missing = [(src, out) for src, out in zip(sources, outs)
               if not out.exists()]
    nvcc = _nvcc() if missing else None
    running = []
    for src, out in missing:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in running:
        log, _ = proc.communicate()
        LOGS[src.name] = log
        if proc.returncode:
            errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if running:
        with _stats_lock:
            NVCC_RUNS += len(running)
            BUILD_S += time.perf_counter() - t0
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return outs


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, built first if it is not
    current and loaded once per process."""
    with _load_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build([source])[0]))
        return lib


def check_operand(kernel: str, t, name: str, dtype, device, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C interface takes."""
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
