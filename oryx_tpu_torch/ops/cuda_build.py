"""Build the package's CUDA sources into shared libraries with a plain C
interface, for ``ctypes``.

Each source compiles with ``nvcc`` for ``sm_90a`` (Hopper) into
``build/kernels/`` at the repository root, under a name keyed by a
hash of the source, the headers beside it (``*.cuh``, which the sources
share) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  Sources are built from the checkout at first
use; nothing prebuilt is shipped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "load", "check_operand", "LOGS"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# compiler output (registers, shared memory, spills) of the builds this
# process ran, by source file name
LOGS: dict[str, str] = {}
# loaded libraries by source: one source may serve several wrappers
_libs: dict[Path, ctypes.CDLL] = {}
_load_lock = threading.Lock()


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
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(sources: list[Path]) -> list[Path]:
    """Compile every source whose library is missing — one ``nvcc`` per
    source, all started together — and return the library paths in the
    order of ``sources``.  Raises with the compiler's output if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(s) for s in sources]
    running = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
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
