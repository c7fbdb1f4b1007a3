"""Concurrency and reflection utilities.

Counterpart of ``oryx_tpu/common/lang.py``, cut down to
``AutoReadWriteLock`` (reference: AutoReadWriteLock.java:37), the
plugin loader ``load_instance`` (ClassUtils.java:89), ``RateLimitCheck``
(RateLimitCheck.java:28), ``logging_call`` (LoggingCallable.java:31)
and ``collect_in_parallel`` (ExecUtils.java:93).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, TypeVar

_log = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["AutoReadWriteLock", "load_class", "load_instance",
           "RateLimitCheck", "logging_call", "collect_in_parallel"]

# the package a configured class path must name: a config written for
# the JAX package (``oryx_tpu.…``) would load that package's classes
_PACKAGE = __name__.split(".")[0]


def load_class(name: str) -> type:
    """Load a class by its ``pkg.module.Class`` path (the
    ``model-manager-class`` plugin mechanism).  Only classes of this
    package load: any other path raises ``ValueError``."""
    module_name, _, cls_name = name.rpartition(".")
    if not module_name:
        raise ValueError(f"not a qualified class name: {name!r}")
    if module_name.split(".")[0] != _PACKAGE:
        raise ValueError(
            f"class {name!r} is not part of {_PACKAGE}: configure the "
            f"{_PACKAGE} classes (for example "
            f"{_PACKAGE}.app.als.serving_manager.ALSServingModelManager)")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, cls_name)
    except AttributeError as e:
        raise ImportError(
            f"no class {cls_name!r} in module {module_name!r}") from e


def load_instance(name: str, *args: Any) -> Any:
    """Instantiate by name, with the given args when the constructor
    takes them and with none otherwise (reference:
    ClassUtils.loadInstanceOf).  The choice is made by signature, so an
    error raised inside the constructor propagates."""
    cls = load_class(name)
    if args:
        try:
            inspect.signature(cls).bind(*args)
            accepts = True
        except TypeError:
            accepts = False
        if accepts:
            return cls(*args)
    return cls()


class RateLimitCheck:
    """True at most once per interval (reference: RateLimitCheck.java:28)."""

    def __init__(self, interval_sec: float):
        self._interval = interval_sec
        self._next = time.monotonic()
        self._lock = threading.Lock()

    def test(self) -> bool:
        with self._lock:
            now = time.monotonic()
            if now >= self._next:
                self._next = now + self._interval
                return True
            return False


def logging_call(fn: Callable[[], T],
                 name: str = "task") -> Callable[[], T | None]:
    """Wrap a callable to log, not raise, its exceptions — for
    fire-and-forget threads (reference: LoggingCallable.java:31)."""

    def _wrapped() -> T | None:
        try:
            return fn()
        except Exception:  # noqa: BLE001 — background task
            _log.exception("Unexpected error in %s", name)
            return None

    return _wrapped


def collect_in_parallel(num_items: int, fn: Callable[[int], T],
                        parallelism: int | None = None) -> list[T]:
    """``fn`` over the indices ``0..num_items-1`` on up to
    ``parallelism`` threads, the results in index order."""
    if num_items <= 0:
        return []
    parallelism = num_items if parallelism is None else max(1, parallelism)
    if parallelism == 1 or num_items == 1:
        return [fn(i) for i in range(num_items)]
    with ThreadPoolExecutor(max_workers=min(parallelism, num_items)) as pool:
        return list(pool.map(fn, range(num_items)))


class _RWLock:
    """Writer-preferring reader/writer lock, reentrant like
    java.util.concurrent.ReentrantReadWriteLock: a thread already holding
    the read (or write) lock may re-acquire it even while a writer waits,
    and the writer thread may take read locks."""

    def __init__(self):
        self._cond = threading.Condition()
        self._read_holds = threading.local()
        self._readers = 0
        self._writer_thread: int | None = None
        self._writer_depth = 0
        self._writers_waiting = 0

    def _holds(self) -> int:
        return getattr(self._read_holds, "count", 0)

    def acquire_read(self):
        me = threading.get_ident()
        with self._cond:
            if self._holds() == 0 and self._writer_thread != me:
                while self._writer_depth or self._writers_waiting:
                    self._cond.wait()
            self._readers += 1
            self._read_holds.count = self._holds() + 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            self._read_holds.count = self._holds() - 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer_thread == me:
                self._writer_depth += 1
                return
            self._writers_waiting += 1
            # readers held by this same thread would deadlock here; that
            # (read->write upgrade) deadlocks in the reference's lock too
            while self._writer_depth or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer_thread = me
            self._writer_depth = 1

    def release_write(self):
        with self._cond:
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer_thread = None
                self._cond.notify_all()


class AutoReadWriteLock:
    """Context-manager reader/writer lock
    (reference: AutoReadWriteLock.java:37 — autoReadLock()/autoWriteLock())."""

    def __init__(self):
        self._lock = _RWLock()

    @contextlib.contextmanager
    def read(self) -> Iterator[None]:
        self._lock.acquire_read()
        try:
            yield
        finally:
            self._lock.release_read()

    @contextlib.contextmanager
    def write(self) -> Iterator[None]:
        self._lock.acquire_write()
        try:
            yield
        finally:
            self._lock.release_write()
