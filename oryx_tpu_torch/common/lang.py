"""Concurrency utilities.

Counterpart of ``oryx_tpu/common/lang.py``, cut down to
``AutoReadWriteLock`` (reference: AutoReadWriteLock.java:37), which the
feature-vector stores and the serving model's known-items map use.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

__all__ = ["AutoReadWriteLock"]


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
