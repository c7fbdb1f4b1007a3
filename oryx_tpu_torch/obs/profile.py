"""On-demand device profiling: ``/admin/profile?ms=N``.

Counterpart of ``oryx_tpu/obs/profile.py``, on ``torch.profiler`` in
place of ``jax.profiler``.  When a replica's latency regresses, the
operator needs a trace of LIVE traffic, captured without a restart:
:func:`capture_profile` records a bounded-duration
``torch.profiler.profile`` of the process (CPU activity, and the card's
kernels through CUPTI when there is one) and exports it as a Chrome
trace, ``profile-<ms>/trace.json`` under ``oryx.obs.profile-dir``
(viewable in Perfetto or ``chrome://tracing``), beside the card's
memory statistics.

The profiler records device kernels launched from every thread of the
process, so a capture taken on the HTTP handler's thread sees the
kernels the batcher's dispatcher threads launch.  Its one-time set-up
runs only on the thread that imported torch, though, and a first
capture on a handler's thread skips it: the layers call :func:`prime`
from ``start()`` when ``oryx.obs.profile-dir`` is set.

Gated twice: the endpoint 404s unless ``oryx.obs.profile-dir`` is
configured, and it is a mutating route, so read-only mode applies.  One
capture at a time per process — ``torch.profiler`` is process-global —
with a concurrent request refused as 503 rather than queued.  The same
lock guards the batch tier's per-generation trace
(``ml/mlupdate._profile``), so the two never overlap.  A capture that
fails raises (a 500 with the error), never an empty success.

Chaos seam ``obs-profile-slow`` fires inside the capture window, so a
test can show that a stalled profiler never blocks serving traffic
(captures run on the requesting handler's own thread).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading

from ..common import clock as clockmod
from ..resilience import faults

_log = logging.getLogger(__name__)

__all__ = ["capture_profile", "ProfileBusyError", "capture_lock",
           "device_memory_stats", "prime", "TRACE_FILE"]

# hard ceiling on one capture: a fat-fingered ms=3600000 must not pin
# the profiler (and one handler thread) for an hour
_MAX_CAPTURE_MS = 60_000

# the exported Chrome trace inside each capture directory
TRACE_FILE = "trace.json"

_capture_lock = threading.Lock()


class ProfileBusyError(Exception):
    """Another capture is already in flight in this process."""


@contextlib.contextmanager
def capture_lock(blocking: bool = True):
    """Hold the process's one profiler lock.  Non-blocking, a held lock
    raises :class:`ProfileBusyError`."""
    if not _capture_lock.acquire(blocking=blocking):
        raise ProfileBusyError("a profile capture is already running")
    try:
        yield
    finally:
        _capture_lock.release()


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity
    out = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        out.append(ProfilerActivity.CUDA)
    return out


def prime() -> None:
    """Run the profiler's one-time set-up on the calling thread: an
    empty capture, which waits for one in flight."""
    from torch.profiler import profile
    with capture_lock(), profile(activities=_activities()):
        pass


def device_memory_stats() -> list[dict]:
    """Per-device memory statistics of the card(s); an empty list on a
    host with none, as the reference's is without an accelerator."""
    try:
        import torch
        if not torch.cuda.is_available():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            free_b, total_b = torch.cuda.mem_get_info(i)
            stats = torch.cuda.memory_stats(i)
            out.append({
                "device": f"cuda:{i}",
                "platform": "gpu",
                "name": torch.cuda.get_device_name(i),
                "memory_stats": {
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(stats.get(
                        "reserved_bytes.all.current", 0)),
                    "bytes_free": int(free_b),
                    "bytes_limit": int(total_b)}})
        return out
    except Exception:  # noqa: BLE001 — forensics are best-effort
        return []


def capture_profile(profile_dir: str, ms: int) -> dict:
    """Record a ``torch.profiler`` trace of the next ``ms`` milliseconds
    of this process under ``profile_dir``, returning the trace path and
    the card's memory stats.  Raises :class:`ProfileBusyError` when a
    capture is already running."""
    ms = max(1, min(int(ms), _MAX_CAPTURE_MS))
    with capture_lock(blocking=False):
        import torch
        from torch.profiler import profile
        trace_dir = os.path.join(profile_dir,
                                 f"profile-{int(clockmod.now() * 1000)}")
        os.makedirs(trace_dir, exist_ok=True)
        activities = _activities()
        t0 = clockmod.monotonic()
        with profile(activities=activities) as prof:
            # chaos seam: a stalled profiler backend — the capture
            # slows but serving threads are untouched (this runs on
            # the requesting handler's thread only)
            faults.fire("obs-profile-slow")
            clockmod.sleep(ms / 1000.0)
            if torch.cuda.is_available():
                # the window's launched kernels finish inside it
                torch.cuda.synchronize()
        wall_ms = round((clockmod.monotonic() - t0) * 1000.0, 1)
        path = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        _log.info("Captured device profile (%s ms) to %s", wall_ms,
                  trace_dir)
        return {"trace_dir": trace_dir,
                "trace_file": path,
                "requested_ms": ms,
                "captured_ms": wall_ms,
                "activities": [a.name for a in activities],
                "devices": device_memory_stats()}
