"""Standalone HTTP traffic generator against live serving hosts.

Counterpart of ``oryx_tpu/bench/traffic.py``; it needs no device.
Reference: app/oryx-app-serving/src/test/java/.../traffic/
TrafficUtil.java:63 — multi-threaded client with exponential
inter-arrival sleeps (Poisson arrivals at a requested mean QPS) firing
endpoint mixes against one or more hosts, logging latency percentiles —
and traffic/als/ALSEndpoint.java:29 (the ALS endpoint mix).

Usage (module CLI):
    python -m oryx_tpu_torch.bench.traffic http://host:8080 \
        --qps 50 --duration 30 --workers 8 --endpoints recommend,similarity
(--endpoints filters the ALS mix to templates containing any of the
given substrings; omit it to fire the full mix.)
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
import time
import urllib.request

import numpy as np

from ..common.rand import RandomManager
from .load import LoadStats

_log = logging.getLogger(__name__)

__all__ = ["EndpointMix", "run_traffic", "ALS_ENDPOINTS", "main"]


class EndpointMix:
    """Weighted endpoint templates; ``{u}``/``{i}`` fill with random
    user/item ids."""

    def __init__(self, templates: dict[str, float],
                 users: int = 1000, items: int = 1000):
        total = sum(templates.values())
        self.templates = [(t, w / total) for t, w in templates.items()]
        self.users = users
        self.items = items

    def pick(self, rng) -> str:
        r = rng.random()
        acc = 0.0
        for template, weight in self.templates:
            acc += weight
            if r <= acc:
                break
        return template.replace("{u}", str(rng.integers(0, self.users))) \
                       .replace("{i}", str(rng.integers(0, self.items)))


# the reference's ALS endpoint mix (ALSEndpoint.java: recommend-heavy)
ALS_ENDPOINTS = {
    "/recommend/{u}": 0.6,
    "/similarity/{i}": 0.2,
    "/estimate/{u}/{i}": 0.1,
    "/knownItems/{u}": 0.1,
}


def run_traffic(base_urls: list[str], mix: EndpointMix,
                mean_qps: float = 10.0, duration_sec: float = 10.0,
                workers: int = 4, timeout_sec: float = 30.0) -> LoadStats:
    """Poisson-arrival load: each worker sleeps Exp(workers/qps) between
    requests (reference: TrafficUtil's exponential inter-arrival)."""
    latencies: list[float] = []
    errors = [0]
    lock = threading.Lock()
    deadline = time.perf_counter() + duration_sec
    per_worker_rate = mean_qps / max(1, workers)

    def worker(worker_id: int):
        rng = np.random.default_rng(
            RandomManager.random_seed() + worker_id)
        host = base_urls[worker_id % len(base_urls)]
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return
            time.sleep(min(rng.exponential(1.0 / per_worker_rate),
                           max(0.0, deadline - now)))
            if time.perf_counter() >= deadline:
                return
            url = host + mix.pick(rng)
            start = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=timeout_sec) as r:
                    r.read()
                ms = (time.perf_counter() - start) * 1000.0
                with lock:
                    latencies.append(ms)
            except Exception:
                with lock:
                    errors[0] += 1

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return LoadStats(requests=len(latencies), errors=errors[0],
                     elapsed_sec=elapsed,
                     latencies_ms=np.asarray(latencies))


def main(argv: list[str] | None = None) -> int:  # pragma: no cover
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("hosts", help="comma-separated base URLs")
    parser.add_argument("--qps", type=float, default=10.0)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--users", type=int, default=1000)
    parser.add_argument("--items", type=int, default=1000)
    parser.add_argument("--endpoints",
                        help="comma-separated substrings selecting a "
                             "subset of the ALS endpoint mix")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    templates = ALS_ENDPOINTS
    if args.endpoints:
        wanted = args.endpoints.split(",")
        templates = {t: w for t, w in ALS_ENDPOINTS.items()
                     if any(s in t for s in wanted)}
        if not templates:
            parser.error(f"no endpoints match {args.endpoints!r}")
    mix = EndpointMix(templates, users=args.users, items=args.items)
    stats = run_traffic(args.hosts.split(","), mix, args.qps,
                        args.duration, args.workers)
    print(stats.summary())
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
