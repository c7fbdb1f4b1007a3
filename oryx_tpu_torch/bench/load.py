"""Serving load benchmark: a synthetic ALS model served over live HTTP,
driven by concurrent /recommend clients.

Counterpart of ``oryx_tpu/bench/load.py`` (reference:
app/oryx-app-serving/src/test/java/.../als/LoadBenchmark.java:65 —
opt-in benchmark profile: build a LoadTestALSModelFactory model with
configurable users/items/features/lshSampleRate/workers, fire
/recommend requests, log mean req time + heap — and
LoadTestALSModelFactory.java:34).  The drivers are plain sockets and
threads; the statistics are the reference's, unchanged: exponential
inter-arrival, latency from the scheduled arrival, the [15 %, 90 %)
mid-window and the 2·√ Poisson allowance for ``sustained``.

The factory sets vectors in bulk through the same set_user_vector /
set_item_vector path the update-topic replay uses, so benchmarked state
is the state production reaches.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import socket
import threading
import time
import urllib.parse

import numpy as np

from ..api.serving import ServingModelManager
from ..app.als.serving_model import ALSServingModel
from ..common.rand import RandomManager

_log = logging.getLogger(__name__)

__all__ = ["StaticModelManager", "build_load_test_model", "LoadStats",
           "run_recommend_load", "run_recommend_open_loop",
           "zipf_picks"]


class StaticModelManager(ServingModelManager):
    """Read-only manager serving a prebuilt model, for benches, endpoint
    tests and the chip smoke run (reference test scope:
    MockServingModelManager.java:27).  Subclass per use and set the
    ``model`` class attribute."""

    model = None

    def __init__(self, config=None):
        pass

    def consume(self, updates) -> None:
        pass

    def get_model(self):
        return type(self).model

    def is_read_only(self) -> bool:
        return True


def build_load_test_model(users: int = 10_000, items: int = 50_000,
                          features: int = 50,
                          lsh_sample_rate: float = 1.0,
                          known_items_per_user: int = 9,
                          device=None) -> ALSServingModel:
    """Synthetic ALS serving model (reference:
    LoadTestALSModelFactory.java:34 — default 2M x 9.7M x 250 on a
    32-core box; scale down by default for small runs).  ``device=None``
    means ``cuda``."""
    rng = RandomManager.random()
    model = ALSServingModel(features, implicit=True,
                            sample_rate=lsh_sample_rate, device=device)
    t0 = time.time()
    x = rng.standard_normal((users, features)).astype(np.float32)
    y = rng.standard_normal((items, features)).astype(np.float32)
    user_ids = [str(u) for u in range(users)]
    item_ids = [str(i) for i in range(items)]
    for u, uid in enumerate(user_ids):
        model.set_user_vector(uid, x[u])
        if known_items_per_user:
            known = rng.integers(0, items, known_items_per_user)
            model.add_known_items(uid, [item_ids[k] for k in known])
    for i, iid in enumerate(item_ids):
        model.set_item_vector(iid, y[i])
    _log.info("Built load-test model %dx%dx%d in %.1fs",
              users, items, features, time.time() - t0)
    return model


@dataclasses.dataclass
class LoadStats:
    requests: int
    errors: int
    elapsed_sec: float
    latencies_ms: np.ndarray

    @property
    def qps(self) -> float:
        return self.requests / self.elapsed_sec if self.elapsed_sec else 0.0

    def percentile_ms(self, p: float) -> float:
        return float(np.percentile(self.latencies_ms, p)) \
            if len(self.latencies_ms) else float("nan")

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "errors": self.errors,
            "qps": round(self.qps, 2),
            "p50_ms": round(self.percentile_ms(50), 3),
            "p95_ms": round(self.percentile_ms(95), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
        }


class _Client:
    """One persistent keep-alive HTTP/1.1 connection, hand-rolled:
    http.client routes every response through the email-parser
    machinery, and with client and server sharing host cores that
    parsing shows up as lost server qps — the harness must not be the
    bottleneck it is measuring.  Connects lazily; after a failed request
    the next one reconnects."""

    def __init__(self, host: str, port: int, timeout_sec: float):
        self.address = (host, port)
        self.timeout_sec = timeout_sec
        self.conn = self.rfile = None

    def connect(self) -> None:
        if self.conn is None:
            self.conn = socket.create_connection(self.address,
                                                 timeout=self.timeout_sec)
            self.conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.rfile = self.conn.makefile("rb")

    def get(self, path: str) -> bool:
        """GET ``path``, read the whole response; whether it was a 200."""
        return self.get_traced(path)[0]

    def get_traced(self, path: str) -> tuple[bool, str | None]:
        """GET ``path``, read the whole response; whether it was a 200,
        and the ``X-Oryx-Trace`` id a sampled response carries."""
        return self.get_stamped(path)[:2]

    def get_stamped(self, path: str
                    ) -> tuple[bool, str | None, str | None]:
        """As ``get_traced``, plus the ``X-Oryx-Cache`` verdict a
        cache-armed router stamps (None without one)."""
        self.connect()
        self.conn.sendall(f"GET {path} HTTP/1.1\r\nHost: a\r\n\r\n"
                          .encode("latin-1"))
        status_line = self.rfile.readline(65537)
        if not status_line:
            raise ConnectionError("closed")
        status = int(status_line.split(b" ", 2)[1])
        clen = 0
        trace = verdict = None
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            if h[:15].lower() == b"content-length:":
                clen = int(h[15:])
            elif h[:13].lower() == b"x-oryx-trace:":
                trace = h[13:].strip().decode("latin-1")
            elif h[:13].lower() == b"x-oryx-cache:":
                verdict = h[13:].strip().decode("latin-1")
        remaining = clen
        while remaining:
            got = self.rfile.read(remaining)
            if not got:
                raise ConnectionError("short body")
            remaining -= len(got)
        return status == 200, trace, verdict

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None


def run_recommend_load(base_url: str, user_ids: list[str],
                       requests: int = 1000, workers: int = 4,
                       how_many: int = 10,
                       timeout_sec: float = 30.0) -> LoadStats:
    """Drive GET /recommend/{user} with ``workers`` concurrent clients
    (reference: LoadBenchmark.java uses ExecUtils.doInParallel over a
    worker count; 1-3 concurrent requests saturate the scorer)."""
    rng = RandomManager.random()
    picks = rng.integers(0, len(user_ids), requests)
    latencies: list[float] = []
    errors = [0]
    lock = threading.Lock()
    next_index = [0]
    parsed = urllib.parse.urlparse(base_url)
    path_prefix = parsed.path.rstrip("/")

    def worker():
        client = _Client(parsed.hostname, parsed.port, timeout_sec)
        try:
            while True:
                with lock:
                    i = next_index[0]
                    if i >= requests:
                        return
                    next_index[0] += 1
                path = (f"{path_prefix}/recommend/{user_ids[picks[i]]}"
                        f"?howMany={how_many}")
                start = time.perf_counter()
                trace = None
                try:
                    ok, trace = client.get_traced(path)
                except Exception:  # noqa: BLE001 — counted as error
                    ok = False
                    client.close()
                ms = (time.perf_counter() - start) * 1000.0
                with lock:
                    if ok:
                        latencies.append(ms)
                    else:
                        errors[0] += 1
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return LoadStats(requests=len(latencies), errors=errors[0],
                     elapsed_sec=elapsed,
                     latencies_ms=np.asarray(latencies))


def zipf_picks(rng, n_users: int, n: int, a: float) -> np.ndarray:
    """Rank-frequency Zipf draw over the user population: user at rank
    r is drawn with probability ∝ 1/r^a — the hot-user skew real
    recommendation traffic shows, and the shape the reference router's
    exact result cache is built to exploit.  The port has no result
    cache yet, so no driver here draws from it."""
    ranks = np.arange(1, n_users + 1, dtype=np.float64)
    p = 1.0 / np.power(ranks, a)
    p /= p.sum()
    return rng.choice(n_users, size=n, p=p)


def run_recommend_open_loop(base_url: str, user_ids: list[str],
                            rate_qps: float, duration_sec: float = 6.0,
                            workers: int = 512, how_many: int = 10,
                            timeout_sec: float = 30.0,
                            zipf_a: float | None = None,
                            cache_bust: bool = False) -> dict:
    """OPEN-LOOP /recommend driver: requests arrive on an exponential
    inter-arrival schedule at ``rate_qps`` regardless of responses, and
    latency is measured from the SCHEDULED arrival time — so queueing
    delay when the server falls behind counts against it (reference:
    TrafficUtil.java:63, exponential inter-arrival against live hosts).
    A closed-loop client bounded by transport RTT measures the
    transport; this measures the server.  Saturation shows as achieved
    qps below offered and a growing scheduled-to-completion tail.

    Users are drawn uniformly, or hot-user Zipf with ``zipf_a``.
    Sampled responses' ``X-Oryx-Trace`` ids are tallied:
    ``worst_sampled`` names the recorded trace (on ``/admin/traces``)
    behind each of the five slowest.  Per-response ``X-Oryx-Cache``
    verdicts are tallied (with a hit-only latency split) whenever the
    router stamps them.  ``cache_bust`` appends a unique query argument
    per request so every request is a distinct cache key — the honest
    way to measure the miss path against a cache-armed router."""
    rng = RandomManager.random()
    n = max(1, int(rate_qps * duration_sec))
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, n))
    picks = zipf_picks(rng, len(user_ids), n, zipf_a) \
        if zipf_a else rng.integers(0, len(user_ids), n)
    parsed = urllib.parse.urlparse(base_url)
    path_prefix = parsed.path.rstrip("/")
    latencies: list[float] = []
    lateness: list[float] = []
    done_ts: list[float] = []
    # (latency_ms, X-Oryx-Trace id) of the sampled responses
    traced: list[tuple[float, str]] = []
    # X-Oryx-Cache verdict tallies and hit-only latencies (the cached-hit
    # p50); empty when the router does not stamp the header
    cache_counts: dict[str, int] = {}
    hit_lat: list[float] = []
    errors = [0]
    lock = threading.Lock()
    next_index = [0]
    t0 = time.perf_counter()

    def worker():
        client = _Client(parsed.hostname, parsed.port, timeout_sec)
        try:
            while True:
                with lock:
                    i = next_index[0]
                    if i >= n:
                        return
                    next_index[0] += 1
                scheduled = t0 + arrivals[i]
                now = time.perf_counter()
                if scheduled > now:
                    time.sleep(scheduled - now)
                late = max(0.0, time.perf_counter() - scheduled)
                path = (f"{path_prefix}/recommend/{user_ids[picks[i]]}"
                        f"?howMany={how_many}")
                if cache_bust:
                    path += f"&cb={i}"
                trace = verdict = sent = None
                try:
                    client.connect()
                    # stamped after the (re)connect: a hit's latency
                    # names the server's cost, not a TCP handshake
                    sent = time.perf_counter()
                    ok, trace, verdict = client.get_stamped(path)
                except Exception:  # noqa: BLE001 — counted as error
                    ok = False
                    client.close()
                done = time.perf_counter()
                ms = (done - scheduled) * 1000.0
                with lock:
                    lateness.append(late * 1000.0)
                    if ok:
                        latencies.append(ms)
                        done_ts.append(done - t0)
                        if trace:
                            traced.append((ms, trace))
                        if verdict:
                            cache_counts[verdict] = \
                                cache_counts.get(verdict, 0) + 1
                            if verdict == "hit" and sent is not None:
                                # send-to-response, not schedule slip:
                                # the hit p50 names the server's cost
                                hit_lat.append((done - sent) * 1000.0)
                    else:
                        errors[0] += 1
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lat = np.asarray(latencies)
    # achieved = completion throughput over a MID WINDOW of the
    # scheduled span ([15%, 90%)).  Total-count-over-wall-time folds
    # the last requests' drain tail into the denominator (a ~14%
    # structural under-report at 0.3 s latencies);
    # total-count-over-scheduled-span is tautologically == offered
    # whenever nothing errors (the fixed worker pool completes every
    # request eventually).  The window excludes both ramp-in and
    # drain: at a sustained rate it measures the offered rate, in
    # overload it measures the server's service capacity.
    span = float(arrivals[-1])
    dt = np.asarray(done_ts)
    w0, w1 = 0.15 * span, 0.9 * span
    mid_done = int(((dt >= w0) & (dt < w1)).sum()) if span else 0
    mid_arr = int(((arrivals >= w0) & (arrivals < w1)).sum()) \
        if span else 0
    achieved = mid_done / (w1 - w0) if span else 0.0
    # kept-up gate: in-window completions vs in-window SCHEDULED
    # arrivals.  Comparing completions against offered*window instead
    # would re-introduce the arrival process's own Poisson noise
    # (relative std 1/sqrt(count): ~14% at a 25 qps x 6 s rung — a
    # healthy server would fail such rungs ~1/3 of the time); against
    # in-window arrivals the arrival noise cancels at stationarity,
    # leaving boundary jitter, absorbed by a 2*sqrt Poisson allowance.
    # Resolution limit: a rung can only resolve overload coarser than
    # max(5%, 2/sqrt(arrivals-in-window)).
    allowance = max(0.05 * mid_arr, 2.0 * math.sqrt(mid_arr))
    kept_up = (mid_done >= mid_arr - allowance) if mid_arr \
        else len(latencies) == n
    late = np.asarray(lateness)
    # saturation = the backlog GROWS across the run: compare mean
    # scheduled-lateness of the third quarter vs the final quarter of
    # arrivals; steady lateness (client pool + transport slack) is
    # fine, divergence is not.  Secondary signal alongside kept_up.
    n_l = len(late)
    growing = False
    if n_l >= 8:
        q3 = float(np.mean(late[n_l // 2:3 * n_l // 4]))
        q4 = float(np.mean(late[3 * n_l // 4:]))
        growing = q4 > q3 + 200.0  # ms of drift across ~1/4 of the run
    # the worst sampled requests, slowest first: each id names a recorded
    # span tree on /admin/traces, so a bad p99 splits into queue wait
    # and device execute
    worst = [{"ms": round(ms, 1), "trace": t}
             for ms, t in sorted(traced, reverse=True)[:5]]
    stamped = sum(cache_counts.values())
    cache = None
    if stamped:
        cache = dict(cache_counts)
        cache["hit_rate"] = round(cache_counts.get("hit", 0) / stamped, 4)
        if hit_lat:
            hl = np.asarray(hit_lat)
            cache["hit_p50_ms"] = round(float(np.percentile(hl, 50)), 3)
            cache["hit_p99_ms"] = round(float(np.percentile(hl, 99)), 3)
    return {
        "offered_qps": round(rate_qps, 1),
        "achieved_qps": round(achieved, 1),
        "errors": errors[0],
        "worst_sampled": worst,
        "cache": cache,
        "p50_ms": round(float(np.percentile(lat, 50)), 1) if len(lat) else None,
        "p95_ms": round(float(np.percentile(lat, 95)), 1) if len(lat) else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 1) if len(lat) else None,
        # mean time requests spent waiting for a free client slot past
        # their scheduled arrival — the open-loop backlog signal
        "mean_sched_lateness_ms": round(float(np.mean(late)), 1)
        if n_l else None,
        "lateness_drift_ms": round(q4 - q3, 1) if n_l >= 8 else None,
        "mid_window": {"arrivals": mid_arr, "completions": mid_done},
        "sustained": errors[0] == 0 and not growing and kept_up,
    }
