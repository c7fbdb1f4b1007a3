"""Gateway scale-out benchmark: sustained /recommend qps through the
scatter-gather router at 1 -> 2 -> 4 catalog-shard replicas, with an
R-way replica-group dimension (``--replicas-per-shard``), a
kill-one-member availability probe, and an admission-control overload
rung.

Counterpart of ``oryx_tpu/bench/gateway.py``.  The cluster is real
processes (``python -m oryx_tpu_torch serving --shard i/N`` and
``router``) over a durable ``file://`` broker, so the scaling measured is
actual OS-level parallelism, not threads behind one GIL.  ``--device``
(default: the CUDA card) is where every replica scans its slice: on the
card the replicas run the hand-written phase-A kernels of their routed
kind, all of them on the one card.  ``--device cpu`` runs the replicas
on the host, pinned to ``--replica-threads`` torch threads each;
there ``--device-ms-per-mrow`` emulates fixed-rate per-replica
accelerators (every scoring dispatch sleeps for the time a device
streaming the replica's slice would take, staged through the
``serving-scan-dispatch`` fault point).  The emulation is refused on
the card: there the scans are real.

The harness publishes one synthetic model (sharded by default: a
manifest-carrying MODEL-REF and murmur2 slices; ``--sharded-publish 0``
publishes MODEL and per-row UP messages instead) and, per cell, waits
for the router to report full shard coverage, spot-checks router
answers against a direct replica merge, then walks an open-loop rate
ladder (bench/load.py's arrival-scheduled driver) to the highest
sustained rate.  ``--load-compare N`` publishes the catalog both ways
and boots an N-way fleet against each.

The router runs the fast path by default: the exact result cache and
single-flight coalescing (``--cache``: the uniform ladder flushes the
cache before every rung and cache-busts every request, so it stays a
miss-path cell; ``--zipf a`` adds a hot-user rung whose hit rate builds
across the ladder; ``--coalesce-burst B`` fires waves of identical
concurrent requests that must collapse onto one scatter), the asyncio
front end (``--async``) and the framed internal transport
(``--transport``).  ``--connections C1,C2,...`` adds a connection-count
ladder on the cache-hit workload; cells with replica groups (R>1) also
run a hedge-frame probe (hedges cost a frame, not a connection), and
``--replica-cache`` arms the replicas' shard caches.

Three options of the reference wait for a later part of this package,
and each exits 2 naming its flag: ``--regions`` above 1 (the two-region
mirror probe), ``--write-heavy`` (the durable-ack ingest rung) and
``--ann`` (the IVF-ANN rung).

Writes ``--out`` (default ``BENCH_TORCH_GATEWAY.json``) with the
reference's artifact keys, plus the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

from ..common import pmml as pmml_io
from ..common.device import resolve_device
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from ..kafka.inproc import resolve_broker
from .load import run_recommend_open_loop

__all__ = ["run_cell", "main", "DEFERRED_FLAGS"]

# the reference's options that wait for a later part of this package
DEFERRED_FLAGS = {
    "--regions": "the two-region mirror probe (cluster/mirror.py)",
    "--write-heavy": "the durable-ack ingest rung (the Kafka wire broker "
                     "and the sharded speed layer)",
    "--ann": "the IVF-ANN rung of the gateway bench",
}


def keys_to_hocon(kv) -> str:
    """Render key/value pairs as HOCON lines."""
    return "\n".join(f"{k} = {json.dumps(v)}" for k, v in kv)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _publish_model(broker_dir: str, users: int, items: int,
                   features: int, seed: int = 5,
                   sharded: int = 0) -> list[str]:
    """MODEL + UP replay onto the file broker — the same stream a
    batch generation publishes, so replicas load through the real
    consume path.  Writes the single-partition topic log directly in
    the broker's JSONL format (``[key, message]`` per line): the
    broker's per-record append re-reads its own write for multi-writer
    offset agreement, a tax a one-shot half-gigabyte publish need not
    pay.  A post-write ``resolve_broker`` sanity read keeps the layout
    honest.

    ``sharded`` > 0 publishes the sharded form instead: a
    manifest-carrying MODEL-REF whose per-murmur2-slice artifacts live
    next to the PMML, and no per-row UP flood — each replica bulk-loads
    only its slices (O(catalog/N) load)."""
    rng = np.random.default_rng(seed)
    os.makedirs(broker_dir, exist_ok=True)
    user_ids = [f"u{j}" for j in range(users)]
    item_ids = [f"i{j}" for j in range(items)]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", features)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", user_ids)
    pmml_io.add_extension_content(doc, "YIDs", item_ids)
    y = np.round(rng.standard_normal((items, features)), 4
                 ).astype(np.float32)
    x = np.round(rng.standard_normal((users, features)), 4
                 ).astype(np.float32)
    if sharded > 0:
        from ..app.als import slices as model_slices
        from ..app.als.update import save_features
        model_dir = os.path.join(broker_dir, "model-gen1")
        os.makedirs(model_dir, exist_ok=True)
        pmml_path = os.path.join(model_dir, "model.pmml.xml")
        pmml_io.write(doc, pmml_path)
        # the monolithic artifacts ride ALONGSIDE the slices, exactly
        # like the real publisher's layout — the fail-closed fallback
        # (corrupt slice, a shard count that does not divide the ring)
        # reads them, and a bench of that path must not dead-end
        save_features(os.path.join(model_dir, "Y"), item_ids, y)
        save_features(os.path.join(model_dir, "X"), user_ids, x)
        slim = model_slices.publish_sliced(
            model_dir, item_ids, y, user_ids, x, None, sharded)
        envelope = model_slices.model_ref_message(pmml_path, model_dir,
                                                  slim)
        with open(os.path.join(broker_dir, "GwUp.topic.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps([KEY_MODEL_REF, envelope]) + "\n")
        broker = resolve_broker(f"file://{broker_dir}")
        assert sum(broker.latest_offsets("GwUp")) == 1
        broker.close()
        return user_ids
    with open(os.path.join(broker_dir, "GwUp.topic.jsonl"), "a",
              encoding="utf-8", buffering=1 << 20) as f:
        f.write(json.dumps([KEY_MODEL, pmml_io.to_string(doc)]) + "\n")
        for iid, row in zip(item_ids, y.tolist()):
            f.write(json.dumps(
                [KEY_UP, json.dumps(["Y", iid, row])]) + "\n")
        for uid, row in zip(user_ids, x.tolist()):
            f.write(json.dumps(
                [KEY_UP, json.dumps(["X", uid, row, []])]) + "\n")
    broker = resolve_broker(f"file://{broker_dir}")
    assert sum(broker.latest_offsets("GwUp")) == 1 + items + users
    broker.close()
    return user_ids


def _write_conf(path: str, broker_dir: str, port: int,
                extra: dict) -> None:
    kv = {
        "oryx.id": "gw-bench",
        "oryx.input-topic.broker": f"file://{broker_dir}",
        "oryx.input-topic.message.topic": "GwIn",
        "oryx.input-topic.partitions": 1,
        "oryx.update-topic.broker": f"file://{broker_dir}",
        "oryx.update-topic.message.topic": "GwUp",
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.als.serving_manager."
            "ALSServingModelManager",
        "oryx.serving.application-resources":
            "oryx_tpu_torch.serving.als",
        "oryx.serving.api.port": port,
        "oryx.resilience.supervisor.enabled": False,
        "oryx.cluster.heartbeat-interval-ms": 250,
        "oryx.cluster.heartbeat-ttl-ms": 1500,
    }
    kv.update(extra)
    with open(path, "w", encoding="utf-8") as f:
        f.write(keys_to_hocon(sorted(kv.items())))


def _spawn(args: list[str], conf: str, threads: int | None,
           log_path: str, device: str | None = None) -> subprocess.Popen:
    """``python -m oryx_tpu_torch <args>`` with this checkout on the
    path; on the host (``device`` "cpu") pinned to ``threads`` torch
    threads: fixed per-replica hardware."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if threads and device == "cpu":
        env["OMP_NUM_THREADS"] = str(threads)
    if device is not None:
        args = [*args, "--device", device]
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch", *args, "--conf", conf],
            env=env, stdout=log, stderr=log)


def _get_json(port: int, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read() or b"null")


def _flush_cache(port: int) -> None:
    """Drop the router's result-cache entries (404 = cache off)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/admin/cache/flush", data=b"",
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            r.read()
    except urllib.error.HTTPError as e:
        e.read()


def _cache_stats(port: int):
    try:
        return _get_json(port, "/admin/cache")
    except urllib.error.HTTPError as e:
        e.read()
        return None


def _coalesce_burst_probe(port: int, user_ids: list[str],
                          burst: int, waves: int = 10) -> dict:
    """Single-flight measurement: per wave, ``burst`` IDENTICAL
    concurrent requests against a cold key — the leader scatters once
    and the followers must latch on (verdict ``coalesced``) or, having
    arrived after completion, hit the stored entry.  The per-cell
    evidence that a thundering herd on one hot key costs ONE device
    dispatch."""
    import threading as th
    tallies: dict[str, int] = {}
    lat: list[float] = []
    errors = 0
    _flush_cache(port)
    for w in range(waves):
        uid = user_ids[w % len(user_ids)]
        url = (f"http://127.0.0.1:{port}/recommend/{uid}"
               "?howMany=10&offset=1")  # offset: distinct from ladder keys
        results: list[tuple[int, str | None, float]] = []
        lock = th.Lock()
        barrier = th.Barrier(burst)

        def one():
            barrier.wait()
            t0 = time.monotonic()
            status, verdict = 0, None
            try:
                with urllib.request.urlopen(url, timeout=60) as r:
                    r.read()
                    status = r.status
                    verdict = r.headers.get("X-Oryx-Cache")
            except Exception:  # noqa: BLE001 — counted
                pass
            with lock:
                results.append((status, verdict,
                                (time.monotonic() - t0) * 1000.0))

        threads = [th.Thread(target=one, daemon=True)
                   for _ in range(burst)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90.0)
        for status, verdict, ms in results:
            if status != 200:
                errors += 1
                continue
            tallies[verdict or "unstamped"] = \
                tallies.get(verdict or "unstamped", 0) + 1
            lat.append(ms)
    out = {"burst": burst, "waves": waves, "errors": errors,
           "verdicts": tallies}
    if lat:
        out["p50_ms"] = round(float(np.percentile(lat, 50)), 1)
        out["p95_ms"] = round(float(np.percentile(lat, 95)), 1)
    return out


def _proc_threads(pid: int) -> int | None:
    """The process's live thread count from /proc — the per-rung
    telemetry that proves connections stopped costing stacks."""
    try:
        with open(f"/proc/{pid}/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("Threads:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        return None
    return None


def _connection_scale_probe(port: int, pid: int, user_ids: list[str],
                            connections: int,
                            duration_sec: float = 8.0,
                            hot_users: int = 32,
                            client_threads: int = 8) -> dict:
    """The C10K rung: ``connections`` concurrent keep-alive sockets
    all driving the cache-hit workload (a small hot user set, primed
    first), served round-robin by a few client threads — the client
    deliberately has FAR fewer threads than sockets, exactly like the
    server under test.  Records 200s/errors, the cached-hit latency
    split, the router's thread count at full connection load, and the
    open-socket count."""
    import socket as sock_mod
    import threading as th
    hot = user_ids[:hot_users]
    for uid in hot:
        _get_json(port, f"/recommend/{uid}?howMany=10")
    socks = []
    for _ in range(connections):
        s = sock_mod.create_connection(("127.0.0.1", port), timeout=30)
        s.setsockopt(sock_mod.IPPROTO_TCP, sock_mod.TCP_NODELAY, 1)
        socks.append((s, s.makefile("rb")))
    ok = [0]
    errors = [0]
    hit_lat: list[float] = []
    verdicts: dict[str, int] = {}
    lock = th.Lock()
    t_end = time.monotonic() + duration_sec
    threads_mid = [None]

    def worker(my: list) -> None:
        while time.monotonic() < t_end:
            for j, (s, rf) in enumerate(my):
                if time.monotonic() >= t_end:
                    return
                uid = hot[j % len(hot)]
                t0 = time.monotonic()
                try:
                    s.sendall(
                        f"GET /recommend/{uid}?howMany=10 HTTP/1.1"
                        "\r\nHost: a\r\n\r\n".encode("latin-1"))
                    status_line = rf.readline(65537)
                    status = int(status_line.split(b" ", 2)[1])
                    clen, verdict = 0, None
                    while True:
                        h = rf.readline(65537)
                        if h in (b"\r\n", b"\n", b""):
                            break
                        if h[:15].lower() == b"content-length:":
                            clen = int(h[15:])
                        elif h[:13].lower() == b"x-oryx-cache:":
                            verdict = h[13:].strip().decode("latin-1")
                    remaining = clen
                    while remaining:
                        got = rf.read(remaining)
                        if not got:
                            raise ConnectionError("short body")
                        remaining -= len(got)
                except Exception:  # noqa: BLE001 — counted
                    with lock:
                        errors[0] += 1
                    return
                ms = (time.monotonic() - t0) * 1000.0
                with lock:
                    if status == 200:
                        ok[0] += 1
                    else:
                        errors[0] += 1
                    if verdict:
                        verdicts[verdict] = verdicts.get(verdict, 0) + 1
                        if verdict == "hit":
                            hit_lat.append(ms)

    chunk = max(1, connections // client_threads)
    workers = [th.Thread(target=worker,
                         args=(socks[i:i + chunk],), daemon=True)
               for i in range(0, connections, chunk)]
    for w in workers:
        w.start()
    time.sleep(duration_sec / 2)
    threads_mid[0] = _proc_threads(pid)
    for w in workers:
        w.join(duration_sec + 60.0)
    out = {
        "connections": connections,
        "open_sockets": len(socks),
        "ok_200": ok[0],
        "errors": errors[0],
        "achieved_qps": round(ok[0] / duration_sec, 1),
        "open_loop_sustained_qps": round(ok[0] / duration_sec, 1)
        if errors[0] == 0 else 0.0,
        "router_threads_at_load": threads_mid[0],
        "verdicts": verdicts,
    }
    if hit_lat:
        out["hit_p50_ms"] = round(float(np.percentile(hit_lat, 50)), 3)
        out["hit_p99_ms"] = round(float(np.percentile(hit_lat, 99)), 3)
    for s, rf in socks:
        try:
            s.close()
        except OSError:
            pass
    return out


def _hedge_frame_probe(work_dir: str, broker_dir: str,
                       user_ids: list[str], extra_conf: dict,
                       shards: int, requests: int = 150,
                       device: str | None = None) -> dict:
    """Hedge-cost evidence on the framed transport: a dedicated
    hedge-EAGER router (hedge-after 1 ms, cache off) over the cell's
    live replicas — every slow-ish answer hedges, and the probe reads
    back how many hedges fired vs how many transport connections per
    replica exist.  The claim under test: hedges cost a frame, never a
    connection (sockets per replica stay 1 through the storm)."""
    port = _free_port()
    conf = os.path.join(work_dir, "hedge-probe-router.conf")
    _write_conf(conf, broker_dir, port, {
        **extra_conf,
        "oryx.cluster.transport.enabled": True,
        "oryx.cluster.hedge-after-ms": 1,
    })
    log_path = os.path.join(work_dir, "hedge-probe.log")
    proc = _spawn(["router"], conf, None, log_path, device)
    try:
        _await(lambda: _get_json(port, "/metrics")
               ["cluster"]["covered_shards"] == list(range(shards)),
               "hedge probe coverage")
        for i in range(requests):
            uid = user_ids[i % len(user_ids)]
            _get_json(port, f"/recommend/{uid}?howMany=10&hp={i}")
        m = _get_json(port, "/metrics")["cluster"]["scatter"]
        tp = m.get("transport") or {}
        contacted = len(tp.get("per_replica", {}))
        open_conns = tp.get("open_connections", 0)
        return {
            "requests": requests,
            "hedges": m.get("hedges"),
            "hedge_abandoned": m.get("hedge_abandoned"),
            "cancels_sent": tp.get("cancels_sent"),
            "transport_connections": open_conns,
            "replicas_contacted": contacted,
            # THE number: sockets per replica through the hedge storm
            # (1.0 = every hedge cost a frame, never a connection)
            "sockets_per_replica": round(open_conns / contacted, 2)
            if contacted else None,
        }
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


def _await(predicate, what: str, timeout: float = 300.0) -> None:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        try:
            if predicate():
                return
        except Exception:  # noqa: BLE001 — still coming up
            pass
        time.sleep(0.5)
    raise RuntimeError(f"timed out waiting for {what}")


def _get_json_retry_cold(port: int, path: str,
                         budget_sec: float = 180.0):
    """_get_json tolerating a COLD scoring path: the first dispatch a
    replica ever runs includes its route measurement and the kernel
    libraries' load, which can outlast the router's shard timeout — the router then
    reads the shard as down and answers 503 (or the direct call times
    out).  Those first-touch failures retry within the budget; any
    other status propagates immediately.  404 is cold too: /ready only
    means the HTTP stack is up — a replica mid-load answers 404 for a
    user its update consumer hasn't reached yet (at 1M+ items the
    replay outlasts boot by minutes)."""
    t_end = time.monotonic() + budget_sec
    while True:
        try:
            return _get_json(port, path, timeout=30.0)
        except urllib.error.HTTPError as e:
            e.read()
            if e.code not in (503, 404) or time.monotonic() >= t_end:
                raise
        except OSError:
            if time.monotonic() >= t_end:
                raise
        time.sleep(1.0)


def _probe_window(port: int, user_ids: list[str], rate_qps: float,
                  duration_sec: float, workers: int = 24) -> list[dict]:
    """Fixed-rate /recommend probe recording PER-RESPONSE verdicts —
    status, the X-Oryx-Partial marker, Retry-After, latency, and the
    completion time relative to probe start — the raw material for the
    kill-window availability fraction and the admission overload
    summary (the open-loop ladder driver only counts errors)."""
    import threading as th
    n = max(1, int(rate_qps * duration_sec))
    results: list[dict] = []
    lock = th.Lock()
    next_i = [0]
    t0 = time.monotonic()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                if i >= n:
                    return
                next_i[0] += 1
            scheduled = t0 + i / rate_qps
            now = time.monotonic()
            if scheduled > now:
                time.sleep(scheduled - now)
            sent = time.monotonic()
            uid = user_ids[i % len(user_ids)]
            url = (f"http://127.0.0.1:{port}/recommend/{uid}"
                   "?howMany=10")
            status, partial, retry_after = 0, False, None
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    r.read()
                    status = r.status
                    partial = r.headers.get("X-Oryx-Partial") is not None
            except urllib.error.HTTPError as e:
                status = e.code
                retry_after = e.headers.get("Retry-After")
                e.read()
            except Exception:  # noqa: BLE001 — transport failure
                status = 0
            done = time.monotonic()
            with lock:
                # ms is the REQUEST's own latency (send -> response),
                # not slip against the schedule: under deliberate
                # overload the probe's own workers starve, and a shed
                # 503's cost must not inherit that local queueing
                results.append({
                    "t": done - t0,
                    "ms": (done - sent) * 1000.0,
                    "status": status, "partial": partial,
                    "retry_after": retry_after})

    threads = [th.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def _kill_window_probe(router_port: int, user_ids: list[str],
                       rate_qps: float, pre_sec: float,
                       window_sec: float, kill_fn) -> dict:
    """Drive steady load, kill one replica-group member at ``pre_sec``,
    and report availability — the fraction of non-partial 200s — over
    the kill window (kill instant to probe end, TTL expiry included:
    hedged failover must hide the death even BEFORE age-out)."""
    import threading as th
    timer = th.Timer(pre_sec, kill_fn)
    timer.start()
    try:
        results = _probe_window(router_port, user_ids, rate_qps,
                                pre_sec + window_sec)
    finally:
        timer.cancel()  # no-op once fired
    window = [r for r in results if r["t"] >= pre_sec]
    ok = [r for r in window
          if r["status"] == 200 and not r["partial"]]
    return {
        "rate_qps": rate_qps,
        "window_requests": len(window),
        "ok_full": len(ok),
        "partials": sum(1 for r in window if r["partial"]),
        "errors": sum(1 for r in window
                      if r["status"] != 200),
        "availability": round(len(ok) / len(window), 4)
        if window else None,
    }


def _overload_probe(router_port: int, user_ids: list[str],
                    rate_qps: float, duration_sec: float) -> dict:
    """Drive the router well past its sustained ceiling with admission
    control armed: overload must degrade to FAST 503 + Retry-After,
    not the queueing collapse of the un-gated front end."""
    # worker pool must exceed the admission cap, or the probe itself
    # bounds inflight below the gate and nothing ever sheds
    results = _probe_window(router_port, user_ids, rate_qps,
                            duration_sec,
                            workers=min(256, max(128,
                                                 int(rate_qps * 1.5))))
    ok = [r for r in results if r["status"] == 200]
    shed = [r for r in results if r["status"] == 503]

    def _p50(rows):
        return round(float(np.percentile(
            [r["ms"] for r in rows], 50)), 1) if rows else None

    return {
        "offered_qps": rate_qps,
        "requests": len(results),
        "ok_200": len(ok),
        "shed_503": len(shed),
        "shed_fraction": round(len(shed) / len(results), 4)
        if results else None,
        "shed_with_retry_after": sum(
            1 for r in shed if r["retry_after"]),
        "other_errors": len(results) - len(ok) - len(shed),
        "p50_ok_ms": _p50(ok),
        # the whole point: a shed answer costs ~a round trip, not a
        # queue residence
        "p50_shed_ms": _p50(shed),
    }


def run_cell(replicas: int, items: int, features: int, users: int,
             rates: list[float], duration_sec: float,
             replica_threads: int, work_dir: str,
             broker_dir: str | None = None,
             user_ids: list[str] | None = None,
             device_ms_per_mrow: float = 0.0,
             spot_users: int = 20,
             tracing_sample: float | None = None,
             replicas_per_shard: int = 1,
             kill_member_probe: bool = False,
             admission: dict | None = None,
             overload_factor: float = 3.0,
             cache: bool = True,
             zipf: float = 0.0,
             coalesce_burst: int = 0,
             sharded_publish: int = 0,
             async_mode: bool = False,
             transport: bool = False,
             replica_cache: bool = False,
             connections: "list[int] | None" = None,
             device: str | None = None) -> dict:
    """One cell: ``replicas`` shards of ``replicas_per_shard`` members
    each and a router, spawned as processes on ``device`` (None means
    the CUDA card), then the ladder and the probes the options arm."""
    # without a card, fail here, not in the spawned replicas
    resolve_device(device)
    if device_ms_per_mrow > 0 and device != "cpu":
        raise ValueError("device emulation (--device-ms-per-mrow) is for "
                         "host runs only: on the card the scans are real")
    publish_s = 0.0
    if broker_dir is None:
        broker_dir = os.path.join(work_dir, f"broker-{replicas}")
        os.makedirs(broker_dir, exist_ok=True)
        t0 = time.time()
        user_ids = _publish_model(broker_dir, users, items, features,
                                  sharded=sharded_publish)
        publish_s = time.time() - t0

    procs: list[subprocess.Popen] = []
    # member grid: replicas shards x replicas_per_shard group members
    members = [(s, r) for s in range(replicas)
               for r in range(replicas_per_shard)]
    member_ports = {m: _free_port() for m in members}
    member_procs: dict[tuple[int, int], subprocess.Popen] = {}
    replica_ports = list(member_ports.values())
    router_port = _free_port()
    log_path = os.path.join(
        work_dir, f"cell-{replicas}x{replicas_per_shard}.log")
    # per-replica catalog slice: what the emulated device streams
    slice_rows = items / replicas
    try:
        # tracing enabled on every process when requested: the
        # overhead cell runs with a sample ratio low enough that the
        # measured delta is the UNsampled per-request branch cost
        obs_extra = {}
        if tracing_sample is not None:
            obs_extra = {
                "oryx.obs.tracing.enabled": True,
                "oryx.obs.tracing.sample-ratio": tracing_sample,
            }
        for s, r in members:
            conf = os.path.join(
                work_dir,
                f"replica-{replicas}x{replicas_per_shard}-{s}-{r}.conf")
            extra = {
                "oryx.cluster.enabled": True,
                "oryx.cluster.shard": f"{s}/{replicas}",
                "oryx.cluster.replica-id":
                    f"s{s}r{r}of{replicas}",
                **obs_extra,
            }
            if transport:
                # the framed internal hop: frame listener next to the
                # HTTP door, port advertised via the heartbeat
                extra["oryx.cluster.transport.enabled"] = True
            if replica_cache:
                extra["oryx.cluster.replica-cache.enabled"] = True
            if device_ms_per_mrow > 0:
                # fixed-rate accelerator emulation: each scoring
                # dispatch sleeps for the time a device streaming this
                # replica's slice would take (time ∝ rows — the
                # measured phase-A roofline shape), WITHOUT burning
                # host CPU.  On a shared CPU box this is the only
                # honest way to measure the GATEWAY's scaling: a real
                # deployment gives each replica its own accelerator,
                # while a co-located CPU "device" just splits the same
                # cores.  Staged through the standard fault registry.
                # max-batch gives the emulated device a finite
                # per-window capacity (a real device's window ladder
                # is bounded too); without it, unbounded coalescing
                # amortizes ANY fixed window cost away and the
                # measurement collapses back into host-CPU scheduling.
                # pipeline-depth 2 pins the batcher's in-flight cap
                # (one window executing + one queued — a double-
                # buffered device stream): the adaptive cap learns
                # from completion gaps that a sleep-emulated device
                # renders meaningless, and wherever it wanders the
                # cell's ceiling follows — two same-config runs
                # measured 1.8x apart.  Pinned, the emulated ceiling
                # is deterministic: pipeline x max-batch / delay.
                delay = device_ms_per_mrow * slice_rows / 1e6
                extra.update({
                    "oryx.serving.api.max-batch": 8,
                    "oryx.serving.api.scoring-pipeline-depth": 2,
                    "oryx.resilience.faults.serving-scan-dispatch"
                    ".mode": "delay",
                    "oryx.resilience.faults.serving-scan-dispatch"
                    ".times": -1,
                    "oryx.resilience.faults.serving-scan-dispatch"
                    ".delay-ms": round(delay, 3),
                })
            _write_conf(conf, broker_dir, member_ports[(s, r)], extra)
            proc = _spawn(["serving", "--shard", f"{s}/{replicas}"],
                          conf, replica_threads, log_path, device)
            procs.append(proc)
            member_procs[(s, r)] = proc
        conf = os.path.join(
            work_dir, f"router-{replicas}x{replicas_per_shard}.conf")
        router_extra = dict(obs_extra)
        if async_mode:
            # the C10K event-loop front end (--no-async runs the
            # threaded router)
            router_extra["oryx.cluster.async.enabled"] = True
        if transport:
            router_extra["oryx.cluster.transport.enabled"] = True
        if device_ms_per_mrow > 0:
            # hedge only on a genuine stall: the default 100 ms window
            # sits far BELOW an emulated cell's per-dispatch delay, so
            # with R-way groups nearly every request would hedge to a
            # sibling and the duplicated work erases the group's extra
            # capacity.  5x the dispatch delay sits past the queueing
            # tail a sustained rung produces (p50 ~2 windows) — the
            # production guidance of hedge-after ~ p95+.
            delay = device_ms_per_mrow * slice_rows / 1e6
            router_extra["oryx.cluster.hedge-after-ms"] = \
                max(1000, int(5 * delay))
        if admission:
            router_extra.update(admission)
        if cache:
            # the exact result cache + single-flight coalescing
            # (cluster/result_cache.py): armed for every rung — the
            # uniform ladder flushes before each rung so it stays a
            # miss-path (overhead) measurement, the Zipf rung lets the
            # hot-user hit rate build, the burst rung measures the
            # latch
            router_extra.update({
                "oryx.cluster.cache.enabled": True,
                "oryx.cluster.coalesce.enabled": True,
            })
        _write_conf(conf, broker_dir, router_port, router_extra)
        procs.append(_spawn(["router"], conf, None, log_path, device))

        def _loaded(port: int) -> bool:
            m = _get_json(port, "/shard/meta")
            # ready fires at the 80% load gate, with the user store
            # still filling (items stream first); the bench drives
            # real user ids, so wait for the full replay
            return bool(m.get("ready")) and m.get("users", 0) >= users

        t0 = time.time()
        _await(lambda: all(_loaded(p) for p in replica_ports),
               "replica model load", timeout=900.0)
        load_s = time.time() - t0
        # per-replica load telemetry (sharded model distribution):
        # each replica's own receipt-to-servable clock,
        # slice bytes read, and fallbacks — the evidence that a
        # slice-loaded fleet loads O(catalog/N) instead of replaying
        # the whole stream
        per_replica_load = []
        for p in replica_ports:
            g = _get_json(p, "/metrics").get("freshness", {})
            per_replica_load.append({
                "port": p,
                "model_load_s": g.get("model_load_s"),
                "model_slice_bytes": g.get("model_slice_bytes"),
                "slice_load_fallbacks": g.get("slice_load_fallbacks"),
            })
        loads = [r["model_load_s"] for r in per_replica_load
                 if r["model_load_s"]]
        model_load = {
            "mode": "slices" if sharded_publish > 0 else "replay",
            "slices": sharded_publish or None,
            "bench_wall_s": round(load_s, 1),
            "per_replica": per_replica_load,
            "max_replica_load_s": round(max(loads), 3) if loads else None,
            "fallbacks": sum(r["slice_load_fallbacks"] or 0
                             for r in per_replica_load),
        }
        _await(lambda: _get_json(router_port, "/metrics")
               ["cluster"]["covered_shards"] == list(range(replicas)),
               "router coverage")

        # correctness spot-check: router merge == exact merge of the
        # replicas' own /shard/recommend answers (one member per
        # shard — group siblings hold identical slices and would
        # double-count every row)
        spot_ports = [member_ports[(s, 0)] for s in range(replicas)]
        # first-touch scoring measures the route per process: warm
        # every member directly (so the router's first scatter never
        # sees a shard stuck in it and degrades to partial/503), then
        # one request through the router itself
        for p in member_ports.values():
            _get_json_retry_cold(
                p, f"/shard/recommend/{user_ids[0]}?howMany=10")
        _get_json_retry_cold(router_port,
                             f"/recommend/{user_ids[0]}?howMany=10")
        spot_ok = True
        for uid in user_ids[:spot_users]:
            got = [d["id"] for d in _get_json_retry_cold(
                router_port, f"/recommend/{uid}?howMany=10")]
            rows = []
            for p in spot_ports:
                payload = _get_json(p, f"/shard/recommend/{uid}"
                                       "?howMany=10")
                rows.extend(tuple(r) for r in payload["rows"])
            rows.sort(key=lambda r: (-r[1], r[2], r[0]))
            want = [r[0] for r in rows[:10]]
            if got != want:
                spot_ok = False
                break

        # warm-up burst: the batchers learn their windows (and the
        # router's connections open) before any rung is judged
        run_recommend_open_loop(
            f"http://127.0.0.1:{router_port}", user_ids, rate_qps=30,
            duration_sec=max(6.0, duration_sec), workers=64)

        def _run_ladder(flush_each_rung: bool, zipf_a=None,
                        cache_bust=False):
            """Walk the rate ladder to the highest sustained rung; one
            retry per rung absorbs a transient stall (a late compile,
            a heartbeat-file fsync burst) before the rung counts."""
            ladder, best = [], None
            for rate in rates:
                out = None
                for _attempt in range(2):
                    if flush_each_rung:
                        _flush_cache(router_port)
                    out = run_recommend_open_loop(
                        f"http://127.0.0.1:{router_port}", user_ids,
                        rate_qps=rate, duration_sec=duration_sec,
                        workers=min(256, max(64, int(rate))),
                        zipf_a=zipf_a, cache_bust=cache_bust)
                    if out["sustained"]:
                        break
                ladder.append(out)
                if out["sustained"]:
                    best = out
                else:
                    break
            return ladder, best

        # uniform COLD (miss-path) cell, comparable with pre-cache
        # rounds: every rung starts from an empty cache AND every
        # request carries a unique cache-busting arg — without it a
        # uniform draw repeats users within a rung (birthday effect)
        # and the accidental hits would inflate the gated cold number,
        # masking scatter-path regressions behind the cache
        ladder, best = _run_ladder(flush_each_rung=cache,
                                   cache_bust=cache)

        # hot-user Zipf rung (the result cache's design load): same
        # rate ladder, skewed user draw, NO flushes between rungs —
        # the hit rate builds exactly as production's would.  Headline
        # = sustained qps vs the cold cell + the cached-hit p50.
        zipf_report = None
        if cache and zipf > 0:
            _flush_cache(router_port)
            z_ladder, z_best = _run_ladder(flush_each_rung=False,
                                           zipf_a=zipf)
            zipf_report = {
                "a": zipf,
                "open_loop_sustained_qps":
                    z_best["achieved_qps"] if z_best else 0.0,
                "sustained_p50_ms": z_best["p50_ms"] if z_best else None,
                "cache": z_best.get("cache") if z_best else None,
                "admin_cache": _cache_stats(router_port),
                "ladder": z_ladder,
            }

        # single-flight burst rung: a thundering herd on one cold hot
        # key must collapse to one scatter
        burst_report = None
        if cache and coalesce_burst > 1:
            burst_report = _coalesce_burst_probe(
                router_port, user_ids, coalesce_burst)

        # connection-count rung ladder (C10K acceptance): C concurrent
        # keep-alive sockets on the cache-hit workload, with open-
        # socket and router-thread telemetry per rung — only
        # meaningful with the cache armed (hits are the workload)
        conns_report = None
        if cache and connections:
            router_pid = procs[-1].pid
            rungs = []
            for cnum in connections:
                rung = _connection_scale_probe(
                    router_port, router_pid, user_ids, cnum,
                    duration_sec=max(6.0, duration_sec))
                rungs.append(rung)
                print(json.dumps(rung), file=sys.stderr)
            top = rungs[-1]
            conns_report = {**top, "rungs": rungs,
                            "router_threads_idle":
                                _proc_threads(router_pid)}

        # hedge-cost probe (framed transport, replica groups only): a
        # dedicated hedge-eager router proves hedges cost a frame, not
        # a connection
        hedge_frames = None
        if transport and replicas_per_shard > 1:
            hedge_frames = _hedge_frame_probe(
                work_dir, broker_dir, user_ids, dict(obs_extra),
                replicas, device=device)
            print(json.dumps(hedge_frames), file=sys.stderr)
        if best and best.get("worst_sampled"):
            # worst sampled requests of the best rung: each trace id
            # names a recorded span tree on the router's /admin/traces
            print("worst-p99 sampled requests: " + ", ".join(
                f"{w['ms']}ms trace={w['trace']}"
                for w in best["worst_sampled"]), file=sys.stderr)
        m = _get_json(router_port, "/metrics")
        partials = m["counters"].get("partial_answers", 0)
        admission_stats = m["cluster"].get("admission")
        scatter_stats = m["cluster"].get("scatter")

        # overload rung FIRST (the cluster is still intact — a
        # post-kill group would bias shed fraction and latency): drive
        # well past the sustained ceiling with admission armed — the
        # shed fraction and its p50 are the measured "fast 503" story
        admission_overload = None
        if admission:
            base = best["achieved_qps"] if best else 50.0
            admission_overload = _overload_probe(
                router_port, user_ids, base * overload_factor,
                max(8.0, duration_sec))
            # let the admitted backlog (bounded by the inflight cap)
            # drain before the availability probe is judged
            time.sleep(6.0)

        # availability probe: kill one group member under steady load;
        # a 2-of-2 group must keep answering FULL (non-partial) 200s —
        # hedged failover before age-out, sibling-only routing after
        kill_probe = None
        if kill_member_probe and replicas_per_shard > 1:
            probe_rate = max(
                20.0, (best["achieved_qps"] if best else 40.0) * 0.5)
            victim = member_procs[(0, replicas_per_shard - 1)]
            kill_probe = _kill_window_probe(
                router_port, user_ids, probe_rate, pre_sec=3.0,
                window_sec=max(8.0, duration_sec),
                kill_fn=victim.kill)

        return {
            "replicas": replicas,
            "device": device or "cuda",
            "replicas_per_shard": replicas_per_shard,
            "items": items,
            "features": features,
            "users": users,
            "replica_threads": replica_threads,
            "tracing_sample": tracing_sample,
            "emulated_device_ms_per_mrow": device_ms_per_mrow,
            "emulated_dispatch_delay_ms":
                round(device_ms_per_mrow * slice_rows / 1e6, 3),
            "emulated_window_cap": (8 if device_ms_per_mrow > 0
                                    else None),
            "emulated_pipeline_depth": (2 if device_ms_per_mrow > 0
                                        else None),
            "publish_s": round(publish_s, 1),
            "model_load_s": round(load_s, 1),
            "model_load": model_load,
            "merge_spotcheck_ok": spot_ok,
            "partial_answers_during_run": partials,
            "open_loop_sustained_qps":
                best["achieved_qps"] if best else 0.0,
            "sustained_p50_ms": best["p50_ms"] if best else None,
            "sustained_p95_ms": best["p95_ms"] if best else None,
            "cache_armed": cache,
            "async_front_end": async_mode,
            "framed_transport": transport,
            "replica_cache_armed": replica_cache,
            "zipf": zipf_report,
            "coalesce_burst": burst_report,
            "conns": conns_report,
            "hedge_frames": hedge_frames,
            "cache_stats_after_run": _cache_stats(router_port),
            "kill_probe": kill_probe,
            "admission": admission or None,
            "admission_stats_after_ladder": admission_stats,
            "scatter_stats_after_ladder": scatter_stats,
            "admission_overload": admission_overload,
            "ladder": ladder,
        }
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def _measure_fleet_load(work_dir: str, broker_dir: str, shards: int,
                        replica_threads: int, tag: str,
                        device: str | None = None) -> dict:
    """Boot a ``shards``-way fleet against an already-published broker
    and measure spawn-to-all-ready wall clock plus each replica's own
    receipt-to-servable ``model_load_s`` gauge — the load-compare
    probe's one measurement."""
    procs, ports = [], []
    log_path = os.path.join(work_dir, f"load-{tag}.log")
    try:
        for s in range(shards):
            port = _free_port()
            conf = os.path.join(work_dir, f"load-{tag}-{s}.conf")
            _write_conf(conf, broker_dir, port, {
                "oryx.cluster.enabled": True,
                "oryx.cluster.shard": f"{s}/{shards}",
                "oryx.cluster.replica-id": f"load{tag}{s}",
            })
            procs.append(_spawn(["serving", "--shard", f"{s}/{shards}"],
                                conf, replica_threads, log_path, device))
            ports.append(port)
        t0 = time.time()
        _await(lambda: all(
            _get_json(p, "/shard/meta").get("ready")
            and _get_json(p, "/metrics").get(
                "model_fraction_loaded", 0) >= 1.0
            and _get_json(p, "/metrics").get(
                "freshness", {}).get("model_load_s", 0) > 0
            for p in ports), f"load probe {tag}", timeout=900.0)
        wall = time.time() - t0
        out = {"wall_s": round(wall, 1), "per_replica": []}
        for p in ports:
            g = _get_json(p, "/metrics").get("freshness", {})
            out["per_replica"].append({
                "model_load_s": g.get("model_load_s"),
                "model_slice_bytes": g.get("model_slice_bytes"),
                "slice_load_fallbacks": g.get("slice_load_fallbacks"),
            })
        loads = [r["model_load_s"] for r in out["per_replica"]
                 if r["model_load_s"]]
        out["max_replica_load_s"] = round(max(loads), 3) if loads else None
        return out
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def run_load_compare(work_dir: str, items: int, features: int,
                     users: int, shards: int, replica_threads: int,
                     sharded: int, device: str | None = None) -> dict:
    """The O(catalog/N) load measurement: the SAME catalog published both ways — full-stream replay vs sharded
    manifest — loaded by the same ``shards``-way fleet.  Reports both
    spawn-to-ready wall clocks and the replicas' own
    receipt-to-servable clocks, plus their ratio (target: sliced ≤ 60%
    of replay at 2 shards)."""
    replay_dir = os.path.join(work_dir, "load-replay-broker")
    sliced_dir = os.path.join(work_dir, "load-sliced-broker")
    _publish_model(replay_dir, users, items, features)
    _publish_model(sliced_dir, users, items, features, sharded=sharded)
    replay = _measure_fleet_load(work_dir, replay_dir, shards,
                                 replica_threads, "replay", device)
    sliced = _measure_fleet_load(work_dir, sliced_dir, shards,
                                 replica_threads, "sliced", device)
    out = {"items": items, "features": features, "shards": shards,
           "slices": sharded, "replay": replay, "sliced": sliced}
    if replay["max_replica_load_s"] and sliced["max_replica_load_s"]:
        out["replica_load_ratio"] = round(
            sliced["max_replica_load_s"] / replay["max_replica_load_s"],
            3)
    if replay["wall_s"]:
        out["wall_ratio"] = round(sliced["wall_s"] / replay["wall_s"], 3)
    return out




def _card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them (None
    without one)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", default="1,2,4",
                    help="comma list of replica counts")
    ap.add_argument("--items", type=int, default=524288,
                    help="catalog size; the default keeps every cell "
                         "(full, half, quarter catalog per replica) on "
                         "the same flat scan kernel family")
    ap.add_argument("--features", type=int, default=129,
                    help="129: the per-window scan cost of a wide model "
                         "at roughly half the publish bytes of 250")
    ap.add_argument("--users", type=int, default=1000)
    ap.add_argument("--rates", default="",
                    help="explicit comma rate ladder (default: "
                         "geometric from 20)")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="where every replica scans (default: the CUDA "
                         "card; 'cpu' runs the cluster on the host)")
    ap.add_argument("--replica-threads", type=int, default=1,
                    help="torch threads per replica on the host (fixed "
                         "per-replica hardware; --device cpu only)")
    ap.add_argument("--device-ms-per-mrow", type=float, default=0.0,
                    help="host runs only: emulate a fixed-rate "
                         "per-replica accelerator — every scoring "
                         "dispatch sleeps this many ms per million "
                         "catalog rows in the replica's slice.  0 = off")
    ap.add_argument("--tracing-sample", type=float, default=None,
                    help="enable oryx.obs tracing on every process at "
                         "this sample ratio.  Default: tracing off")
    ap.add_argument("--replicas-per-shard", default="1",
                    help="comma list of group sizes R: each (replicas, "
                         "R) pair is a cell with R serving processes "
                         "per shard announcing the same (shard, of)")
    ap.add_argument("--cells", default="",
                    help="explicit comma list of NxR cells (e.g. "
                         "1x1,1x2,2x1), overriding the "
                         "--replicas x --replicas-per-shard product")
    ap.add_argument("--kill-probe", action="store_true",
                    help="in every R>1 cell, kill one group member "
                         "under steady load after the ladder and "
                         "record the kill-window availability")
    ap.add_argument("--admission-max-inflight", type=int, default=0,
                    help="arm the router's admission hard cap on "
                         "concurrent data-plane requests (0 = off)")
    ap.add_argument("--admission-queue-wait-ms", type=int, default=0,
                    help="arm the router's measured-queue-wait shed "
                         "threshold in ms (0 = off)")
    ap.add_argument("--overload-factor", type=float, default=3.0,
                    help="overload rung rate = this x the cell's best "
                         "sustained qps (only when admission is armed)")
    ap.add_argument("--admission-cells", default="",
                    help="comma list of NxR cells to arm admission in "
                         "(default: every cell when the admission flags "
                         "are set)")
    ap.add_argument("--cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="arm the router's exact result cache and "
                         "single-flight coalescing; the uniform ladder "
                         "flushes before every rung and cache-busts "
                         "every request, so it stays a miss-path cell")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="hot-user Zipf rung: rerun the rate ladder "
                         "with user picks drawn as 1/rank^a, the hit "
                         "rate building across rungs.  0 = off")
    ap.add_argument("--coalesce-burst", type=int, default=0,
                    help="single-flight rung: waves of this many "
                         "identical concurrent requests against a cold "
                         "key.  0 = off")
    ap.add_argument("--async", dest="async_mode",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="run the router on the asyncio front end "
                         "(oryx.cluster.async.enabled)")
    ap.add_argument("--transport",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="run the internal hop on the multiplexed "
                         "framed transport; --no-transport uses the "
                         "HTTP/1.1 socket pool")
    ap.add_argument("--replica-cache",
                    action=argparse.BooleanOptionalAction,
                    default=False,
                    help="arm the replica-side result cache on every "
                         "replica")
    ap.add_argument("--connections", default="",
                    help="comma ladder of concurrent keep-alive socket "
                         "counts driving the cache-hit workload.  "
                         "Empty = off")
    ap.add_argument("--sharded-publish", type=int, default=24,
                    help="publish the model as this many murmur2 slices "
                         "and a manifest-carrying MODEL-REF.  0 = the "
                         "full-stream replay publish")
    ap.add_argument("--load-compare", type=int, default=0,
                    help="before the cells, publish the catalog both "
                         "ways and boot this many shards against each.  "
                         "0 = off")
    # the reference's options that wait for a later part of this package
    ap.add_argument("--regions", type=int, default=1,
                    help="2 = the two-region mirror probe (not part of "
                         "this package yet)")
    ap.add_argument("--write-heavy", action="store_true",
                    help="the durable-ack write rung (not part of this "
                         "package yet)")
    ap.add_argument("--ann", action="store_true",
                    help="the IVF-ANN rung (not part of this package "
                         "yet)")
    ap.add_argument("--out", default="BENCH_TORCH_GATEWAY.json")
    ap.add_argument("--keep-work", action="store_true")
    args = ap.parse_args(argv)
    for flag, on in (("--regions", args.regions > 1),
                     ("--write-heavy", args.write_heavy),
                     ("--ann", args.ann)):
        if on:
            print(f"gateway: {flag}: {DEFERRED_FLAGS[flag]} is not part "
                  f"of this package yet", file=sys.stderr)
            return 2
    if args.device_ms_per_mrow > 0 and args.device != "cpu":
        ap.error("--device-ms-per-mrow is for --device cpu runs only")
    resolve_device(args.device)

    if args.rates:
        rates = [float(r) for r in args.rates.split(",")]
    else:
        rates, r = [], 20.0
        while r <= 4000.0:
            rates.append(round(r))
            r *= 1.35

    work_dir = tempfile.mkdtemp(prefix="oryx-gw-bench-")
    rows = []
    try:
        # one shared broker and model stream: every cell's replicas load
        # the identical topic (cells run one after another; a dead
        # cell's heartbeats age out past the TTL)
        load_compare = None
        if args.load_compare > 0:
            print("== load-compare probe (replay vs sliced) ==",
                  file=sys.stderr)
            load_compare = run_load_compare(
                work_dir, args.items, args.features, args.users,
                args.load_compare, args.replica_threads,
                args.sharded_publish or 24, args.device)
            print(json.dumps(load_compare), file=sys.stderr)
        broker_dir = os.path.join(work_dir, "broker")
        os.makedirs(broker_dir, exist_ok=True)
        t0 = time.time()
        user_ids = _publish_model(broker_dir, args.users, args.items,
                                  args.features,
                                  sharded=args.sharded_publish)
        publish_s = round(time.time() - t0, 1)
        print(f"== published model stream in {publish_s}s ==",
              file=sys.stderr)
        admission = {}
        if args.admission_max_inflight > 0:
            admission["oryx.cluster.admission.max-inflight"] = \
                args.admission_max_inflight
        if args.admission_queue_wait_ms > 0:
            admission["oryx.cluster.admission.queue-wait-high-ms"] = \
                args.admission_queue_wait_ms
        if args.cells:
            cells = [tuple(int(v) for v in c.split("x"))
                     for c in args.cells.split(",") if c]
        else:
            group_sizes = [int(x) for x in
                           args.replicas_per_shard.split(",") if x]
            cells = [(n, rps)
                     for n in [int(x) for x in
                               args.replicas.split(",") if x]
                     for rps in group_sizes]
        admission_cells = {
            tuple(int(v) for v in c.split("x"))
            for c in args.admission_cells.split(",") if c}
        for n, rps in cells:
            print(f"== cell: {n} shard(s) x {rps} member(s) ==",
                  file=sys.stderr)
            cell_admission = admission or None
            if admission_cells and (n, rps) not in admission_cells:
                cell_admission = None
            row = run_cell(
                n, args.items, args.features, args.users, rates,
                args.duration, args.replica_threads, work_dir,
                broker_dir=broker_dir, user_ids=user_ids,
                device_ms_per_mrow=args.device_ms_per_mrow,
                tracing_sample=args.tracing_sample,
                replicas_per_shard=rps,
                kill_member_probe=args.kill_probe,
                admission=cell_admission,
                overload_factor=args.overload_factor,
                cache=args.cache,
                zipf=args.zipf,
                coalesce_burst=args.coalesce_burst,
                sharded_publish=args.sharded_publish,
                async_mode=args.async_mode,
                transport=args.transport,
                replica_cache=args.replica_cache,
                connections=[int(x) for x in
                             args.connections.split(",") if x],
                device=args.device)
            row["publish_s"] = publish_s
            rows.append(row)
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "ladder"}), file=sys.stderr)
    finally:
        if not args.keep_work:
            shutil.rmtree(work_dir, ignore_errors=True)

    # the shard-scaling summary compares like-for-like R=1 cells only;
    # replica groups add availability, not shard scaling
    by_n = {r["replicas"]: r["open_loop_sustained_qps"]
            for r in rows if r["replicas_per_shard"] == 1}
    report = {
        "metric": "gateway_recommend_scaling",
        "cache_armed": args.cache,
        "async_front_end": args.async_mode,
        "framed_transport": args.transport,
        "replica_cache_armed": args.replica_cache,
        "connections": args.connections or None,
        "sharded_publish": args.sharded_publish or None,
        "load_compare": load_compare,
        "regions": args.regions,
        "mirror_probe": None,
        "write_probe": None,
        "ann_probe": None,
        "zipf_a": args.zipf or None,
        "tracing_sample": args.tracing_sample,
        "emulated_device_ms_per_mrow": args.device_ms_per_mrow,
        "backend": "cpu" if args.device == "cpu" else "cuda",
        "card": None if args.device == "cpu" else _card(),
        "host_cpus": os.cpu_count(),
        "rows": rows,
        "scaling_vs_1": {
            str(n): round(q / by_n[1], 2)
            for n, q in sorted(by_n.items()) if 1 in by_n and by_n[1]},
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
