"""Smoke run of the PyTorch port (``oryx_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero
without a card, outside a checkout, or when any phase fails.  Phases:

1. Build the hand-written kernels from the sources in the checkout
   (timed), print the card's name and power limit, and check that float32
   matmuls run without TF32.
2. Hold the phase-A kernel against its plain PyTorch version at the
   serving shapes: 5,111,808 rows (the store capacity of 5M items) x 250
   features padded to 256, windows of 8, 32 and 256 queries, float32 and
   bfloat16 stores, exact, and with LSH on a 1M-item store.  Each case
   prints one JSON line with the kernel's time, the plain version's, a
   PyTorch-library yardstick's, the bound and the error.  Block maxima
   must agree within rtol 1e-5 (float32) or 1e-4 (bfloat16) plus the
   same figure as an absolute tolerance in score units, for maxima near
   0; the -inf pattern must be identical and no NaN may appear.
3. Time one served window at each ladder size (``top_n_batch`` end to
   end, its phase A and its phase B), then serve a 5M x 250 float32 model
   over HTTP through the port's HttpApp + TopNBatcher +
   StaticModelManager: one untimed round of concurrent /recommend,
   /recommendToMany and considerKnownItems requests, then the same round
   timed, every answer checked against the same model's two-phase top-k
   computed here with the kernel's plain version in its place (and a few
   against the exact scan).  The kernel's launch count, set to 0 before
   the timed round, must rise during it.
4. The same at 5M x 250 bfloat16 and at 1M x 250 float32 with LSH at
   sample rate 0.3, with fewer requests.

The line before the last is a JSON ``{"kernels": [...]}`` summary; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import gc
import http.client
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261017
FEATURES = 250
N_ITEMS = 5_000_000
N_LSH_ITEMS = 1_000_000
LSH_RATE = 0.3
N_USERS = 1000
KNOWN_PER_USER = 9
WINDOWS = (8, 32, 256)
REPS = 10
DEVICE = "cuda"
# float32: summation order only; bfloat16: the certificate's own margin
RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
# (HBM bytes/s, FP32 CUDA-core FLOP/s, bf16 dense tensor-core FLOP/s),
# NVIDIA's data sheets for the SXM parts
PEAKS = {"H200": (4.8e12, 67e12, 989e12), "H100": (3.35e12, 67e12, 989e12)}
PHASE_A_REPLACES = "oryx_tpu/app/als/serving_model.py:314"


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def peaks(name: str) -> tuple[float, float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def time_ms(torch, fn) -> float:
    """Median of REPS timed calls (CUDA events) after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def build_model(Y, X, known, dtype, sample_rate=1.0):
    from oryx_tpu_torch.convert import serving_model_from_arrays
    t0 = time.perf_counter()
    model = serving_model_from_arrays(
        FEATURES, True, x_ids=[f"u{u}" for u in range(len(X))], X=X,
        y_ids=[f"i{j}" for j in range(len(Y))], Y=Y, known_items=known,
        sample_rate=sample_rate, dtype=dtype, device=DEVICE)
    vecs, _ = model.Y.device_arrays()
    model.X.device_arrays()
    import torch
    torch.cuda.synchronize()
    log({"phase": "model", "items": len(Y), "dtype": dtype,
         "sample_rate": sample_rate, "rows": int(vecs.shape[0]),
         "width": int(vecs.shape[1]),
         "load_s": time.perf_counter() - t0})
    return model


# -- phase 2: the kernel against its plain version ---------------------------

def kernel_cases(model, rng, gpu_name, lsh: bool, stores) -> list[dict]:
    """Every (store dtype, window) case on this model's snapshot: the
    store's own retired rows (its padding past the last item) plus every
    11th row retired, and the last eighth of each window zero, as a
    window padded past its requests is."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.app.als.lsh import _popcount
    from oryx_tpu_torch.ops import phase_a as pa

    bw, fp32_rate, bf16_rate = peaks(gpu_name)
    vecs, active, version = model.Y.device_arrays_versioned()
    n, width = vecs.shape
    live = active.clone()
    live[::11] = False
    pen = sm._penalty_kernel(live, pa.BLOCK_ROWS).contiguous()
    buckets = target_of = None
    mb = 0
    if lsh:
        buckets = model._cached_buckets(vecs, version)
        hp = model.lsh._device_hyperplanes()
        mb = model.lsh.max_bits_differing
        target_of = lambda Q: sm._query_buckets(Q, hp)  # noqa: E731
    out = []
    for dtype in stores:
        Y = vecs if vecs.dtype == dtype else vecs.to(dtype)
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        for b in WINDOWS:
            q = rng.standard_normal((b, FEATURES), dtype=np.float32)
            zero = b // 8
            q[b - zero:] = 0.0
            Q = torch.from_numpy(q).to(DEVICE)
            Qc = sm._q_cast(Q, Y).contiguous()
            tgt = target_of(Q) if lsh else None
            M = pa.phase_a(Qc, Y, pen, buckets, tgt, mb)
            R = pa.phase_a_reference(Qc, Y, pen, buckets, tgt, mb)
            torch.cuda.synchronize()
            fin = torch.isfinite(R)
            check(bool((torch.isfinite(M) == fin).all()),
                  f"{name} B={b}: -inf pattern differs from the plain "
                  "version")
            check(not bool(torch.isnan(M).any()), f"{name} B={b}: NaN")
            diff = (M[fin] - R[fin]).abs()
            rtol = RTOL[name]
            check(bool((diff <= rtol * R[fin].abs() + rtol).all()),
                  f"{name} B={b}: block maxima beyond rtol {rtol}")
            check(bool((M[b - zero:][torch.isfinite(M[b - zero:])]
                        == 0).all()), f"{name} B={b}: zero query != 0")
            max_abs = float(diff.max()) if diff.numel() else 0.0
            max_rel = float((diff / R[fin].abs().clamp_min(1e-30)).max()) \
                if diff.numel() else 0.0
            ms = time_ms(torch, lambda: pa.phase_a(Qc, Y, pen, buckets, tgt,
                                                   mb))
            plain_ms = time_ms(torch, lambda: pa.phase_a_reference(
                Qc, Y, pen, buckets, tgt, mb))
            flat_pen = pen.view(-1)

            def library():
                s = torch.matmul(Qc, Y.T).float() + flat_pen
                if lsh:
                    ok = _popcount(buckets[None, :] ^ tgt[:, None]) <= mb
                    s = torch.where(ok, s, float("-inf"))
                return s.view(b, -1, pa.BLOCK_ROWS).amax(-1)

            library_ms = time_ms(torch, library)
            nbytes = (Y.numel() * Y.element_size()
                      + Qc.numel() * Qc.element_size() + pen.numel() * 4
                      + b * (n // pa.BLOCK_ROWS) * 4
                      + (buckets.numel() * 4 + b * 4 if lsh else 0))
            ops = 2.0 * n * FEATURES * b
            t_bytes = nbytes / bw * 1e3
            t_ops = ops / (bf16_rate if name == "bfloat16"
                           else fp32_rate) * 1e3
            case = {"phase": "kernel", "kernel": "phase_a", "store": name,
                    "lsh": lsh, "rows": n, "features": FEATURES,
                    "width": width, "B": b, "zero_queries": zero,
                    "retired_rows": int((~live).sum()),
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "bytes": nbytes, "ops": ops,
                    "max_abs_err": max_abs, "max_rel_err": max_rel}
            log(case)
            out.append(case)
            del M, R, diff
        del Y
    torch.cuda.empty_cache()
    return out


# -- phases 3 and 4: the served path -----------------------------------------

def reference_top_n_batch(model, how_many: int, Q: np.ndarray,
                          excl: list[set[str]]):
    """The model's streaming two-phase top-k with the phase-A kernel's
    plain version in its place: same windows' worth of queries, same
    phase B, same certificate fallback, same decode."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.ops.phase_a import phase_a_reference

    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    hm = [how_many] * len(Q)
    k = min(sm._pad_k(max(h + len(e) for h, e in zip(hm, excl))), n_rows)
    big, chunk = sm._stream_plan(n_rows, 8)
    check(big and n_rows % chunk == 0, "model is on the streaming path")
    bs = sm._BLOCK_ROWS
    ksel = min(sm._BLOCK_KSEL, n_rows // bs)
    lsh_on = model._lsh_active()
    buckets = model._cached_buckets(vecs, version) if lsh_on else None
    hp = model.lsh._device_hyperplanes() if lsh_on else None
    mb = model.lsh.max_bits_differing if lsh_on else 0
    pen = sm._penalty_kernel(active, bs)
    Qd = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(DEVICE)
    Qc = sm._q_cast(Qd, vecs).contiguous()
    target = sm._query_buckets(Qd, hp) if lsh_on else None
    M = phase_a_reference(Qc, vecs, pen, buckets, target, mb, bs)
    ts, ti, cert = sm._phase_b(vecs, Qc, active, buckets, target, M, k, bs,
                               ksel, mb)
    fallbacks = int((~cert).sum())
    if fallbacks:
        ts, ti = sm._batch_top_n_chunked_kernel(vecs, Qd, active, buckets,
                                                hp, k, chunk, mb)
    return model._decode_top_n(ts.cpu().numpy(), ti.cpu().numpy(), hm, excl,
                               len(Q), k < n_rows, Q, True), fallbacks


def exact_top_n(model, how_many: int, Q: np.ndarray, excl):
    """Exact chunked scan, no two-phase selection: the oracle."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    k = min(sm._pad_k(max(how_many + len(e) for e in excl)), n_rows)
    _, chunk = sm._stream_plan(n_rows, 8)
    lsh_on = model._lsh_active()
    buckets = model._cached_buckets(vecs, version) if lsh_on else None
    hp = model.lsh._device_hyperplanes() if lsh_on else None
    mb = model.lsh.max_bits_differing if lsh_on else 0
    Qd = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(DEVICE)
    ts, ti = sm._batch_top_n_chunked_kernel(vecs, Qd, active, buckets, hp,
                                            k, chunk, mb)
    return model._decode_top_n(ts.cpu().numpy(), ti.cpu().numpy(),
                               [how_many] * len(Q), excl, len(Q),
                               k < n_rows, Q, True)


def same_answers(got, want, rtol: float, what: str) -> None:
    check([i for i, _ in got] == [i for i, _ in want],
          f"{what}: ids {[i for i, _ in got]} != {[i for i, _ in want]}")
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=rtol, err_msg=what)


def serve_and_check(model, label: str, n_recommend: int, n_many: int,
                    n_consider: int, rtol: float, n_exact: int) -> dict:
    import torch
    from oryx_tpu_torch.bench.load import StaticModelManager
    from oryx_tpu_torch.lambda_rt.http import HttpApp, make_server
    from oryx_tpu_torch.ops import phase_a as pa
    from oryx_tpu_torch.serving import als as als_routes
    from oryx_tpu_torch.serving import framework
    from oryx_tpu_torch.serving.batcher import TopNBatcher

    class Manager(StaticModelManager):
        pass

    Manager.model = model
    batcher = TopNBatcher()
    app = HttpApp(framework.ROUTES + als_routes.ROUTES,
                  context={"model_manager": Manager(),
                           "input_producer": None, "config": None,
                           "min_model_load_fraction": 0.0,
                           "top_n_batcher": batcher},
                  read_only=True)
    server = make_server(app, 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    requests = [(f"/recommend/u{u}?howMany=10", [f"u{u}"], False)
                for u in range(n_recommend)]
    requests += [(f"/recommendToMany/u{u}/u{u + 1}/u{u + 2}?howMany=10",
                  [f"u{u}", f"u{u + 1}", f"u{u + 2}"], False)
                 for u in range(100, 100 + 3 * n_many, 3)]
    requests += [(f"/recommend/u{u}?howMany=10&considerKnownItems=true",
                  [f"u{u}"], True) for u in range(500, 500 + n_consider)]

    def fetch(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            t0 = time.perf_counter()
            conn.request("GET", path, headers={"Accept": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            return resp.status, body, (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()

    try:
        status, _, _ = fetch("/ready")
        check(status == 204, f"{label}: /ready gave {status}")
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            # one untimed round first: the batcher learns its pacing
            # from completed dispatches, and until then it lets every
            # dispatcher thread take a request of its own
            for path, (status, body, _) in zip(
                    [r[0] for r in requests],
                    pool.map(fetch, [r[0] for r in requests])):
                check(status == 200, f"{label}: warm-up {path} gave "
                      f"{status}: {body[:300]}")
            torch.cuda.synchronize()
            drains0 = len(batcher.batch_sizes)
            pa.LAUNCHES = 0
            t0 = time.perf_counter()
            results = list(pool.map(fetch, [r[0] for r in requests]))
            wall = time.perf_counter() - t0
            launches = pa.LAUNCHES
        sizes = batcher.batch_sizes[drains0:]
        stats = batcher.stats()
        status, _, _ = fetch("/recommend/nobody")
        check(status == 404, f"{label}: unknown user gave {status}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(30)

    for (path, _, _), (status, body, _) in zip(requests, results):
        check(status == 200, f"{label}: {path} gave {status}: {body[:300]}")
    check(launches > 0, f"{label}: phase-A kernel launched no time")

    # the answers the same model gives with the kernel's plain version
    Q, excl = [], []
    for _, users, consider in requests:
        Q.append(np.mean([model.get_user_vector(u) for u in users], axis=0))
        excl.append(set() if consider else
                    set().union(*(model.get_known_items(u) for u in users)))
    Q = np.asarray(Q, np.float32)
    want, ref_fallbacks = reference_top_n_batch(model, 10, Q, excl)
    for (path, _, _), (_, body, _), w in zip(requests, results, want):
        got = [(d["id"], d["value"]) for d in json.loads(body)]
        check(len(got) == 10, f"{label}: {path} gave {len(got)} items")
        check(all(np.isfinite(v) for _, v in got), f"{label}: non-finite")
        same_answers(got, w, rtol, f"{label} {path}")
    exact = exact_top_n(model, 10, Q[:n_exact], excl[:n_exact])
    for w, e in zip(want[:n_exact], exact):
        same_answers(w, e, 1e-5, f"{label} exact scan")

    lat = sorted(r[2] for r in results)
    summary = {"phase": "serve", "config": label,
               "requests": len(requests), "concurrency": 32,
               "phase_a_launches": launches,
               "batcher_dispatches": len(sizes),
               "mean_batch": float(np.mean(sizes)),
               "queue_wait_ms": stats["queue_wait_ms"],
               "service_time_ms": stats["service_time_ms"],
               "twophase_fallbacks": model.twophase_fallbacks,
               "reference_fallbacks": ref_fallbacks,
               "qps": len(requests) / wall,
               "p50_ms": lat[len(lat) // 2],
               "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
               "max_ms": lat[-1]}
    log(summary)
    return summary


def window_times(model, rng, label: str) -> list[dict]:
    """One served window at each ladder size: ``top_n_batch`` end to
    end (host clock around a synchronised call), and its phase A
    (kernel) and phase B alone (CUDA events) on the same queries."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.ops import phase_a as pa

    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    lsh_on = model._lsh_active()
    buckets = model._cached_buckets(vecs, version) if lsh_on else None
    hp = model.lsh._device_hyperplanes() if lsh_on else None
    mb = model.lsh.max_bits_differing if lsh_on else 0
    pen = model._cached_penalty(active, version)
    bs, k = sm._BLOCK_ROWS, sm._pad_k(10)
    ksel = min(sm._BLOCK_KSEL, n_rows // bs)
    out = []
    for b in WINDOWS:
        q = rng.standard_normal((b, FEATURES), dtype=np.float32)
        fb0 = model.twophase_fallbacks

        def served():
            model.top_n_batch(10, q)
            torch.cuda.synchronize()

        for _ in range(2):
            served()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            served()
            walls.append((time.perf_counter() - t0) * 1e3)
        Q = torch.from_numpy(q).to(DEVICE)
        Qc = sm._q_cast(Q, vecs).contiguous()
        tgt = sm._query_buckets(Q, hp) if lsh_on else None
        M = pa.phase_a(Qc, vecs, pen, buckets, tgt, mb)
        row = {"phase": "window", "config": label, "B": b,
               "top_n_batch_ms": statistics.median(walls),
               "phase_a_ms": time_ms(torch, lambda: pa.phase_a(
                   Qc, vecs, pen, buckets, tgt, mb)),
               "phase_b_ms": time_ms(torch, lambda: sm._phase_b(
                   vecs, Qc, active, buckets, tgt, M, k, bs, ksel, mb)),
               "fallback_rows": model.twophase_fallbacks - fb0}
        log(row)
        out.append(row)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from oryx_tpu_torch.ops import cuda_build
    from oryx_tpu_torch.ops import phase_a as pa

    # phase 1: environment and build
    log(gpu_line())
    gpu_name = torch.cuda.get_device_name(0)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    t0 = time.perf_counter()
    pa.build()
    log({"phase": "build", "kernels": ["phase_a"],
         "build_s": time.perf_counter() - t0,
         "python": sys.version.split()[0], "torch": torch.__version__,
         "cuda": torch.version.cuda})
    for name, text in cuda_build.LOGS.items():
        print(f"--- {name}\n{text}", file=sys.stderr)

    rng = np.random.default_rng(SEED)
    Y = rng.standard_normal((N_ITEMS, FEATURES), dtype=np.float32)
    X = rng.standard_normal((N_USERS, FEATURES), dtype=np.float32)
    known = {f"u{u}": [f"i{j}" for j in rng.integers(0, N_ITEMS,
                                                     KNOWN_PER_USER)]
             for u in range(N_USERS)}
    cases = []
    serves = {}

    # 5M x 250 float32: kernel cases, then the main served path
    model = build_model(Y, X, known, "float32")
    cases += kernel_cases(model, rng, gpu_name, False, [torch.float32])
    window_times(model, rng, "5M_f32_exact")
    serves["5M_f32_exact"] = serve_and_check(model, "5M_f32_exact", 64, 8,
                                             8, RTOL["float32"], 8)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 5M x 250 bfloat16
    model = build_model(Y, X, known, "bfloat16")
    cases += kernel_cases(model, rng, gpu_name, False, [torch.bfloat16])
    window_times(model, rng, "5M_bf16_exact")
    serves["5M_bf16_exact"] = serve_and_check(model, "5M_bf16_exact", 32, 4,
                                              4, RTOL["bfloat16"], 4)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 1M x 250 float32 with LSH at 0.3; kernel cases for both stores
    known_lsh = {u: [f"i{int(i[1:]) % N_LSH_ITEMS}" for i in items]
                 for u, items in known.items()}
    model = build_model(Y[:N_LSH_ITEMS], X, known_lsh, "float32",
                        sample_rate=LSH_RATE)
    cases += kernel_cases(model, rng, gpu_name, True,
                          [torch.float32, torch.bfloat16])
    window_times(model, rng, "1M_f32_lsh0.3")
    serves["1M_f32_lsh0.3"] = serve_and_check(model, "1M_f32_lsh0.3", 32, 4,
                                              4, RTOL["float32"], 4)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    head = next(c for c in cases if c["store"] == "float32"
                and not c["lsh"] and c["B"] == 256)
    log({"kernels": [{
        "name": "phase_a", "route": "cuda",
        "source": "oryx_tpu_torch/csrc/phase_a.cu",
        "replaces": PHASE_A_REPLACES,
        "launches": serves["5M_f32_exact"]["phase_a_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {"rows": head["rows"], "width": head["width"],
                  "features": FEATURES, "B": head["B"],
                  "store": "float32"}}]})
    log({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
