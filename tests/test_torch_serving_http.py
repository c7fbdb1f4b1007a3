"""The same model served over HTTP by two bench-style stacks — the
reference package's HttpApp + TopNBatcher + StaticModelManager and the
port's — answers /recommend, /recommendToMany and /knownItems alike."""

import concurrent.futures
import http.client
import json
import threading

import numpy as np
import pytest

from oryx_tpu.app.als import serving_model as jsm
from oryx_tpu.bench import load as jload
from oryx_tpu.lambda_rt import http as jhttp
from oryx_tpu.serving import als as jals
from oryx_tpu.serving import batcher as jbatcher
from oryx_tpu.serving import framework as jframework
from oryx_tpu_torch.app.als import serving_model as tsm
from oryx_tpu_torch.bench import load as tload
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.convert import serving_model_from_arrays
from oryx_tpu_torch.lambda_rt import http as thttp
from oryx_tpu_torch.serving import als as tals
from oryx_tpu_torch.serving import batcher as tbatcher
from oryx_tpu_torch.serving import framework as tframework

N_ITEMS, N_USERS, F = 4096, 40, 8


def _serve(http, framework, als, batcher_mod, manager_cls, model):
    class Manager(manager_cls):
        pass

    Manager.model = model
    batcher = batcher_mod.TopNBatcher()
    app = http.HttpApp(
        framework.ROUTES + als.ROUTES,
        context={"model_manager": Manager(), "input_producer": None,
                 "config": None, "min_model_load_fraction": 0.0,
                 "top_n_batcher": batcher},
        read_only=True)
    server = http.make_server(app, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, batcher


@pytest.fixture(scope="module", params=["flat", "streaming"])
def stacks(request):
    TorchRandomManager.use_test_seed()
    patches = []
    if request.param == "streaming":
        for mod in (jsm, tsm):
            for name, val in (("_FLAT_SCORES_LIMIT", 1),
                              ("_MAX_CHUNK_ROWS", 1024),
                              ("_BLOCK_ROWS", 64), ("_BLOCK_KSEL", 8),
                              ("_PA_TILE", 2048)):
                patches.append((mod, name, getattr(mod, name)))
                setattr(mod, name, val)
    rng = np.random.default_rng(31)
    Y = rng.standard_normal((N_ITEMS, F)).astype(np.float32)
    X = rng.standard_normal((N_USERS, F)).astype(np.float32)
    known = {f"u{u}": [f"i{j}" for j in rng.integers(0, N_ITEMS, 9)]
             for u in range(N_USERS)}
    jm = jsm.ALSServingModel(F, implicit=True)
    jm.Y.bulk_load([f"i{j}" for j in range(N_ITEMS)], Y)
    jm.X.bulk_load([f"u{j}" for j in range(N_USERS)], X)
    for u, items in known.items():
        jm.add_known_items(u, items)
    yh, _, yr = jm.Y.host_arrays()
    xh, _, xr = jm.X.host_arrays()
    tm = serving_model_from_arrays(F, True, x_ids=xr, X=xh, y_ids=yr, Y=yh,
                                   known_items=known, device="cpu")
    servers = [
        _serve(jhttp, jframework, jals, jbatcher, jload.StaticModelManager,
               jm),
        _serve(thttp, tframework, tals, tbatcher, tload.StaticModelManager,
               tm)]
    try:
        yield [s.server_address[1] for s, _ in servers]
    finally:
        for server, batcher in servers:
            server.shutdown()
            server.server_close()
            batcher.close()
        for mod, name, val in patches:
            setattr(mod, name, val)


def _get(port, path, accept="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers={"Accept": accept})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _both(ports, path, accept="application/json"):
    return [_get(p, path, accept) for p in ports]


def _assert_same_pairs(want, got):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)


def _json_pairs(body):
    return [(d["id"], d["value"]) for d in json.loads(body)]


def _csv_pairs(body):
    out = []
    for line in body.decode().splitlines():
        i, v = line.rsplit(",", 1)
        out.append((i, float(v)))
    return out


_PATHS = ["/recommend/u3", "/recommend/u4?howMany=7",
          "/recommend/u5?howMany=4&offset=3",
          "/recommend/u6?howMany=12&considerKnownItems=true",
          "/recommendToMany/u1/u2/u7?howMany=6",
          "/recommendToMany/u8/nobody?howMany=5&considerKnownItems=true"]


def test_recommend_routes_match(stacks):
    for path in _PATHS:
        (js, jct, jb), (ts, tct, tb) = _both(stacks, path)
        assert js == ts == 200, path
        assert jct == tct == "application/json"
        _assert_same_pairs(_json_pairs(jb), _json_pairs(tb))
        (js, jct, jb), (ts, tct, tb) = _both(stacks, path, "text/csv")
        assert js == ts == 200 and jct == tct == "text/csv"
        _assert_same_pairs(_csv_pairs(jb), _csv_pairs(tb))


def test_concurrent_requests_batch_and_match(stacks):
    paths = [f"/recommend/u{u}?howMany=10" for u in range(N_USERS)]
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        results = [list(pool.map(lambda p: _get(port, p), paths))
                   for port in stacks]
    for (js, _, jb), (ts, _, tb) in zip(*results):
        assert js == ts == 200
        _assert_same_pairs(_json_pairs(jb), _json_pairs(tb))


def test_known_items_and_errors_match(stacks):
    (js, _, jb), (ts, _, tb) = _both(stacks, "/knownItems/u9")
    assert js == ts == 200 and jb == tb
    (js, _, jb), (ts, _, tb) = _both(stacks, "/knownItems/u9", "text/csv")
    assert js == ts == 200 and jb == tb
    for path in ("/recommend/nobody", "/recommendToMany/nobody/none"):
        (js, _, jb), (ts, _, tb) = _both(stacks, path)
        assert js == ts == 404 and jb == tb
    (js, _, jb), (ts, _, tb) = _both(stacks, "/recommend/u1?howMany=0")
    assert js == ts == 400 and jb == tb
    (js, _, _), (ts, _, _) = _both(stacks, "/ready")
    assert js == ts
    (js, _, jb), (ts, _, tb) = _both(stacks, "/no/such/route")
    assert js == ts == 404 and jb == tb
