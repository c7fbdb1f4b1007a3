"""The port's measured-cost kernel router against the reference's.

The router tests of ``tests/test_int8_route.py`` run against
``oryx_tpu_torch``, plus the port's own: the dispatch takes the routed
order's first kind, the route reaches ``metrics()`` and
``kernel_route_label``, and under the same injected delays the port's
LSH decisions and answers equal the JAX model's.  On the CPU the port's
kinds run their plain versions; the JAX model's Pallas kinds do not
lower there and it serves its scan.  Injected delays of 250 ms dwarf
every measured cost at these sizes, so each side's decision is the one
the delay forces.  The port's plain kinds run on one CPU thread here:
with a thread pool per test process on a shared host, a CPU reading
can stall for hundreds of milliseconds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.app.als.serving_model import ALSServingModel as JaxModel
from oryx_tpu.resilience import faults as jfaults
from oryx_tpu_torch.app.als import kernel_router
from oryx_tpu_torch.app.als import serving_model as sm
from oryx_tpu_torch.app.als.serving_model import ALSServingModel
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager
from oryx_tpu_torch.obs import device_time
from oryx_tpu_torch.resilience import faults

DELAY_S = 0.25


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def toy_streaming(monkeypatch):
    """The streaming two-phase path at toy scale."""
    for name, val in (("_FLAT_SCORES_LIMIT", 1), ("_MAX_CHUNK_ROWS", 1024),
                      ("_BLOCK_KSEL", 4), ("_PA_TILE", 1024)):
        monkeypatch.setattr(sm, name, val)


def _small_lsh_model(n=2048, features=10, seed=90):
    rng = np.random.default_rng(seed)
    model = ALSServingModel(features=features, implicit=True,
                            sample_rate=0.3, device="cpu")
    assert model._lsh_active()
    model.Y.bulk_load([f"i{j}" for j in range(n)],
                      rng.standard_normal((n, features)).astype(np.float32))
    model.X.bulk_load(["u0"],
                      rng.standard_normal((1, features)).astype(np.float32))
    return model


def _streaming_model(seed=93, features=6, n=4096):
    rng = np.random.default_rng(seed)
    model = ALSServingModel(features=features, implicit=True, device="cpu")
    model.Y.bulk_load([f"i{j}" for j in range(n)],
                      rng.standard_normal((n, features)).astype(np.float32))
    return model


def test_router_falls_back_to_exact_when_lsh_cost_inflated():
    model = _small_lsh_model()
    n_rows = len(model.Y.row_ids())
    faults.inject("route-measure-lsh", mode="delay", times=None,
                  delay_sec=DELAY_S)
    route = model.refresh_route(force=True)
    assert faults.fired("route-measure-lsh") > 0
    assert route["measured"] and route["use_lsh"] is False
    assert model._route_use_lsh(n_rows) is False
    rng = np.random.default_rng(91)
    q = rng.standard_normal((3, model.features)).astype(np.float32)
    got = model.top_n_batch(5, q, use_lsh=True)
    want = model.top_n_batch(5, q, use_lsh=False)
    assert got == want
    m = model.metrics()
    assert m["kernel_route"]["use_lsh"] is False
    assert m["kernel_route"]["costs_lsh_ms"]
    assert m["kernel_route"]["costs_exact_ms"]


def test_router_honors_lsh_when_it_measures_faster():
    model = _small_lsh_model(seed=92)
    n_rows = len(model.Y.row_ids())
    faults.inject("route-measure-exact", mode="delay", times=None,
                  delay_sec=DELAY_S)
    route = model.refresh_route(force=True)
    assert faults.fired("route-measure-exact") > 0
    assert route["use_lsh"] is True
    assert model._route_use_lsh(n_rows) is True


def test_router_streaming_measures_every_kind_and_orders_by_cost(
        toy_streaming):
    """Every phase-A kind of the chain is measured on its plain version
    (the scan is skipped once another kind measured, as in the
    reference); a synthetic cost table reorders the chain strictly by
    measured cost, and a stale route leaves the static order."""
    model = _streaming_model(features=6)
    route = model.refresh_route(force=True)
    assert route["path"] == "streaming"
    kinds, _ = model._phase_a_kinds(len(model.Y.row_ids()), 32,
                                    sm._BLOCK_ROWS)
    assert kinds == ["i8_fold", "fold", "i8", "pallas", "scan"]
    measured = route["costs_exact_ms"]
    assert set(measured) == set(kinds) - {"scan"}
    assert all(c is not None and c > 0 for c in measured.values())
    assert "errors" not in route
    assert route["chosen"] == min(measured, key=measured.get)
    n_rows = len(model.Y.row_ids())
    model._route = {"measured": True, "lsh_configured": False,
                    "ann_key": None,
                    "phase_a_costs_ms": {"pallas": 1.0, "fold": 5.0,
                                         "i8_fold": 3.0}}
    model._route_capacity = n_rows
    assert model._route_order(
        ["i8_fold", "fold", "i8", "pallas"], n_rows) == \
        ["pallas", "i8_fold", "fold", "i8"]
    assert model._route_order(["fold", "pallas"], n_rows + 1) == \
        ["fold", "pallas"]


def test_route_cached_per_capacity_and_refreshed_on_growth():
    model = _small_lsh_model(seed=94)
    r1 = model.refresh_route()
    assert r1 is not None
    assert model.refresh_route() is r1
    n_rows = len(model.Y.row_ids())
    assert model._route_current(n_rows) is r1
    assert model._route_current(n_rows * 2) is None
    r2 = model.refresh_route(force=True)
    assert r2 is not r1
    # a hot-swap that regrows the padded capacity re-measures
    rng = np.random.default_rng(97)
    model.Y.bulk_load([f"j{j}" for j in range(n_rows)],
                      rng.standard_normal((n_rows, model.features)).astype(
                          np.float32))
    assert len(model.Y.row_ids()) > n_rows
    r3 = model.refresh_route()
    assert r3 is not r2 and r3["capacity"] == len(model.Y.row_ids())


def test_router_skips_empty_models():
    model = ALSServingModel(features=6, implicit=True, device="cpu")
    assert model.refresh_route() is None
    assert model._route_use_lsh(0) is True
    assert model.kernel_route_label is None


def test_refresh_route_failure_never_escapes(monkeypatch):
    model = _small_lsh_model(seed=95)

    def boom(*_a, **_k):
        raise RuntimeError("injected measurement failure")

    monkeypatch.setattr(kernel_router, "measure_routes", boom)
    assert model.refresh_route(force=True) is None
    assert model._route_use_lsh(len(model.Y.row_ids())) is True


def test_route_measurement_evicts_losing_mirrors(toy_streaming):
    """After routing only the chosen kind's mirror caches stay."""
    model = _streaming_model(seed=96)
    route = model.refresh_route(force=True)
    keep = {"i8_fold": {"_i8_fold", "_fold_bkt"}, "i8": {"_i8", "_penalty_i"},
            "fold": {"_fold", "_fold_bkt"}, "pallas": {"_penalty"},
            "scan": set()}[route["chosen"]]
    for attr in ("_i8", "_i8_fold", "_fold", "_fold_bkt", "_penalty",
                 "_penalty_i"):
        if attr in keep and attr != "_fold_bkt":
            assert getattr(model, attr) is not None, attr
        if attr not in keep:
            assert getattr(model, attr) is None, attr


@pytest.mark.parametrize("kind", ["i8_fold", "fold", "i8", "pallas"])
def test_dispatch_takes_the_routed_first_kind(toy_streaming, kind):
    """``_dispatch_twophase`` dispatches ``_route_order(...)[0]`` and no
    other kind."""
    model = _streaming_model(seed=98)
    n_rows = len(model.Y.row_ids())
    costs = {k: 5.0 for k in ("i8_fold", "fold", "i8", "pallas")}
    costs[kind] = 1.0
    model._route = {"measured": True, "lsh_configured": False,
                    "ann_key": None, "costs_exact_ms": costs,
                    "use_lsh": None, "chosen": kind}
    model._route_capacity = n_rows
    seen = []
    real = model._dispatch_kind

    def spy(k, *a, **kw):
        seen.append(k)
        return real(k, *a, **kw)

    model._dispatch_kind = spy
    q = np.random.default_rng(99).standard_normal((3, 6)).astype(np.float32)
    out = model.top_n_batch(5, q)
    assert seen == [kind]
    assert len(out) == 3 and all(len(r) == 5 for r in out)


def test_route_reaches_metrics_and_label(toy_streaming):
    model = _streaming_model(seed=100)
    acct = device_time.DeviceTimeAccountant()
    device_time.install_process_accountant(acct)
    try:
        route = model.refresh_route(force=True)
    finally:
        device_time.install_process_accountant(None)
    assert model.metrics()["kernel_route"] is route
    assert model.kernel_route_label == route["chosen"]
    # the sweep is booked as measure time under the chosen kind
    booked = acct.snapshot()["by_route"]
    assert [(b["route_class"], b["kernel_route"]) for b in booked] == \
        [("measure", route["chosen"])]
    lsh = _small_lsh_model(seed=101)
    faults.inject("route-measure-exact", mode="delay", times=None,
                  delay_sec=DELAY_S)
    r = lsh.refresh_route(force=True)
    assert r["use_lsh"] is True
    assert lsh.kernel_route_label == f"{r['chosen']}+lsh"


def _pair(seed: int, n: int = 2048, features: int = 10):
    """The same seeded LSH model in both packages."""
    TorchRandomManager.use_test_seed()
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, features)).astype(np.float32)
    X = rng.standard_normal((4, features)).astype(np.float32)
    jm = JaxModel(features=features, implicit=True, sample_rate=0.3)
    tm = ALSServingModel(features=features, implicit=True, sample_rate=0.3,
                         device="cpu")
    tm.lsh.set_hyperplanes(jm.lsh.hyperplanes)
    for m in (jm, tm):
        m.Y.bulk_load([f"i{j}" for j in range(n)], Y)
        m.X.bulk_load([f"u{j}" for j in range(4)], X)
    return jm, tm, rng


@pytest.mark.parametrize("inflate", ["route-measure-lsh",
                                     "route-measure-exact"])
def test_lsh_decisions_and_answers_match_the_reference(inflate):
    jm, tm, rng = _pair(seed=102)
    for f in (faults, jfaults):
        f.inject(inflate, mode="delay", times=None, delay_sec=DELAY_S)
    jr = jm.refresh_route(force=True)
    tr = tm.refresh_route(force=True)
    assert jr["use_lsh"] == tr["use_lsh"] == (inflate ==
                                               "route-measure-exact")
    assert jr["path"] == tr["path"] and jr["batch"] == tr["batch"]
    assert set(jr["costs_exact_ms"]) == set(tr["costs_exact_ms"])
    assert set(jr["costs_lsh_ms"]) == set(tr["costs_lsh_ms"])
    n_rows = len(tm.Y.row_ids())
    assert jm._route_use_lsh(n_rows) == tm._route_use_lsh(n_rows)
    q = rng.standard_normal((6, 10)).astype(np.float32)
    want = jm.top_n_batch(7, q)
    got = tm.top_n_batch(7, q)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   rtol=1e-5)
    for b in range(2):
        w = jm.top_n(5, user_vector=q[b])
        g = tm.top_n(5, user_vector=q[b])
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   rtol=1e-5)
