"""Every worker thread of the port that may launch device work makes its
card current first (``common/device.bind_thread``), so that a first CUDA
call never runs with no current context and, on a host with several
cards, lands on the card it was given rather than card 0: the batcher's
dispatchers, the HTTP server's request threads, the solver cache's
recompute thread, a layer thread started through ``bound``, and the
pools built with ``bind_thread`` as their initializer.  On the CPU no
card exists, so ``torch.cuda.set_device`` is replaced by a recorder and
the card is named outright."""

import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from oryx_tpu_torch.common import device as device_mod

CARD = torch.device("cuda", 1)


@pytest.fixture
def recorded(monkeypatch):
    seen: list[tuple[str, torch.device]] = []
    lock = threading.Lock()

    def set_device(dev):
        with lock:
            seen.append((threading.current_thread().name, dev))

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    return seen


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_thread_card_names_the_index(monkeypatch):
    assert device_mod.thread_card("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device_mod.thread_card(None) == torch.device("cuda", 3)
    assert device_mod.thread_card("cuda:1") == CARD
    assert device_mod.thread_card("cpu") is None


def test_batcher_dispatchers_take_their_card(recorded):
    from oryx_tpu_torch.serving.batcher import TopNBatcher
    batcher = TopNBatcher(pipeline=3, device=CARD)
    try:
        assert _wait(lambda: len(recorded) == 3)
        assert {d for _, d in recorded} == {CARD}
        assert all(n.startswith("TopNBatcher-") for n, _ in recorded)
    finally:
        batcher.close()


def test_http_request_threads_take_their_card(recorded):
    from oryx_tpu_torch.lambda_rt.http import HttpApp, Route, make_server
    app = HttpApp([Route("GET", "/x", lambda req: {"ok": True})],
                  context={"thread_card": CARD})
    server = make_server(app, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        for _ in range(2):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_address[1]}/x",
                    timeout=10) as r:
                assert r.status == 200
        assert len(recorded) >= 2 and {d for _, d in recorded} == {CARD}
    finally:
        server.shutdown()


def test_solver_recompute_thread_takes_its_card(recorded, monkeypatch):
    from oryx_tpu_torch.app.als import factor_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    solved = threading.Event()

    def get_solver(m, device=None):
        solved.set()
        return None

    monkeypatch.setattr(factor_model, "get_solver", get_solver)
    cache = factor_model.SolverCache(lambda: np.eye(2), CARD)
    cache.compute_async()
    assert solved.wait(5.0)
    assert recorded and recorded[0][1] == CARD


def test_bound_threads_and_pools_take_their_card(recorded):
    t = threading.Thread(target=device_mod.bound(lambda: None, CARD),
                         name="layer")
    t.start()
    t.join()
    assert recorded == [("layer", CARD)]
    with ThreadPoolExecutor(2, initializer=device_mod.bind_thread,
                            initargs=(CARD,)) as pool:
        pool.submit(lambda: None).result()
    assert len(recorded) >= 2 and recorded[-1][1] == CARD
    device_mod.bind_thread(None)  # the CPU: nothing to make current
    assert len(recorded) <= 3
