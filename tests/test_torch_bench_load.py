"""The port's load drivers (``oryx_tpu_torch/bench/{load,traffic}.py``)
against the reference's: the same draws from the same seeded NumPy
generator, the same statistics on the same latencies, and a few
requests of each driver against a port ServingLayer on the CPU (as
``tests/test_bench_load.py`` drives the reference's)."""

import numpy as np
import pytest

from oryx_tpu.bench import load as jload
from oryx_tpu.bench import traffic as jtraffic
from oryx_tpu_torch.bench import load as tload
from oryx_tpu_torch.bench import traffic as ttraffic
from oryx_tpu_torch.common.config import from_dict
from oryx_tpu_torch.lambda_rt.serving import ServingLayer

USERS, ITEMS, F = 200, 500, 8


@pytest.mark.parametrize("a", [0.8, 1.1, 2.0])
def test_zipf_picks_are_the_reference_draws(a):
    got = tload.zipf_picks(np.random.default_rng(3), 500, 2000, a)
    want = jload.zipf_picks(np.random.default_rng(3), 500, 2000, a)
    assert np.array_equal(got, want)


def test_endpoint_mix_picks_are_the_reference_draws():
    tmix = ttraffic.EndpointMix(ttraffic.ALS_ENDPOINTS, users=50, items=70)
    jmix = jtraffic.EndpointMix(jtraffic.ALS_ENDPOINTS, users=50, items=70)
    assert ttraffic.ALS_ENDPOINTS == jtraffic.ALS_ENDPOINTS
    trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    assert [tmix.pick(trng) for _ in range(300)] == \
        [jmix.pick(jrng) for _ in range(300)]


def test_load_stats_are_the_reference_statistics():
    lat = np.random.default_rng(5).exponential(12.0, 997)
    t = tload.LoadStats(requests=997, errors=3, elapsed_sec=2.5,
                        latencies_ms=lat)
    j = jload.LoadStats(requests=997, errors=3, elapsed_sec=2.5,
                        latencies_ms=lat)
    assert t.qps == j.qps
    for p in (50, 95, 99, 99.9):
        assert t.percentile_ms(p) == j.percentile_ms(p)
    assert t.summary() == j.summary()
    empty = tload.LoadStats(0, 0, 0.0, np.asarray([]))
    assert empty.qps == 0.0 and np.isnan(empty.percentile_ms(50))


@pytest.fixture(scope="module")
def layer():
    model = tload.build_load_test_model(users=USERS, items=ITEMS,
                                        features=F, known_items_per_user=3,
                                        device="cpu")
    tload.StaticModelManager.model = model
    cfg = from_dict({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.bench.load.StaticModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
        "oryx.input-topic.broker": None,
        "oryx.update-topic.broker": None,
    })
    served = ServingLayer(cfg, port=0, device="cpu")
    served.start()
    try:
        yield served
    finally:
        served.close()
        tload.StaticModelManager.model = None


def test_build_load_test_model_shape():
    model = tload.build_load_test_model(users=20, items=60, features=4,
                                        known_items_per_user=2,
                                        lsh_sample_rate=0.5, device="cpu")
    assert len(model.X) == 20 and len(model.Y) == 60
    assert model.lsh is not None
    assert model.device.type == "cpu"


def test_recommend_load(layer):
    base = f"http://127.0.0.1:{layer.port}"
    stats = tload.run_recommend_load(base, [str(u) for u in range(USERS)],
                                     requests=50, workers=3)
    assert stats.errors == 0 and stats.requests == 50
    assert stats.qps > 0 and np.isfinite(stats.percentile_ms(50))
    assert set(stats.summary()) == {"requests", "errors", "qps", "p50_ms",
                                    "p95_ms", "p99_ms"}


def test_open_loop_driver(layer):
    base = f"http://127.0.0.1:{layer.port}"
    out = tload.run_recommend_open_loop(
        base, [str(u) for u in range(USERS)], rate_qps=60.0,
        duration_sec=1.5, workers=16)
    assert out["errors"] == 0 and out["achieved_qps"] > 0
    assert set(out) >= {"offered_qps", "achieved_qps", "p50_ms", "p95_ms",
                        "p99_ms", "mean_sched_lateness_ms", "mid_window",
                        "sustained"}
    # a modest rate against an idle in-process model holds
    assert out["sustained"] is True


def test_traffic_generator(layer):
    base = f"http://127.0.0.1:{layer.port}"
    mix = ttraffic.EndpointMix(ttraffic.ALS_ENDPOINTS, users=USERS,
                               items=ITEMS)
    stats = ttraffic.run_traffic([base], mix, mean_qps=100.0,
                                 duration_sec=1.5, workers=3)
    assert stats.requests > 0 and stats.errors == 0


def test_traffic_main_filters_the_mix(layer, capsys):
    base = f"http://127.0.0.1:{layer.port}"
    assert ttraffic.main([base, "--qps", "50", "--duration", "0.5",
                          "--users", str(USERS), "--items", str(ITEMS),
                          "--endpoints", "recommend"]) == 0
    assert "'errors': 0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ttraffic.main([base, "--endpoints", "nothing-matches"])
