"""Full lambda-loop smoke on the card, one process.

Counterpart of ``oryx_tpu/bench/e2e_smoke.py``.  The CPU tests prove the
loop's logic (tests/test_torch_lambda_loop.py); this drives the same
loop — input topic -> BatchLayer generation -> MODEL/UP on the update
topic -> SpeedLayer micro-batch fold-in -> ServingLayer replay -> live
HTTP answers -> /pref write-back — through the port's three layers on
the CUDA card (``--device cpu`` runs it on the host).  It is the "does
the whole framework run on the card" check, not a benchmark.

Run: python -m oryx_tpu_torch.bench.e2e_smoke [--device cpu]
Prints one JSON line with per-stage timings and assertions passed.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import urllib.request

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = ap.parse_args(argv).device

    from ..common.config import from_dict
    from ..kafka.api import KEY_MODEL, KEY_UP
    from ..kafka.inproc import get_broker
    from ..lambda_rt.batch import BatchLayer
    from ..lambda_rt.serving import ServingLayer
    from ..lambda_rt.speed import SpeedLayer
    from .train import device_name

    t_start = time.perf_counter()
    stages: dict[str, float] = {}
    name = f"e2e-{time.monotonic_ns()}"
    with tempfile.TemporaryDirectory() as td:
        cfg = from_dict({
            "oryx.id": "e2e",
            "oryx.input-topic.broker": f"memory://{name}",
            "oryx.input-topic.partitions": 1,
            "oryx.input-topic.message.topic": "In",
            "oryx.update-topic.broker": f"memory://{name}",
            "oryx.update-topic.message.topic": "Up",
            "oryx.batch.update-class":
                "oryx_tpu_torch.app.als.update.ALSUpdate",
            "oryx.speed.model-manager-class":
                "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager",
            "oryx.serving.model-manager-class": "oryx_tpu_torch.app.als."
                "serving_manager.ALSServingModelManager",
            "oryx.serving.application-resources":
                "oryx_tpu_torch.serving.als",
            "oryx.batch.storage.data-dir": td + "/data",
            "oryx.batch.storage.model-dir": td + "/model",
            "oryx.compile-cache-dir": td + "/cache",
            # the smoke drives micro-batches manually; park the speed
            # layer's background ticker far out so the manual call is
            # the sole producer over the uncommitted range
            "oryx.speed.streaming.generation-interval-sec": 3600,
            "oryx.als.iterations": 3,
            "oryx.als.implicit": True,
            "oryx.als.hyperparams.features": 8,
            "oryx.ml.eval.test-fraction": 0.0,
        })
        broker = get_broker(name)
        rng = np.random.default_rng(5)
        t = 1_700_000_000_000
        n_in = 0
        for u in range(40):
            for i in range(25):
                if rng.random() < 0.4:
                    broker.send("In", None,
                                f"u{u},i{i},{rng.exponential(1):.2f},{t}")
                    t += 1000
                    n_in += 1

        t0 = time.perf_counter()
        BatchLayer(cfg, device=device).run_one_generation()
        stages["batch_generation_s"] = round(time.perf_counter() - t0, 2)
        msgs = list(broker.consume("Up", from_beginning=True,
                                   max_idle_sec=0.3))
        assert msgs and msgs[0].key == KEY_MODEL, "no MODEL published"

        t0 = time.perf_counter()
        speed = SpeedLayer(cfg, device=device)
        speed.start()
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                m = speed.model_manager.model
                if m is not None and m.get_fraction_loaded() >= 0.8:
                    break
                time.sleep(0.05)
            before = broker.latest_offsets("Up")[0]
            broker.send("In", None, "u0,i1,3.0,1800000000000")
            broker.send("In", None, "brandnew,i2,1.0,1800000000001")
            speed.run_one_micro_batch()
            ups = []
            deadline = time.time() + 30
            while time.time() < deadline:
                after = broker.latest_offsets("Up")[0]
                if after > before:
                    ups = [km.message for km in
                           broker.read_ranges("Up", [before], [after])
                           if km.key == KEY_UP]
                    if any(json.loads(u)[1] == "brandnew" for u in ups):
                        break
                time.sleep(0.05)
            assert ups, "speed layer produced no UP deltas"
            assert any(json.loads(u)[1] == "brandnew" for u in ups), \
                "fold-in dropped the new user's UP delta"
        finally:
            speed.close()
        stages["speed_fold_in_s"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        serving = ServingLayer(cfg, port=0, device=device)
        serving.start()
        try:
            deadline = time.time() + 120
            model = None
            while time.time() < deadline:
                model = serving.model_manager.get_model()
                if model is not None \
                        and model.get_fraction_loaded() >= 0.8:
                    break
                time.sleep(0.05)
            assert model is not None and model.user_count() > 0
            base = f"http://127.0.0.1:{serving.port}"
            uid = model.all_user_ids()[0]
            with urllib.request.urlopen(f"{base}/recommend/{uid}?howMany=4",
                                        timeout=60) as r:
                recs = json.loads(r.read())
            assert len(recs) >= 1 and "id" in recs[0]
            # the speed layer's fold-in reached serving via UP replay;
            # the serving gate opens at 0.8 loaded, before the replay
            # reaches the last UP record, so wait for it (bounded)
            deadline = time.time() + 60
            while model.get_user_vector("brandnew") is None \
                    and time.time() < deadline:
                time.sleep(0.05)
            assert model.get_user_vector("brandnew") is not None, \
                "speed-layer UP delta never reached the serving model"
            with urllib.request.urlopen(f"{base}/similarity/i1?howMany=3",
                                        timeout=60) as r:
                sims = json.loads(r.read())
            assert sims
            # write path: /pref lands on the input topic
            in_before = broker.latest_offsets("In")[0]
            req = urllib.request.Request(f"{base}/pref/u0/i3", data=b"4.5",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status in (200, 204)
            tail = broker.read_ranges("In", [in_before],
                                      broker.latest_offsets("In"))
            assert any("u0" in m.message and "i3" in m.message
                       for m in tail), "pref never reached the input topic"
        finally:
            serving.close()
        stages["serving_replay_query_s"] = round(time.perf_counter() - t0, 2)

    print(json.dumps({
        "metric": "lambda_e2e_smoke",
        "device": device_name(device),
        "input_records": n_in,
        **stages,
        "total_s": round(time.perf_counter() - t_start, 2),
        "ok": True,
    }))


if __name__ == "__main__":
    main()
