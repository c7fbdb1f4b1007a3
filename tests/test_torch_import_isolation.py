"""oryx_tpu_torch stands alone: it imports, serves, trains and folds a
speed micro-batch, trains and evaluates k-means, builds an IVF index
and measures its recall, and trains a decision forest and serves
/predict from it with JAX, ml_dtypes and the reference package blocked,
and its entry points refuse to fall back to the CPU silently."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "ml_dtypes", "oryx_tpu")

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, _Block())
    for mod in list(sys.modules):
        if any(mod == b or mod.startswith(b + ".") for b in BLOCKED):
            del sys.modules[mod]

    import numpy as np
    import oryx_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        oryx_tpu_torch.__path__, "oryx_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from oryx_tpu_torch.convert import serving_model_from_arrays
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((600, 12)).astype(np.float32)
    X = rng.standard_normal((4, 12)).astype(np.float32)
    model = serving_model_from_arrays(
        12, True, x_ids=[f"u{i}" for i in range(4)], X=X,
        y_ids=[f"i{i}" for i in range(600)], Y=Y,
        known_items={"u0": ["i1"]}, device="cpu")
    out = model.top_n_batch(5, X)
    assert len(out) == 4 and all(len(r) == 5 for r in out)

    # the batch and speed layers: train a tiny model from an input
    # topic, then fold one micro-batch into UP deltas
    import json
    import tempfile
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.kafka.inproc import get_broker
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
    td = tempfile.mkdtemp()
    cfg = from_dict({
        "oryx.input-topic.broker": "memory://iso",
        "oryx.input-topic.partitions": 1,
        "oryx.update-topic.broker": "memory://iso",
        "oryx.batch.update-class": "oryx_tpu_torch.app.als.update.ALSUpdate",
        "oryx.speed.model-manager-class":
            "oryx_tpu_torch.app.als.speed.ALSSpeedModelManager",
        "oryx.batch.storage.data-dir": td + "/data",
        "oryx.batch.storage.model-dir": td + "/model",
        "oryx.als.iterations": 2, "oryx.als.hyperparams.features": 3,
        "oryx.ml.eval.test-fraction": 0.0})
    broker = get_broker("iso")
    for j in range(120):
        broker.send("OryxInput", None, f"u{j % 15},i{(7 * j) % 11},1,{j}")
    BatchLayer(cfg, device="cpu").run_one_generation()
    speed = SpeedLayer(cfg, device="cpu")
    for km in broker.consume("OryxUpdate", from_beginning=True,
                             max_idle_sec=0.2):
        speed.model_manager.consume_key_message(km.key, km.message)
    assert speed.model_manager.model.get_fraction_loaded() == 1.0
    before = broker.latest_offsets("OryxUpdate")
    broker.set_offsets(speed._group, "OryxInput",
                       broker.latest_offsets("OryxInput"))
    broker.send("OryxInput", None, "newbie,i3,1,999")
    speed.run_one_micro_batch()
    ups = broker.read_ranges("OryxUpdate", before,
                             broker.latest_offsets("OryxUpdate"))
    assert any(json.loads(km.message)[:2] == ["X", "newbie"] for km in ups)
    speed.close()

    # k-means: train (both initializations) and evaluate
    from oryx_tpu_torch.app.kmeans.evaluation import evaluate
    from oryx_tpu_torch.app.kmeans.trainer import train_kmeans
    pts = np.concatenate([c + 0.3 * rng.standard_normal((50, 2))
                          for c in ([0, 0], [6, 0], [0, 6])]).astype(
                              np.float32)
    for init in ("random", "k-means||"):
        clusters = train_kmeans(pts, 3, 5, seed=1, initialization=init,
                                device="cpu")
        assert sum(c.count for c in clusters) == len(pts)
        assert evaluate("SILHOUETTE", clusters, pts, device="cpu") > 0.5

    # the IVF index: train, build the mirror, measure recall
    from oryx_tpu_torch.app.als import ivf
    cfg = ivf.AnnConfig(enabled=True, cells=4, nprobe=4, min_recall=0.9,
                        recall_at=10, recall_queries=8, train_sample=600,
                        train_iterations=3)
    yv, ya, _ids = model.Y.host_arrays()
    state = ivf.AnnState(cfg, ivf.train_generation_centroids(
        yv[ya], cfg, device="cpu"))
    model.attach_ann(state)
    vecs, active, version = model.Y.device_arrays_versioned()
    mirror = model._cached_ivf(vecs, active, version)
    assert ivf.measure_recall(model, mirror, cfg) > 0.9

    # a decision forest: one batch generation, then /predict over HTTP
    import time
    import urllib.request
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    cfg = from_dict({
        "oryx.input-topic.broker": "memory://iso-rdf",
        "oryx.input-topic.partitions": 1,
        "oryx.update-topic.broker": "memory://iso-rdf",
        "oryx.batch.update-class": "oryx_tpu_torch.app.rdf.update.RDFUpdate",
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.app.rdf.serving.RDFServingModelManager",
        "oryx.serving.application-resources":
            "oryx_tpu_torch.serving.classreg",
        "oryx.batch.storage.data-dir": td + "/rdf-data",
        "oryx.batch.storage.model-dir": td + "/rdf-model",
        "oryx.input-schema.feature-names": ["a", "color", "label"],
        "oryx.input-schema.categorical-features": ["color", "label"],
        "oryx.input-schema.target-feature": "label",
        "oryx.rdf.num-trees": 3, "oryx.rdf.hyperparams.max-depth": 3,
        "oryx.rdf.hyperparams.max-split-candidates": 8,
        "oryx.ml.eval.test-fraction": 0.0})
    broker = get_broker("iso-rdf")
    for j in range(200):
        a = (j % 17) / 8.0 - 1.0
        color = ("red", "green", "blue")[j % 3]
        label = "yes" if a >= 0.1 or color == "blue" else "no"
        broker.send("OryxInput", None, f"{a},{color},{label}")
    BatchLayer(cfg, device="cpu").run_one_generation()
    layer = ServingLayer(cfg, port=0, device="cpu")
    layer.start()
    try:
        answer = None
        deadline = time.monotonic() + 60
        while answer is None and time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{layer.port}/predict/0.9,red,",
                        timeout=10) as resp:
                    answer = json.loads(resp.read())
            except urllib.error.HTTPError:
                time.sleep(0.05)
        assert answer == "yes", answer
    finally:
        layer.close()
    leaked = sorted(m for m in sys.modules
                    if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print("OK", len(names))
""")


def test_port_imports_and_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPT],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")
    # every module of the slice was imported, not just the package root
    assert int(proc.stdout.split()[1]) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means cuda: without a card, an entry point called
    without device="cpu" raises instead of running on the host."""
    from oryx_tpu_torch.app.als.feature_vectors import FeatureVectorStore
    from oryx_tpu_torch.app.als.lsh import LocalitySensitiveHash
    from oryx_tpu_torch.app.als.serving_model import ALSServingModel
    from oryx_tpu_torch.app.rdf.forest_arrays import ForestArrays
    from oryx_tpu_torch.app.rdf.serving import (RDFServingModel,
                                                RDFServingModelManager)
    from oryx_tpu_torch.app.rdf.speed import RDFSpeedModelManager
    from oryx_tpu_torch.app.rdf.trainer import train_forest
    from oryx_tpu_torch.app.rdf.tree import (DecisionForest, DecisionTree,
                                             TerminalNode)
    from oryx_tpu_torch.app.rdf.update import RDFUpdate
    from oryx_tpu_torch.app.classreg import NumericPrediction
    from oryx_tpu_torch.app.schema import (CategoricalValueEncodings,
                                           InputSchema)
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.convert import serving_model_from_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = dict(x_ids=["u0"], X=np.zeros((1, 4), np.float32),
                  y_ids=["i0"], Y=np.zeros((1, 4), np.float32),
                  known_items={})
    cfg = from_dict({"oryx.input-schema.feature-names": ["a", "y"],
                     "oryx.input-schema.numeric-features": ["a", "y"],
                     "oryx.input-schema.target-feature": "y"})
    schema = InputSchema(cfg)
    forest = DecisionForest([DecisionTree(
        TerminalNode("r", NumericPrediction(1.0, 1)))])
    encodings = CategoricalValueEncodings({})
    x = np.zeros((4, 1), np.float32)
    for call in (lambda: FeatureVectorStore(4),
                 lambda: LocalitySensitiveHash(0.3, 4),
                 lambda: ALSServingModel(4, True),
                 lambda: ALSServingModel(4, True, device="cuda"),
                 lambda: serving_model_from_arrays(4, True, **arrays),
                 lambda: ForestArrays(forest, 2, 0),
                 lambda: train_forest(x, np.zeros(4, np.float32), schema,
                                      {}, 1, 1, 4, "variance"),
                 lambda: RDFUpdate(cfg),
                 lambda: RDFSpeedModelManager(cfg),
                 lambda: RDFServingModelManager(cfg),
                 lambda: RDFServingModel(forest, encodings, schema)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the explicit CPU request is honoured
    assert ALSServingModel(4, True, device="cpu").device.type == "cpu"
    assert ForestArrays(forest, 2, 0, device="cpu").predict_value(
        np.zeros((3, 2), np.float32)).tolist() == [1.0, 1.0, 1.0]
