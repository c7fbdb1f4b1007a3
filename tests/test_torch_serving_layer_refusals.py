"""The port's ServingLayer refuses, by name, each reference key whose
feature the port does not have yet (the serving cluster, tracing, the
SLO engine, the event log and the flight recorder), instead of
constructing and quietly ignoring it."""

import pytest

from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.lambda_rt.serving import ServingLayer

BASE = {
    "oryx.serving.model-manager-class":
        "oryx_tpu_torch.app.als.serving_manager.ALSServingModelManager",
    "oryx.serving.application-resources": "oryx_tpu_torch.serving.als",
    "oryx.update-topic.broker": None, "oryx.input-topic.broker": None}


@pytest.mark.parametrize("key,value", [
    ("oryx.cluster.enabled", True),
    ("oryx.obs.tracing.enabled", True),
    ("oryx.obs.slo.enabled", True),
    ("oryx.obs.events.dir", "EVENTS"),
    ("oryx.obs.flight.dir", "FLIGHT"),
])
def test_unported_key_is_refused_by_name(tmp_path, key, value):
    if isinstance(value, str):
        value = str(tmp_path / value)
    cfg = tconfig.from_dict({**BASE, key: value})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        ServingLayer(cfg, port=0, device="cpu")


def test_defaults_construct():
    """The keys at their reference.conf defaults (off, unset) pass."""
    layer = ServingLayer(tconfig.from_dict(BASE), port=0, device="cpu")
    assert layer.model_manager is not None
