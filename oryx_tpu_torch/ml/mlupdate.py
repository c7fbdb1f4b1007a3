"""The batch-ML training loop: hyperparameter search, train, evaluate,
pick best, publish.

Counterpart of ``oryx_tpu/ml/mlupdate.py``, whole; its per-generation
trace (``oryx.ml.profile-dir``) is a ``torch.profiler`` trace here.

Reference: framework/oryx-ml/src/main/java/com/cloudera/oryx/ml/
MLUpdate.java:60-382 — runUpdate :161 (cache, combos, parallel build,
atomic rename, MODEL vs MODEL-REF publish, publishAdditionalModelData
hook), findBestCandidatePath :254 (NaN-eval handling, eval-disabled
case, threshold gate), buildAndEval :299, splitTrainTest :346.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import math
import os
import time
from typing import Sequence
from xml.etree.ElementTree import Element

from ..api.batch import BatchLayerUpdate
from ..common import pmml as pmml_io
from ..common import store
from ..common.config import Config
from ..common.io_utils import mkdirs
from ..common.lang import collect_in_parallel
from ..common.rand import RandomManager
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF, KeyMessage, TopicProducer
from ..obs.profile import _activities, capture_lock
from . import params as hp

_log = logging.getLogger(__name__)

MODEL_FILE_NAME = "model.pmml.xml"

__all__ = ["MLUpdate", "MODEL_FILE_NAME"]


@contextlib.contextmanager
def _profile(trace_dir: str):
    """A torch.profiler trace of the block (host, and the card when
    there is one), written to ``trace_dir/trace.json``.  The profiler is
    process-global: the block waits for an ``/admin/profile`` capture in
    flight (at most its 60 s ceiling), and one arriving meanwhile gets
    503 (``obs/profile.capture_lock``)."""
    from torch.profiler import profile
    with capture_lock(), profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class MLUpdate(BatchLayerUpdate, abc.ABC):
    """Subclasses supply model building and evaluation; this class runs
    the per-generation loop."""

    def __init__(self, config: Config):
        self.config = config
        self.test_fraction = config.get_double("oryx.ml.eval.test-fraction")
        self.candidates = config.get_int("oryx.ml.eval.candidates")
        self.eval_parallelism = config.get_int("oryx.ml.eval.parallelism")
        self.threshold = config.get_optional_double("oryx.ml.eval.threshold")
        self.max_message_size = config.get_int("oryx.update-topic.message.max-size")
        # optional per-generation trace of the candidate builds (the
        # counterpart of the reference's per-layer Spark UI): a
        # torch.profiler Chrome trace, viewable in Perfetto
        self.profile_dir = config.get_optional_string("oryx.ml.profile-dir")
        if not 0.0 <= self.test_fraction <= 1.0:
            raise ValueError("test-fraction must be in [0,1]")
        if self.candidates < 1:
            raise ValueError("candidates must be positive")
        if self.test_fraction == 0.0 and self.candidates > 1:
            _log.info("Building multiple candidates requires test-fraction > 0; "
                      "building one model")
            self.candidates = 1

    # -- subclass contract --------------------------------------------------

    @abc.abstractmethod
    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        ...

    @abc.abstractmethod
    def build_model(self, train_data: Sequence[KeyMessage],
                    hyper_parameters: list, candidate_path: str) -> Element | None:
        """Train on ``train_data`` with the given hyperparameters; return a
        PMML document (side artifacts may be written under
        ``candidate_path``)."""

    @abc.abstractmethod
    def evaluate(self, model: Element, candidate_path: str,
                 test_data: Sequence[KeyMessage],
                 train_data: Sequence[KeyMessage]) -> float:
        """Higher is better (negate error metrics)."""

    def validate_model(self, model: Element, candidate_path: str) -> bool:
        """Pre-publish integrity gate: return False to reject the
        candidate outright (it can never be selected or published).
        Subclasses override to check model content — e.g. ALS verifies
        every factor artifact is finite.  The default accepts."""
        return True

    def can_publish_additional_model_data(self) -> bool:
        return False

    def prepare_model_ref_payload(self, model: Element | None,
                                  model_path: str,
                                  new_data: Sequence[KeyMessage],
                                  past_data: Sequence[KeyMessage]) -> str:
        """The MODEL-REF message payload for a too-large-to-inline
        model.  The default is the reference contract — the bare
        storage path of the PMML file.  Apps with a sharded
        distribution story (ALS) override to write per-slice artifacts
        next to the model and return a manifest-carrying envelope
        (app/als/slices.py), so consumers bulk-load their slice
        instead of replaying a full UP stream."""
        return model_path

    def publish_additional_model_data(self, model: Element,
                                      new_data: Sequence[KeyMessage],
                                      past_data: Sequence[KeyMessage],
                                      model_path: str,
                                      model_update_topic: TopicProducer) -> None:
        pass

    def split_new_data_to_train_test(
            self, new_data: Sequence[KeyMessage]
    ) -> tuple[list[KeyMessage], list[KeyMessage]]:
        """Random split; apps override for e.g. time-based splits
        (reference: MLUpdate.splitNewDataToTrainTest)."""
        rng = RandomManager.random()
        mask = rng.random(len(new_data)) < self.test_fraction
        train = [km for km, m in zip(new_data, mask) if not m]
        test = [km for km, m in zip(new_data, mask) if m]
        return train, test

    # -- the loop -----------------------------------------------------------

    def run_update(self, timestamp_ms: int,
                   new_data: Sequence[KeyMessage],
                   past_data: Sequence[KeyMessage],
                   model_dir: str,
                   model_update_topic: TopicProducer | None) -> None:
        new_data = list(new_data or [])
        past_data = list(past_data or [])

        ranges = self.get_hyper_parameter_values()
        per_param = hp.choose_values_per_hyperparam(len(ranges), self.candidates)
        combos = hp.choose_hyper_parameter_combos(ranges, self.candidates, per_param)

        model_dir = store.mkdirs(model_dir)
        candidates_path = store.join(model_dir, ".temporary",
                                     str(int(time.time() * 1000)))
        store.mkdirs(candidates_path)

        if self.profile_dir:
            trace = _profile(mkdirs(os.path.join(self.profile_dir,
                                                 str(timestamp_ms))))
        else:
            trace = contextlib.nullcontext()
        with trace:
            best_candidate = self._find_best_candidate_path(
                new_data, past_data, combos, candidates_path)

        final_path = store.join(model_dir, str(int(time.time() * 1000)))
        if best_candidate is None:
            _log.info("Unable to build any model")
        else:
            store.rename(best_candidate, final_path)  # atomic publish
        store.delete_recursively(store.join(model_dir, ".temporary"))

        if model_update_topic is None:
            _log.info("No update topic configured, not publishing models")
        else:
            best_model_path = store.join(final_path, MODEL_FILE_NAME)
            if store.exists(best_model_path):
                size = store.getsize(best_model_path)
                needed = self.can_publish_additional_model_data()
                not_too_large = size <= self.max_message_size
                best_model = None
                if needed or not_too_large:
                    best_model = pmml_io.read(best_model_path)
                if not_too_large:
                    model_update_topic.send(KEY_MODEL, pmml_io.to_string(best_model))
                else:
                    model_update_topic.send(
                        KEY_MODEL_REF,
                        self.prepare_model_ref_payload(
                            best_model, best_model_path, new_data,
                            past_data))
                if needed:
                    self.publish_additional_model_data(
                        best_model, new_data, past_data, final_path,
                        model_update_topic)

    def _find_best_candidate_path(self, new_data, past_data, combos,
                                  candidates_path: str) -> str | None:
        results = collect_in_parallel(
            self.candidates,
            lambda i: self._build_and_eval(i, combos, new_data, past_data,
                                           candidates_path),
            min(self.eval_parallelism, self.candidates))

        best_path, best_eval = None, float("-inf")
        for path, eval_ in results:
            if path is None or not store.exists(path):
                continue
            if math.isfinite(eval_):
                # argmax strictly over FINITE evals: NaN is the
                # reference's skip semantics (MLUpdate.java:254-296),
                # and +/-Inf is a degenerate metric no candidate may
                # win with — garbage never outranks a real model
                if eval_ > best_eval:
                    _log.info("Best eval / model path is now %s / %s", eval_, path)
                    best_eval, best_path = eval_, path
            elif best_path is None and self.test_fraction == 0.0:
                # eval disabled: keep the one model that was built
                best_path = path
        if self.threshold is not None and best_eval < self.threshold:
            _log.info("Best model had eval %s, below threshold %s; discarding",
                      best_eval, self.threshold)
            best_path = None
        return best_path

    def _build_and_eval(self, i: int, combos, new_data, past_data,
                        candidates_path: str) -> tuple[str | None, float]:
        hyper_parameters = combos[i % len(combos)]
        candidate_path = store.join(candidates_path, str(i))
        _log.info("Building candidate %d with params %s", i, hyper_parameters)

        train, test = self._split_train_test(new_data, past_data)
        eval_ = float("nan")
        if not train:
            _log.info("No train data to build a model")
            return candidate_path, eval_
        model = self.build_model(train, hyper_parameters, candidate_path)
        if model is None:
            _log.info("Unable to build a model")
            return candidate_path, eval_
        store.mkdirs(candidate_path)
        model_path = store.join(candidate_path, MODEL_FILE_NAME)
        pmml_io.write(model, model_path)
        # pre-publish integrity gate: a candidate that fails validation
        # is dropped entirely (path=None) so no selection branch — not
        # even the eval-disabled one — can ever publish it
        if not self.validate_model(model, candidate_path):
            _log.warning("Model for params %s failed integrity validation; "
                         "rejecting candidate %s", hyper_parameters, i)
            return None, eval_
        if not test:
            _log.info("No test data available to evaluate model")
        else:
            eval_ = self.evaluate(model, candidate_path, test, train)
        _log.info("Model eval for params %s: %s (%s)", hyper_parameters, eval_,
                  candidate_path)
        return candidate_path, eval_

    def _split_train_test(self, new_data, past_data):
        if self.test_fraction <= 0.0:
            return list(new_data) + list(past_data), []
        if self.test_fraction >= 1.0:
            return list(past_data), list(new_data)
        if not new_data:
            return list(past_data), []
        new_train, test = self.split_new_data_to_train_test(new_data)
        return list(new_train) + list(past_data), test
