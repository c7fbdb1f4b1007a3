"""Classification/regression routes (the RDF app's API).

Counterpart of ``oryx_tpu/serving/classreg.py`` (reference:
Predict.java:52 — GET /predict/{datum} and the POSTed batch; Train.java:42
— training examples onto the input topic; ClassificationDistribution.java:53
— per-class probabilities; FeatureImportance.java:46 —
/feature/importance(/{n})), with the reference's console page.
"""

from __future__ import annotations

from ..api.serving import OryxServingException
from ..app.rdf.serving import RDFServingModel
from ..common import text as text_utils
from ..lambda_rt.http import Request, Route
from .als import IDValue
from . import console
from .framework import get_serving_model, send_input

__all__ = ["ROUTES"]


def _rdf_model(req: Request) -> RDFServingModel:
    model = get_serving_model(req)
    if not isinstance(model, RDFServingModel):
        raise OryxServingException(503, "Model not available yet")
    return model


def _tokens(datum: str) -> list[str]:
    if not datum:
        raise OryxServingException(400, "Missing input data")
    return text_utils.parse_delimited(datum, ",")


def _body_lines(req: Request) -> list[str]:
    return [ln.strip() for ln in req.body.decode().splitlines()
            if ln.strip()]


def _predict_get(req: Request):
    model = _rdf_model(req)
    try:
        return model.predict(_tokens(req.params["datum"]))
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))


def _predict_post(req: Request):
    """Bulk prediction: one forest walk over all lines on the device."""
    model = _rdf_model(req)
    rows = [_tokens(line) for line in _body_lines(req)]
    if not rows:
        return []
    try:
        return model.predict_bulk(rows)
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))


def _train_datum(req: Request):
    # no model gate: training data must flow before the first model
    # exists (reference: Train.java writes the input topic directly)
    datum = req.params["datum"]
    if not datum:
        raise OryxServingException(400, "Missing input data")
    send_input(req, datum)
    return None


def _train_post(req: Request):
    for line in _body_lines(req):
        send_input(req, line)
    return None


def _classification_distribution(req: Request):
    model = _rdf_model(req)
    schema = model.input_schema
    if not schema.is_classification():
        raise OryxServingException(400, "Only applicable for classification")
    try:
        prediction = model.make_prediction(_tokens(req.params["datum"]))
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))
    target = schema.target_feature_index
    return [IDValue(model.encodings.decode(target, i), float(p))
            for i, p in enumerate(prediction.category_probabilities)]


def _predictor_importances(model: RDFServingModel) -> list[float]:
    """Importances indexed by PREDICTOR number (reference:
    RDFUpdate.countsToImportances sizes by getNumPredictors, so
    /feature/importance/{n} takes a predictor index — the target column
    is not a feature here).  The forest stores them all-features-indexed
    for PMML round-tripping; project down through the schema."""
    schema = model.input_schema
    imps = model.forest.feature_importances
    return [float(imps[schema.predictor_to_feature_index(p)])
            for p in range(schema.num_predictors)]


def _feature_importance_all(req: Request):
    return _predictor_importances(_rdf_model(req))


def _feature_importance_one(req: Request):
    importances = _predictor_importances(_rdf_model(req))
    try:
        number = int(req.params["featureNumber"])
    except ValueError:
        raise OryxServingException(400, "Bad feature number")
    if not 0 <= number < len(importances):
        raise OryxServingException(400, "Bad feature number")
    return importances[number]


ROUTES = [
    Route("GET", "/predict/{datum}", _predict_get),
    Route("POST", "/predict", _predict_post),
    Route("POST", "/train/{datum}", _train_datum, mutates=True),
    Route("POST", "/train", _train_post, mutates=True),
    Route("GET", "/classificationDistribution/{datum}",
          _classification_distribution),
    Route("GET", "/feature/importance", _feature_importance_all),
    Route("GET", "/feature/importance/{featureNumber}",
          _feature_importance_one),
    console.console_route("Random Decision Forest", [
        console.Endpoint("/predict/{0}", ("datum (CSV)",)),
        console.Endpoint("/classificationDistribution/{0}", ("datum (CSV)",)),
        console.Endpoint("/feature/importance"),
        console.Endpoint("/train/{0}", ("datum (CSV)",), method="POST"),
        console.Endpoint("/ready"),
    ]),
]
