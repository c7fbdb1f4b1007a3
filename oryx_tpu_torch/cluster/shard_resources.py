"""Replica-internal shard resources: the scatter-gather targets.

Counterpart of ``oryx_tpu/cluster/shard_resources.py``, copied whole.
Each replica's local top-k runs through ``merge.exact_local_top_n``,
whose plain dot queries go through the app-scope batcher into the
model's ``top_n_batch``: above the streaming threshold that is the
routed phase-A kernel on the card.

Registered by the serving layer when ``oryx.cluster.enabled`` is true.
Every response carries the replica's shard coordinates and model
generation so the router can detect topology or generation drift, and
top-k rows travel as ``[id, score, ordinal]`` triples — the ordinal is
the cluster's canonical tie-break (cluster/merge.py).

Surface:

========================  ===================================================
``GET  /shard/meta``      shard coords, generation, readiness, model shape
``GET  /shard/recommend/{userID}``  local exact top-k for the user (the
                          flagship internal resource; params mirror the
                          public ``/recommend``)
``POST /shard/query``     generic local query (JSON body): kinds
                          ``recommend`` / ``recommendToMany`` /
                          ``byVector`` / ``because`` / ``mostSurprising``
                          / ``allItemIDs``
``POST /shard/vectors``   bulk user/item vector fetch (users answer from
                          the replicated store; items only when local)
``GET  /shard/yty``       this shard's partial Gramian Y_s^T Y_s — the
                          router sums shards' partials into the full YtY
                          for anonymous/context fold-in
========================  ===================================================
"""

from __future__ import annotations

import numpy as np

from ..api.serving import OryxServingException
from ..app.als.serving_model import ALSServingModel
from ..lambda_rt.http import Request, Route
from ..serving.framework import get_serving_model
from .merge import canon_sort, exact_local_top_n

__all__ = ["ROUTES"]

# ordinal for items that never came through the update-topic replay
# (models built directly in tests/benches): pushes past any real
# ordinal; the canonical order's final id key keeps it total
_NO_ORDINAL = 1 << 62


def _manager(req: Request):
    return req.context["model_manager"]


def _als_model(req: Request) -> ALSServingModel:
    model = get_serving_model(req)
    if not isinstance(model, ALSServingModel):
        raise OryxServingException(503, "Model not available yet")
    return model


def _ordinal_of(manager):
    ordinals = getattr(manager, "item_ordinals", {})
    return lambda i: ordinals.get(i, _NO_ORDINAL)


def _envelope(req: Request, manager, **extra) -> dict:
    out = {
        "shard": getattr(manager, "shard_index", 0),
        "of": getattr(manager, "shard_count", 1),
        "generation": getattr(manager, "generation", 0),
    }
    batcher = req.context.get("top_n_batcher")
    if batcher is not None:
        # measured scoring queue wait, piggybacked on every internal
        # answer: the router's admission control reads the cluster's
        # live overload state from responses it already parses, no
        # extra scrape round
        out["queue_wait_ms"] = round(batcher.recent_queue_wait_ms(), 2)
    out.update(extra)
    return out


def _rescorer_from(model, spec: dict):
    provider = model.rescorer_provider
    hook = spec.get("rescorerHook")
    if provider is None or not hook:
        return None
    args = list(spec.get("rescorerArgs") or [])
    return getattr(provider, hook)(*args,
                                   list(spec.get("rescorerParams") or []))


def _local_rows(req: Request, model, manager, how_many: int, *,
                user_vector=None, cosine_to=None, exclude=(),
                rescorer=None, allowed=None, lowest=False):
    return exact_local_top_n(
        model, _ordinal_of(manager), how_many,
        user_vector=user_vector, cosine_to=cosine_to, exclude=exclude,
        rescorer=rescorer, allowed=allowed, lowest=lowest,
        batcher=req.context.get("top_n_batcher"), deadline=req.deadline)


# -- GET /shard/recommend/{userID} -------------------------------------------

def _shard_recommend(req: Request):
    model = _als_model(req)
    manager = _manager(req)
    user_id = req.params["userID"]
    how_many = req.q_int("howMany", 10)
    if how_many <= 0:
        raise OryxServingException(400, "howMany must be positive")
    consider_known = (req.q1("considerKnownItems", "false") == "true")
    user_vector = model.get_user_vector(user_id)
    if user_vector is None:
        raise OryxServingException(404, user_id)
    exclude = set() if consider_known else model.get_known_items(user_id)
    rescorer = None
    if model.rescorer_provider is not None:
        rescorer = model.rescorer_provider.get_recommend_rescorer(
            user_id, req.q_list("rescorerParams"))
    rows = _local_rows(req, model, manager, how_many,
                       user_vector=user_vector, exclude=exclude,
                       rescorer=rescorer)
    return _envelope(req, manager, rows=rows)


# -- POST /shard/query --------------------------------------------------------

def _kind_recommend(req, model, manager, q):
    user_id = str(q["userID"])
    user_vector = model.get_user_vector(user_id)
    if user_vector is None:
        raise OryxServingException(404, user_id)
    exclude = set() if q.get("considerKnownItems") \
        else model.get_known_items(user_id)
    rescorer = None
    if model.rescorer_provider is not None:
        rescorer = model.rescorer_provider.get_recommend_rescorer(
            user_id, list(q.get("rescorerParams") or []))
    return {"rows": _local_rows(req, model, manager, int(q["howMany"]),
                                user_vector=user_vector, exclude=exclude,
                                rescorer=rescorer)}


def _kind_recommend_to_many(req, model, manager, q):
    vectors, exclude, found = [], set(), []
    for uid in q["userIDs"]:
        v = model.get_user_vector(str(uid))
        if v is not None:
            vectors.append(v)
            found.append(str(uid))
            if not q.get("considerKnownItems"):
                exclude |= model.get_known_items(str(uid))
    if not vectors:
        raise OryxServingException(404, str(q["userIDs"]))
    mean_vector = np.mean(vectors, axis=0)
    rescorer = None
    if model.rescorer_provider is not None:
        rescorer = model.rescorer_provider.get_recommend_rescorer(
            str(q["userIDs"][0]), list(q.get("rescorerParams") or []))
    return {"rows": _local_rows(req, model, manager, int(q["howMany"]),
                                user_vector=mean_vector, exclude=exclude,
                                rescorer=rescorer),
            "found": found}


def _kind_by_vector(req, model, manager, q):
    """Generic top-k against explicit query vectors (the router's
    second phase after gathering item/user vectors): one result list
    per vector.  ``cosine`` selects mean-cosine scoring with ALL the
    vectors as one query (the /similarity contract); otherwise each
    vector is an independent dot-product query."""
    vectors = [np.asarray(v, dtype=np.float32) for v in q["vectors"]]
    exclude = set(map(str, q.get("exclude") or ()))
    if q.get("excludeKnownOf"):
        exclude |= model.get_known_items(str(q["excludeKnownOf"]))
    rescorer = _rescorer_from(model, q)
    how_many = int(q["howMany"])
    if q.get("cosine"):
        rows = _local_rows(req, model, manager, how_many,
                           cosine_to=np.stack(vectors, axis=1),
                           exclude=exclude, rescorer=rescorer)
        return {"multi": [rows]}
    return {"multi": [
        _local_rows(req, model, manager, how_many, user_vector=v,
                    exclude=exclude, rescorer=rescorer,
                    lowest=bool(q.get("lowest")))
        for v in vectors]}


def _kind_because(req, model, manager, q):
    """The user's LOCAL known items ranked by cosine to an explicit
    target vector — same host math as the public /because, restricted
    to this shard's slice; the router merges shard partials."""
    user_id = str(q["userID"])
    target = np.asarray(q["vector"], dtype=np.float32)
    norm = float(np.linalg.norm(target))
    ordinal = _ordinal_of(manager)
    rows = []
    for other in model.get_known_items(user_id):
        ov = model.get_item_vector(other)
        if ov is None:
            continue  # not this shard's item (or retired)
        denom = norm * float(np.linalg.norm(ov))
        rows.append((other,
                     float(np.dot(ov, target)) / denom if denom > 0
                     else 0.0, ordinal(other)))
    return {"rows": canon_sort(rows)[:int(q["howMany"])]}


def _kind_most_surprising(req, model, manager, q):
    user_id = str(q["userID"])
    xu = model.get_user_vector(user_id)
    if xu is None:
        raise OryxServingException(404, user_id)
    ordinal = _ordinal_of(manager)
    rows = []
    for iid in model.get_known_items(user_id):
        yi = model.get_item_vector(iid)
        if yi is not None:
            rows.append((iid, float(xu @ yi), ordinal(iid)))
    return {"rows": canon_sort(rows, lowest=True)[:int(q["howMany"])]}


def _kind_all_item_ids(req, model, manager, q):
    return {"ids": model.all_item_ids()}


_KINDS = {
    "recommend": _kind_recommend,
    "recommendToMany": _kind_recommend_to_many,
    "byVector": _kind_by_vector,
    "because": _kind_because,
    "mostSurprising": _kind_most_surprising,
    "allItemIDs": _kind_all_item_ids,
}


def _shard_query(req: Request):
    import json
    model = _als_model(req)
    manager = _manager(req)
    try:
        q = json.loads(req.body.decode("utf-8"))
        kind = q["kind"]
        fn = _KINDS[kind]
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, f"bad shard query: {e}") from e
    return _envelope(req, manager, **fn(req, model, manager, q))


# -- POST /shard/vectors ------------------------------------------------------

def _shard_vectors(req: Request):
    """Bulk vector fetch.  Users answer from the replicated full store;
    items answer only when LOCAL (the router asks each id's owner
    shard), absent ids map to null."""
    import json
    model = _als_model(req)
    manager = _manager(req)
    try:
        q = json.loads(req.body.decode("utf-8"))
    except ValueError as e:
        raise OryxServingException(400, f"bad body: {e}") from e

    def fetch(ids, getter):
        out = {}
        for i in ids or ():
            v = getter(str(i))
            out[str(i)] = None if v is None else [float(x) for x in v]
        return out

    return _envelope(req, manager,
                     users=fetch(q.get("users"), model.get_user_vector),
                     items=fetch(q.get("items"), model.get_item_vector))


# -- GET /shard/yty -----------------------------------------------------------

def _shard_yty(req: Request):
    """This shard's partial Gramian: sum over shards == the full-catalog
    YtY (row-disjoint slices), which the router feeds to the fold-in
    solver for anonymous/context recommendations.  A slice-loaded
    replica answers from the manifest's precomputed per-slice partials
    (summed at load — no device scan) until a live Y write outdates
    them; otherwise the store's one-matmul vtv runs."""
    model = _als_model(req)
    manager = _manager(req)
    precomputed = getattr(manager, "partial_yty", None)
    yty = precomputed() if callable(precomputed) else None
    if yty is None:
        yty = model.Y.vtv()
    return _envelope(req, manager, features=model.features,
                     implicit=bool(model.implicit),
                     yty=[[float(x) for x in row] for row in yty])


def _shard_meta(req: Request):
    manager = _manager(req)
    model = manager.get_model()
    out = _envelope(req, manager)
    fraction = model.get_fraction_loaded() if model is not None else 0.0
    out.update(
        ready=model is not None
        and fraction >= req.context["min_model_load_fraction"],
        fraction=fraction)
    if isinstance(model, ALSServingModel):
        out.update(features=model.features, implicit=bool(model.implicit),
                   users=len(model.X), items=len(model.Y))
    return out


ROUTES = [
    Route("GET", "/shard/meta", _shard_meta),
    Route("GET", "/shard/recommend/{userID}", _shard_recommend),
    Route("POST", "/shard/query", _shard_query),
    Route("POST", "/shard/vectors", _shard_vectors),
    Route("GET", "/shard/yty", _shard_yty),
]
