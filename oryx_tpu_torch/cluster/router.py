"""The scatter-gather gateway: the public serving front end, answered
by a horizontally-sharded replica fleet.

Counterpart of ``oryx_tpu/cluster/router.py``: the threaded front end
(HTTP/1.1 and HTTP/2, TLS and DIGEST auth included) or, with
``oryx.cluster.async.enabled``, the asyncio front end
(cluster/async_http.py); the scatter over the replicas' framed
transport or HTTP/1.1 socket pool; and the exact result cache with
single-flight coalescing (``oryx.cluster.cache.enabled``,
``oryx.cluster.coalesce.enabled``), fed by the membership consumer's
tap.  The region mirror's keys (``oryx.cluster.region.mirror.*``)
configure the mirror process that reads the same conf (cluster/mirror.py);
the router ignores them.  The router's fold-in solves on ``device``
(None means ``cuda``), as a replica's does.

``python -m oryx_tpu_torch router`` speaks the SAME public HTTP surface
as a single serving layer — endpoints, JSON/CSV negotiation, gzip, DIGEST
auth, HTTPS, ``X-Deadline-Ms`` — but holds no model: every item-scan
query scatters to the catalog shards discovered via update-topic
heartbeats (cluster/membership.py) and merges their exact local top-k
into the exact global top-N (cluster/merge.py).  The full user store
is replicated on every replica, so user-keyed lookups (known items,
most-active users) proxy to any live replica, and item-vector-keyed
math (estimates, similarity-to-item) gathers vectors from their owner
shards and computes at the gateway with the same host arithmetic the
single-node resources use.

Anonymous/context fold-in needs the full-catalog Gramian: the router
sums the shards' partial ``Y_s^T Y_s`` (``/shard/yty``, cached per
(shard, generation)) — row-disjoint slices sum to exactly the full
YtY — and runs the same ``ops.als_fold_in`` solve a replica would.

Degraded partial answers: when a shard is down or past deadline the
merge proceeds over the surviving shards, the response carries
``X-Oryx-Partial: shards=m/N``, and ``partial_answers`` counts on
``/metrics``.  When no shard survives: 503.  The router never
restarts over membership changes — kill/rejoin flows through the
registry (tests/test_cluster_it.py).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from typing import Sequence

import numpy as np

from ..api.serving import OryxServingException
from ..common import clock as clockmod
from ..common.config import Config
from ..common.device import bound, resolve_device, thread_card
from ..kafka import utils as kafka_utils
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF, KEY_UP
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..lambda_rt.http import HttpApp, Request, Route, TextResponse, \
    make_server
from ..lambda_rt.metrics import MetricsRegistry
from ..obs import (engine_from_config, events_from_config,
                   flight_from_config, merge_snapshots,
                   render_openmetrics_blocks,
                   render_prometheus_blocks, tracer_from_config)
from ..obs import profile as profile_mod
from ..obs.server import (OPENMETRICS_CTYPE, admin_diagnose,
                          admin_flight, admin_flight_dump,
                          admin_profile, admin_region, admin_slo,
                          admin_tail, admin_traces,
                          own_prometheus_snapshot)
from ..ops import als_fold_in
from ..ops.solver import SingularMatrixSolverException, get_solver
from ..resilience import faults
from ..resilience.policy import (CircuitBreaker, ResilientTopicProducer,
                                 Retry, resilience_snapshot,
                                 run_with_resubscribe)
from ..serving import console
from ..serving.als import IDCount, IDValue
from ..serving.als import _how_many_offset as how_many_offset
from ..serving.als import \
    _parse_id_value_segments as parse_id_value_segments
from ..serving.framework import send_input
from .admission import AdmissionController
from .membership import KEY_HEARTBEAT, MembershipRegistry
from .merge import Row, merge_top_n
from .result_cache import ResultCache
from .scatter import ScatterGather, ShardResponse, ShardUnavailable
from .sharding import shard_of

_log = logging.getLogger(__name__)

__all__ = ["RouterLayer", "ROUTES"]


# -- request-scope helpers ----------------------------------------------------

def _reg(req: Request) -> MembershipRegistry:
    return req.context["membership"]


def _sg(req: Request) -> ScatterGather:
    return req.context["scatter"]


def _partial_headers(req: Request, failed: Sequence[int]) -> dict[str, str]:
    """The degraded-answer marker; also counts the event."""
    if not failed:
        return {}
    n = _reg(req).shard_count
    req.context["metrics"].inc("partial_answers")
    return {"X-Oryx-Partial": f"shards={n - len(failed)}/{n}"}


def _id_values(rows: Sequence[Row]) -> list[IDValue]:
    return [IDValue(i, float(s)) for i, s, _ in rows]


def _collect_rows(responses: dict[int, ShardResponse],
                  key: str = "rows"
                  ) -> tuple[list[list[Row]], int, list[int]]:
    """Row lists from the 2xx shard responses, the consensus non-2xx
    status (404 passthrough when every answering shard said 404), and
    the shards that answered non-2xx while OTHERS had rows — replay
    skew (e.g. one replica absorbed a new user's vector before its
    peer): their catalog slice is missing from the merge, which must
    surface as a partial answer, never as a silently incomplete 200."""
    rows, statuses, odd = [], [], []
    for shard, r in responses.items():
        if r.ok:
            rows.append([(str(i), float(s), int(o))
                         for i, s, o in (r.payload or {}).get(key) or []])
        else:
            statuses.append(r.status)
            odd.append(shard)
    miss = statuses[0] if statuses and not rows \
        and all(s == statuses[0] for s in statuses) else 0
    return rows, miss, (sorted(odd) if rows else [])


def _raise_for(miss: int, what: str) -> None:
    if miss:
        raise OryxServingException(
            miss, what if miss == 404 else f"shard error {miss}: {what}")


def _qs(pairs: list[tuple[str, str]]) -> str:
    return ("?" + urllib.parse.urlencode(pairs)) if pairs else ""


def _scatter_query(req: Request, body: dict,
                   deadline=None) -> tuple[dict[int, ShardResponse],
                                           list[int]]:
    payload = json.dumps(body).encode("utf-8")
    return _sg(req).scatter("POST", "/shard/query", payload,
                            deadline or req.deadline)


def _gather_vectors(req: Request, item_ids: Sequence[str] = (),
                    user_ids: Sequence[str] = ()
                    ) -> tuple[dict[str, np.ndarray | None],
                               dict[str, np.ndarray | None], list[int]]:
    """Fetch vectors: items from their owner shards, users from any
    replica.  Returns (item id -> vector|None, user id -> vector|None,
    failed owner shards).  Item and user vectors live in SEPARATE maps:
    X and Y are independent stores single-node, so one string may
    legitimately name both a user and an item."""
    sg, n = _sg(req), _reg(req).shard_count
    items_out: dict[str, np.ndarray | None] = {}
    users_out: dict[str, np.ndarray | None] = {}
    failed: list[int] = []
    by_owner: dict[int, list[str]] = {}
    for iid in item_ids:
        by_owner.setdefault(shard_of(iid, n), []).append(iid)
    for shard, ids in by_owner.items():
        body = json.dumps({"items": ids}).encode("utf-8")
        try:
            r = sg.query_shard(shard, "POST", "/shard/vectors", body,
                               req.deadline)
        except ShardUnavailable:
            failed.append(shard)
            for iid in ids:
                items_out.setdefault(iid, None)
            continue
        items = (r.payload or {}).get("items") or {}
        for iid in ids:
            v = items.get(iid)
            items_out[iid] = None if v is None else np.asarray(v, np.float32)
    if user_ids:
        body = json.dumps({"users": list(user_ids)}).encode("utf-8")
        r = sg.any_replica("POST", "/shard/vectors", body, req.deadline)
        users = (r.payload or {}).get("users") or {}
        for uid in user_ids:
            v = users.get(uid)
            users_out[uid] = None if v is None else np.asarray(v, np.float32)
    return items_out, users_out, failed


# -- cluster-wide Gramian (fold-in support) ----------------------------------

def _cluster_solver(req: Request) -> tuple[object, bool, int, list[int]]:
    """(solver over the summed cluster YtY, implicit flag, features,
    failed shards).  Partial Gramians are cached per
    (shard, generation) so a stable cluster pays one /shard/yty round
    per shard per model generation: the registry's heartbeats already
    carry each shard's live generation, so a cache hit for it costs no
    network at all — /shard/yty is only fetched for shards whose
    generation moved (or was never seen).  At f features the payload is
    f^2 floats (~0.5 MB of JSON at f=250); shipping that per fold-in
    request would dwarf the fold-in itself."""
    cache: dict = req.context["yty_cache"]
    lock = req.context["yty_lock"]
    reg, sg = _reg(req), _sg(req)
    n = reg.shard_count
    entries: dict[int, tuple] = {}
    missing: list[int] = []
    with lock:
        for shard in range(n):
            cands = reg.candidates(shard)
            entry = None
            if cands:
                # heartbeat generation of the replica a query would
                # hit.  Keyed by TOPOLOGY too: shard 0 of 2 and shard
                # 0 of 3 are different catalog slices, and a live
                # reshard must never reuse the old ring's partial
                # Gramian under the new ring's shard number
                entry = cache.get((n, shard, cands[0].generation))
            if entry is None:
                missing.append(shard)
            else:
                entries[shard] = entry
    failed: list[int] = []
    if missing:
        # the lock covers only the cache dict — fetches run outside it
        # (and concurrently), so one stalled shard cannot serialize
        # every fold-in request in the cluster behind its timeout
        try:
            responses, failed = sg.scatter("GET", "/shard/yty",
                                           deadline=req.deadline,
                                           shards=missing)
        except ShardUnavailable:
            responses, failed = {}, list(missing)
        with lock:
            for shard, r in sorted(responses.items()):
                if not r.ok or not r.payload:
                    failed.append(shard)
                    continue
                entry = (np.asarray(r.payload["yty"], dtype=np.float64),
                         bool(r.payload.get("implicit", True)),
                         int(r.payload.get("features", 0)))
                # one entry per (topology, shard): drop older
                # generations, and drop OTHER topologies wholesale — a
                # retired ring's partial Gramians are features² float64
                # blocks that would otherwise pin forever across
                # repeated reshards.  Keyed by the generation the
                # REPLICA reports (authoritative; a heartbeat mid-swap
                # may lag it by one — the next request re-checks
                # against the fresher heartbeat)
                for k in [k for k in cache
                          if k[0] != n or k[1] == shard]:
                    del cache[k]
                cache[(n, shard,
                       int(r.payload.get("generation", 0)))] = entry
                entries[shard] = entry
    total = None
    implicit, features = True, 0
    for shard in sorted(entries):
        mat, implicit, features = entries[shard]
        features = features or int(mat.shape[0])
        total = mat if total is None else total + mat
    if total is None:
        raise OryxServingException(503, "no shard Gramian available")
    try:
        solver = get_solver(total, device=req.context["device"])
    except SingularMatrixSolverException as e:
        raise OryxServingException(
            503, "No solver available for model yet") from e
    return solver, implicit, features, sorted(set(failed))


def _fold_user_vector(req: Request, item_values: list[tuple[str, float]],
                      xu: np.ndarray | None
                      ) -> tuple[np.ndarray | None, int, list[int]]:
    """The gateway's EstimateForAnonymous.buildTemporaryUserVector:
    gather the context items' vectors from their owner shards, solve
    against the summed cluster Gramian, fold sequentially (the same
    ops.als_fold_in kernel a replica runs)."""
    solver, implicit, features, failed = _cluster_solver(req)
    vecs, _, failed_v = _gather_vectors(
        req, item_ids=[i for i, _ in item_values])
    xu = als_fold_in.fold_in_sequential(
        solver, list(item_values), lambda i: vecs.get(i), xu,
        implicit, features)
    return xu, features, sorted(set(failed) | set(failed_v))


# -- top-N family -------------------------------------------------------------

def _merged_response(req: Request, rows: list[list[Row]],
                     failed: Sequence[int], how_many: int, offset: int,
                     lowest: bool = False):
    tracer = req.context.get("tracer")
    if tracer is None:
        merged = merge_top_n(rows, how_many, offset, lowest=lowest)
    else:
        # the gather-side counterpart of the scatter's shard_call
        # spans: how long the exact cross-shard merge itself took
        with tracer.span("router.merge") as span:
            span.set_attr("shards_merged", len(rows))
            span.set_attr("rows_in", sum(len(r) for r in rows))
            merged = merge_top_n(rows, how_many, offset, lowest=lowest)
    return 200, _id_values(merged), _partial_headers(req, failed)


def _recommend(req: Request):
    how_many, offset = how_many_offset(req)
    k = how_many + offset
    pairs = [("howMany", str(k))]
    if req.q1("considerKnownItems"):
        pairs.append(("considerKnownItems", req.q1("considerKnownItems")))
    for p in req.q_list("rescorerParams"):
        pairs.append(("rescorerParams", p))
    path = ("/shard/recommend/"
            + urllib.parse.quote(req.params["userID"], safe="") + _qs(pairs))
    responses, failed = _sg(req).scatter("GET", path,
                                         deadline=req.deadline)
    rows, miss, odd = _collect_rows(responses)
    _raise_for(miss, req.params["userID"])
    return _merged_response(req, rows, sorted({*failed, *odd}),
                            how_many, offset)


def _recommend_to_many(req: Request):
    how_many, offset = how_many_offset(req)
    responses, failed = _scatter_query(req, {
        "kind": "recommendToMany",
        "userIDs": req.params["userIDs"].split("/"),
        "considerKnownItems":
            req.q1("considerKnownItems", "false") == "true",
        "howMany": how_many + offset,
        "rescorerParams": req.q_list("rescorerParams")})
    rows, miss, odd = _collect_rows(responses)
    _raise_for(miss, req.params["userIDs"])
    return _merged_response(req, rows, sorted({*failed, *odd}),
                            how_many, offset)


def _by_vector_scatter(req: Request, vectors, how_many: int,
                       exclude=(), cosine=False, lowest=False,
                       exclude_known_of=None, rescorer_hook=None,
                       rescorer_args=()):
    body = {"kind": "byVector",
            "vectors": [[float(x) for x in np.asarray(v, np.float32)]
                        for v in vectors],
            "howMany": how_many, "exclude": sorted(exclude),
            "cosine": cosine, "lowest": lowest}
    if exclude_known_of:
        body["excludeKnownOf"] = exclude_known_of
    if rescorer_hook:
        body["rescorerHook"] = rescorer_hook
        body["rescorerArgs"] = list(rescorer_args)
        body["rescorerParams"] = req.q_list("rescorerParams")
    return _scatter_query(req, body)


def _multi_rows(responses: dict[int, ShardResponse],
                index: int) -> list[list[Row]]:
    out = []
    for r in responses.values():
        if r.ok:
            multi = (r.payload or {}).get("multi") or []
            if index < len(multi):
                out.append([(str(i), float(s), int(o))
                            for i, s, o in multi[index]])
    return out


def _recommend_to_anonymous(req: Request):
    item_values = parse_id_value_segments(req.params["itemIDs"])
    how_many, offset = how_many_offset(req)
    xu, _, failed_fold = _fold_user_vector(req, item_values, None)
    if xu is None:
        raise OryxServingException(404, req.params["itemIDs"])
    known = sorted({i for i, _ in item_values})
    responses, failed = _by_vector_scatter(
        req, [xu], how_many + offset, exclude=known,
        rescorer_hook="get_recommend_to_anonymous_rescorer",
        rescorer_args=[known])
    rows = _multi_rows(responses, 0)
    return _merged_response(req, rows, sorted(set(failed) | set(failed_fold)),
                            how_many, offset)


def _recommend_with_context(req: Request):
    user_id = req.params["userID"]
    item_values = parse_id_value_segments(req.params["itemIDs"])
    how_many, offset = how_many_offset(req)
    _, users, _ = _gather_vectors(req, user_ids=[user_id])
    xu = users.get(user_id)
    if xu is None:
        raise OryxServingException(404, user_id)
    xu, _, failed_fold = _fold_user_vector(req, item_values, xu)
    responses, failed = _by_vector_scatter(
        req, [xu], how_many + offset,
        exclude={i for i, _ in item_values}, exclude_known_of=user_id,
        rescorer_hook="get_recommend_rescorer", rescorer_args=[user_id])
    rows = _multi_rows(responses, 0)
    return _merged_response(req, rows, sorted(set(failed) | set(failed_fold)),
                            how_many, offset)


# -- similarity family --------------------------------------------------------

def _similarity(req: Request):
    item_ids = req.params["itemIDs"].split("/")
    how_many, offset = how_many_offset(req)
    vecs, _, failed_own = _gather_vectors(req, item_ids=item_ids)
    for iid in item_ids:
        if vecs.get(iid) is None:
            if shard_of(iid, _reg(req).shard_count) in failed_own:
                raise OryxServingException(
                    503, f"shard owning {iid} unavailable")
            raise OryxServingException(404, iid)
    responses, failed = _by_vector_scatter(
        req, [vecs[i] for i in item_ids], how_many + offset,
        exclude=set(item_ids), cosine=True,
        rescorer_hook="get_most_similar_items_rescorer")
    rows = _multi_rows(responses, 0)
    return _merged_response(req, rows, failed, how_many, offset)


def _similarity_to_item(req: Request):
    to_item = req.params["toItemID"]
    item_ids = req.params["itemIDs"].split("/")
    vecs, _, failed_own = _gather_vectors(req, item_ids=[to_item] + item_ids)

    def _vec(iid):
        v = vecs.get(iid)
        if v is None:
            if shard_of(iid, _reg(req).shard_count) in failed_own:
                raise OryxServingException(
                    503, f"shard owning {iid} unavailable")
            raise OryxServingException(404, iid)
        return v

    to_vec = _vec(to_item)
    to_norm = float(np.linalg.norm(to_vec))
    out = []
    for iid in item_ids:
        v = _vec(iid)
        denom = to_norm * float(np.linalg.norm(v))
        out.append(IDValue(iid, float(np.dot(v, to_vec)) / denom
                           if denom > 0 else 0.0))
    return out


# -- estimates ----------------------------------------------------------------

def _estimate(req: Request):
    user_id = req.params["userID"]
    item_ids = req.params["itemIDs"].split("/")
    vecs, users, failed = _gather_vectors(req, item_ids=item_ids,
                                          user_ids=[user_id])
    xu = users.get(user_id)
    if xu is None:
        raise OryxServingException(404, user_id)
    out = []
    for iid in item_ids:
        yi = vecs.get(iid)
        out.append(IDValue(iid, 0.0 if yi is None
                           else float(xu @ yi)))
    # items owned by a dead shard estimate as 0.0 (the unknown-item
    # value) under the partial marker rather than failing the request
    return 200, out, _partial_headers(req, failed)


def _estimate_for_anonymous(req: Request):
    to_item = req.params["toItemID"]
    vecs, _, failed_own = _gather_vectors(req, item_ids=[to_item])
    to_vec = vecs.get(to_item)
    if to_vec is None:
        if shard_of(to_item, _reg(req).shard_count) in failed_own:
            raise OryxServingException(
                503, f"shard owning {to_item} unavailable")
        raise OryxServingException(404, to_item)
    item_values = parse_id_value_segments(req.params["itemIDs"])
    xu, _, failed = _fold_user_vector(req, item_values, None)
    value = 0.0 if xu is None else float(np.dot(xu, to_vec))
    return 200, value, _partial_headers(req, failed)


# -- known-items math ---------------------------------------------------------

def _because(req: Request):
    how_many, offset = how_many_offset(req)
    item_id = req.params["itemID"]
    vecs, _, failed_own = _gather_vectors(req, item_ids=[item_id])
    target = vecs.get(item_id)
    if target is None:
        if shard_of(item_id, _reg(req).shard_count) in failed_own:
            raise OryxServingException(
                503, f"shard owning {item_id} unavailable")
        raise OryxServingException(404, item_id)
    responses, failed = _scatter_query(req, {
        "kind": "because", "userID": req.params["userID"],
        "vector": [float(x) for x in target],
        "howMany": how_many + offset})
    rows, miss, odd = _collect_rows(responses)
    _raise_for(miss, req.params["userID"])
    return _merged_response(req, rows, sorted({*failed, *odd}),
                            how_many, offset)


def _most_surprising(req: Request):
    how_many, offset = how_many_offset(req)
    responses, failed = _scatter_query(req, {
        "kind": "mostSurprising", "userID": req.params["userID"],
        "howMany": how_many + offset})
    rows, miss, odd = _collect_rows(responses)
    _raise_for(miss, req.params["userID"])
    return _merged_response(req, rows, sorted({*failed, *odd}),
                            how_many, offset, lowest=True)


# -- proxied user-store endpoints --------------------------------------------

def _proxy_any(req: Request):
    """Forward to any live replica: these endpoints answer from the
    user store / known-items map, which every replica holds in full."""
    query = ""
    if req.query:
        query = "?" + urllib.parse.urlencode(
            [(k, v) for k, vs in req.query.items() for v in vs])
    # req.path arrives URL-DECODED from the front end: re-quote it for
    # the hand-rolled request line (an id with a space or non-latin-1
    # characters must round-trip the internal hop like any other)
    path = urllib.parse.quote(req.path, safe="/")
    try:
        r = _sg(req).any_replica("GET", path + query,
                                 deadline=req.deadline)
    except ShardUnavailable as e:
        raise OryxServingException(503, str(e)) from e
    if not r.ok:
        raise OryxServingException(r.status, str(r.payload))
    return r.payload


def _most_counts(req: Request):
    payload = _proxy_any(req)
    return [IDCount(str(d["id"]), int(d["count"])) for d in payload or []]


def _all_item_ids(req: Request):
    responses, failed = _scatter_query(req, {"kind": "allItemIDs"})
    seen, out = set(), []
    for _, r in sorted(responses.items()):
        if r.ok:
            for i in (r.payload or {}).get("ids") or []:
                if i not in seen:
                    seen.add(i)
                    out.append(i)
    return 200, out, _partial_headers(req, failed)


def _popular_representative_items(req: Request):
    try:
        meta = _sg(req).any_replica("GET", "/shard/meta",
                                    deadline=req.deadline)
    except ShardUnavailable as e:
        raise OryxServingException(503, str(e)) from e
    features = int((meta.payload or {}).get("features") or 0)
    if not features:
        raise OryxServingException(503, "Model not available yet")
    eye = np.eye(features, dtype=np.float32)
    responses, failed = _by_vector_scatter(req, list(eye), 1)
    items = []
    for i in range(features):
        top = merge_top_n(_multi_rows(responses, i), 1)
        items.append(top[0][0] if top else None)
    return 200, items, _partial_headers(req, failed)


# -- write path ---------------------------------------------------------------

def _gate_writes(req: Request) -> None:
    # parity with the single-node model gate: 503 while nothing could
    # serve the data back (no live replica at all)
    if not _reg(req).any_candidates():
        raise OryxServingException(503, "no live replica")


def _pref_post(req: Request):
    _gate_writes(req)
    body = req.body.decode().strip()
    value = body if body else "1"
    float(value)
    send_input(req, f"{req.params['userID']},{req.params['itemID']},{value}")
    return None


def _pref_delete(req: Request):
    _gate_writes(req)
    send_input(req, f"{req.params['userID']},{req.params['itemID']},")
    return None


def _ingest(req: Request):
    from ..serving.als import _ingest as serving_ingest
    _gate_writes(req)
    return serving_ingest(req)


# -- result-cache admin -------------------------------------------------------

def _cache(req: Request) -> "ResultCache":
    rc = req.context.get("result_cache")
    if rc is None:
        raise OryxServingException(
            404, "result cache disabled (oryx.cluster.cache.enabled / "
                 "oryx.cluster.coalesce.enabled)")
    return rc


def _cache_get(req: Request):
    """Operator stats for the exact result cache + coalescer: entry
    and byte occupancy, hit rate, invalidation/eviction/flush counts,
    in-flight coalesced scatters (docs/SCALING.md)."""
    return _cache(req).stats()


def _cache_flush(req: Request):
    """Drop every cached entry (the operator hatch — e.g. after
    arming a rescorer provider on the replicas, whose output the
    cache must not outlive)."""
    rc = _cache(req)
    return {"flushed": rc.flush("admin"), "stats": rc.stats()}


# -- topology admin -----------------------------------------------------------

def _topology_get(req: Request):
    """Reshard/topology status: the merged topology, the declared
    warming target's coverage and worst warm fraction, retired
    topologies, and the stale-heartbeat counter — the view the reshard
    runbook watches between 'start the M-way fleet' and 'cutover
    happened' (docs/SCALING.md)."""
    return _reg(req).topology_status()


def _topology_post(req: Request):
    """Declare a reshard target: ``{"of": M}``.  New-topology replicas'
    heartbeats are accepted from now on, and the router cuts over
    atomically once every one of the M shards has a live ready
    replica.  Declaring a retired topology un-retires it (scale back
    down); declaring the merged topology cancels a pending target."""
    try:
        body = json.loads(req.body.decode("utf-8"))
        of = int(body["of"])
    except (ValueError, TypeError, KeyError) as e:
        raise OryxServingException(
            400, f'body must be {{"of": M}}: {e}') from e
    try:
        return _reg(req).begin_reshard(of)
    except ValueError as e:
        raise OryxServingException(400, str(e)) from e


# -- framework ----------------------------------------------------------------

def _ready(req: Request):
    """200 when every catalog shard has a live ready replica."""
    reg = _reg(req)
    covered = reg.covered_shards()
    if len(covered) < reg.shard_count or reg.shard_count < 1:
        raise OryxServingException(
            503, f"shards covered: {len(covered)}/{reg.shard_count}")
    return None


def _prometheus_metrics(req: Request, registry: MetricsRegistry,
                        fmt: str):
    """The router's non-JSON /metrics forms.  ``prometheus-json`` is
    the router's OWN mergeable snapshot; ``prometheus`` and
    ``openmetrics`` additionally scrape every live replica's snapshot
    and render the cluster-wide merge — fixed-bucket histogram counts
    sum exactly across replicas (obs/prom.py), which reservoir
    percentiles never could.  The OpenMetrics form carries each
    bucket's exemplar through the merge (newest per bucket wins), so a
    cluster-wide p99 bucket still names one concrete trace."""
    snap = own_prometheus_snapshot(req, registry)
    if fmt == "prometheus-json":
        return snap
    scraped = _sg(req).scrape_replicas(
        "/metrics?format=prometheus-json", deadline=req.deadline)
    merged = merge_snapshots([payload for _, payload in scraped])
    # how many replicas the merged block actually covers: a replica
    # that failed its scrape is silently absent from the sums, and the
    # reader must be able to tell a full view from a partial one
    merged["gauges"] = {"scraped_replicas": len(scraped)}
    # one exposition for both blocks: the text format allows exactly
    # one # TYPE line per metric name, so the families are emitted
    # once with router- and replica-labeled samples grouped together
    blocks = [(snap, {"tier": "router"}), (merged, {"tier": "replica"})]
    if fmt == "openmetrics":
        return TextResponse(render_openmetrics_blocks(blocks),
                            content_type=OPENMETRICS_CTYPE)
    return TextResponse(render_prometheus_blocks(blocks))


def _metrics(req: Request):
    registry: MetricsRegistry = req.context["metrics"]
    fmt = req.q1("format", "json")
    if fmt in ("prometheus", "prometheus-json", "openmetrics"):
        return _prometheus_metrics(req, registry, fmt)
    out = {
        "routes": registry.snapshot(),
        "counters": registry.counters_snapshot(),
        "cluster": {
            "membership": _reg(req).snapshot(),
            "scatter": _sg(req).stats(),
            "covered_shards": _reg(req).covered_shards(),
        },
        "resilience": resilience_snapshot(),
    }
    admission = req.context.get("admission")
    if admission is not None:
        out["cluster"]["admission"] = admission.stats()
    ingest_gate = req.context.get("ingest_gate")
    if ingest_gate is not None:
        out["cluster"]["ingest"] = ingest_gate.stats()
    result_cache = req.context.get("result_cache")
    if result_cache is not None:
        out["cluster"]["cache"] = result_cache.stats()
    gauges = registry.gauges_snapshot()
    if gauges:
        out["freshness"] = gauges
    tracer = req.context.get("tracer")
    if tracer is not None:
        out["obs"] = {"trace_record_failures": tracer.record_failures}
    return out


def _error(req: Request):
    from ..serving.framework import _error as framework_error
    return framework_error(req)


ROUTES = [
    # admission=True marks the scatter data plane: when the admission
    # controller measures overload these shed as fast 503 + Retry-After
    # (cluster/admission.py); health/admin/write endpoints stay open.
    # cache=True marks the exact-result-cache surface (routes whose
    # answers have a precise per-user/per-item invalidation key —
    # cluster/result_cache.py); a hit bypasses the admission gate.
    Route("GET", "/recommend/{userID}", _recommend, admission=True,
          cache=True),
    Route("GET", "/recommendToMany/{userIDs:+}", _recommend_to_many,
          admission=True, cache=True),
    Route("GET", "/recommendToAnonymous/{itemIDs:+}",
          _recommend_to_anonymous, admission=True, cache=True),
    Route("GET", "/recommendWithContext/{userID}/{itemIDs:+}",
          _recommend_with_context, admission=True, cache=True),
    Route("GET", "/similarity/{itemIDs:+}", _similarity, admission=True,
          cache=True),
    Route("GET", "/similarityToItem/{toItemID}/{itemIDs:+}",
          _similarity_to_item, admission=True, cache=True),
    Route("GET", "/estimate/{userID}/{itemIDs:+}", _estimate,
          admission=True, cache=True),
    Route("GET", "/estimateForAnonymous/{toItemID}/{itemIDs:+}",
          _estimate_for_anonymous, admission=True, cache=True),
    Route("GET", "/because/{userID}/{itemID}", _because, admission=True,
          cache=True),
    Route("GET", "/mostSurprising/{userID}", _most_surprising,
          admission=True, cache=True),
    Route("GET", "/mostActiveUsers", _most_counts, admission=True),
    Route("GET", "/mostPopularItems", _most_counts, admission=True),
    Route("GET", "/popularRepresentativeItems",
          _popular_representative_items, admission=True),
    Route("GET", "/user/allIDs", _proxy_any, admission=True),
    Route("GET", "/allUserIDs", _proxy_any, admission=True),
    Route("GET", "/item/allIDs", _all_item_ids, admission=True),
    Route("GET", "/allItemIDs", _all_item_ids, admission=True),
    Route("GET", "/knownItems/{userID}", _proxy_any, admission=True,
          cache=True),
    Route("POST", "/pref/{userID}/{itemID}", _pref_post, mutates=True),
    Route("DELETE", "/pref/{userID}/{itemID}", _pref_delete, mutates=True),
    Route("POST", "/ingest", _ingest, mutates=True),
    Route("GET", "/ready", _ready),
    Route("GET", "/metrics", _metrics),
    # ?join=1 merges every live replica's ring by trace id — the
    # cluster-complete view /admin/tail consumes by default
    Route("GET", "/admin/traces", admin_traces),
    Route("GET", "/admin/tail", admin_tail),
    Route("GET", "/admin/slo", admin_slo),
    # mutating: captures device state to disk — read-only mode and
    # DIGEST auth (when configured) both gate it
    Route("GET", "/admin/profile", admin_profile, mutates=True),
    # region identity: which active-active region answered — the
    # failover runbook's first probe (docs/SCALING.md "Multi-region")
    Route("GET", "/admin/region", admin_region),
    # flight recorder + cluster auto-triage (obs/flight.py,
    # obs/diagnose.py); /admin/flight 404s until the config gate opens,
    # /admin/diagnose joins every live replica's surface via ?join=1
    Route("GET", "/admin/flight", admin_flight),
    Route("GET", "/admin/diagnose", admin_diagnose),
    # mutating: writes a bundle to the store AND fans the dump
    # cluster-wide when the trigger originates here
    Route("POST", "/admin/flight/dump", admin_flight_dump,
          mutates=True),
    # elastic-topology admin: reshard status + target declaration
    Route("GET", "/admin/topology", _topology_get),
    Route("POST", "/admin/topology", _topology_post, mutates=True),
    # result-cache admin: occupancy/hit-rate stats + the flush hatch
    Route("GET", "/admin/cache", _cache_get),
    Route("POST", "/admin/cache/flush", _cache_flush, mutates=True),
    Route("GET", "/error", _error),
    console.console_route("ALS scatter-gather gateway", [
        console.Endpoint("/recommend/{0}", ("userID",)),
        console.Endpoint("/similarity/{0}/{1}", ("itemID1", "itemID2")),
        console.Endpoint("/estimate/{0}/{1}", ("userID", "itemID")),
        console.Endpoint("/mostPopularItems"),
        console.Endpoint("/allUserIDs"),
        console.Endpoint("/metrics"),
        console.Endpoint("/ready"),
    ]),
]


class RouterLayer:
    """start()/await_()/close() around the gateway HTTP server and the
    membership consumer — the same lifecycle contract as the other
    layers, so ``python -m oryx_tpu_torch router`` runs supervised like
    the rest.  ``port`` overrides the configured one (0 picks a free
    one); ``device`` (None means ``cuda``) is where the fold-in
    solves."""

    def __init__(self, config: Config, port: int | None = None,
                 device=None):
        self.config = config
        # without a card, fail at boot, not at the first fold-in
        self.device = resolve_device(device)
        api = "oryx.serving.api"
        self.keystore_file = config.get_optional_string(f"{api}.keystore-file")
        self.keystore_password = config.get_optional_string(
            f"{api}.keystore-password")
        if port is not None:
            self.port = port
        elif self.keystore_file:
            self.port = config.get_int(f"{api}.secure-port")
        else:
            self.port = config.get_int(f"{api}.port")
        self.read_only = config.get_bool(f"{api}.read-only")
        self.update_broker = config.get_optional_string(
            "oryx.update-topic.broker")
        self.update_topic = config.get_optional_string(
            "oryx.update-topic.message.topic")
        self.input_broker = config.get_optional_string(
            "oryx.input-topic.broker")
        self.input_topic = config.get_optional_string(
            "oryx.input-topic.message.topic")
        if not (self.update_broker and self.update_topic):
            raise ValueError("router requires an update topic for "
                             "replica membership")
        faults.configure_from_config(config)
        ttl = config.get_int("oryx.cluster.heartbeat-ttl-ms") / 1000.0
        # region-pinned membership (multi-region serving): a foreign
        # region's heartbeats on this topic — a mirror misconfiguration
        # — are rejected, never routed (docs/SCALING.md "Multi-region")
        self.region = config.get_optional_string(
            "oryx.cluster.region.name")
        self.membership = MembershipRegistry(ttl, region=self.region)
        # sampled distributed tracing (obs/trace.py; None = disabled):
        # the request span opens at the HTTP dispatcher, each shard
        # query runs under a router.shard_call span whose context rides
        # the internal hop as the `traceparent` header
        self.tracer = tracer_from_config(config, "router")
        self.scatter = ScatterGather(self.membership, config,
                                     tracer=self.tracer)
        self.metrics = MetricsRegistry()
        # measured-queue-wait admission control (cluster/admission.py;
        # both gates default 0 = off — the shipped router admits all)
        self.admission = AdmissionController(config, self.scatter,
                                             self.metrics)
        # the admission signal, visible as a freshness-style gauge so
        # the autoscaler and operators read the same number the gate
        # uses
        self.metrics.gauge_fn("cluster_queue_wait_ms",
                              self.scatter.cluster_queue_wait_ms)
        # exact result cache + single-flight coalescing on the scatter
        # hot path (cluster/result_cache.py; None = both gates off),
        # invalidated precisely from the same update-topic tap the
        # membership consumer runs — no extra consumer, no TTLs
        self.result_cache = ResultCache.from_config(
            config, self.metrics, self.membership)
        # SLO burn-rate engine over the router's own exactly-mergeable
        # bucket counters (obs/slo.py; None = disabled).  Evaluated
        # lazily on gauge reads, alert state at /admin/slo, and the
        # burn gauge is the autoscaler's SLO pressure signal.
        self.slo_engine = engine_from_config(config, self.metrics)
        if self.slo_engine is not None:
            self.metrics.gauge_fn("slo_burn_rate",
                                  self.slo_engine.burn_gauge)
            self.metrics.gauge_fn("slo_error_budget_remaining",
                                  self.slo_engine.budget_gauge)
        # wide-event request log (obs/events.py; None = disabled)
        self.events = events_from_config(config, "router", self.metrics)
        if self.events is not None:
            reg = self.metrics

            def _event_context() -> dict:
                # requests that served while
                # the write path was shedding carry the cumulative count
                n = int(reg.counters_snapshot().get("ingest_sheds", 0))
                return {"ingest_sheds": n} if n else {}

            self.events.context_fn = _event_context
        # flight recorder (obs/flight.py; None until the config gate
        # opens).  The router is the trigger fan-out root: its dump's
        # trigger id rides a POST to every live ready replica over the
        # scatter transport, so one page yields one correlated bundle
        # per live process.
        self.flight = flight_from_config(config, "router", self.metrics,
                                         slo=self.slo_engine)
        if self.flight is not None:
            flight = self.flight
            sg = self.scatter
            flight.fan_out = lambda tid, reason: len(sg.scrape_replicas(
                f"/admin/flight/dump?trigger={tid}&reason={reason}",
                method="POST"))
            if self.slo_engine is not None:
                # page transition -> one debounced cluster-wide dump;
                # the callback runs with the SLO lock held and
                # trigger() never re-enters the engine
                self.slo_engine.on_page = \
                    lambda name, st: flight.trigger(
                        "slo-page", {"objective": name,
                                     "burn_5m": st.get("burn_5m")})
        self.input_producer = None
        self.input_breaker = CircuitBreaker.from_config(
            "router-input", config)
        if not self.read_only and self.input_broker and self.input_topic:
            if not config.get_bool("oryx.serving.no-init-topics"):
                kafka_utils.maybe_create_topic(
                    self.input_broker, self.input_topic,
                    partitions=kafka_utils.input_topic_partitions(config))
            self.input_producer = ResilientTopicProducer(
                InProcTopicProducer(self.input_broker, self.input_topic),
                retry=Retry.from_config("router-input-send", config),
                breaker=self.input_breaker)
        # write-path admission (serving/ingest.py), the scatter
        # AdmissionController's twin: bounded in-flight input-topic
        # appends + measured-send-lag shedding around the /ingest and
        # /pref produce only — fast 503 + Retry-After + ingest_sheds,
        # health/admin/read routes never gated
        from ..serving.ingest import IngestGate
        self.ingest_gate = IngestGate(config, self.metrics)
        if not self.ingest_gate.enabled:
            self.ingest_gate = None
        self._stop = threading.Event()
        self._consume_thread: threading.Thread | None = None
        self._server = None
        self._server_thread: threading.Thread | None = None
        # the asyncio front end (cluster/async_http.py): cache hits and
        # coalesced followers never leave the loop, misses bridge to a
        # fixed worker pool, and concurrency is bounded by file
        # descriptors instead of thread stacks
        self.async_enabled = config.get_bool("oryx.cluster.async.enabled")
        self._frontend = None
        self.app = HttpApp(
            ROUTES,
            context={
                "membership": self.membership,
                "scatter": self.scatter,
                "metrics": self.metrics,
                "tracer": self.tracer,
                "config": config,
                "device": self.device,
                "thread_card": thread_card(self.device),
                "input_producer": self.input_producer,
                "ingest_gate": self.ingest_gate,
                "admission":
                    self.admission if self.admission.enabled else None,
                "result_cache": self.result_cache,
                "slo": self.slo_engine,
                "events": self.events,
                "flight": self.flight,
                "yty_cache": {},
                "yty_lock": threading.Lock(),
                # /admin/region enrichment: the router's region answers
                # with its routed topology + epoch so a failover
                # runbook reads identity AND health in one probe
                "region_info": self._region_info,
            },
            read_only=self.read_only,
            user_name=config.get_optional_string(f"{api}.user-name"),
            password=config.get_optional_string(f"{api}.password"),
            context_path=config.get_string(f"{api}.context-path"),
            request_deadline_ms=config.get_int(
                "oryx.resilience.request-deadline-ms"),
        )

    def _region_info(self) -> dict:
        """The router's /admin/region block: identity + the local
        fleet's routed topology and cache epoch, so re-pointed clients
        can verify both WHERE they landed and that the region can
        serve (the failover runbook's one probe)."""
        of, gens, mixed = self.membership.generation_topology()
        return {
            "role": "router",
            "merged_of": of,
            "covered_shards": self.membership.covered_shards(),
            "generation_epoch": list(gens),
            "epoch_mixed": mixed,
        }

    # -- lifecycle -----------------------------------------------------------

    def _consume_membership(self) -> None:
        broker = resolve_broker(self.update_broker)
        rc = self.result_cache
        cutovers_seen = self.membership.topology_cutovers
        tailed_before = [False]

        def tail():
            nonlocal cutovers_seen
            # from the current end: membership is periodic state, not
            # history — replicas re-announce every interval, so the
            # registry is complete one heartbeat period after start.
            # The cache's invalidations are one-shot, though: a
            # resubscribe skips whatever UP records went by during the
            # gap, so the restarted tail flushes the epoch
            if tailed_before[0] and rc is not None:
                rc.flush("tap-resubscribe")
            tailed_before[0] = True
            for km in broker.consume(self.update_topic,
                                     from_beginning=False,
                                     stop=self._stop):
                if km.key == KEY_HEARTBEAT:
                    if not self.membership.note_message(km.message):
                        # dropped: a retired fleet still announcing, or
                        # a misconfigured i/N replica whose ring does
                        # not exist here — countable, never merged
                        self.metrics.inc("stale_topology_heartbeats")
                    if rc is not None:
                        # a topology cutover retires a whole ring: its
                        # entries can never be served (the topology is
                        # in every key) — reclaim their bytes now
                        cut = self.membership.topology_cutovers
                        if cut != cutovers_seen:
                            cutovers_seen = cut
                            rc.flush("topology-cutover")
                elif rc is not None:
                    # the cache's invalidation feed rides the same tap:
                    # an UP evicts exactly the touched user's or item's
                    # keys, a model publish flushes the epoch
                    if km.key == KEY_UP:
                        rc.note_up(km.message)
                    elif km.key in (KEY_MODEL, KEY_MODEL_REF):
                        rc.note_generation_publish()

        run_with_resubscribe(tail, stop=self._stop,
                             what="router membership consumer", log=_log)

    def start(self) -> None:
        self._consume_thread = threading.Thread(
            target=bound(self._consume_membership, self.app.thread_card),
            daemon=True,
            name="RouterMembership")
        self._consume_thread.start()
        ssl_context = None
        if self.keystore_file:
            import ssl
            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(self.keystore_file,
                                        password=self.keystore_password)
        self.scheme = "https" if ssl_context is not None else "http"
        if self.config.get_optional_string("oryx.obs.profile-dir"):
            # /admin/profile captures on a handler's thread
            profile_mod.prime()
        if self.async_enabled:
            from .async_http import AsyncFrontEnd
            self._frontend = AsyncFrontEnd(self.app, self.port,
                                           self.config,
                                           ssl_context=ssl_context)
            self._frontend.start()
            self.port = self._frontend.port
            fe = self._frontend
            self.metrics.gauge_fn("async_open_connections",
                                  lambda: float(fe.open_connections))
            self.metrics.gauge_fn("async_loop_lag_ms",
                                  lambda: float(fe.loop_lag_ms))
            _log.info("Router (async front end) listening on port %d",
                      self.port)
        else:
            self._server = make_server(self.app, self.port,
                                       ssl_context=ssl_context)
            self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="RouterHTTP")
            self._server_thread.start()
            _log.info("Router listening on port %d", self.port)
        if self.scatter.transport is not None:
            sg = self.scatter
            self.metrics.gauge_fn(
                "transport_open_connections",
                lambda: float(sg.transport.open_connections()))

    def await_(self) -> None:
        if self._frontend is not None:
            while self._frontend.is_alive():
                clockmod.sleep(1.0)
            return
        while self._server_thread and self._server_thread.is_alive():
            self._server_thread.join(1.0)

    def close(self) -> None:
        self._stop.set()
        if self._frontend is not None:
            self._frontend.shutdown()
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        self.scatter.close()
        if self.flight is not None:
            self.flight.close()
        if self.events is not None:
            self.events.close()
        if self.input_producer:
            self.input_producer.close()
        for t in (self._consume_thread, self._server_thread):
            if t:
                t.join(10.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
