"""Router hot path: exact result cache, fold-in invalidation, and
single-flight coalescing.

Counterpart of ``oryx_tpu/cluster/result_cache.py``, whole.

Every routed request today pays scatter → shard-score → gather →
exact-merge → JSON-encode.  BENCH_GATEWAY rounds put that path — not
the device — at the throughput ceiling, while the workload's structure
says most of the work is redundant: recommendation traffic is heavily
skewed toward hot users and identical repeated queries, and the model
only changes at generation publishes and per-user UP fold-ins.  This
module exploits exactly that structure:

**Exact result cache.**  Key = (route class, canonicalized path+args,
model generation, topology id); value = the *fully rendered* response
body — JSON bytes rendered at store time, CSV and gzip variants
rendered once on first demand — in a bounded LRU with a byte budget.
Only complete, header-less 200s are cacheable: partial answers
(``X-Oryx-Partial``), errors, bodiless (None) results, and requests
carrying ``rescorerParams``
(a per-request rescorer parameterization the router cannot prove pure)
are never stored.  A hit bypasses ``json_or_csv``, gzip, and admission
shedding entirely (it costs no device or queue time), stamped
``X-Oryx-Cache: hit``.

**Precise invalidation — no TTLs.**  The router already tails the
update topic for HB membership; the same tap feeds the cache:

- an UP record names the user (``["X", user, vec, ...]``) or item
  (``["Y", item, vec, [user]]``) the speed layer's fold-in touched —
  exactly that user's / item's tagged keys are evicted, nobody else's;
- a MODEL/MODEL-REF publish or a topology cutover flushes the epoch
  wholesale (the generation and topology also live in the key, so a
  stale epoch could never be *served* — the flush reclaims the bytes
  and is the safety valve when the invalidation feed stalls, chaos
  point ``router-cache-stale-feed``).

Entries additionally refuse to store (or to be shared with coalesced
followers) when any of their tags was invalidated after the request
began or within the quarantine window just before it (``_seq``
fencing + ``invalidation-quarantine-ms``): a scatter that read
pre-fold-in replica state can never insert over a newer invalidation.
Freshness contract, per tag: once the tap has a user's/item's UP
record, that user's/item's keys never serve their pre-fold-in rows
again (bounded by the tap's replay lag — the tap and the replicas
consume the same totally ordered topic).  Cross-entry effects — an
untouched user's cached ranking over item vectors some OTHER user's
fold-in nudged — persist until that entry's own tags are touched, it
is evicted, or the next generation publish: the same freshness the
speed layer itself gives untouched users (the residual-window
argument in docs/SCALING.md).

**Negative caching (hot 404s).**  An "unknown user/item" answer on the
cacheable surface is cached as a NEGATIVE entry under the same
generation/topology epoch (``oryx.cluster.cache.negative-enabled``):
a hot missing id stops costing a full scatter per probe.  Eviction is
the same precise UP feed — the fold-in that finally *creates* the
user/item names it in an UP record, which evicts its 404 — and the
``X-Oryx-Cache`` verdict semantics are unchanged (a cached 404 serves
as ``hit``, re-rendered through the same error page as a cold one).

**Single-flight coalescing.**  Concurrent requests with the same cache
key latch onto one in-flight scatter: the first becomes the *leader*,
followers wait on its flight and reuse the complete rendered result
(``X-Oryx-Cache: coalesced``).  A leader that dies (chaos point
``router-coalesce-leader-death``) wakes its followers empty-handed and
they fall through to their own scatter — coalescing can save work,
never lose a request.

Config: ``oryx.cluster.cache.*`` / ``oryx.cluster.coalesce.*`` (both
off by default).  Observable: ``cache_hits`` / ``cache_misses`` /
``cache_evictions`` / ``cache_invalidations`` /
``coalesced_requests`` / ``cache_stale_feed_stalls`` counters, the
``router.cache_lookup`` span, and the ``/admin/cache`` stats + flush
endpoint (docs/OBSERVABILITY.md, docs/SCALING.md).
"""

from __future__ import annotations

import gzip as gzip_mod
import json
import threading
from collections import OrderedDict
from typing import Callable, NamedTuple

from ..common import clock as clockmod
from ..resilience import faults

_monotonic = clockmod.monotonic

__all__ = ["ResultCache", "CacheEntry", "CacheProbe", "route_tags",
           "ShardResultCache"]


def _ids_of_segments(raw: str) -> tuple[str, ...]:
    """Item ids from an ``i1=2.5/i2/i3=0.5`` path tail (the id part of
    parse_id_value_segments, without importing the serving app)."""
    out = []
    for seg in raw.split("/"):
        if seg:
            out.append(seg.rsplit("=", 1)[0] if "=" in seg else seg)
    return tuple(out)


# route pattern -> (user ids, item ids) the response depends on through
# the speed layer's per-user/per-item fold-ins.  Only patterns listed
# here are cacheable; global aggregates (mostPopularItems, allItemIDs,
# ...) change on ANY ingest and have no precise invalidation key.
_ROUTE_TAGS: dict[str, Callable[[dict], tuple[tuple[str, ...],
                                              tuple[str, ...]]]] = {
    "/recommend/{userID}":
        lambda p: ((p["userID"],), ()),
    "/recommendToMany/{userIDs:+}":
        lambda p: (tuple(p["userIDs"].split("/")), ()),
    "/recommendToAnonymous/{itemIDs:+}":
        lambda p: ((), _ids_of_segments(p["itemIDs"])),
    "/recommendWithContext/{userID}/{itemIDs:+}":
        lambda p: ((p["userID"],), _ids_of_segments(p["itemIDs"])),
    "/similarity/{itemIDs:+}":
        lambda p: ((), tuple(p["itemIDs"].split("/"))),
    "/similarityToItem/{toItemID}/{itemIDs:+}":
        lambda p: ((), (p["toItemID"],) + tuple(p["itemIDs"].split("/"))),
    "/estimate/{userID}/{itemIDs:+}":
        lambda p: ((p["userID"],), tuple(p["itemIDs"].split("/"))),
    "/estimateForAnonymous/{toItemID}/{itemIDs:+}":
        lambda p: ((), (p["toItemID"],) + _ids_of_segments(p["itemIDs"])),
    "/because/{userID}/{itemID}":
        lambda p: ((p["userID"],), (p["itemID"],)),
    "/mostSurprising/{userID}":
        lambda p: ((p["userID"],), ()),
    "/knownItems/{userID}":
        lambda p: ((p["userID"],), ()),
}


def route_tags(pattern: str, params: dict
               ) -> tuple[tuple, tuple] | None:
    """(user tags, item tags) for a cacheable route pattern, or None
    when the pattern has no precise invalidation key."""
    fn = _ROUTE_TAGS.get(pattern)
    return fn(params) if fn is not None else None


class CacheProbe(NamedTuple):
    """One request's cache coordinates: minted before the lookup,
    carried to the store so insertion can be fenced against
    invalidations that ran while the scatter was in flight."""

    key: tuple
    tags: tuple          # (("u", id) | ("i", id), ...)
    epoch: tuple         # (topology, per-shard generations, mixed)
    seq: int             # invalidation sequence at probe time
    t: float             # cache clock at probe time (quarantine fence)


class CacheEntry:
    """A complete 200 answer, stored as its Python value plus rendered
    wire variants.  The JSON body is rendered at store time (the common
    case — it doubles as the leader's own response, so a hit is
    byte-identical to the miss that created it); the CSV and gzip
    variants render once on first demand and are charged to the byte
    budget as they appear.

    A NEGATIVE entry (``status`` != 200 — the hot-404 cache) retains
    only the error message: the dispatcher re-renders the error page
    from it per request (byte-identical to a cold 404 by construction,
    Accept negotiation included), so what the cache saves is the
    scatter, and the ``X-Oryx-Cache`` verdict semantics are
    unchanged."""

    __slots__ = ("key", "value", "variants", "bytes", "tags",
                 "value_charge", "status")

    def __init__(self, key: tuple, value, tags: tuple = (),
                 status: int = 200):
        self.key = key
        self.value = value
        self.tags = tags
        self.status = status
        # (kind, gzipped) -> (payload bytes, content type)
        self.variants: dict[tuple[str, bool], tuple[bytes, str]] = {}
        self.bytes = 0
        # the retained Python value's estimated footprint, charged to
        # the byte budget until the value is dropped (see
        # _VALUE_FOOTPRINT_FACTOR)
        self.value_charge = 0


class _Flight:
    __slots__ = ("key", "event", "entry", "done", "waiters")

    def __init__(self, key: tuple):
        self.key = key
        self.event = threading.Event()
        self.entry: CacheEntry | None = None
        self.done = False
        # completion callbacks for waiters that must not block a
        # thread on `event` — the async front end parks a coroutine
        # here and is woken via loop.call_soon_threadsafe
        self.waiters: list = []


# gzip threshold mirrors lambda_rt.http._send: small bodies are not
# worth the header overhead, and the cached variant must match what a
# cold response would have negotiated
_GZIP_MIN = 256
# recent per-tag invalidation sequences kept for store fencing; older
# evictions lower the floor and conservatively refuse stores instead
_TAG_SEQ_CAP = 65536
# the Python result object kept for lazy CSV rendering weighs several
# times its JSON bytes (per-row dataclasses + object headers): charge
# a conservative multiple to the byte budget while it is retained, so
# max-bytes bounds real memory, not just the wire bytes.  The value is
# dropped (and the charge released) once both plain variant kinds are
# rendered — gzip variants derive from the rendered bytes.
_VALUE_FOOTPRINT_FACTOR = 3


class ResultCache:
    """The router's exact result cache + single-flight coalescer.

    ``store_enabled`` and ``coalesce`` gate independently
    (``oryx.cluster.cache.enabled`` / ``oryx.cluster.coalesce.enabled``);
    either one brings the object into the router's context.
    """

    def __init__(self, config, metrics, registry, clock=None):
        c = "oryx.cluster"
        self.store_enabled = config.get_bool(f"{c}.cache.enabled")
        self.coalesce = config.get_bool(f"{c}.coalesce.enabled")
        self.max_entries = config.get_int(f"{c}.cache.max-entries")
        self.max_bytes = config.get_int(f"{c}.cache.max-bytes")
        self.coalesce_wait_sec = \
            config.get_int(f"{c}.coalesce.wait-ms") / 1000.0
        # hot-404 negative caching (roadmap item 2 leftover): unknown
        # user/item answers cached under the same epoch with the same
        # precise UP eviction — the fold-in that CREATES the id evicts
        # its 404
        self.negative_enabled = config.get_bool(
            f"{c}.cache.negative-enabled")
        self.quarantine_sec = config.get_int(
            f"{c}.cache.invalidation-quarantine-ms") / 1000.0
        if self.max_entries < 1 or self.max_bytes < 1:
            raise ValueError("oryx.cluster.cache budgets must be >= 1")
        self._metrics = metrics
        self._registry = registry
        self._clock = clock or _monotonic
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self._by_tag: dict[tuple, set] = {}
        self._bytes = 0
        # invalidation fencing: a global sequence, recent per-tag
        # (seq, wall) marks, and the floor below which fencing
        # information was dropped
        self._seq = 0
        self._tag_seq: OrderedDict[tuple, tuple[int, float]] = \
            OrderedDict()
        self._tag_floor = 0
        self._flush_seq = 0
        self._flights: dict[tuple, _Flight] = {}
        # operator stats (cumulative; /admin/cache)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.coalesced = 0
        self.coalesce_fallthroughs = 0
        self.stale_feed_stalls = 0
        self.store_rejects = 0
        self.epoch_flushes = 0
        self.negative_hits = 0
        self.negative_stores = 0

    @classmethod
    def from_config(cls, config, metrics, registry) -> "ResultCache | None":
        cache = cls(config, metrics, registry)
        return cache if (cache.store_enabled or cache.coalesce) else None

    # -- probe / lookup ------------------------------------------------------

    def probe(self, pattern: str, path: str, query: dict,
              params: dict) -> CacheProbe | None:
        """Mint this request's cache coordinates; None when the request
        is uncacheable (unknown route class, or per-request rescorer
        parameterization the router cannot prove is a pure function of
        model state).  ``params`` are the dispatcher's matched path
        variables."""
        if "rescorerParams" in query:
            return None
        tagged = route_tags(pattern, params)
        if tagged is None:
            return None
        users, items = tagged
        epoch = self._registry.generation_topology()
        if epoch[2]:
            # a replica group spans generations mid-rollout: a hedge
            # may fall back to an older-generation sibling and win, so
            # a complete 200 is not provably of the epoch the key
            # would claim — uncacheable until the group converges
            return None
        args = tuple(sorted((k, tuple(vs)) for k, vs in query.items()))
        key = (pattern, path, args, epoch)
        tags = tuple(("u", u) for u in users) \
            + tuple(("i", i) for i in items)
        with self._lock:
            seq = self._seq
        return CacheProbe(key, tags, epoch, seq, self._clock())

    def lookup(self, probe: CacheProbe) -> CacheEntry | None:
        if not self.store_enabled:
            return None
        with self._lock:
            entry = self._entries.get(probe.key)
            if entry is None:
                self.misses += 1
                self._metrics.inc("cache_misses")
                return None
            self._entries.move_to_end(probe.key)
            self.hits += 1
            self._metrics.inc("cache_hits")
            if entry.status != 200:
                self.negative_hits += 1
                self._metrics.inc("cache_negative_hits")
            return entry

    def lookup_present(self, probe: CacheProbe) -> CacheEntry | None:
        """Hit-or-nothing lookup for the async front end's on-loop
        fast path: a present entry counts (and serves) exactly like
        :meth:`lookup`; an ABSENT key is not counted as a miss — the
        bridged full dispatch re-probes the same request and counts
        its miss exactly once."""
        if not self.store_enabled:
            return None
        with self._lock:
            entry = self._entries.get(probe.key)
            if entry is None:
                return None
            self._entries.move_to_end(probe.key)
            self.hits += 1
            self._metrics.inc("cache_hits")
            if entry.status != 200:
                self.negative_hits += 1
                self._metrics.inc("cache_negative_hits")
            return entry

    # -- store ---------------------------------------------------------------

    def store(self, probe: CacheProbe, status: int, value, headers,
              render) -> CacheEntry | None:
        """Offer a finished handler result.  Returns the entry when the
        response was cacheable (the caller serves THROUGH it, so a hit
        is byte-identical to the miss that stored it), else None.

        Uncacheable: non-200s, any extra response header (the partial
        marker is the live case), bodiless (None) results.  Fenced —
        neither stored nor shared with coalesced followers: any tag
        invalidated after the probe or within the quarantine before
        it, an epoch flush, or an epoch that moved while the scatter
        was in flight."""
        if status != 200 or headers or value is None:
            return None
        if not (self.store_enabled or self.coalesce):
            return None
        if self._registry.generation_topology() != probe.epoch:
            return None  # generation/topology moved mid-request
        entry = CacheEntry(probe.key, value, probe.tags)
        # render the JSON-plain variant eagerly (outside the lock):
        # the leader responds through it, so the bytes exist anyway
        raw, _ = self._render_variant(entry, "json", False, render)
        entry.value_charge = _VALUE_FOOTPRINT_FACTOR * len(raw)
        entry.bytes += entry.value_charge
        with self._lock:
            if self._fenced_locked(probe):
                # an invalidation for this answer's tags arrived after
                # the probe (this scatter may have read pre-fold-in
                # state) or within the replica-catch-up quarantine
                # just before it: neither retained NOR shared — a
                # coalesced follower may have arrived after the tap
                # applied the eviction, and handing it these bytes
                # would serve pre-fold-in rows past the invalidation.
                # (The leader's own response legitimately raced the
                # fold-in; followers re-issue and read fresh state.)
                self.store_rejects += 1
                return None
            if not self.store_enabled:
                return entry  # coalesce-only: share, don't retain
            old = self._entries.pop(probe.key, None)
            if old is not None:
                self._bytes -= old.bytes
                self._unindex_locked(old)
            self._entries[probe.key] = entry
            self._bytes += entry.bytes
            for tag in probe.tags:
                self._by_tag.setdefault(tag, set()).add(probe.key)
            self._evict_over_budget_locked()
        return entry

    def store_negative(self, probe: CacheProbe, status: int,
                       message: str) -> CacheEntry | None:
        """Offer a 404 from the cacheable surface (unknown user/item).
        Same epoch key, same tag index, same fencing as :meth:`store`:
        the UP record of the fold-in that finally CREATES the id
        evicts its negative entry, so a hot missing id stops costing a
        full scatter without ever outliving its own absence.  Returns
        the entry for coalesced followers (a herd on a missing id
        collapses to one scatter too), or None when negative caching
        is off or the store is fenced."""
        if status != 404 or not self.negative_enabled:
            return None
        if not (self.store_enabled or self.coalesce):
            return None
        if self._registry.generation_topology() != probe.epoch:
            return None
        entry = CacheEntry(probe.key, message, probe.tags, status=status)
        # budget charge: the message plus per-entry bookkeeping — tiny
        # next to rendered bodies, but never free
        entry.bytes = len(message.encode("utf-8", "replace")) + 128
        with self._lock:
            if self._fenced_locked(probe):
                self.store_rejects += 1
                return None
            if not self.store_enabled:
                return entry  # coalesce-only: share, don't retain
            old = self._entries.pop(probe.key, None)
            if old is not None:
                self._bytes -= old.bytes
                self._unindex_locked(old)
            self._entries[probe.key] = entry
            self._bytes += entry.bytes
            for tag in probe.tags:
                self._by_tag.setdefault(tag, set()).add(probe.key)
            self.negative_stores += 1
            self._evict_over_budget_locked()
        return entry

    def _fenced_locked(self, probe: CacheProbe) -> bool:
        """Whether an epoch flush or a tag invalidation fences this
        probe's store: sequence fencing catches invalidations that
        arrived after the probe; the recency quarantine catches ones
        just before it (the tap can run a beat ahead of a replica's
        replay of the same topic — a scatter probed right after the
        eviction may still have read the pre-fold-in replica; past
        pathological replica lag the MODEL-publish epoch flush remains
        the backstop)."""
        if self._flush_seq > probe.seq or probe.seq < self._tag_floor:
            return True
        for tag in probe.tags:
            mark = self._tag_seq.get(tag)
            # quarantine measured against PROBE time, not store time:
            # the scatter began around the probe, so what matters is
            # whether the replicas had caught up by then — a scatter
            # slower than the quarantine must not age its way past
            # the fence
            if mark is not None and (
                    mark[0] > probe.seq
                    or probe.t - mark[1] < self.quarantine_sec):
                return True
        return False

    def _unindex_locked(self, entry: CacheEntry) -> None:
        # entries carry their tags, so unindexing is O(entry tags),
        # not a walk of the whole tag index
        for tag in entry.tags:
            keys = self._by_tag.get(tag)
            if keys is not None:
                keys.discard(entry.key)
                if not keys:
                    del self._by_tag[tag]

    def _evict_over_budget_locked(self) -> None:
        while self._entries and (len(self._entries) > self.max_entries
                                 or self._bytes > self.max_bytes):
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.bytes
            self._unindex_locked(old)
            self.evictions += 1
            self._metrics.inc("cache_evictions")

    # -- rendering -----------------------------------------------------------

    def render(self, entry: CacheEntry, wants_csv: bool,
               gzip_ok: bool, render) -> tuple[bytes, str, bool]:
        """(payload, content type, gzipped) for one Accept/encoding
        combination, rendered once and memoized on the entry.
        ``render(value, kind)`` is the caller's canonical serializer
        (lambda_rt.http.json_or_csv under a canonical Accept), so a
        cached body is byte-identical to a cold one by construction."""
        kind = "csv" if wants_csv else "json"
        raw, ctype = self._render_variant(entry, kind, False, render)
        if not gzip_ok or len(raw) <= _GZIP_MIN:
            return raw, ctype, False
        gz, _ = self._render_variant(entry, kind, True, render)
        return gz, ctype, True

    def _render_variant(self, entry: CacheEntry, kind: str, gz: bool,
                        render) -> tuple[bytes, str]:
        got = entry.variants.get((kind, gz))
        if got is not None:
            return got
        if gz:
            raw, ctype = self._render_variant(entry, kind, False, render)
            # mtime pinned: the cached gzip bytes are deterministic, and
            # re-serving them skips the per-hit recompression entirely
            payload = gzip_mod.compress(raw, mtime=0)
        else:
            payload, ctype = render(entry.value, kind)
        with self._lock:
            got = entry.variants.get((kind, gz))
            if got is not None:
                return got
            entry.variants[(kind, gz)] = (payload, ctype)
            delta = len(payload)
            if not gz and entry.value is not None \
                    and ("json", False) in entry.variants \
                    and ("csv", False) in entry.variants:
                # both plain kinds rendered: the Python value has
                # nothing left to render (gzip derives from the
                # bytes) — drop it and release its footprint charge
                entry.value = None
                delta -= entry.value_charge
                entry.value_charge = 0
            entry.bytes += delta
            # identity, not key membership: the key may have been
            # re-stored by a newer entry while this (evicted) one was
            # still being served — charging ITS variant to the global
            # budget would leak phantom bytes that no eviction ever
            # reclaims
            if self._entries.get(entry.key) is entry:
                self._bytes += delta
                self._evict_over_budget_locked()
        return payload, ctype

    # -- invalidation feed ---------------------------------------------------

    def note_up(self, message: str) -> None:
        """One UP record from the router's update-topic tap: evict
        exactly the touched user's / item's keys.  The stale-feed chaos
        point models a stalled tap (records seen but not applied); the
        epoch flush on the next generation publish is the safety valve
        that bounds the resulting staleness."""
        if faults.fire("router-cache-stale-feed") == "drop":
            self.stale_feed_stalls += 1
            self._metrics.inc("cache_stale_feed_stalls")
            return
        try:
            up = json.loads(message)
            kind, id_ = str(up[0]), str(up[1])
            extras = up[3] if len(up) > 3 else None
        except (ValueError, IndexError, TypeError, KeyError):
            return  # malformed control traffic: the consumers count it
        tags = []
        if kind == "X":
            tags.append(("u", id_))
        elif kind == "Y":
            tags.append(("i", id_))
            # the item-side record of a fold-in names the user whose
            # interaction produced it: evict them too, so invalidation
            # does not depend on X/Y record ordering in the micro-batch
            if isinstance(extras, list):
                tags.extend(("u", str(u)) for u in extras)
        self._invalidate(tags)

    def note_generation_publish(self) -> None:
        """MODEL/MODEL-REF went by on the update topic: flush the
        epoch.  The generation is in every key, so stale entries could
        never be served — the flush reclaims their bytes and caps how
        long a stalled invalidation feed can matter."""
        self.flush("generation-publish")

    def _invalidate(self, tags) -> None:
        with self._lock:
            now = self._clock()
            for tag in tags:
                self._seq += 1
                self._tag_seq[tag] = (self._seq, now)
                self._tag_seq.move_to_end(tag)
                while len(self._tag_seq) > _TAG_SEQ_CAP:
                    _, dropped = self._tag_seq.popitem(last=False)
                    self._tag_floor = max(self._tag_floor, dropped[0])
                for key in self._by_tag.pop(tag, ()):
                    old = self._entries.pop(key, None)
                    if old is not None:
                        self._bytes -= old.bytes
                        self._unindex_locked(old)
                        self.invalidations += 1
                        self._metrics.inc("cache_invalidations")

    def flush(self, reason: str) -> int:
        """Drop every entry (generation publish, topology cutover, or
        the /admin/cache operator hatch).  Returns entries dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_tag.clear()
            self._bytes = 0
            self._seq += 1
            self._flush_seq = self._seq
            self.epoch_flushes += 1
        return n

    # -- single-flight coalescing --------------------------------------------

    def begin_flight(self, probe: CacheProbe,
                     deadline) -> tuple[str, object]:
        """("lead", flight) — this request computes and MUST call
        :meth:`finish_flight`; ("coalesced", entry) — a leader finished
        with a shareable result; ("solo", None) — coalescing is off, or
        the leader died / timed out and this request falls through to
        its own scatter."""
        if not self.coalesce:
            return "solo", None
        with self._lock:
            fl = self._flights.get(probe.key)
            if fl is None:
                fl = _Flight(probe.key)
                self._flights[probe.key] = fl
                lead = True
            else:
                lead = False
        if lead:
            try:
                # chaos: the coalescing leader dies before completing
                # its scatter — followers must re-issue, never hang
                faults.fire("router-coalesce-leader-death")
            except BaseException:
                self.finish_flight(fl, None)
                raise
            return "lead", fl
        timeout = self.coalesce_wait_sec
        if deadline is not None:
            timeout = min(timeout, max(0.0, deadline.remaining()))
        clockmod.wait(fl.event, timeout)
        if fl.done and fl.entry is not None:
            with self._lock:
                self.coalesced += 1
            self._metrics.inc("coalesced_requests")
            return "coalesced", fl.entry
        with self._lock:
            self.coalesce_fallthroughs += 1
        return "solo", None

    def flight_for(self, key: tuple) -> "_Flight | None":
        """The in-flight leader for a key, if any — the async front
        end joins it on-loop instead of parking a thread."""
        if not self.coalesce:
            return None
        with self._lock:
            return self._flights.get(key)

    def add_flight_waiter(self, flight: _Flight, callback) -> bool:
        """Register a completion callback on an in-flight leader.
        Returns False when the flight already finished (the caller
        reads ``flight.entry`` directly instead of waiting).  The
        callback runs on the LEADER's thread at finish time and must
        be cheap and non-raising (the async front end passes
        ``loop.call_soon_threadsafe``)."""
        with self._lock:
            if flight.done:
                return False
            flight.waiters.append(callback)
            return True

    def count_coalesced(self) -> None:
        """Count one follower served from a leader's flight — the
        async front end's on-loop join path (begin_flight counts the
        thread-parked form itself)."""
        with self._lock:
            self.coalesced += 1
        self._metrics.inc("coalesced_requests")

    def finish_flight(self, flight: _Flight,
                      entry: CacheEntry | None) -> None:
        """Publish the leader's outcome (idempotent; entry None =
        uncacheable result or leader death — followers re-issue)."""
        with self._lock:
            if flight.done:
                return
            flight.done = True
            flight.entry = entry
            waiters, flight.waiters = flight.waiters, []
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
        flight.event.set()
        for cb in waiters:
            try:
                cb()
            except Exception:  # noqa: BLE001 — waiters are best-effort
                pass

    # -- operator surface ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.store_enabled,
                "coalesce": self.coalesce,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / (self.hits + self.misses), 4)
                if (self.hits + self.misses) else None,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "coalesced_requests": self.coalesced,
                "coalesce_fallthroughs": self.coalesce_fallthroughs,
                "stale_feed_stalls": self.stale_feed_stalls,
                "store_rejects": self.store_rejects,
                "epoch_flushes": self.epoch_flushes,
                "negative_enabled": self.negative_enabled,
                "negative_stores": self.negative_stores,
                "negative_hits": self.negative_hits,
                "in_flight": len(self._flights),
            }


class ShardResultCache:
    """Replica-side exact result cache for the ``/shard/*`` surface
    (``oryx.cluster.replica-cache.*``, off by default).

    The router's result cache saves the scatter; this one saves the
    DEVICE: a cold-router miss on a shard query the replica already
    answered (a restarted router, a second router in the same region,
    a cache-busted public request that maps to the same internal
    query) skips scoring entirely.  Same epoch discipline as the
    router cache, one level stricter: the epoch is a counter bumped on
    EVERY model-state record this replica applies (UP fold-ins and
    MODEL/MODEL-REF publishes alike — the serving layer's update tap
    feeds :meth:`note_record`), so an entry serves only while nothing
    whatsoever has changed in the model it was computed from.  Exact
    by construction, no per-tag index needed.

    The bump happens when the record is HANDED to the model manager,
    a beat before the apply completes; like the router cache's
    invalidation quarantine, stores are refused for a configured
    window after the last bump so an answer computed from mid-apply
    state can never be retained under the post-apply epoch.

    Entries hold the COMPLETE rendered answer (status + response
    headers + body bytes) keyed by ``(method, path, body)``: a hit
    replays the exact bytes the frame dispatcher produced for the
    first asker, byte-identical by construction.  Bounded LRU with a
    byte budget, same shape as the router cache's.
    """

    def __init__(self, config, metrics=None, clock=None):
        c = "oryx.cluster.replica-cache"
        self.enabled = config.get_bool(f"{c}.enabled")
        self.max_entries = config.get_int(f"{c}.max-entries")
        self.max_bytes = config.get_int(f"{c}.max-bytes")
        self.quarantine_sec = \
            config.get_int(f"{c}.quarantine-ms") / 1000.0
        if self.max_entries < 1 or self.max_bytes < 1:
            raise ValueError(
                "oryx.cluster.replica-cache budgets must be >= 1")
        self._metrics = metrics
        self._clock = clock or _monotonic
        self._lock = threading.Lock()
        # (method, path, body) -> (epoch, status, headers, body, bytes)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self._epoch = 0
        self._last_bump = -1e9
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.store_rejects = 0

    @classmethod
    def from_config(cls, config, metrics=None) -> "ShardResultCache | None":
        cache = cls(config, metrics)
        return cache if cache.enabled else None

    # -- epoch feed ----------------------------------------------------------

    def note_record(self) -> None:
        """One model-state record (UP / MODEL / MODEL-REF) is about to
        be applied: move the epoch.  Every cached entry is keyed under
        the previous epoch and stops serving instantly; their bytes
        are reclaimed lazily as lookups touch them and by LRU
        pressure."""
        with self._lock:
            self._epoch += 1
            self._last_bump = self._clock()

    def tap(self, stream):
        """Wrap the serving layer's (heartbeat-filtered) update replay:
        the epoch moves on BOTH sides of every record's apply.  The
        pre-yield bump fences new lookups off entries computed from
        the pre-apply model; the post-yield bump (which runs when the
        consumer asks for the NEXT record — i.e. the moment this
        record's apply completed) retires anything a mid-apply request
        managed to store under the in-between epoch.  Together they
        make the stale-store window zero REGARDLESS of how long the
        apply takes (a sliced MODEL-REF load can run for seconds —
        far past any fixed quarantine); the quarantine remains as
        defense in depth for clock-adjacent races."""
        for km in stream:
            self.note_record()
            yield km
            self.note_record()

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- lookup / store ------------------------------------------------------

    def lookup(self, method: str, path: str, body: bytes
               ) -> "tuple[int, dict, bytes] | None":
        """(status, response headers, body bytes) when the exact query
        was answered under the CURRENT epoch; None (counted as a miss)
        otherwise.  A stale-epoch entry is dropped on touch."""
        key = (method, path, body)
        with self._lock:
            got = self._entries.get(key)
            if got is not None and got[0] == self._epoch:
                self._entries.move_to_end(key)
                self.hits += 1
                if self._metrics is not None:
                    self._metrics.inc("shard_cache_hits")
                return got[1], got[2], got[3]
            if got is not None:
                # keyed under a retired epoch: unservable, reclaim now
                del self._entries[key]
                self._bytes -= got[4]
            self.misses += 1
            if self._metrics is not None:
                self._metrics.inc("shard_cache_misses")
            return None

    def store(self, method: str, path: str, body: bytes,
              epoch0: int, status: int, headers: dict,
              payload: bytes) -> None:
        """Offer a finished answer computed while the epoch was
        ``epoch0``.  Refused for non-200s, when the epoch moved during
        the request, or within the quarantine window after the last
        bump (the answer may have read mid-apply state)."""
        if not self.enabled or status != 200:
            return
        size = len(payload) + len(path) + len(body) + 160
        with self._lock:
            if self._epoch != epoch0 \
                    or self._clock() - self._last_bump \
                    < self.quarantine_sec:
                self.store_rejects += 1
                return
            key = (method, path, body)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[4]
            self._entries[key] = (epoch0, status, dict(headers),
                                  payload, size)
            self._bytes += size
            while self._entries and (
                    len(self._entries) > self.max_entries
                    or self._bytes > self.max_bytes):
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= dropped[4]
                self.evictions += 1

    def flush(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "epoch": self._epoch,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "store_rejects": self.store_rejects,
            }
