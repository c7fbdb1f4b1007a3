"""Replica membership: heartbeats on the update topic + the router's
live registry, including the elastic-topology state machine.

Counterpart of ``oryx_tpu/cluster/membership.py``, copied whole: the
heartbeat bytes are the reference's, so either package's router reads
either package's replicas.

Replicas publish small JSON heartbeats under the ``HB`` key on the
same update topic that carries MODEL/MODEL-REF/UP — no extra
infrastructure, and the router discovers replicas by tailing the topic
it already understands.  Every update-topic consumer that is not the
router must skip ``HB`` records (:func:`without_heartbeats`); they are
control-plane traffic, not model state.

A heartbeat carries the replica's shard assignment, its public URL,
the model *generation* it is currently serving (count of accepted
MODEL/MODEL-REF documents since replay offset 0 — identical across
replicas because the update topic is totally ordered), and a ``ready``
flag (fraction loaded past the serving gate).  The registry routes
only to ready replicas and, within a shard, prefers the newest
generation — a replica still replaying an older model is never routed.

Liveness is judged by *receive* time (router monotonic clock), not the
sender's timestamp, so clock skew between hosts cannot fake liveness.

Topology state machine (live N→M resharding)
--------------------------------------------

Exactness requires merging replicas of ONE topology only — a ``0/1``
replica's catalog overlaps an ``i/2`` shard's, so mixing ``of`` values
in a merge would duplicate items.  The registry therefore routes one
*merged* topology at a time and moves between topologies through an
explicit lifecycle:

- **bootstrap** — nothing merged yet: the first topology to reach full
  ready coverage (every shard with a live ready replica) is committed;
  until one does, routing provisionally follows the largest ``of``
  announced (partial answers during cluster bring-up, exactly the old
  behavior).
- **warming** — with a topology merged, a *declared* reshard target
  (:meth:`MembershipRegistry.begin_reshard`, the router's
  ``POST /admin/topology``) may announce ``(shard, of=M)`` heartbeats;
  its replicas replay the update topic filtered through the murmur2
  ring and are tracked but never routed.
- **cutover** — the moment the target reaches full ready coverage the
  registry atomically (under its one lock) retires the old topology
  and routes the new one.  Nothing in between: a request routes either
  entirely old or entirely new.
- **retired** — the old fleet's continuing heartbeats are dropped and
  counted (``stale_topology_heartbeats``), and its registry entries
  are purged at cutover, so a retired replica can never be merged
  again.  Re-declaring a retired ``of`` (scale back down) un-retires
  it.

A heartbeat whose ``of`` is neither the merged topology nor the
declared target is **rejected** with the same counter — a misconfigured
``i/N`` replica cannot be merged into the wrong ring, and a lone
``0/1`` replica (trivially "fully covered" by itself) cannot yank the
routed topology.  One recovery hatch: when the merged topology has had
no live replica for several TTLs (``REBOOTSTRAP_GRACE_TTLS`` — the
fleet is dead, not blinking through a broker stall or GC pause; the
old stop-the-world reshard, or a total outage), the registry re-enters
bootstrap acceptance so a fresh fleet of any non-retired topology can
take over without an admin call.
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from dataclasses import dataclass
from typing import Iterable, Iterator

from ..common import clock as clockmod
from ..kafka.api import KeyMessage
from ..resilience import faults

_log = logging.getLogger(__name__)

__all__ = ["KEY_HEARTBEAT", "Heartbeat", "MembershipRegistry",
           "HeartbeatPublisher", "without_heartbeats"]

# update-topic key for replica heartbeats (rides next to MODEL/UP;
# consumers that build model state skip it)
KEY_HEARTBEAT = "HB"


def without_heartbeats(updates: Iterable[KeyMessage]) -> Iterator[KeyMessage]:
    """Drop cluster heartbeats from an update-topic stream — the filter
    every model-state consumer (serving/speed) tails through."""
    return (km for km in updates if km.key != KEY_HEARTBEAT)


@dataclass
class Heartbeat:
    replica: str          # stable per-process id
    shard: int            # catalog shard this replica serves
    of: int               # total shard count the replica was started with
    url: str              # public base URL, e.g. http://10.0.0.3:8080
    generation: int       # accepted MODEL documents since replay offset 0
    ready: bool           # fraction loaded past the serving gate
    fraction: float = 0.0
    ts: float = 0.0       # sender wall clock (diagnostic only)
    # region identity (oryx.cluster.region.name; None = unset): a
    # multi-region deployment's defense in depth — the mirror already
    # drops HB records at the link (cluster/mirror.py), but a
    # misconfigured shared topic must still never route a router at
    # replicas it cannot reach across the region boundary
    region: str | None = None
    # framed-transport listener port (cluster/transport.py; None =
    # the replica speaks only HTTP/1.1 internally).  The router falls
    # back to the HTTP hop per replica, so a mixed fleet mid-rollout
    # keeps serving
    tport: int | None = None

    def to_json(self) -> str:
        d = {k: v for k, v in self.__dict__.items()
             if not (k in ("region", "tport") and v is None)}
        return json.dumps(d, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Heartbeat | None":
        try:
            d = json.loads(s)
            region = d.get("region")
            tport = d.get("tport")
            return cls(replica=str(d["replica"]), shard=int(d["shard"]),
                       of=int(d["of"]), url=str(d["url"]),
                       generation=int(d["generation"]),
                       ready=bool(d["ready"]),
                       fraction=float(d.get("fraction", 0.0)),
                       ts=float(d.get("ts", 0.0)),
                       region=None if region is None else str(region),
                       tport=None if tport is None else int(tport))
        except (ValueError, TypeError, KeyError):
            return None  # malformed control message: ignore, don't die


class MembershipRegistry:
    """Router-side view of the cluster, built from heartbeats.

    ``candidates(shard)`` returns the ready replicas of a shard in the
    merged topology — an R-way replica *group* when several replicas
    announce the same ``(shard, of)`` — newest generation first, ties
    rotated round-robin for load spreading.  ``shard_count`` is the
    merged topology (see the module docstring's state machine), so the
    router needs no shard-count config of its own and reports partial
    answers as ``m/N`` against the true topology.
    """

    def __init__(self, ttl_sec: float, clock=clockmod.monotonic,
                 region: str | None = None):
        self.ttl_sec = ttl_sec
        self._clock = clock
        # this router's region (oryx.cluster.region.name).  With a
        # region set, a heartbeat stamped with a DIFFERENT region is
        # rejected like a stale topology: the replica is in another
        # region's fleet and routing to it would cross the region
        # boundary the mirror exists to avoid.  Unstamped heartbeats
        # (single-region deployments, older replicas) always merge.
        self.region = region
        self._lock = threading.Lock()
        # replica id -> (Heartbeat, last_seen_monotonic)
        self._replicas: dict[str, tuple[Heartbeat, float]] = {}
        self._of = 0                    # largest of ever seen (bootstrap)
        self._merged_of = 0             # committed routed topology; 0 = none
        self._target_of: int | None = None  # declared reshard target
        self._retired: set[int] = set()
        self._rr = 0
        self.heartbeats_seen = 0
        # heartbeats dropped because their `of` is neither the merged
        # topology nor the declared warming target (misconfigured
        # replicas, retired fleets still announcing)
        self.stale_topology_heartbeats = 0
        self.topology_cutovers = 0
        # when a merged-topology heartbeat was last received: gates the
        # re-bootstrap hatch (see _merged_grace_expired_locked)
        self._merged_last_live: float | None = None

    # A transient heartbeat gap (broker stall, GC/VM pause) must not
    # open the bootstrap hatch: a foreign topology can take over only
    # after the merged fleet has been silent this many TTLs — long
    # enough that it is dead, not blinking.  A one-TTL blip with a
    # misconfigured 0/1 replica beating would otherwise commit the
    # rogue ring and permanently retire the real fleet.
    REBOOTSTRAP_GRACE_TTLS = 3.0

    def _merged_grace_expired_locked(self, now: float) -> bool:
        if self._merged_last_live is None:
            return True
        return (now - self._merged_last_live
                > self.ttl_sec * self.REBOOTSTRAP_GRACE_TTLS)

    # -- topology lifecycle ---------------------------------------------------

    def begin_reshard(self, of: int) -> dict:
        """Declare ``of`` as the warming reshard target: its replicas'
        heartbeats are accepted (and tracked on /admin/topology) and
        the registry cuts over to it the moment every one of its shards
        has a live ready replica.  Re-declaring a retired topology
        un-retires it (scale back down).  Declaring the merged topology
        cancels any pending target."""
        if of < 1:
            raise ValueError(f"shard count must be >= 1, got {of}")
        with self._lock:
            if of == self._merged_of:
                self._target_of = None
            else:
                self._retired.discard(of)
                self._target_of = of
            return self._status_locked()

    def _merged_live_locked(self, now: float) -> bool:
        return any(hb.of == self._merged_of
                   and now - seen <= self.ttl_sec
                   for hb, seen in self._replicas.values())

    def note(self, hb: Heartbeat) -> bool:
        """Absorb one heartbeat; False = dropped as stale/misconfigured
        (counted in ``stale_topology_heartbeats``, entry purged)."""
        with self._lock:
            self.heartbeats_seen += 1
            now = self._clock()
            if hb.of < 1 or not 0 <= hb.shard < hb.of:
                # structurally invalid shard coordinates: never routable
                self.stale_topology_heartbeats += 1
                self._replicas.pop(hb.replica, None)
                return False
            if (self.region is not None and hb.region is not None
                    and hb.region != self.region):
                # a foreign region's replica on this topic (mirror
                # misconfiguration, shared broker): countable evidence,
                # never merged — its URL is across the region boundary
                self.stale_topology_heartbeats += 1
                self._replicas.pop(hb.replica, None)
                return False
            if hb.of in self._retired:
                # a retired fleet still announcing after cutover: aged
                # out instantly, counted, never merged
                self.stale_topology_heartbeats += 1
                self._replicas.pop(hb.replica, None)
                return False
            if (self._merged_of
                    and hb.of not in (self._merged_of, self._target_of)
                    and (self._merged_live_locked(now)
                         or not self._merged_grace_expired_locked(now))):
                # a foreign topology that is neither merged nor the
                # declared warming target, while the merged fleet is
                # alive (or only blinking, within the grace window): a
                # misconfigured i/N replica must not be merged into the
                # wrong ring.  Once the merged fleet has been silent
                # past the grace the cluster re-enters bootstrap
                # acceptance — a fresh fleet may take over without an
                # admin call.
                self.stale_topology_heartbeats += 1
                self._replicas.pop(hb.replica, None)
                return False
            self._replicas[hb.replica] = (hb, now)
            if hb.of == self._merged_of:
                self._merged_last_live = now
            if hb.of > self._of:
                self._of = hb.of
            return True

    def note_message(self, message: str) -> bool:
        hb = Heartbeat.from_json(message)
        if hb is not None:
            return self.note(hb)
        _log.warning("Malformed heartbeat ignored")
        return True  # malformed, not stale: not the rejection counter

    @property
    def shard_count(self) -> int:
        with self._lock:
            return self._topology_locked()

    def _live_locked(self) -> list[Heartbeat]:
        now = self._clock()
        return [hb for hb, seen in self._replicas.values()
                if now - seen <= self.ttl_sec]

    def _full_coverage_locked(self) -> list[int]:
        """Topologies whose EVERY shard has a live ready replica."""
        cov: dict[int, set[int]] = {}
        for hb in self._live_locked():
            if hb.ready:
                cov.setdefault(hb.of, set()).add(hb.shard)
        return sorted(of for of, shards in cov.items()
                      if len(shards) == of)

    def _commit_locked(self, new_of: int) -> None:
        old = self._merged_of
        if old and old != new_of:
            # atomic drain: the instant the new topology is fully
            # covered the old one retires — its entries purge NOW, its
            # later heartbeats drop with the stale counter, and no
            # request ever merges shards of two topologies
            self._retired.add(old)
            self.topology_cutovers += 1
            self._replicas = {rid: (hb, seen)
                              for rid, (hb, seen) in self._replicas.items()
                              if hb.of != old}
            _log.warning("Topology cutover: %d-way -> %d-way "
                         "(old fleet retired)", old, new_of)
        self._merged_of = new_of
        self._merged_last_live = self._clock()
        self._retired.discard(new_of)
        if self._target_of == new_of:
            self._target_of = None

    def _topology_locked(self) -> int:
        """The routed shard count, advancing the topology state machine
        (see module docstring): commit at bootstrap or cut over to a
        fully-ready warming topology; otherwise hold the merged one."""
        full = self._full_coverage_locked()
        if self._merged_of == 0:
            if full:
                self._commit_locked(max(full))
                return self._merged_of
            live = self._live_locked()
            if live:
                # provisional (uncommitted): route the largest topology
                # announced so bring-up serves partial answers instead
                # of nothing
                return max(hb.of for hb in live)
            return max(1, self._of)
        candidates = [of for of in full
                      if of != self._merged_of and of not in self._retired]
        if candidates:
            now = self._clock()
            if self._target_of in candidates:
                self._commit_locked(self._target_of)
            elif (not self._merged_live_locked(now)
                    and self._merged_grace_expired_locked(now)):
                # merged fleet silent past the grace window (dead, not
                # blinking): re-bootstrap onto the fully-covered
                # survivor
                self._commit_locked(max(candidates))
        return self._merged_of

    def _ranked_locked(self, live: list[Heartbeat], shard: int,
                       of: int) -> list[Heartbeat]:
        """One shard's ready candidates, ranked: newest generation
        first, rotated by the shared round-robin counter so repeated
        calls spread load; older-generation replicas stay at the tail
        — a hedge may still fall back to them (stale beats dead), but
        a replica mid-replay of a newer model is ranked behind its
        peers.  THE single ranking definition: candidates() and
        routing_plan() must never disagree on ordering."""
        sl = [hb for hb in live
              if hb.shard == shard and hb.ready and hb.of == of]
        if not sl:
            return []
        top_gen = max(hb.generation for hb in sl)
        newest = [hb for hb in sl if hb.generation == top_gen]
        older = [hb for hb in sl if hb.generation != top_gen]
        self._rr += 1
        r = self._rr % len(newest)
        older.sort(key=lambda hb: -hb.generation)
        return newest[r:] + newest[:r] + older

    def candidates(self, shard: int) -> list[Heartbeat]:
        """Ready live replicas for a shard IN THE CURRENT TOPOLOGY —
        the shard's replica group (see _ranked_locked for the
        ordering)."""
        with self._lock:
            of = self._topology_locked()
            return self._ranked_locked(self._live_locked(), shard, of)

    def routing_plan(self) -> tuple[int, list[list[Heartbeat]]]:
        """One CONSISTENT snapshot of (routed topology, per-shard ready
        candidate lists) under a SINGLE lock acquisition — the scatter
        fan-out's view of the cluster.  The per-shard ``candidates()``
        calls each re-derive the topology, so a cutover landing between
        two of them could hand one request shard 0 of the OLD ring and
        shard 1 of the NEW one: overlapping catalogs merged as if
        disjoint, a silently wrong 200 with no partial marker.  The
        atomic-cutover contract ("a request routes either entirely old
        or entirely new", module docstring) therefore requires the
        whole plan to come from one locked read.  Ordering per shard
        is _ranked_locked — the same definition ``candidates()``
        uses."""
        with self._lock:
            of = self._topology_locked()
            live = self._live_locked()
            return of, [self._ranked_locked(live, shard, of)
                        for shard in range(of)]

    def any_candidates(self) -> list[Heartbeat]:
        """Ready live replicas of ANY shard in the current topology
        (for endpoints served from the replicated user store), newest
        generation first — rotation for load spreading happens WITHIN
        the newest generation only, the same contract as
        ``candidates()``, so a replica still replaying an older model
        is never ranked ahead of an up-to-date one."""
        with self._lock:
            of = self._topology_locked()
            live = [hb for hb in self._live_locked()
                    if hb.ready and hb.of == of]
            if not live:
                return []
            top_gen = max(hb.generation for hb in live)
            newest = [hb for hb in live if hb.generation == top_gen]
            older = [hb for hb in live if hb.generation != top_gen]
            older.sort(key=lambda hb: -hb.generation)
            self._rr += 1
            r = self._rr % len(newest)
            return newest[r:] + newest[:r] + older

    def generation_topology(self) -> tuple[int, tuple[int, ...], bool]:
        """The result cache's epoch: (routed topology, per-shard newest
        ready generation with -1 for an uncovered shard, and a MIXED
        flag).  Keying cached answers by the first two means a
        generation rollout or topology cutover changes the key
        shard-by-shard as heartbeats flip.  ``mixed`` is True while any
        shard's replica group spans generations: during that window a
        hedge may fall back to an older-generation sibling and win, so
        a complete answer is NOT provably of the newest generation —
        the cache refuses to serve or store until the group converges
        (cluster/result_cache.py; the MODEL-publish flush reclaims the
        previous epoch's bytes)."""
        with self._lock:
            of = self._topology_locked()
            gens = [-1] * of
            mixed = False
            for hb in self._live_locked():
                if hb.ready and hb.of == of and 0 <= hb.shard < of:
                    prev = gens[hb.shard]
                    if prev != -1 and prev != hb.generation:
                        mixed = True
                    gens[hb.shard] = max(prev, hb.generation)
            return of, tuple(gens), mixed

    def covered_shards(self) -> list[int]:
        with self._lock:
            of = self._topology_locked()
            return sorted({hb.shard for hb in self._live_locked()
                           if hb.ready and hb.of == of})

    def group_sizes(self) -> dict[int, int]:
        """shard -> live ready replica-group size in the merged
        topology — in-process introspection for tests and embedders
        (the autoscaler, a separate process, derives the same map from
        the router's /metrics membership snapshot)."""
        with self._lock:
            of = self._topology_locked()
            out: dict[int, int] = {s: 0 for s in range(of)}
            for hb in self._live_locked():
                if hb.ready and hb.of == of:
                    out[hb.shard] = out.get(hb.shard, 0) + 1
            return out

    def _status_locked(self) -> dict:
        """Reshard/topology status (the /admin/topology view): per live
        topology, its coverage toward cutover and the slowest member's
        warm fraction."""
        merged = self._topology_locked()
        by_of: dict[int, dict] = {}
        for hb in self._live_locked():
            st = by_of.setdefault(hb.of, {
                "replicas": 0, "ready_shards": set(), "min_fraction": 1.0})
            st["replicas"] += 1
            if hb.ready:
                st["ready_shards"].add(hb.shard)
            st["min_fraction"] = min(st["min_fraction"], hb.fraction)
        return {
            "merged_of": merged,
            "reshard_target": self._target_of,
            "retired": sorted(self._retired),
            "topology_cutovers": self.topology_cutovers,
            "stale_topology_heartbeats": self.stale_topology_heartbeats,
            "topologies": {
                str(of): {
                    "replicas": st["replicas"],
                    "ready_shards": len(st["ready_shards"]),
                    "of": of,
                    "full_coverage": len(st["ready_shards"]) == of,
                    "min_fraction": round(st["min_fraction"], 4),
                    "state": ("merged" if of == merged else
                              "warming" if of == self._target_of
                              else "observed"),
                }
                for of, st in sorted(by_of.items())},
        }

    def topology_status(self) -> dict:
        with self._lock:
            return self._status_locked()

    def snapshot(self) -> dict:
        """Operator view for the router's /metrics."""
        with self._lock:
            now = self._clock()
            return {
                # the CURRENT routed topology, not the largest ever
                # seen: after a reshard down, routing follows the live
                # `of` and the operator view must agree with it
                "shards": self._topology_locked(),
                "reshard_target": self._target_of,
                "heartbeats_seen": self.heartbeats_seen,
                "stale_topology_heartbeats":
                    self.stale_topology_heartbeats,
                "topology_cutovers": self.topology_cutovers,
                "replicas": {
                    rid: {"shard": hb.shard, "of": hb.of, "url": hb.url,
                          "generation": hb.generation, "ready": hb.ready,
                          "fraction": round(hb.fraction, 4),
                          "age_sec": round(now - seen, 3),
                          "live": now - seen <= self.ttl_sec}
                    for rid, (hb, seen) in sorted(self._replicas.items())},
            }


class HeartbeatPublisher:
    """Replica-side heartbeat loop (a daemon thread owned by the
    serving layer).  Publish failures are logged and retried next
    interval — a replica that cannot reach the broker ages out of the
    router's registry, which IS the designed degrade.  Chaos seams:
    ``replica-heartbeat-drop`` suppresses sends (a partitioned-but-
    alive replica); ``replica-group-flap`` (mode=delay just past the
    TTL) makes beats straggle so the replica oscillates in and out of
    routing — the no-oscillation-churn test handle."""

    def __init__(self, producer, shard: int, of: int, url: str,
                 manager, min_fraction: float,
                 interval_sec: float = 0.5,
                 replica_id: str | None = None,
                 region: str | None = None,
                 tport: int | None = None):
        self._producer = producer
        self.shard = shard
        self.of = of
        self.url = url
        self._manager = manager
        self._min_fraction = min_fraction
        self.interval_sec = interval_sec
        self.replica_id = replica_id or uuid.uuid4().hex[:12]
        self.region = region
        self.tport = tport
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.published = 0

    def current_heartbeat(self) -> Heartbeat:
        model = self._manager.get_model()
        fraction = model.get_fraction_loaded() if model is not None else 0.0
        return Heartbeat(
            replica=self.replica_id, shard=self.shard, of=self.of,
            url=self.url,
            generation=int(getattr(self._manager, "generation", 0)),
            ready=model is not None and fraction >= self._min_fraction,
            fraction=fraction, ts=clockmod.now(), region=self.region,
            tport=self.tport)

    def publish_once(self) -> bool:
        if faults.fire("replica-heartbeat-drop") == "drop":
            return False  # chaos: alive but silent -> ages out of routing
        # flap chaos: mode=delay with delay-ms slightly past the TTL
        # stretches the inter-beat gap so the replica keeps aging out
        # and returning; mode=drop skips single beats
        if faults.fire("replica-group-flap") == "drop":
            return False
        try:
            self._producer.send(KEY_HEARTBEAT,
                                self.current_heartbeat().to_json())
            self.published += 1
            return True
        except Exception:  # noqa: BLE001 — next interval retries
            _log.warning("heartbeat publish failed; replica will age "
                         "out of routing until the broker returns",
                         exc_info=True)
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            self.publish_once()
            clockmod.wait(self._stop, self.interval_sec)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ClusterHeartbeat")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
