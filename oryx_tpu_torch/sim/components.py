"""The simulated cluster's components.

Each component is a small cooperative task around as much REAL
production code as the seams allow:

- :class:`SimRouter` hosts a real :class:`MembershipRegistry` under
  the virtual clock — topology bootstrap, warming, atomic cutover,
  TTL liveness and the single-snapshot ``routing_plan()`` are the
  production code paths, fed by real Heartbeat JSON records tapped
  off the region's inproc update topic.
- :class:`SimMirror` hosts a real :class:`MirrorLayer` — origin
  stamping, loop prevention, the checkpoint + dedup fence and
  ``recover()`` are production code; the sim only decides WHEN
  ``poll_once()`` runs, whether the replication link is partitioned,
  and when the process dies (including the production
  ``mirror-crash-mid-replay`` seam: after the batch's sends, before
  its checkpoint save).
- :class:`SimReplica` / :class:`SimSpeed` / :class:`SimClient` are
  sim-native models: a replica replays the update topic from offset 0
  with bounded per-cycle throughput (so warming takes virtual time
  and cutovers have a window), applies records it owns per the real
  ``shard_of``, and heartbeats through the real Heartbeat codec; the
  speed layer folds the input topic into UP records with
  commit-after-publish (at-least-once — a crash redelivers, applies
  are idempotent by record id, the paper's fold-in-SET argument).

Record formats on the region's "OryxUpdate" topic: real HB records
(``KEY_HEARTBEAT`` + Heartbeat JSON), real ``KEY_MODEL`` markers, and
sim UP records (``KEY_UP`` + ``{"e": entity, "rec": id}``) — opaque
bytes to the mirror, exactly like production traffic.
"""

from __future__ import annotations

import json
import os

from ..cluster.membership import (KEY_HEARTBEAT, Heartbeat,
                                  MembershipRegistry)
from ..cluster.mirror import MirrorLayer
from ..cluster.sharding import shard_of
from ..common.config import from_dict
from ..kafka.api import KEY_MODEL, KEY_UP
from ..lambda_rt.speed_checkpoint import (SpeedCheckpoint,
                                          recover_pending,
                                          stamp_headers)
from ..resilience import faults as prod_faults
from ..resilience.faults import InjectedCrash
from .net import NetError
from .sched import Sleep, Step, gather

__all__ = ["UPDATE_TOPIC", "INPUT_TOPIC", "SimReplica", "SimRouter",
           "SimSpeed", "SimSpeedShard", "SimMirror", "SimClient"]

UPDATE_TOPIC = "OryxUpdate"
INPUT_TOPIC = "SimIn"


def _up_record(entity: str, rec: str) -> str:
    return json.dumps({"e": entity, "rec": rec},
                      separators=(",", ":"))


def _drained_to(broker, topic: str, pos: int) -> bool:
    """Caught up for drain purposes: nothing unconsumed beyond
    ``pos`` except heartbeats.  Heartbeats flow forever, so "pos ==
    latest offset" is a moving target that a fleet of consumers
    almost never satisfies simultaneously — drain means the *payload*
    backlog is empty."""
    end = broker.latest_offset(topic)
    if pos >= end:
        return True
    return all(km.key == KEY_HEARTBEAT
               for km in broker.read_range(topic, pos, end))


class SimReplica:
    """One serving replica of shard ``shard``/``of``: replays the
    region update topic from 0, applies owned UP records idempotently
    (set semantics keyed by record id), counts MODEL generations, and
    publishes real heartbeats.  ``ready`` gates the first time it is
    fully caught up with generation >= 1 — until then the router
    never routes to it (warming)."""

    POLL = 0.05
    HB_INTERVAL = 0.25
    MAX_PER_CYCLE = 64       # replay throughput: warming takes time

    def __init__(self, cx, region: str, shard: int, of: int,
                 idx: int):
        self.cx = cx
        self.region = region
        self.shard = shard
        self.of = of
        self.name = f"{region}.rep{of}x{shard}.{idx}"
        self.pos = 0
        self.state: dict[str, set[str]] = {}
        self.generation = 0
        self.ready = False
        self.applied = 0

    def handler(self, req):
        if req.get("op") != "scan":
            raise ValueError(f"bad op {req!r}")
        return {
            "replica": self.name, "shard": self.shard, "of": self.of,
            "gen": self.generation,
            "data": {e: sorted(recs)
                     for e, recs in self.state.items()},
        }

    def _apply(self, km) -> None:
        if km.key == KEY_HEARTBEAT:
            return
        if km.key == KEY_MODEL:
            self.generation += 1
            return
        if km.key != KEY_UP:
            return
        try:
            doc = json.loads(km.message)
            e, rec = doc["e"], doc["rec"]
        except (ValueError, KeyError, TypeError):
            return
        if shard_of(e, self.of) == self.shard:
            self.state.setdefault(e, set()).add(rec)
            self.applied += 1

    def drained(self) -> bool:
        return _drained_to(self.cx.broker(self.region),
                           UPDATE_TOPIC, self.pos)

    def run(self):
        b = self.cx.broker(self.region)
        last_hb = -1e9
        while True:
            yield Sleep(self.POLL)
            end = b.latest_offset(UPDATE_TOPIC)
            if self.pos < end:
                upto = min(self.pos + self.MAX_PER_CYCLE, end)
                for km in b.read_range(UPDATE_TOPIC, self.pos, upto):
                    self._apply(km)
                self.pos = upto
            if not self.ready and self.generation >= 1 \
                    and self.pos >= end:
                self.ready = True
                self.cx.sched.note(f"replica.ready|{self.name}")
            now = self.cx.clock.monotonic()
            if now - last_hb >= self.HB_INTERVAL:
                hb = Heartbeat(replica=self.name, shard=self.shard,
                               of=self.of, url=f"sim://{self.name}",
                               generation=self.generation,
                               ready=self.ready,
                               fraction=1.0 if self.ready else 0.5,
                               ts=self.cx.clock.time(),
                               region=self.region)
                b.send(UPDATE_TOPIC, KEY_HEARTBEAT, hb.to_json())
                last_hb = now


class _CacheEntry:
    __slots__ = ("resp", "seq", "entities")

    def __init__(self, resp: dict, seq: int):
        self.resp = resp
        self.seq = seq
        self.entities = set(resp["data"])


class SimRouter:
    """The region's scatter/gather front end around a REAL
    MembershipRegistry, plus the replica-side result cache model:
    entries keyed by the registry's ``generation_topology()`` epoch,
    evicted by the topic tap's UP records, refused while the epoch is
    mixed — the production cache's contract, checked continuously by
    the freshness invariant."""

    TAP_INTERVAL = 0.04
    SHARD_TIMEOUT = 0.25
    TTL = 1.2

    def __init__(self, cx, region: str):
        self.cx = cx
        self.region = region
        self.name = f"{region}.router"
        self.registry = MembershipRegistry(
            ttl_sec=self.TTL, clock=cx.clock.monotonic, region=region)
        self.tap_pos = 0
        self.tap_seq = 0                 # records tapped, ever
        self.last_up_seq: dict[str, int] = {}  # entity -> tap seq
        self.cache: dict[tuple, _CacheEntry] = {}
        self.cache_hits = 0
        self.cache_stores = 0
        self._qn = 0
        # sliding admission window for the write path (the ingest
        # backpressure model); the LIMIT lives on the cluster so a
        # restarted router keeps shedding, the window state is
        # per-instance — a cold router starts with headroom, exactly
        # like a real in-memory gate
        self._write_times: list[float] = []

    def _tap(self) -> None:
        b = self.cx.broker(self.region)
        end = b.latest_offset(UPDATE_TOPIC)
        if self.tap_pos >= end:
            return
        for km in b.read_range(UPDATE_TOPIC, self.tap_pos, end):
            self.tap_seq += 1
            if km.key == KEY_HEARTBEAT:
                self.registry.note_message(km.message)
            elif km.key == KEY_UP:
                try:
                    e = json.loads(km.message)["e"]
                except (ValueError, KeyError, TypeError):
                    continue
                self.last_up_seq[e] = self.tap_seq
                # invalidation record: evict every entry holding e
                for k in [k for k, ent in self.cache.items()
                          if e in ent.entities]:
                    del self.cache[k]
        self.tap_pos = end

    def drained(self) -> bool:
        return _drained_to(self.cx.broker(self.region),
                           UPDATE_TOPIC, self.tap_pos)

    def run(self):
        while True:
            yield Sleep(self.TAP_INTERVAL)
            self._tap()

    # -- request handling -----------------------------------------------------

    def handler(self, req):
        op = req.get("op")
        if op == "write":
            limit = self.cx.ingest_limits.get(self.region)
            if limit is not None:
                cap, window = limit
                now = self.cx.clock.monotonic()
                self._write_times = [t for t in self._write_times
                                     if now - t < window]
                if len(self._write_times) >= cap:
                    # shed BEFORE the durable append: a 503 carries
                    # no record id, so "503 means retry, nothing was
                    # acked" holds by construction
                    self.cx.stats["ingest_sheds"] += 1
                    return {"status": 503, "retry_after": 1}
                self._write_times.append(now)
            e = req["e"]
            rec = self.cx.next_rec(self.region)
            self.cx.broker(self.region).send(
                INPUT_TOPIC, e, _up_record(e, rec))
            # the ack ledger the exactly-once-fold invariant audits:
            # a 200 here is a durability promise the speed layer must
            # honor through any crash
            self.cx.acked_writes.append((self.region, e, rec))
            return {"status": 200, "rec": rec}
        if op == "query":
            return self._query(req)   # generator: async handler
        raise ValueError(f"bad op {req!r}")

    def _fetch_shard(self, shard: int, cands):
        # group failover: newest-generation-first candidates from the
        # single-snapshot plan; first reachable replica answers
        for hb in cands[:3]:
            try:
                r = yield from self.cx.net.call(
                    self.name, hb.replica, {"op": "scan"},
                    timeout=self.SHARD_TIMEOUT)
                return r
            except NetError:
                continue
        raise NetError(f"shard {shard}: no reachable replica")

    def _query(self, req):
        epoch = self.registry.generation_topology()
        of_e, gens, mixed = epoch
        ckey = ("scan", of_e, gens)
        if not mixed:
            ent = self.cache.get(ckey)
            if ent is not None:
                self.cache_hits += 1
                resp = dict(ent.resp)
                resp["cache"] = True
                self.cx.checkers.on_response(self, resp,
                                             cache_entry=ent)
                return resp
        of, groups = self.registry.routing_plan()
        self._qn += 1
        res = yield from gather(
            self.cx.sched, f"{self.name}.q{self._qn}",
            [self._fetch_shard(s, groups[s]) for s in range(of)])
        shards: dict[int, dict] = {}
        missing: list[int] = []
        data: dict[str, list[str]] = {}
        for s, out in enumerate(res):
            if out is None or out[0] != "ok":
                missing.append(s)
                continue
            r = out[1]
            shards[s] = {"of": r["of"], "replica": r["replica"],
                         "entities": sorted(r["data"])}
            data.update(r["data"])
        resp = {"status": 200, "of": of, "cache": False,
                "partial": missing or None, "data": data,
                "shards": shards}
        self.cx.checkers.on_response(self, resp)
        if resp["partial"] is None and not mixed \
                and self.registry.generation_topology() == epoch:
            # store only when complete AND the epoch held for the
            # whole scatter — a mixed or moved epoch must refuse
            self.cache[ckey] = _CacheEntry(resp, self.tap_seq)
            self.cache_stores += 1
        return resp


class SimSpeed:
    """The speed layer: folds the region's input topic into UP
    records on the update topic.  Commit-after-publish on the
    broker's group offsets: a kill between the publish step and the
    commit step redelivers the batch on restart (at-least-once), and
    replica applies absorb the duplicates by record id."""

    POLL = 0.05
    GROUP = "sim-speed"

    def __init__(self, cx, region: str):
        self.cx = cx
        self.region = region
        self.name = f"{region}.speed"
        self.published = 0

    def drained(self) -> bool:
        b = self.cx.broker(self.region)
        committed = b.get_offset(self.GROUP, INPUT_TOPIC, 0) or 0
        return committed >= b.latest_offset(INPUT_TOPIC)

    def run(self):
        b = self.cx.broker(self.region)
        while True:
            yield Sleep(self.POLL)
            start = b.get_offset(self.GROUP, INPUT_TOPIC, 0) or 0
            end = b.latest_offset(INPUT_TOPIC)
            if start >= end:
                continue
            for km in b.read_range(INPUT_TOPIC, start, end):
                b.send(UPDATE_TOPIC, KEY_UP, km.message,
                       headers={"ts": str(int(
                           self.cx.clock.time() * 1000))})
                self.published += 1
            # the crash window: records published, offset uncommitted
            yield Step()
            b.set_offset(self.GROUP, INPUT_TOPIC, end, 0)


class SimSpeedShard:
    """One shard of the crash-safe sharded speed layer, around the
    REAL :class:`SpeedCheckpoint` durable fence
    (lambda_rt/speed_checkpoint.py).  Every worker consumes the full
    input topic but folds only entities it owns per the real
    ``shard_of``; each micro-batch is write-ahead staged, published
    with shard/batch/seq headers, then committed in one atomic
    document.  The sim decides WHEN the loop steps and when the
    process dies — a kill between publishes, or the production
    ``speed-crash-mid-batch`` seam (after the sends, before the
    commit), lands in the fence's window; restart runs the real
    ``recover_pending`` scan-and-dedup, so acked writes fold exactly
    once no matter where the death landed."""

    POLL = 0.05

    def __init__(self, cx, region: str, shard: int, of: int):
        self.cx = cx
        self.region = region
        self.shard = shard
        self.of = of
        self.name = f"{region}.speed{of}x{shard}"
        self.tag = f"{shard}/{of}"
        self.published = 0
        self.dedup_skips = 0
        self.checkpoint = SpeedCheckpoint(
            os.path.join(cx.checkpoint_dir(region),
                         f"speed{of}x{shard}"))
        # the production restart path: resolve any staged-uncommitted
        # batch against the destination log before the first poll
        self._recover()

    def _publish(self, message: str, headers: dict) -> None:
        self.cx.broker(self.region).send(UPDATE_TOPIC, KEY_UP,
                                         message, headers=headers)
        self.published += 1

    def _recover(self) -> None:
        b = self.cx.broker(self.region)
        dest_end = b.latest_offset(UPDATE_TOPIC)
        republished, deduped = recover_pending(
            self.checkpoint, self.tag,
            lambda starts, ends: b.read_range(
                UPDATE_TOPIC, starts[0], ends[0]),
            [dest_end], self._publish)
        self.dedup_skips += deduped
        if republished or deduped:
            self.cx.sched.note(
                f"speed.recovered|{self.name}|{republished}|{deduped}")
        self.cx.checkers.on_speed_checkpoint(self)

    def drained(self) -> bool:
        b = self.cx.broker(self.region)
        return (self.checkpoint.pending is None
                and self.checkpoint.input.get(0, 0)
                >= b.latest_offset(INPUT_TOPIC))

    def run(self):
        b = self.cx.broker(self.region)
        try:
            while True:
                yield Sleep(self.POLL)
                if self.checkpoint.pending is not None:
                    # a publish attempt died mid-batch: finish it from
                    # the staged bytes before deriving anything new
                    self._recover()
                    continue
                start = self.checkpoint.input.get(0, 0)
                end = b.latest_offset(INPUT_TOPIC)
                if start >= end:
                    continue
                updates = []
                for km in b.read_range(INPUT_TOPIC, start, end):
                    try:
                        e = json.loads(km.message)["e"]
                    except (ValueError, KeyError, TypeError):
                        continue
                    if shard_of(e, self.of) == self.shard:
                        updates.append(km.message)
                if not updates:
                    # nothing owned in this slice: just advance the
                    # input fence (other shards own those records)
                    self.checkpoint.commit_batch([end])
                    self.cx.checkers.on_speed_checkpoint(self)
                    continue
                base = {"ts": str(int(self.cx.clock.time() * 1000))}
                batch = self.checkpoint.stage_batch([end], updates,
                                                    base)
                for seq, msg in enumerate(updates):
                    self._publish(msg, stamp_headers(base, self.tag,
                                                     batch, seq))
                    # the crash window: some publishes durable, the
                    # staged batch still uncommitted.  A Sleep (not a
                    # bare Step) so the window spans virtual time and
                    # kill faults can land INSIDE it — forcing the
                    # republish-missing-seqs recovery path, not just
                    # the dedup-all one
                    yield Sleep(0.004)
                # the production seam: die after the sends, before
                # the atomic commit
                prod_faults.fire("speed-crash-mid-batch")
                self.checkpoint.commit_batch(
                    [end], dest_ends=[b.latest_offset(UPDATE_TOPIC)])
                self.cx.checkers.on_speed_checkpoint(self)
        except InjectedCrash:
            self.cx.sched.note(f"speed.crashed|{self.name}")
            self.cx.on_component_crashed(self.name)


class SimMirror:
    """A real :class:`MirrorLayer` driven cooperatively.  The
    replication link to the remote region's broker is subject to the
    net's partition facts; a partitioned link means the poll cannot
    run (the tail's reads would fail), so replay stalls and staleness
    climbs — heal and it drains.  Crash/restart goes through the
    REAL checkpoint + ``recover()`` fence re-derivation."""

    POLL = 0.08

    def __init__(self, cx, region: str, source_region: str):
        self.cx = cx
        self.region = region
        self.source_region = source_region
        self.name = f"{region}.mirror"
        self.remote = f"{source_region}.broker"
        cfg = from_dict({
            "oryx.cluster.region.name": region,
            "oryx.cluster.region.mirror.source-broker":
                f"memory://{cx.broker_name(source_region)}",
            "oryx.cluster.region.mirror.source-region": source_region,
            "oryx.cluster.region.mirror.checkpoint-dir":
                cx.checkpoint_dir(region),
            "oryx.cluster.region.mirror.poll-interval-ms": 80,
            "oryx.cluster.region.mirror.max-batch-records": 64,
            "oryx.update-topic.broker":
                f"memory://{cx.broker_name(region)}",
            "oryx.resilience.retry.max-attempts": 2,
            "oryx.resilience.retry.initial-backoff-ms": 1,
            "oryx.resilience.retry.max-backoff-ms": 2,
        })
        self.layer = MirrorLayer(cfg, clock=cx.clock)
        # the production restart path: re-derive the dedup fence from
        # the destination log before the first poll
        self.layer.recover()

    def caught_up(self) -> bool:
        # sim topics are single-partition, so partition 0 carries
        # everything; trailing heartbeats don't count as backlog
        src = self.cx.broker(self.source_region)
        return _drained_to(src, UPDATE_TOPIC,
                           self.layer.checkpoint.source.get(0, 0))

    def run(self):
        try:
            while True:
                yield Sleep(self.POLL)
                if not self.cx.net.reachable(self.name, self.remote):
                    self.layer.link_failures += 1
                    continue
                n = self.layer.poll_once()
                self.cx.checkers.on_mirror_poll(self)
                if n:
                    self.cx.sched.note(
                        f"mirror.replayed|{self.name}|{n}")
        except InjectedCrash:
            # the production mid-replay crash seam fired: sends done,
            # checkpoint save lost — recover() must re-fence
            self.cx.sched.note(f"mirror.crashed|{self.name}")
            self.cx.on_component_crashed(self.name)


class SimClient:
    """Seeded workload: writes and full-scan queries against one
    region's router.  Every response flows through the invariant
    checkers router-side; the client just keeps score."""

    def __init__(self, cx, region: str, idx: int, ops: int,
                 entities: list[str], write_ratio: float = 0.55):
        self.cx = cx
        self.region = region
        self.name = f"{region}.client{idx}"
        self.router = f"{region}.router"
        self.ops = ops
        self.entities = entities
        self.write_ratio = write_ratio

    def run(self):
        rng = self.cx.rng
        st = self.cx.stats
        for _ in range(self.ops):
            yield Sleep(rng.uniform(0.01, 0.09))
            if rng.random() < self.write_ratio:
                e = self.entities[rng.randrange(len(self.entities))]
                req = {"op": "write", "e": e}
            else:
                req = {"op": "query"}
            try:
                resp = yield from self.cx.net.call(
                    self.name, self.router, req, timeout=1.2)
            except NetError:
                st["client_net_errors"] += 1
                continue
            if req["op"] == "write":
                if resp.get("status") == 503:
                    # shed by the ingest admission window: retryable,
                    # explicitly NOT acked — no durability promise
                    st["writes_shed"] += 1
                else:
                    st["writes_ok"] += 1
            else:
                st["queries_ok"] += 1
                if resp.get("partial"):
                    st["queries_partial"] += 1
                if resp.get("cache"):
                    st["cache_hits"] += 1
        st[f"client_done_{self.name}"] = 1
