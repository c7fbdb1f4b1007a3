"""The continuously-checked correctness invariants.

Each checker recomputes its property from primary state (topic
contents, registry snapshots, checkpoint dicts) rather than trusting
the component that maintains it — a checker sharing the component's
bug would certify the bug.  A violation raises
:class:`InvariantViolation` from wherever it is detected; the
scenario runner wraps it with the seed, the virtual time, the trace
hash and the one-line repro command.

1. **no-silently-partial-200** — a 200 without a partial marker must
   cover EXACTLY the shard set {0..of-1} of ONE topology snapshot:
   every per-shard answer's ``of`` equals the plan's, and every
   entity a shard returned hashes to that shard under the plan's
   ``of`` (the real ``shard_of``).  Catches any regression of the
   routing-plan single-snapshot contract — a cutover landing between
   per-shard candidate reads merges two rings into one silently
   wrong answer.
2. **result-cache freshness** — a cache hit must not be served past
   its invalidation record: for every entity in the hit entry, the
   tap sequence of that entity's last UP record must precede the
   entry's store point.
3. **mirror checkpoint never-rewind** — source positions, dedup-fence
   watermarks and recovery scan marks only ever advance, across
   polls AND across crash/recover cycles (keyed by mirror name, not
   instance).
4. **exactly-once-effective replay** — in any region's log, at most
   one mirrored copy per origin coordinate (region, partition,
   offset), and never a mirrored record whose origin is the region
   itself (a loop).
5. **cross-region convergence after heal** — once healed and
   drained, both regions hold byte-identical update-record state:
   the same record ids per entity, with identical message bytes per
   record id; and every caught-up replica's applied state equals the
   state derived independently from its region's log.
6. **speed checkpoint never-rewind** — a sharded speed worker's
   input fence, destination scan mark and batch counter only ever
   advance, across polls AND across crash/recover cycles.
7. **acked writes fold exactly once, on the owner shard** — in a
   region running the sharded speed layer, every write the router
   ACKED appears EXACTLY once among the update topic's
   speed-stamped UP records after drain (zero lost through any
   crash, zero double-folds through any replay), and the stamping
   worker is the entity's owner under the real ``shard_of``.
"""

from __future__ import annotations

import json

from ..cluster.mirror import H_ORIGIN_REGION, origin_of
from ..cluster.sharding import shard_of
from ..kafka.api import KEY_UP
from ..lambda_rt.speed_checkpoint import H_SPEED_SHARD
from .components import UPDATE_TOPIC

__all__ = ["InvariantViolation", "Checkers"]


class InvariantViolation(AssertionError):
    def __init__(self, name: str, detail: str):
        super().__init__(f"[{name}] {detail}")
        self.invariant = name


def _region_log_state(cx, region: str):
    """(entity -> set(rec), rec -> message bytes, violations via
    origin coordinates) derived straight from the region's log."""
    b = cx.broker(region)
    end = b.latest_offset(UPDATE_TOPIC)
    by_entity: dict[str, set[str]] = {}
    rec_bytes: dict[str, str] = {}
    origins_seen: dict[tuple, int] = {}
    for off, km in enumerate(b.read_range(UPDATE_TOPIC, 0, end)):
        if km.key != KEY_UP:
            continue
        h = km.headers or {}
        if H_ORIGIN_REGION in h:
            o = origin_of(km, "?", 0, off)
            if o[0] == region:
                raise InvariantViolation(
                    "exactly-once",
                    f"loop: region {region} log offset {off} carries "
                    f"its own origin {o}")
            origins_seen[o] = origins_seen.get(o, 0) + 1
            if origins_seen[o] > 1:
                raise InvariantViolation(
                    "exactly-once",
                    f"origin {o} mirrored {origins_seen[o]}x into "
                    f"region {region} (dedup fence breached)")
        try:
            doc = json.loads(km.message)
            e, rec = doc["e"], doc["rec"]
        except (ValueError, KeyError, TypeError):
            continue
        by_entity.setdefault(e, set()).add(rec)
        prev = rec_bytes.get(rec)
        if prev is not None and prev != km.message:
            raise InvariantViolation(
                "convergence",
                f"record {rec} has two different bodies in region "
                f"{region}")
        rec_bytes[rec] = km.message
    return by_entity, rec_bytes


class Checkers:
    def __init__(self, cx):
        self.cx = cx
        # (mirror name, kind, key) -> highest value ever observed;
        # survives component restarts by design
        self._ckpt_max: dict[tuple, int] = {}
        self.responses_checked = 0
        self.cache_hits_checked = 0
        self.mirror_polls_checked = 0
        self.speed_checkpoints_checked = 0

    # -- request-path invariants (1, 2) ---------------------------------------

    def on_response(self, router, resp: dict, cache_entry=None):
        self.responses_checked += 1
        if cache_entry is not None:
            self.cache_hits_checked += 1
            for e in cache_entry.entities:
                seq = router.last_up_seq.get(e, 0)
                if seq > cache_entry.seq:
                    raise InvariantViolation(
                        "cache-freshness",
                        f"{router.name} served entity {e} from a "
                        f"cache entry stored at tap seq "
                        f"{cache_entry.seq}, past its invalidation "
                        f"record at seq {seq}")
            return
        of = resp["of"]
        shards = resp["shards"]
        for s, meta in shards.items():
            if meta["of"] != of:
                raise InvariantViolation(
                    "single-snapshot",
                    f"{router.name} merged shard {s} answered by a "
                    f"{meta['of']}-way replica ({meta['replica']}) "
                    f"into a {of}-way plan")
            for e in meta["entities"]:
                if shard_of(e, of) != s:
                    raise InvariantViolation(
                        "single-snapshot",
                        f"{router.name}: entity {e} returned by "
                        f"shard {s} but hashes to shard "
                        f"{shard_of(e, of)} under of={of} — two "
                        f"rings merged into one answer")
        if resp["partial"] is None:
            if set(shards) != set(range(of)):
                raise InvariantViolation(
                    "no-partial-200",
                    f"{router.name} returned 200 with no partial "
                    f"marker covering shards {sorted(shards)} of an "
                    f"{of}-way topology")

    # -- mirror invariants (3) ------------------------------------------------

    def on_mirror_poll(self, sim_mirror):
        self.mirror_polls_checked += 1
        ck = sim_mirror.layer.checkpoint
        name = sim_mirror.name
        for p, off in ck.source.items():
            self._advance_only(name, "source", p, off)
        for key, wm in ck.watermarks.items():
            self._advance_only(name, "fence", key, wm)
        for p, off in ck.dest_scanned.items():
            self._advance_only(name, "scan", p, off)

    # -- speed-layer invariants (6) -------------------------------------------

    def on_speed_checkpoint(self, sim_speed):
        """Called by a sharded speed worker after every checkpoint
        transition (stage resolution or batch commit): the durable
        fence's marks must never rewind, across crash/recover cycles
        (keyed by worker name, not instance)."""
        self.speed_checkpoints_checked += 1
        ck = sim_speed.checkpoint
        name = sim_speed.name
        for p, off in ck.input.items():
            self._advance_only(name, "input", p, off)
        for p, off in ck.dest_scanned.items():
            self._advance_only(name, "dest-scan", p, off)
        self._advance_only(name, "batch", 0, ck.next_batch)

    def _advance_only(self, name: str, kind: str, key, value: int):
        k = (name, kind, key)
        prev = self._ckpt_max.get(k, -1)
        if value < prev:
            raise InvariantViolation(
                "checkpoint-rewind",
                f"{name} {kind}[{key}] rewound {prev} -> {value}")
        self._ckpt_max[k] = value

    # -- terminal invariants (4, 5) -------------------------------------------

    def final(self, regions: list[str], replicas) -> dict:
        """After heal + drain: convergence, exactly-once, and
        replica-applied state == log-derived state.  Returns summary
        counters for the scenario result."""
        states = {}
        for r in regions:
            states[r] = _region_log_state(self.cx, r)
        if len(regions) == 2:
            a, b = regions
            ea, ra = states[a]
            eb, rb = states[b]
            if ea != eb:
                only_a = {e: sorted(ea.get(e, set()) - eb.get(e, set()))
                          for e in set(ea) | set(eb)
                          if ea.get(e, set()) != eb.get(e, set())}
                raise InvariantViolation(
                    "convergence",
                    f"regions diverged after heal+drain: {only_a}")
            for rec in set(ra) & set(rb):
                if ra[rec] != rb[rec]:
                    raise InvariantViolation(
                        "convergence",
                        f"record {rec} bytes differ across regions")
        for rep in replicas:
            if not rep.ready:
                continue
            derived = {
                e: recs
                for e, recs in states[rep.region][0].items()
                if shard_of(e, rep.of) == rep.shard}
            if rep.state != derived:
                diff = {e for e in set(rep.state) | set(derived)
                        if rep.state.get(e) != derived.get(e)}
                raise InvariantViolation(
                    "convergence",
                    f"replica {rep.name} applied state diverges from "
                    f"its region log on entities {sorted(diff)}")
        folds_checked = self._check_speed_folds()
        return {
            "entities": sum(len(s[0]) for s in states.values()),
            "records": sum(len(s[1]) for s in states.values()),
            "responses_checked": self.responses_checked,
            "cache_hits_checked": self.cache_hits_checked,
            "mirror_polls_checked": self.mirror_polls_checked,
            "speed_folds_checked": folds_checked,
        }

    def _check_speed_folds(self) -> int:
        """Terminal invariant 7: in every sharded-speed region, each
        ACKED write appears exactly once among the speed-stamped UP
        records, published by the entity's owner shard — recomputed
        straight from the ack ledger and the raw log, never from the
        workers' own counters."""
        checked = 0
        for region, of in self.cx.speed_sharded.items():
            b = self.cx.broker(region)
            end = b.latest_offset(UPDATE_TOPIC)
            folded: dict[str, list[tuple[str, str]]] = {}
            for km in b.read_range(UPDATE_TOPIC, 0, end):
                if km.key != KEY_UP:
                    continue
                tag = (km.headers or {}).get(H_SPEED_SHARD)
                if tag is None:
                    continue
                try:
                    doc = json.loads(km.message)
                    e, rec = doc["e"], doc["rec"]
                except (ValueError, KeyError, TypeError):
                    continue
                folded.setdefault(rec, []).append((e, tag))
            for r, e, rec in self.cx.acked_writes:
                if r != region:
                    continue
                checked += 1
                hits = folded.get(rec, [])
                if not hits:
                    raise InvariantViolation(
                        "speed-exactly-once",
                        f"acked write {rec} (entity {e}) never folded "
                        f"into region {region}'s update log — a 200 "
                        f"was a durability promise")
                if len(hits) > 1:
                    raise InvariantViolation(
                        "speed-exactly-once",
                        f"acked write {rec} (entity {e}) folded "
                        f"{len(hits)}x into region {region} "
                        f"(double-fold past the dedup fence)")
                owner = f"{shard_of(e, of)}/{of}"
                if hits[0][1] != owner:
                    raise InvariantViolation(
                        "speed-exactly-once",
                        f"write {rec} (entity {e}) folded by shard "
                        f"{hits[0][1]}, but the owner under of={of} "
                        f"is {owner}")
        return checked
