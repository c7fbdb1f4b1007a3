"""Exact top-N merge and the cluster's canonical result order.

Counterpart of ``oryx_tpu/cluster/merge.py``, copied whole.

The cluster must return the SAME answer as a single node holding the
full catalog, for any shard count — ties included.  Device ``top_k``
breaks score ties by store row index, an artifact of each process's
own free-row recycling that no other process can reproduce.  The
cluster therefore defines ONE canonical total order and applies it on
every path:

    (score descending, ordinal ascending, id ascending)

where ``ordinal`` is the item's first-appearance index in the totally
ordered update topic (assigned by every consumer identically —
ALSServingModelManager.item_ordinals).  A 1-shard replica and an
N-shard merge sort identical per-item (score, ordinal) pairs, so the
merged result is byte-identical to the single-node exact scan
(tests/test_cluster_merge.py drives random catalogs / shardings /
ties / retired rows through exactly this claim).

Exactness needs each shard's *local* top-k to be exact under the
canonical order too: :func:`exact_local_top_n` detects a tie group
straddling the local k-boundary (where the device's row-order pick is
not canonical) and widens the fetch window until the boundary tie
group is fully in view — the same fetched device scores, never a
recompute, so scores stay bit-identical to the plain serving path.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["canon_sort", "merge_top_n", "exact_local_top_n"]

# rows travel between shard and router as [id, score, ordinal]
Row = tuple[str, float, int]


def _key(row: Row, lowest: bool):
    # NaN-free by construction (serving filters non-finite scores);
    # -score gives descending score, ordinal ascending breaks ties.
    # The id is a final key so the order stays TOTAL even for items
    # that never got a replay ordinal (models built outside the
    # update-topic replay, e.g. bench factories).
    return (row[1] if lowest else -row[1], row[2], row[0])


def canon_sort(rows: Sequence[Row], lowest: bool = False) -> list[Row]:
    return sorted(rows, key=lambda r: _key(r, lowest))


def merge_top_n(shard_rows: Sequence[Sequence[Row]], how_many: int,
                offset: int = 0, lowest: bool = False) -> list[Row]:
    """Merge per-shard exact local top-k lists into the exact global
    top-``how_many`` after ``offset`` under the canonical order.
    Exact because catalog shards are disjoint and each shard list is
    its exact local prefix of length >= offset + how_many (or its
    whole catalog's survivors)."""
    merged: list[Row] = []
    for rows in shard_rows:
        merged.extend((r[0], r[1], r[2]) for r in rows)
    return canon_sort(merged, lowest)[offset:offset + how_many]


def exact_local_top_n(model, ordinal_of, how_many: int, *,
                      user_vector=None, cosine_to=None,
                      exclude=(), rescorer=None, allowed=None,
                      lowest: bool = False,
                      use_lsh: bool = True,
                      batcher=None, deadline=None) -> list[Row]:
    """This shard's exact top-``how_many`` under the canonical order,
    as (id, score, ordinal) rows.

    Fast path (no rescorer/allowed): fetch ``how_many + 1`` through the
    normal device scan; when the boundary score is strictly separated,
    the top-k SET is unique and only needs the canonical re-sort.  A
    tie group straddling the boundary widens the window (doubling)
    until every member of the boundary tie group is in view, then
    fills canonically.  Rescorer / allowed-predicate queries rank by
    POST-rescore score, for which no raw-score window bound exists —
    those take the full exact scan (``how_many`` = whole catalog),
    which is also exactly what makes a 1-shard replica the reference
    semantics for the property tests.
    """
    exclude = set(exclude)
    kw = dict(user_vector=user_vector, cosine_to=cosine_to,
              exclude=exclude, lowest=lowest, use_lsh=use_lsh)

    def _rows(pairs) -> list[Row]:
        return [(i, s, ordinal_of(i)) for i, s in pairs]

    n_live = model.item_count()
    if n_live == 0 or how_many <= 0:
        return []
    if rescorer is not None or allowed is not None:
        pairs = model.top_n(n_live, rescorer=rescorer, allowed=allowed,
                            **kw)
        return canon_sort(_rows(pairs), lowest)[:how_many]

    def fetch(m: int):
        # plain dot queries coalesce with concurrent shard requests
        # through the app-scope batcher (same pairs as model.top_n —
        # serving throughput must not regress because a gateway fronts
        # the replica); cosine/lowest take the direct path
        if batcher is not None and user_vector is not None \
                and not lowest and use_lsh:
            return batcher.top_n(model, m, user_vector, exclude,
                                 deadline=deadline)
        if deadline is not None:
            deadline.check("shard top_n")
        return model.top_n(m, **kw)

    # capacity bound: once the request window covers every store row,
    # the fetch is complete no matter how deep the tie group runs
    capacity = len(model.Y.row_ids())
    m = how_many + 1
    while True:
        pairs = fetch(m)
        if len(pairs) <= how_many:
            # fewer live candidates than asked: everything is in view
            return canon_sort(_rows(pairs), lowest)
        boundary = pairs[how_many - 1][1]
        # the fetch is complete when it returned FEWER pairs than asked
        # (top_n full-scans whenever filtering eats its padded window,
        # so a short answer means every live non-excluded candidate is
        # in view) or the request itself covers every store row.  The
        # exclude size must NOT count toward coverage: on a sharded
        # replica the exclude set is the user's GLOBAL known items,
        # most of which occupy no local row — counting them stopped
        # the widening loop with live tied candidates still unfetched.
        complete = len(pairs) < m or m >= capacity
        # pairs arrive sorted by score (desc, or asc under lowest); the
        # boundary tie group is fully in view once the tail score has
        # strictly passed it
        tail_past = (pairs[-1][1] < boundary if not lowest
                     else pairs[-1][1] > boundary)
        if tail_past or complete:
            head = [r for r in _rows(pairs)
                    if (r[1] > boundary if not lowest else r[1] < boundary)]
            tied = [r for r in _rows(pairs) if r[1] == boundary]
            out = canon_sort(head, lowest) + canon_sort(tied, lowest)
            return out[:how_many]
        m = min(max(m * 2, 16), capacity)
