"""Catalog sharding: stable item id -> shard index.

Counterpart of ``oryx_tpu/cluster/sharding.py``, copied whole: the hash
is Kafka's DefaultPartitioner contract (``kafka/partitioner.py``), so
shard and slice assignment are a pure function of the id and the
count.
"""

from __future__ import annotations

from ..kafka.partitioner import partition_for_key

__all__ = ["shard_of", "parse_shard_spec", "is_local_item"]


def shard_of(item_id: str, shard_count: int) -> int:
    """The shard that owns ``item_id`` in a ``shard_count``-way split."""
    if shard_count <= 1:
        return 0
    return partition_for_key(item_id, shard_count)


def parse_shard_spec(spec: str) -> tuple[int, int]:
    """``"i/N"`` -> (shard_index, shard_count), validated."""
    try:
        idx_s, count_s = spec.split("/", 1)
        idx, count = int(idx_s), int(count_s)
    except ValueError as e:
        raise ValueError(f"shard spec must be 'i/N', got {spec!r}") from e
    if count < 1 or not 0 <= idx < count:
        raise ValueError(f"shard index out of range in {spec!r}")
    return idx, count


def is_local_item(item_id: str, shard_index: int, shard_count: int) -> bool:
    return shard_count <= 1 or shard_of(item_id, shard_count) == shard_index
