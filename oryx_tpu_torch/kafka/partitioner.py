"""Kafka's default keyed-partitioning contract.

Counterpart of ``oryx_tpu/kafka/partitioner.py``, copied whole: the
Java client's ``DefaultPartitioner`` routes a keyed record to
``(murmur2(keyBytes) & 0x7fffffff) % numPartitions``, and the same
``(murmur2 & 0x7fffffff) % n`` contract assigns item ids to catalog
slices (``app/als/slices.py``), so slices written by either package
hold the same items.
"""

from __future__ import annotations

__all__ = ["murmur2", "partition_for_key"]


def murmur2(data: bytes) -> int:
    """Kafka's partitioner hash (the Java client's ``Utils.murmur2``),
    returned as an unsigned 32-bit value (Java's signed int, masked)."""
    length = len(data)
    seed = 0x9747B28C
    m = 0x5BD1E995
    mask = 0xFFFFFFFF
    h = (seed ^ length) & mask
    i = 0
    for i in range(0, length - 3, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * m) & mask
        k ^= k >> 24
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
    left = length & 3
    if left:
        tail = data[length - left:]
        if left >= 3:
            h ^= tail[2] << 16
        if left >= 2:
            h ^= tail[1] << 8
        h ^= tail[0]
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def partition_for_key(key: str, num_partitions: int) -> int:
    """Partition index for a keyed record — Kafka's DefaultPartitioner
    contract, byte-for-byte (positive-masked murmur2 modulo count)."""
    return (murmur2(key.encode("utf-8")) & 0x7FFFFFFF) % num_partitions
