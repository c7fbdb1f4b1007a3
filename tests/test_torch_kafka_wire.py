"""The port's Kafka wire codec (``oryx_tpu_torch/kafka/wire.py``) against
the reference's (``oryx_tpu/kafka/wire.py``), on seeded inputs.

CRC32C against the RFC 3720 vectors and the reference on 500 seeded
byte strings; ``encode_record_batch`` byte-identical to the reference's
on 200 seeded record lists (null and non-null keys and values), and
each package decodes the other's bytes.  Record headers, which the
reference's encoder does not write, are held to the v2 record layout of
the Kafka protocol guide and to the reference's decoder, which skips
them."""

from __future__ import annotations

import numpy as np
import pytest

from oryx_tpu.kafka import wire as jwire
from oryx_tpu_torch.kafka import wire as twire

# RFC 3720 B.4 CRC32C check values
_RFC3720 = [(b"", 0x00000000), (b"123456789", 0xE3069283),
            (b"\x00" * 32, 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
            (bytes(range(32)), 0x46DD794E)]


@pytest.mark.parametrize("data,want", _RFC3720)
def test_crc32c_rfc3720_vectors(data, want):
    assert twire.crc32c(data) == want == jwire.crc32c(data)


def test_crc32c_matches_the_reference_on_seeded_bytes():
    rng = np.random.default_rng(31)
    for _ in range(500):
        n = int(rng.integers(0, 2048))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert twire.crc32c(data) == jwire.crc32c(data)


def _blob(rng, max_len=64):
    if rng.random() < 0.2:
        return None
    n = int(rng.integers(0, max_len))
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _records(rng, n):
    return [(_blob(rng), _blob(rng, 400)) for _ in range(n)]


def _seeded_lists(seed=17, count=200):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        yield (int(rng.integers(0, 1 << 40)),
               _records(rng, int(rng.integers(1, 30))),
               int(rng.integers(0, 1 << 41)))


def test_record_batches_are_byte_identical_to_the_reference():
    for base, records, ts in _seeded_lists():
        got = twire.encode_record_batch(base, records, ts)
        assert got == jwire.encode_record_batch(base, records, ts)
        # the same records with an empty header list: the same bytes
        assert twire.encode_record_batch(
            base, [(k, v, []) for k, v in records], ts) == got


def test_each_package_decodes_the_others_batches():
    for base, records, ts in _seeded_lists(seed=18, count=50):
        want = [(base + j, k, v) for j, (k, v) in enumerate(records)]
        ours = twire.encode_record_batch(base, records, ts)
        theirs = jwire.encode_record_batch(base, records, ts)
        assert jwire.decode_record_batches(ours) == want
        assert twire.decode_record_batches(theirs) == want
        # concatenated batches and a truncated tail, as a broker cuts
        two = ours + twire.encode_record_batch(base + len(records),
                                               [(b"k", b"v")])
        assert twire.decode_record_batches(two) == \
            jwire.decode_record_batches(two)
        assert twire.decode_record_batches(two[:-3]) == want


def test_record_headers_follow_the_v2_layout():
    """A record's headers after its value: a varint count, then each
    header's varint key length, key, varint value length (-1 for null)
    and value (the Kafka protocol guide's v2 record)."""
    headers = [("ts", b"17"), ("speed-seq", None)]
    batch = twire.encode_record_batch(5, [(b"k", b"v", headers)])
    rec = bytearray()
    rec.append(0)                          # attributes
    rec += bytes([0, 0])                   # ts delta 0, offset delta 0
    rec += bytes([2]) + b"k" + bytes([2]) + b"v"   # zigzag(1) = 2
    rec += bytes([4])                      # two headers
    rec += bytes([4]) + b"ts" + bytes([4]) + b"17"
    rec += bytes([18]) + b"speed-seq" + bytes([1])  # zigzag(-1) = 1
    assert batch.endswith(bytes([2 * len(rec)]) + bytes(rec))
    # the CRC covers the headers
    assert int.from_bytes(batch[17:21], "big") == \
        jwire.crc32c(batch[21:])
    assert twire.decode_record_batches(batch, with_headers=True) == \
        [(5, b"k", b"v", headers)]


def test_headered_batches_decode_in_both_packages():
    rng = np.random.default_rng(19)
    for base, records, ts in _seeded_lists(seed=20, count=50):
        headered = [(k, v, [(f"h{j}", _blob(rng, 16))
                            for j in range(int(rng.integers(0, 4)))])
                    for k, v in records]
        batch = twire.encode_record_batch(base, headered, ts)
        plain = [(base + j, k, v) for j, (k, v, _) in enumerate(headered)]
        # the reference skips the headers; the port returns them
        assert jwire.decode_record_batches(batch) == plain
        assert twire.decode_record_batches(batch) == plain
        assert twire.decode_record_batches(batch, with_headers=True) == \
            [(o, k, v, h) for (o, k, v), (_, _, h) in zip(plain, headered)]


def test_varints_match_the_reference():
    values = [0, 1, -1, 63, -64, 64, 300, -300, 2 ** 31, -2 ** 31,
              2 ** 40, -(2 ** 62)]
    for v in values:
        a, b = bytearray(), bytearray()
        twire.write_varint(a, v)
        jwire.write_varint(b, v)
        assert a == b
        assert twire.read_varint(bytes(a), 0) == (v, len(a))


def test_compressed_and_control_batches_as_the_reference():
    batch = bytearray(twire.encode_record_batch(0, [(b"k", b"v")]))
    compressed = bytes(batch[:21]) + b"\x00\x01" + bytes(batch[23:])
    for wire in (twire, jwire):
        with pytest.raises(wire.KafkaProtocolError):
            wire.decode_record_batches(compressed)
    control = bytes(batch[:21]) + b"\x00\x20" + bytes(batch[23:])
    assert twire.decode_record_batches(control) == \
        jwire.decode_record_batches(control) == []
