"""HPACK (RFC 7541) header compression, the subset HTTP/2 requires.

Counterpart of ``oryx_tpu/lambda_rt/hpack.py``, whole: the encoder emits
the reference's bytes for every header list.

Reference parity target: the serving connector speaks HTTP/2 when TLS
is configured (ServingLayer.java:202-255 adds an Http2Protocol to the
Tomcat connector); this codec plus lambda_rt/http2.py is this
package's stdlib-only equivalent.

Decoding implements the full wire format — indexed fields, all three
literal forms, dynamic-table size updates, static + dynamic tables, and
Huffman-coded string literals (clients Huffman-encode aggressively).
Encoding stays deliberately simple: exact static-table matches are
indexed, everything else is a literal without indexing, never
Huffman-coded — always legal, and responses are small.

The Huffman code table is transcribed from RFC 7541 Appendix B and
validated in tests against the RFC's own Appendix C vectors plus a
prefix-freeness/round-trip property check and live curl (nghttp2)
interop.
"""

from __future__ import annotations

__all__ = ["HpackDecoder", "HpackEncoder", "huffman_decode",
           "huffman_encode", "HpackError"]


class HpackError(Exception):
    pass


# (code, bit_length) per symbol 0..256 — RFC 7541 Appendix B
HUFFMAN_TABLE = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
]

# prefix-tree decoder built once: {(code_so_far, nbits) -> symbol} would
# be slow; a nested dict keyed bit by bit is simple and fast enough for
# header-sized strings
_DECODE_ROOT: dict = {}


def _build_decode_tree() -> None:
    for sym, (code, nbits) in enumerate(HUFFMAN_TABLE):
        node = _DECODE_ROOT
        for i in range(nbits - 1, -1, -1):
            bit = (code >> i) & 1
            if i == 0:
                if bit in node:
                    raise HpackError("huffman table not prefix-free")
                node[bit] = sym
            else:
                nxt = node.get(bit)
                if nxt is None:
                    nxt = node[bit] = {}
                elif not isinstance(nxt, dict):
                    raise HpackError("huffman table not prefix-free")
                node = nxt


_build_decode_tree()


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _DECODE_ROOT
    depth = 0
    path = 0  # bits walked since the last emitted symbol
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            nxt = node[bit] if bit in node else None
            if nxt is None:
                raise HpackError("invalid huffman code")
            if isinstance(nxt, dict):
                node = nxt
                depth += 1
                path = (path << 1) | bit
            else:
                if nxt == 256:
                    raise HpackError("EOS symbol inside huffman string")
                out.append(nxt)
                node = _DECODE_ROOT
                depth = 0
                path = 0
    # RFC 7541 §5.2: trailing bits MUST be the EOS prefix — at most 7
    # bits, all ones (plenty of codes start with 0-bits, so an unchecked
    # zero-padded tail would walk a valid path and be silently accepted)
    if depth > 7:
        raise HpackError("huffman padding longer than 7 bits")
    if path != (1 << depth) - 1:
        raise HpackError("huffman padding is not the EOS prefix")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    """Huffman-encode (used by tests for round-trip validation and by
    clients in the wild; the server's encoder emits plain literals)."""
    acc = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code, n = HUFFMAN_TABLE[byte]
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


# RFC 7541 Appendix A — the static table, 1-indexed
STATIC_TABLE = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
]

_STATIC_EXACT = {pair: i + 1 for i, pair in enumerate(STATIC_TABLE)
                 if pair[1] != "" or pair[0] in (":authority",)}


def _decode_int(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    """RFC 7541 §5.1 prefix integer; returns (value, next_pos)."""
    mask = (1 << prefix_bits) - 1
    value = data[pos] & mask
    pos += 1
    if value < mask:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer too large")
        if not b & 0x80:
            return value, pos


def _encode_int(value: int, prefix_bits: int, first_byte_bits: int) -> bytes:
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([first_byte_bits | value])
    out = bytearray([first_byte_bits | mask])
    value -= mask
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


class HpackDecoder:
    """Connection-scoped decoder: one dynamic table, blocks decoded in
    receipt order (RFC 7541 §2.3.2 — the table is connection state)."""

    def __init__(self, max_table_size: int = 4096):
        self._dynamic: list[tuple[str, str]] = []
        self._dyn_size = 0
        self._max_size = max_table_size
        self._settings_cap = max_table_size

    def _entry(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if d >= len(self._dynamic):
            raise HpackError(f"index {index} beyond tables")
        return self._dynamic[d]

    def _add(self, name: str, value: str) -> None:
        size = len(name.encode()) + len(value.encode()) + 32
        self._dynamic.insert(0, (name, value))
        self._dyn_size += size
        while self._dyn_size > self._max_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._dyn_size -= len(n.encode()) + len(v.encode()) + 32

    def _resize(self, new_max: int) -> None:
        if new_max > self._settings_cap:
            raise HpackError("table size update above SETTINGS cap")
        self._max_size = new_max
        while self._dyn_size > self._max_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._dyn_size -= len(n.encode()) + len(v.encode()) + 32

    def _string(self, data: bytes, pos: int) -> tuple[str, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huff = bool(data[pos] & 0x80)
        length, pos = _decode_int(data, pos, 7)
        if pos + length > len(data):
            raise HpackError("string runs past block")
        raw = data[pos:pos + length]
        pos += length
        if huff:
            raw = huffman_decode(raw)
        return raw.decode("utf-8", "replace"), pos

    def decode(self, block: bytes,
               max_headers: int | None = None) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        pos = 0
        while pos < len(block):
            if max_headers is not None and len(out) >= max_headers:
                # indexed references amplify ~4 KB of table entry per
                # single input byte; a count bound caps the blow-up
                raise HpackError("too many headers in block")
            b = block[pos]
            if b & 0x80:  # indexed
                index, pos = _decode_int(block, pos, 7)
                out.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = _decode_int(block, pos, 6)
                name = self._entry(index)[0] if index \
                    else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                new_max, pos = _decode_int(block, pos, 5)
                self._resize(new_max)
            else:  # literal without indexing (0000) / never indexed (0001)
                index, pos = _decode_int(block, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                out.append((name, value))
        return out


class HpackEncoder:
    """Minimal conformant encoder: indexed static exact matches, plain
    literals without indexing otherwise (no dynamic table, no Huffman —
    always legal, and the peer needs no state about us)."""

    def encode(self, headers: list[tuple[str, str]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = _STATIC_EXACT.get((name, value))
            if idx is not None:
                out += _encode_int(idx, 7, 0x80)
                continue
            name_idx = next((i + 1 for i, (n, _) in enumerate(STATIC_TABLE)
                             if n == name), 0)
            if name_idx:
                out += _encode_int(name_idx, 4, 0x00)
            else:
                out += b"\x00"
                nb = name.encode()
                out += _encode_int(len(nb), 7, 0x00) + nb
            vb = value.encode()
            out += _encode_int(len(vb), 7, 0x00) + vb
        return bytes(out)
