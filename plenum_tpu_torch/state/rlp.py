"""Minimal RLP (recursive length prefix) codec.

Reference behavior: state/util/fast_rlp.py — the trie's node serialization.
Items are bytes or nested lists of items.
"""
from __future__ import annotations


class RlpError(ValueError):
    pass


def encode(item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    if isinstance(item, (list, tuple)):
        # trie nodes are flat lists of byte strings — inline that case
        # instead of recursing per item (hot path of every state write)
        parts = []
        for x in item:
            if isinstance(x, (bytes, bytearray)):
                b = bytes(x)
                parts.append(b if len(b) == 1 and b[0] < 0x80
                             else _len_prefix(len(b), 0x80) + b)
            else:
                parts.append(encode(x))
        payload = b"".join(parts)
        return _len_prefix(len(payload), 0xC0) + payload
    raise RlpError(f"cannot RLP-encode {type(item)}")


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    ll = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(ll)]) + ll


def decode(data: bytes):
    item, rest = _decode_one(memoryview(data))
    if rest:
        raise RlpError("trailing bytes")
    return item


def _decode_one(mv):
    if not mv:
        raise RlpError("empty input")
    b0 = mv[0]
    if b0 < 0x80:
        return bytes(mv[:1]), mv[1:]
    if b0 < 0xB8:                       # short string
        n = b0 - 0x80
        _check(mv, 1 + n)
        if n == 1 and mv[1] < 0x80:
            raise RlpError("non-canonical single byte")
        return bytes(mv[1:1 + n]), mv[1 + n:]
    if b0 < 0xC0:                       # long string
        ll = b0 - 0xB7
        _check(mv, 1 + ll)
        n = int.from_bytes(mv[1:1 + ll], "big")
        if n < 56:
            raise RlpError("non-canonical length")
        _check(mv, 1 + ll + n)
        return bytes(mv[1 + ll:1 + ll + n]), mv[1 + ll + n:]
    if b0 < 0xF8:                       # short list
        n = b0 - 0xC0
        _check(mv, 1 + n)
        return _decode_list(mv[1:1 + n]), mv[1 + n:]
    ll = b0 - 0xF7                      # long list
    _check(mv, 1 + ll)
    n = int.from_bytes(mv[1:1 + ll], "big")
    if n < 56:
        raise RlpError("non-canonical length")
    _check(mv, 1 + ll + n)
    return _decode_list(mv[1 + ll:1 + ll + n]), mv[1 + ll + n:]


def _decode_list(mv):
    out = []
    while mv:
        item, mv = _decode_one(mv)
        out.append(item)
    return out


def _check(mv, n):
    if len(mv) < n:
        raise RlpError("truncated input")
