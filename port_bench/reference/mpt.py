"""Root of an Ethereum-shaped Merkle Patricia trie, built from scratch.

Node shapes as in the Ethereum yellow paper, appendix D: a leaf is
[hex_prefix(rest, leaf), value], an extension [hex_prefix(path), ref],
a branch 16 refs and a value. A node is held inline in its parent where its
RLP is shorter than 32 bytes, else by the hash of it; the root is always
the hash of its RLP. The hash is SHA3-256 (hashlib), as the indy-plenum
state trie uses. The trie of a key set is unique, so this rebuild from
the pairs alone gives the root of any trie that holds exactly them.
"""
from __future__ import annotations

import hashlib


def _sha3(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


def rlp(item) -> bytes:
    """RLP of bytes or a (nested) list of bytes."""
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _length(len(item), 0x80) + item
    body = b"".join(rlp(x) for x in item)
    return _length(len(body), 0xC0) + body


def _length(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(raw)]) + raw


def _hex_prefix(nibbles, leaf: bool) -> bytes:
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        out = [((flag + 1) << 4) | nibbles[0]]
        nibbles = nibbles[1:]
    else:
        out = [flag << 4]
    out += [(nibbles[i] << 4) | nibbles[i + 1]
            for i in range(0, len(nibbles), 2)]
    return bytes(out)


def _nibbles(key: bytes) -> tuple:
    return tuple(n for b in key for n in (b >> 4, b & 15))


def _ref(node):
    """A child as its parent holds it: inline when its RLP is short."""
    enc = rlp(node)
    return node if len(enc) < 32 else _sha3(enc)


def _build(pairs: list, depth: int):
    """pairs: (nibbles, value), sorted by nibbles, all sharing
    nibbles[:depth]. -> the node over them."""
    if not pairs:
        return b""
    if len(pairs) == 1:
        key, value = pairs[0]
        return [_hex_prefix(key[depth:], True), value]
    first, last = pairs[0][0], pairs[-1][0]
    common = depth
    while (common < len(first) and common < len(last)
           and first[common] == last[common]):
        common += 1
    if common > depth:
        child = _build(pairs, common)
        return [_hex_prefix(first[depth:common], False), _ref(child)]
    branch = [b""] * 17
    rest = pairs
    if len(rest[0][0]) == depth:
        branch[16] = rest[0][1]
        rest = rest[1:]
    start = 0
    while start < len(rest):
        nib = rest[start][0][depth]
        end = start
        while end < len(rest) and rest[end][0][depth] == nib:
            end += 1
        branch[nib] = _ref(_build(rest[start:end], depth + 1))
        start = end
    return branch


def root(kv: dict) -> bytes:
    """SHA3-256 root of the trie holding exactly kv (bytes -> bytes,
    values non-empty)."""
    pairs = sorted((_nibbles(k), v) for k, v in kv.items())
    return _sha3(rlp(_build(pairs, 0)))
