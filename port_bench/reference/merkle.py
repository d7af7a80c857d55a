"""RFC 6962 section 2.1 Merkle tree hash with hashlib.

MTH({}) = SHA-256(), a leaf hashes as SHA-256(0x00 || d) and an
interior node as SHA-256(0x01 || left || right), the left subtree
holding the largest power of two below n leaves.
"""
from __future__ import annotations

import hashlib


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + leaf).digest()


def _node(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _mth(hashes: list[bytes]) -> bytes:
    n = len(hashes)
    if n == 1:
        return hashes[0]
    k = 1 << ((n - 1).bit_length() - 1)
    return _node(_mth(hashes[:k]), _mth(hashes[k:]))


def root(leaves) -> bytes:
    """The Merkle tree hash of the leaves, in order."""
    hashes = [leaf_hash(bytes(x)) for x in leaves]
    if not hashes:
        return hashlib.sha256(b"").digest()
    return _mth(hashes)
