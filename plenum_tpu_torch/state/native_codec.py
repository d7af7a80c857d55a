"""Native (C++) codec for the trie's per-node encode+hash.

Every trie store/commit pays `rlp.encode(node)` + `sha3_256` per
modified node (plenum_tpu_torch/state/trie.py:_store, root_hash). The
in-tree C++ codec (native/mptcodec.cpp) does both in one call for FLAT
nodes (every item a byte string — the common shape once children are
hashed refs); nodes with embedded (nested-list) children fall back to
the pure-Python twin, which stays authoritative for differential tests.
Gracefully absent when the toolchain is unavailable.

Integration status: per-node ctypes dispatch measured ~2x SLOWER than
the pure-Python path (round 4, tests/test_native_mptcodec.py), so
`encode_hash_flat` is deliberately NOT called by the production trie.
The production entry point is `encode_hash_many` below — one native
call per commit batch over all dirty nodes, where the ctypes overhead
amortizes across the batch (round-5 wiring; see trie.commit).
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from plenum_tpu_torch.native import _build
    lib = _build("mptcodec.cpp", "mptcodec")
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mptc_sha3_256.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p]
    lib.mptc_sha3_256.restype = None
    lib.mptc_encode_hash.argtypes = [ctypes.c_int32, u32p, ctypes.c_char_p,
                                     u8p, ctypes.c_uint64, u8p]
    lib.mptc_encode_hash.restype = ctypes.c_long
    lib.mptc_rlp_encode.argtypes = [ctypes.c_int32, u32p, ctypes.c_char_p,
                                    u8p, ctypes.c_uint64]
    lib.mptc_rlp_encode.restype = ctypes.c_long
    # packed-bytes inputs (struct.pack) + writable buffers out
    lib.mptc_encode_hash_batch.argtypes = [
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.mptc_encode_hash_batch.restype = ctypes.c_long
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def encode_hash_flat(node: list) -> Optional[tuple[bytes, bytes]]:
    """Flat list-of-bytes node -> (rlp, sha3) via C++, or None when the
    node has nested children / the native lib is absent (caller falls
    back to the Python twin)."""
    lib = _load()
    if lib is None:
        return None
    lens = []
    for item in node:
        if type(item) is not bytes:
            return None                  # embedded child or non-bytes
        if len(item) > 0xFFFFFFFF:
            return None                  # would truncate in the u32 ABI
        lens.append(len(item))
    n = len(node)
    concat = b"".join(node)
    cap = len(concat) + 9 * (n + 1) + 32
    out = (ctypes.c_uint8 * cap)()
    digest = (ctypes.c_uint8 * 32)()
    lens_arr = (ctypes.c_uint32 * n)(*lens)
    got = lib.mptc_encode_hash(n, lens_arr, concat, out, cap, digest)
    if got < 0:                          # cannot happen with cap above
        return None
    return bytes(out[:got]), bytes(digest)


def encode_hash_batch(counts: list, tags: list,
                      chunks: list) -> Optional[list]:
    """Batch RLP-encode + SHA3 a commit's whole dirty-node set in ONE
    native call (mptc_encode_hash_batch) — the production trie path
    (trie._resolve_dirty).

    Nodes are described in POST-ORDER (children before parents):
      counts[i]  item count of node i
      tags       per item: -1 literal byte string, -2 pre-encoded RLP
                 spliced raw (clean inline child), j>=0 backref to node
                 j's ref (its RLP if <32 bytes, else its hash) —
                 resolved inside the native call
      chunks     the data for tag<0 items, in item order
    Returns [(rlp, sha3_32), ...] aligned with counts, or None when the
    native lib is absent / a chunk exceeds the u32 ABI (caller runs the
    pure-Python twin). Inputs are packed with struct (C speed) — the
    per-element ctypes conversion measured slower than the pure-Python
    encode it was replacing."""
    lib = _load()
    if lib is None or not counts:
        return None
    lens = list(map(len, chunks))
    concat = b"".join(chunks)
    if lens and max(lens) > 0xFFFFFFFF:
        return None
    n = len(counts)
    n_backref = len(tags) - len(chunks)
    cap = len(concat) + 9 * len(chunks) + 33 * n_backref + 18 * n
    out = ctypes.create_string_buffer(cap)
    out_lens = (ctypes.c_uint32 * n)()
    out_hashes = ctypes.create_string_buffer(32 * n)
    got = lib.mptc_encode_hash_batch(
        n, struct.pack(f"<{n}i", *counts),
        struct.pack(f"<{len(tags)}i", *tags),
        struct.pack(f"<{len(lens)}I", *lens),
        concat, out, cap, out_lens, out_hashes)
    if got < 0:                          # cannot happen with cap above
        return None
    raw = out.raw
    hashes = out_hashes.raw
    res = []
    off = 0
    for i in range(n):
        ln = out_lens[i]
        res.append((raw[off:off + ln], hashes[32 * i:32 * i + 32]))
        off += ln
    return res


def encode_hash_many(prepared: list) -> Optional[list]:
    """(tag, data) item-list adapter over encode_hash_batch — the
    differential-test surface; the trie builds the flat arrays
    directly."""
    counts, tags, chunks = [], [], []
    for items in prepared:
        counts.append(len(items))
        for tag, data in items:
            tags.append(tag)
            if tag < 0:
                chunks.append(data)
    return encode_hash_batch(counts, tags, chunks)


def sha3_native(data: bytes) -> Optional[bytes]:
    """Differential-test surface for the in-tree SHA3-256."""
    lib = _load()
    if lib is None:
        return None
    digest = (ctypes.c_uint8 * 32)()
    lib.mptc_sha3_256(data, len(data), digest)
    return bytes(digest)
