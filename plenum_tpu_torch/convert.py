"""Carry state across from the JAX package into the port.

The state of this system is its ledgers, and, for the limb-staged
Ed25519 dispatch, a verifier's cache of staged keys.

Ledgers: a txn log and a Merkle hash store, each a key/value store of
bytes. Both packages lay the rows out
identically (txn log: 8-byte big-endian seq_no -> msgpack txn; hash
store: `l<idx>` leaves and `n<level><idx>` interior nodes -> 32-byte
digests), so carrying a ledger across is copying its rows. The port's
Ledger recovers its tree from the copied hash store and goes on
appending from the same root.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np

from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import HashStore
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.storage.kv_memory import KvMemory

Rows = Iterable[tuple[bytes, bytes]]


def ledger_from_rows(txn_rows: Rows, hash_rows: Rows,
                     hasher: Optional[TreeHasher] = None) -> Ledger:
    """A port Ledger on copies of another ledger's rows.

    txn_rows / hash_rows are (key, value) byte pairs as a reference
    Ledger's stores yield them: `ledger.txn_log.iterator()` and
    `ledger.tree.hash_store.kv.iterator()`. `hasher` is the port's tree
    hasher for the appends that follow (hashlib when None)."""
    log = KvMemory()
    for key, value in txn_rows:
        log.put(bytes(key), bytes(value))
    kv = KvMemory()
    for key, value in hash_rows:
        kv.put(bytes(key), bytes(value))
    tree = CompactMerkleTree(hasher or TreeHasher(), HashStore(kv))
    return Ledger(tree=tree, txn_log=log)


def verifier_cache_from_reference(rows: Mapping[bytes, Optional[np.ndarray]],
                                  verifier):
    """Seed a port verifier's staged-key cache (`_pt_cache`) from a
    reference verifier's: verkey -> int32[4, 4, 20] quarter-point rows of
    -A in 13-bit limbs, or None for an invalid key. Both packages stage
    the same arrays, so the rows are copied as they are; the verifier's
    FIFO bound holds (the oldest entries go first). -> the verifier."""
    cache = verifier._pt_cache
    for vk, quarters in rows.items():
        if quarters is not None:
            quarters = np.array(quarters, dtype=np.int32)
            if quarters.shape != (4, 4, 20):
                raise ValueError(f"staged rows of {bytes(vk).hex()}: want "
                                 f"int32[4, 4, 20], got {quarters.shape}")
        cache.pop(bytes(vk), None)
        if len(cache) >= verifier._cache_size:
            cache.pop(next(iter(cache)))
        cache[bytes(vk)] = quarters
    return verifier
