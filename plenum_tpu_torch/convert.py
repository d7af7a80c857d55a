"""Carry state across from the JAX package into the port.

The state of this system is a replica's stores (its ledgers, states and
BLS store) and, for the limb-staged Ed25519 dispatch, a verifier's cache
of staged keys.

Ledgers: a txn log and a Merkle hash store, each a key/value store of
bytes. Both packages lay the rows out
identically (txn log: 8-byte big-endian seq_no -> msgpack txn; hash
store: `l<idx>` leaves and `n<level><idx>` interior nodes -> 32-byte
digests), so carrying a ledger across is copying its rows. The port's
Ledger recovers its tree from the copied hash store and goes on
appending from the same root.

A replica: every store `NodeBootstrap` opens is a key/value store of
bytes under a label (`domain_log`, `domain_hashes`, `domain_state`,
`bls_store`, ...), laid out identically by both packages. On disk the
two share the `KvFile`/`KvNative` formats, so a port `NodeBootstrap(
data_dir=...)` reopens a reference replica's directory as it is. In
memory, `replica_rows` reads each store's rows from a replica's
components and `bootstrap_from_rows` builds a port replica on copies of
them: it resumes from the same roots and goes on applying batches.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID,
                                                   POOL_LEDGER_ID)
from plenum_tpu_torch.execution.database_manager import (
    BLS_STORE_LABEL, NODE_STATUS_DB_LABEL, SEQ_NO_DB_LABEL, TS_STORE_LABEL)
from plenum_tpu_torch.execution.handlers.attrib import ATTRIB_STORE_LABEL
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import HashStore
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.storage.kv_memory import KvMemory

Rows = Iterable[tuple[bytes, bytes]]

# NodeBootstrap's ledger labels, in its build order (node/bootstrap.py)
_LEDGER_LABELS = ((AUDIT_LEDGER_ID, "audit"), (POOL_LEDGER_ID, "pool"),
                  (CONFIG_LEDGER_ID, "config"), (DOMAIN_LEDGER_ID, "domain"))
# its other stores: database-manager label -> NodeBootstrap's _kv label
_STORE_LABELS = ((TS_STORE_LABEL, "ts_store"),
                 (SEQ_NO_DB_LABEL, "seq_no_db"),
                 (NODE_STATUS_DB_LABEL, "node_status_db"),
                 (BLS_STORE_LABEL, "bls_store"),
                 (ATTRIB_STORE_LABEL, "attrib_db"))


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


def replica_rows(components) -> dict[str, list[tuple[bytes, bytes]]]:
    """Every store of a replica as plain (key, value) bytes, under the
    label NodeBootstrap opens it by. `components` is either package's
    `NodeComponents` from an in-memory (data_dir=None) bootstrap; only
    their common attributes are read, so the reference needs no import.
    Staged, uncommitted batches are not carried: call it between
    batches."""
    db = components.db

    def rows(kv):
        return [(bytes(k), bytes(v)) for k, v in kv.iterator()]

    out: dict[str, list[tuple[bytes, bytes]]] = {}
    for lid, label in _LEDGER_LABELS:
        ledger = db.get_ledger(lid)
        out[f"{label}_log"] = rows(ledger.txn_log)
        out[f"{label}_hashes"] = rows(ledger.tree.hash_store.kv)
        state = db.get_state(lid)
        if state is not None:
            out[f"{label}_state"] = rows(state.kv)
    for db_label, label in _STORE_LABELS:
        store = db.get_store(db_label)
        if store is not None:
            out[label] = rows(getattr(store, "kv", store))
    return out


def bootstrap_from_rows(name: str, rows: Mapping[str, Rows], **kwargs):
    """A port `NodeBootstrap` whose in-memory stores start as copies of
    `rows` (`replica_rows` of a reference or port replica); every other
    argument is NodeBootstrap's. Its `build()` recovers each ledger's
    tree from the copied hash store and skips the genesis replay (the
    copied state is already built), so the replica resumes with the
    source's roots."""
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    if kwargs.get("data_dir") is not None:
        raise ValueError("bootstrap_from_rows builds in-memory stores: "
                         "reopen a data_dir with NodeBootstrap itself")

    class _FromRows(NodeBootstrap):
        def _kv(self, label: str):
            kv = KvMemory()
            for key, value in rows.get(label, ()):
                kv.put(bytes(key), bytes(value))
            return kv

    return _FromRows(name, **kwargs)
