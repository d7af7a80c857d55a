"""Append-only transaction ledger: KV txn log + compact Merkle tree.

Reference behavior: ledger/ledger.py:17 — txns keyed by 1-based seq_no in a KV
log, every append updates the Merkle tree and returns merkle info (root + audit
path); supports an uncommitted staging area (appendTxns → commitTxns /
discardTxns) used by 3PC dynamic validation, genesis loading, and recovery from
the hash store with txn-log replay as fallback (ledger.py:70-113).

Device angle: `append_txns_to_uncommitted` stages and `commit_txns` extends
the tree with ALL the batch's leaves through the hasher's batch API — with
the cuda backend the leaf hashes are one kernel launch per SHA-256 block
count and an append wave's interior levels one fused launch (ops/sha256.py
`merkle_wave`; a wave past its width goes level by level). Staged with
defer_hash=True, the leaves wait for the commit wave
(parallel/commit_wave.py), which hashes every co-hosted replica's
identical leaves once.
"""
from __future__ import annotations

from typing import Optional, Sequence

from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.storage.kv_store import KeyValueStorage
from plenum_tpu_torch.storage.kv_memory import KvMemory

from .compact_merkle_tree import CompactMerkleTree


def txn_to_leaf(txn: dict) -> bytes:
    return pack(txn)


class Ledger:
    def __init__(self,
                 tree: Optional[CompactMerkleTree] = None,
                 txn_log: Optional[KeyValueStorage] = None,
                 genesis_txns: Sequence[dict] = ()):
        self.tree = tree or CompactMerkleTree()
        self.hasher = self.tree.hasher
        self._log = txn_log if txn_log is not None else KvMemory()
        self.seq_no = 0                      # last committed seq_no (1-based)
        self._uncommitted: list[dict] = []   # staged txns
        self._uncommitted_tree: Optional[CompactMerkleTree] = None
        # txns staged with defer_hash=True: in _uncommitted (and the
        # shadow's root once hashed) but NOT yet extended into the
        # shadow tree — the commit wave hashes their leaves in one
        # fused dispatch (uncommitted_root_staged); the host path folds
        # them in lazily, so both paths stay byte-identical
        self._shadow_pending: list[dict] = []
        self.recover()
        if self.size == 0 and genesis_txns:
            for txn in genesis_txns:
                self.append(txn)

    # --- recovery (ref ledger.py:70-113) ----------------------------------

    def recover(self) -> None:
        log_size = self._log.size
        self.seq_no = log_size
        # First sync the tree with its own hash store: a fresh CompactMerkleTree
        # handed a persisted store must pick up the stored leaves (callers need
        # not remember CompactMerkleTree.recover()).
        hs_count = self.tree.hash_store.leaf_count
        if self.tree.tree_size < hs_count:
            self.tree = CompactMerkleTree.recover(self.hasher, self.tree.hash_store)
        if self.tree.tree_size == log_size:
            return
        if self.tree.tree_size == self.tree.hash_store.leaf_count and \
                self.tree.tree_size < log_size:
            # hash store lags the log: replay the missing tail
            missing = [self.get_by_seq_no(i)
                       for i in range(self.tree.tree_size + 1, log_size + 1)]
            self.tree.extend_batch([txn_to_leaf(t) for t in missing])
            return
        if self.tree.tree_size > log_size:
            # hash store ahead of (or inconsistent with) the log: rebuild
            self.tree.hash_store.reset()
            self.tree = CompactMerkleTree(self.hasher, self.tree.hash_store)
            all_txns = [self.get_by_seq_no(i) for i in range(1, log_size + 1)]
            self.tree.extend_batch([txn_to_leaf(t) for t in all_txns])

    # --- committed appends ------------------------------------------------

    def append(self, txn: dict) -> dict:
        """Append one committed txn; returns merkle info for the REPLY."""
        return self.append_batch([txn])[0]

    def append_batch(self, txns: Sequence[dict]) -> list[dict]:
        leaves = [txn_to_leaf(t) for t in txns]
        start = self.seq_no
        # one atomic KV batch for the txn-log rows and one for the Merkle
        # hash-store rows (leaves + interior nodes), instead of a flushed
        # append per row — with a durable backend this is the difference
        # between 2 fsync-ish flushes and ~3n per committed batch
        self._log.do_ops_in_batch(
            [("put", start + 1 + i, leaf) for i, leaf in enumerate(leaves)])
        with self.tree.hash_store.kv.write_batch():
            self.tree.extend_batch(leaves)
        self.seq_no += len(txns)
        # merkle_info for each txn, the audit paths built in one pass from
        # the wave this extend just computed
        root, size = self.root_hash.hex(), self.tree.tree_size
        return [{"seqNo": start + 1 + i,
                 "rootHash": root,
                 "auditPath": [h.hex() for h in path],
                 "treeSize": size}
                for i, path in enumerate(
                    self.tree.inclusion_proofs(start, start + len(txns)))]

    @property
    def txn_log(self) -> KeyValueStorage:
        """Backing txn-log store — exposed for the commit path's group
        flush (DatabaseManager.group_commit)."""
        return self._log

    # --- uncommitted staging (ref appendTxns/commitTxns/discardTxns) ------

    def append_txns_to_uncommitted(self, txns: Sequence[dict],
                                   defer_hash: bool = False):
        """Stage txns; returns (uncommitted_root, uncommitted_size).
        With defer_hash=True the leaf hashing is left for the commit
        wave (`uncommitted_root_staged`) — no root is computed here and
        None is returned in its place; reading `uncommitted_root_hash`
        before the wave drains folds the pending leaves in on host, so
        the deferral can never be observed as a different root."""
        if defer_hash:
            self._uncommitted.extend(txns)
            if self._uncommitted_tree is not None:
                self._shadow_pending.extend(txns)
            return None, self.uncommitted_size
        if self._uncommitted_tree is not None:
            self._fold_shadow_pending()
            # shadow exists: extend incrementally instead of rebuilding
            self._uncommitted_tree.extend_batch([txn_to_leaf(t) for t in txns])
        self._uncommitted.extend(txns)
        return self.uncommitted_root_hash, self.uncommitted_size

    def _fold_shadow_pending(self) -> None:
        """Host-side catch-up for leaves staged with defer_hash=True:
        extend the shadow with anything the commit wave has not hashed
        yet (the wave's degrade-to-host path, and any host read that
        races a staged-but-undrained wave)."""
        if self._shadow_pending and self._uncommitted_tree is not None:
            pending, self._shadow_pending = self._shadow_pending, []
            self._uncommitted_tree.extend_batch(
                [txn_to_leaf(t) for t in pending])

    def commit_txns(self, count: int) -> tuple[list[dict], list[dict]]:
        """Commit the first `count` staged txns; returns (txns, merkle_infos)."""
        if count > len(self._uncommitted):
            raise ValueError(f"commit {count} > {len(self._uncommitted)} staged")
        txns = self._uncommitted[:count]
        self._uncommitted = self._uncommitted[count:]
        self._uncommitted_tree = None
        self._shadow_pending = []
        infos = self.append_batch(txns)
        return txns, infos

    def discard_txns(self, count: int) -> None:
        """Drop the LAST `count` staged txns (revert on 3PC reject)."""
        if count > len(self._uncommitted):
            raise ValueError(f"discard {count} > {len(self._uncommitted)} staged")
        if count:
            self._uncommitted = self._uncommitted[:-count]
            self._uncommitted_tree = None
            self._shadow_pending = []

    def reset_uncommitted(self) -> None:
        self._uncommitted = []
        self._uncommitted_tree = None
        self._shadow_pending = []

    @property
    def uncommitted_size(self) -> int:
        """TOTAL size including staged txns (committed size + staged count)."""
        return self.seq_no + len(self._uncommitted)

    @property
    def uncommitted_txns(self) -> list[dict]:
        return list(self._uncommitted)

    @property
    def uncommitted_root_hash(self) -> bytes:
        if not self._uncommitted:
            return self.root_hash
        if self._uncommitted_tree is None:
            shadow = self.tree.fork()
            shadow.extend_batch([txn_to_leaf(t) for t in self._uncommitted])
            self._uncommitted_tree = shadow
            self._shadow_pending = []
        else:
            self._fold_shadow_pending()
        return self._uncommitted_tree.root_hash

    def uncommitted_root_staged(self):
        """Commit-wave family (parallel/commit_wave.py): the staged twin
        of `uncommitted_root_hash` for leaves staged with
        defer_hash=True. Yields ONE ("hlev", "sha256", <leaf preimages>)
        cmt job — every pending txn's domain-prefixed leaf bytes —
        receives the leaf digests back, extends the shadow through the
        precomputed-hash entry point (`_extend_hashes`, whose interior
        sweep rides the fused merkle kernel when the tree's hasher is
        device-backed), and returns the uncommitted root."""
        if not self._uncommitted:
            return self.root_hash
        shadow = self._uncommitted_tree
        pending = self._shadow_pending if shadow is not None \
            else list(self._uncommitted)
        if shadow is None:
            shadow = self.tree.fork()
        if pending:
            res = yield [("hlev", "sha256",
                          tuple(b"\x00" + txn_to_leaf(t) for t in pending))]
            shadow._extend_hashes(list(res[0]))
        self._uncommitted_tree = shadow
        self._shadow_pending = []
        return shadow.root_hash

    # --- reads ------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.seq_no

    @property
    def root_hash(self) -> bytes:
        return self.tree.root_hash

    def get_by_seq_no(self, seq_no: int) -> dict:
        if not (1 <= seq_no <= self.seq_no):
            raise KeyError(seq_no)
        return unpack(self._log.get(seq_no))

    def get_all_txns(self, start: int = 1, end: Optional[int] = None):
        end = self.seq_no if end is None else min(end, self.seq_no)
        for i in range(start, end + 1):
            yield i, self.get_by_seq_no(i)

    def merkle_info(self, seq_no: int) -> dict:
        """Root + audit path for the txn at seq_no, as wire-friendly hex."""
        path = self.tree.inclusion_proof(seq_no - 1)
        return {"seqNo": seq_no,
                "rootHash": self.root_hash.hex(),
                "auditPath": [h.hex() for h in path],
                "treeSize": self.tree.tree_size}

    def consistency_proof(self, old_size: int, new_size: Optional[int] = None) -> list[str]:
        return [h.hex() for h in self.tree.consistency_proof(
            old_size, new_size if new_size is not None else self.tree.tree_size)]

    def close(self) -> None:
        self._log.close()
        self.tree.hash_store.close()
