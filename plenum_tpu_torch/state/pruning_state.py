"""State with committed/uncommitted heads over the MPT.

Reference behavior: state/pruning_state.py:14 — `set/get` act on the
uncommitted head; `commit()` promotes it; `revertToHead` rewinds to any stored
root (3PC revert path, ref ordering_service._revert:1229). Reads can target
either head (`get(..., committed=True)` reads the committed root, as request
handlers do for committed data vs dynamic validation on uncommitted).

Content-addressed trie nodes make revert O(1): both heads are just root
hashes into the same node store.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.storage.kv_store import KeyValueStorage
from plenum_tpu_torch.storage.kv_memory import KvMemory

from .trie import Trie, BLANK_ROOT


class PruningState:
    def __init__(self, db: Optional[KeyValueStorage] = None,
                 pipeline=None):
        self._db = db if db is not None else KvMemory()
        root = self._db.try_get(b"__committed_head__") or BLANK_ROOT
        # one decoded-node cache shared by the head trie AND every
        # throwaway Trie built for committed/historic reads below —
        # content-addressed nodes make sharing across roots safe
        self._node_cache: dict = {}
        self._trie = Trie(self._db, root, cache=self._node_cache)
        self._committed_root = root
        # commit-wave seam (parity with the Verkle backend's signature):
        # MPT recommits need no MSM engine, only the pipeline's "hlev"
        # hashing lane driven through `recommit_staged`
        self._pipeline = pipeline

    @property
    def kv(self) -> KeyValueStorage:
        """Backing trie-node store — exposed so the commit path can group
        trie-node writes into the per-3PC-batch atomic write."""
        return self._db

    # --- writes (uncommitted head) ----------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        self._trie.set(key, value)

    def remove(self, key: bytes) -> bool:
        return self._trie.remove(key)

    # --- reads ------------------------------------------------------------

    def get(self, key: bytes, committed: bool = True) -> Optional[bytes]:
        if committed:
            return Trie(self._db, self._committed_root,
                        cache=self._node_cache).get(key)
        return self._trie.get(key)

    def get_for_root(self, key: bytes, root_hash: bytes) -> Optional[bytes]:
        """Historic read at any stored root (ts-store reads)."""
        return Trie(self._db, root_hash, cache=self._node_cache).get(key)

    def as_dict(self, committed: bool = False) -> dict:
        trie = Trie(self._db, self._committed_root,
                    cache=self._node_cache) if committed else self._trie
        return trie.to_dict()

    # --- heads ------------------------------------------------------------

    @property
    def head_hash(self) -> bytes:
        return self._trie.root_hash

    @property
    def committed_head_hash(self) -> bytes:
        return self._committed_root

    def recommit_staged(self):
        """Commit-wave family (parallel/commit_wave.py): resolve the
        uncommitted head by staging one ("hlev", "sha3", <level>) cmt
        job per dirty trie level instead of hashing inline — yields
        lists of cmt jobs, receives the aligned result lists back, and
        returns the new head hash via StopIteration.value.
        Byte-identical to `head_hash` (golden-vector pinned)."""
        gen = self._trie.resolve_root_staged()
        try:
            msgs = next(gen)
            while True:
                res = yield [("hlev", "sha3", tuple(msgs))]
                msgs = gen.send(list(res[0]))
        except StopIteration as e:
            return e.value

    def commit(self, root_hash: Optional[bytes] = None) -> None:
        """Promote the committed pointer to the given root (default: head).

        Deliberately does NOT touch the uncommitted head: with pipelined 3PC
        batches, later batches are already applied on top of the one being
        committed (ref pruning_state.py:87 — committing an earlier root while
        the head advances is the normal case, rewinding here would silently
        drop the in-flight batches' writes).
        """
        target = root_hash if root_hash is not None else self._trie.root_hash
        self._committed_root = target
        self._db.put(b"__committed_head__", target)

    def revert_to_head(self, root_hash: Optional[bytes] = None) -> None:
        """Rewind the uncommitted head (default: back to committed)."""
        target = root_hash if root_hash is not None else self._committed_root
        self._trie.root_hash = target

    # --- proofs (ref pruning_state.py:105-123) ----------------------------

    def generate_state_proof(self, key: bytes, root_hash: Optional[bytes] = None,
                             serialize: bool = False):
        trie = Trie(self._db, root_hash if root_hash is not None
                    else self._committed_root, cache=self._node_cache)
        proof = trie.produce_proof(key)
        if serialize:
            from . import rlp
            return rlp.encode(proof)
        return proof

    @staticmethod
    def verify_state_proof(root_hash: bytes, key: bytes, value: Optional[bytes],
                           proof) -> bool:
        """Check that `key` maps to `value` (None = absent) under root_hash.
        Fails CLOSED: undecodable proof bytes are False, never a raise
        (the StateCommitment verifier contract both backends pin)."""
        from . import rlp as _rlp
        try:
            if isinstance(proof, (bytes, bytearray)):
                proof = _rlp.decode(bytes(proof))
            present, got = Trie.verify_proof(root_hash, key, list(proof))
        except Exception:
            return False
        if value is None:
            return not present
        return present and got == value

    def close(self) -> None:
        self._db.close()
