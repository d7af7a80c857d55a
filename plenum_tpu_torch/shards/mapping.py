"""The mapping ledger: shard id -> key range, node set, BLS key set.

The sharding plane's single source of truth is itself a normal
BLS-anchored ledger — a compact Merkle tree whose leaves are canonical
shard-descriptor serializations, whose root is multi-signed by a small
DIRECTORY committee with exactly the `MultiSignature` machinery the
consensus anchors already use. That makes the map *provable*: a node
answering a cross-shard read attaches an **ownership proof** — the
descriptor covering the key, its RFC-6962 inclusion proof at the signed
tree size, and the directory multi-sig — and a client that has never
spoken to the mapping service can still check, from its directory trust
root alone, that the answering shard owns the key.

Partitioning is static key-range over the uniformized keyspace: a
routing key (the request's target DID) is hashed once and the shard
ranges partition the sha256 hex space [00.. , ff..] — uniform placement
with no hot-prefix pathology, and the client can re-derive the hash from
its OWN request, so a lying node cannot substitute a different key.

Fail-closed rules (`verify_ownership` never raises, never returns True
for anything malformed):

- the descriptor's range must CONTAIN the client-derived key hash —
  a valid proof for the wrong shard is a wrong-shard answer, not a proof;
- the descriptor leaf must verify against the root NAMED IN THE SIGNED
  VALUE (a prover-supplied root field would be forgeable);
- the directory multi-sig must verify (distinct participants, known
  keys, n-f quorum, pairing — `MultiSignature.verify`);
- the multi-sig timestamp must be inside the freshness bound;
- the descriptor epoch must be >= the verifier's epoch watermark —
  after a resharding, proofs minted under the superseded map are STALE
  and rejected even though their inclusion + signature still check out.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Mapping, Optional, Sequence

from plenum_tpu_torch.common.serialization import signing_serialize
from plenum_tpu_torch.crypto.multi_signature import (MultiSignature,
                                               MultiSignatureValue)
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier

# a ledger id outside VALID_LEDGER_IDS: the mapping ledger is the
# sharding plane's OWN ledger, never addressable by pool client queries
MAPPING_LEDGER_ID = 100

SHARD_PROOF = "shard_proof"

# mapping proofs anchor a topology, not a txn stream: the directory
# re-signs on every epoch change and sims run minutes, so the default
# bound only needs to exceed the slowest re-publication cadence
DEFAULT_MAP_FRESHNESS_S = 3600.0


def routing_key(operation: Mapping, identifier: Optional[str] = None) -> bytes:
    """The byte key a request routes (and proves ownership) by: the
    target DID. Falls back to the author identifier for operations that
    name no dest (they still need SOME deterministic placement)."""
    dest = operation.get("dest") if isinstance(operation, Mapping) else None
    if isinstance(dest, str) and dest:
        return dest.encode()
    if identifier:
        return identifier.encode()
    raise ValueError("operation has no routable key")


def key_point(key: bytes) -> str:
    """Uniformized position of a key in the partitioned space."""
    return hashlib.sha256(key).hexdigest()


class ShardDescriptor:
    """One shard's row in the mapping ledger."""

    __slots__ = ("shard_id", "lo", "hi", "nodes", "bls_keys", "epoch")

    def __init__(self, shard_id: int, lo: str, hi: Optional[str],
                 nodes: Sequence[str], bls_keys: Mapping[str, str],
                 epoch: int = 0):
        self.shard_id = int(shard_id)
        self.lo = str(lo)
        self.hi = str(hi) if hi is not None else None   # None = top of space
        self.nodes = tuple(nodes)
        self.bls_keys = dict(bls_keys)
        self.epoch = int(epoch)

    def owns_point(self, point: str) -> bool:
        return self.lo <= point and (self.hi is None or point < self.hi)

    def owns(self, key: bytes) -> bool:
        return self.owns_point(key_point(key))

    def to_dict(self) -> dict:
        return {"shard_id": self.shard_id, "lo": self.lo, "hi": self.hi,
                "nodes": list(self.nodes), "bls_keys": dict(self.bls_keys),
                "epoch": self.epoch}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ShardDescriptor":
        return cls(d["shard_id"], d["lo"], d.get("hi"), d["nodes"],
                   d["bls_keys"], d.get("epoch", 0))

    def leaf_bytes(self) -> bytes:
        """Canonical serialization (sorted keys) — the Merkle leaf."""
        return signing_serialize(self.to_dict())


def equal_ranges(n_shards: int) -> list[tuple[str, Optional[str]]]:
    """n equal slices of the sha256 hex space, [lo, hi) with the last
    hi = None (top). Bounds are full-width hex strings so plain string
    comparison IS numeric comparison."""
    assert n_shards >= 1
    width = 1 << 64
    bounds = [(i * width) // n_shards for i in range(n_shards + 1)]
    out: list[tuple[str, Optional[str]]] = []
    for i in range(n_shards):
        lo = f"{bounds[i]:016x}" + "0" * 48
        hi = None if i == n_shards - 1 else f"{bounds[i + 1]:016x}" + "0" * 48
        out.append((lo if i else "0" * 64, hi))
    return out


def range_midpoint(lo: str, hi: Optional[str]) -> str:
    """The split point of [lo, hi): the numeric midpoint as a full-width
    hex string (hi=None means the top of the sha256 space)."""
    lo_i = int(lo, 16)
    hi_i = (1 << 256) if hi is None else int(hi, 16)
    assert hi_i > lo_i + 1, "range too narrow to split"
    return f"{(lo_i + hi_i) // 2:064x}"


def ranges_adjacent(a: ShardDescriptor, b: ShardDescriptor) -> bool:
    """True when a's range ends exactly where b's begins."""
    return a.hi is not None and a.hi == b.lo


class MappingLedger:
    """Directory-side: holds descriptors, anchors each epoch's tree.

    `signers` are the directory committee's BLS signers (name -> signer);
    their verkeys are the client trust root. Publishing is explicit
    (`publish`) so tests can interleave edits and staleness windows;
    `reshard` bumps the epoch and republishes in one step.
    """

    def __init__(self, descriptors: Sequence[ShardDescriptor],
                 signers: Mapping[str, "object"],
                 now: Optional[Callable[[], float]] = None):
        import time as _time
        self.descriptors = list(descriptors)
        self.signers = dict(signers)
        self.now = now or _time.time
        self.epoch = max((d.epoch for d in self.descriptors), default=0)
        self._tree: Optional[CompactMerkleTree] = None
        self._ms: Optional[MultiSignature] = None
        self.publish()

    @property
    def directory_keys(self) -> dict:
        return {name: signer.pk for name, signer in self.signers.items()}

    @property
    def root_hex(self) -> str:
        return self._tree.root_hash.hex()

    def publish(self) -> MultiSignature:
        """(Re)build the descriptor tree and multi-sign its root."""
        tree = CompactMerkleTree()
        for d in self.descriptors:
            tree.append(d.leaf_bytes())
        self._tree = tree
        root_hex = self.root_hex
        value = MultiSignatureValue(
            ledger_id=MAPPING_LEDGER_ID, state_root_hash=root_hex,
            pool_state_root_hash=root_hex, txn_root_hash=root_hex,
            timestamp=self.now())
        from plenum_tpu_torch.crypto import bls as bls_lib
        message = value.as_single_value()
        names = sorted(self.signers)
        agg = bls_lib.aggregate_sigs(
            [self.signers[n].sign(message) for n in names])
        self._ms = MultiSignature(signature=agg, participants=tuple(names),
                                  value=value)
        return self._ms

    def reshard(self, descriptors: Sequence[ShardDescriptor]) -> None:
        """Install a new map under a bumped epoch — the resharding
        commit point: the instant this publishes, proofs minted under
        the superseded map are STALE for every ratcheted verifier."""
        self.epoch += 1
        for d in descriptors:
            d.epoch = self.epoch
        self.descriptors = list(descriptors)
        self.publish()

    def rotate_signer(self, name: str, new_signer) -> None:
        """Replace one directory-committee member's signing key and
        re-sign the current map root under the new committee. Proofs
        minted under the OLD committee fail `bad_map_multi_sig` against
        any verifier holding the rotated trust root — the directory twin
        of the pool-BLS rotation the membership_churn fuzz exercises."""
        if name not in self.signers:
            raise KeyError(f"{name} is not a directory signer")
        self.signers[name] = new_signer
        self.publish()

    def shard_of(self, key: bytes) -> ShardDescriptor:
        point = key_point(key)
        for d in self.descriptors:
            if d.owns_point(point):
                return d
        raise LookupError(f"no shard owns {point}")   # ranges must cover

    def ownership_proof(self, key: bytes) -> dict:
        """The server-attached proof that `key`'s shard is in the signed
        map: descriptor + inclusion at the signed tree size + multi-sig."""
        point = key_point(key)
        for idx, d in enumerate(self.descriptors):
            if d.owns_point(point):
                break
        else:
            raise LookupError(f"no shard owns {point}")
        path = self._tree.inclusion_proof(idx, self._tree.tree_size)
        return {"descriptor": d.to_dict(), "index": idx,
                "tree_size": self._tree.tree_size,
                "audit_path": [h.hex() for h in path],
                "multi_signature": self._ms.to_list()}


def verify_ownership(key: bytes, proof: Mapping,
                     directory_keys: Mapping[str, str],
                     n_directory: Optional[int] = None,
                     min_epoch: int = 0,
                     freshness_s: float = DEFAULT_MAP_FRESHNESS_S,
                     now: Optional[Callable[[], float]] = None,
                     ms_cache: Optional[dict] = None
                     ) -> tuple[Optional[ShardDescriptor], str]:
    """-> (descriptor, "ok") or (None, reason). Never raises.

    ms_cache: caller-owned {(sig, participants, value): bool} — between
    two map publications every proof cites the SAME directory multi-sig,
    so a read-heavy client pays the pairing once per epoch, not per read.
    """
    try:
        return _verify_ownership(key, proof, directory_keys, n_directory,
                                 min_epoch, freshness_s, now, ms_cache)
    except Exception:
        return None, "malformed_map_proof"


def _verify_ownership(key, proof, directory_keys, n_directory, min_epoch,
                      freshness_s, now, ms_cache):
    import time as _time
    if not isinstance(proof, Mapping):
        return None, "no_map_proof"
    desc = ShardDescriptor.from_dict(proof["descriptor"])
    if not desc.owns(key):
        return None, "wrong_shard"
    ms = MultiSignature.from_list(list(proof["multi_signature"]))
    if ms.value.ledger_id != MAPPING_LEDGER_ID:
        return None, "wrong_ledger"
    cache_key = (ms.signature, ms.participants, ms.value)
    verdict = ms_cache.get(cache_key) if ms_cache is not None else None
    if verdict is None:
        verdict = ms.verify(directory_keys, n=n_directory)
        if ms_cache is not None:
            if len(ms_cache) >= 64:
                ms_cache.clear()
            ms_cache[cache_key] = verdict
    if not verdict:
        return None, "bad_map_multi_sig"
    clock = now() if now is not None else _time.time()
    if abs(clock - ms.value.timestamp) > freshness_s:
        return None, "stale_map_sig"
    if desc.epoch < min_epoch:
        return None, "stale_map"
    root = bytes.fromhex(ms.value.state_root_hash)
    index = int(proof["index"])
    tree_size = int(proof["tree_size"])
    path = [bytes.fromhex(h) for h in proof["audit_path"]]
    if not MerkleVerifier().verify_inclusion(desc.leaf_bytes(), index,
                                             tree_size, path, root):
        return None, "bad_map_inclusion"
    return desc, "ok"


def directory_bls_signers(names: Sequence[str]) -> dict:
    """Name-seeded directory committee — the sim twin of the name-seeded
    pool BLS derivation in tools/local_pool.pool_bls_keys."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    return {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0")[:32])
            for n in names}
