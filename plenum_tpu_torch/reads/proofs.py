"""Proof envelope for verified reads: format, key plans, verification.

The envelope rides inside REPLY.result under the ``read_proof`` key and is
the ONE format both sides speak — the server's ReadPlane builds it
(plane.py) and the verifying client checks it (client.py) through
`verify_read_proof`, which fails CLOSED: any malformed, truncated, or
tampered envelope verifies False, never raises, never True.

Three proof kinds:

``state`` — trie-backed queries. A chain of MPT proofs, every entry under
    ONE signed state root: ``entries[i] = {key, value, proof}``. The
    client re-derives the expected key chain from ITS OWN request (a lying
    node cannot substitute a different key) via `state_read_plan`, checks
    each proof, then checks the visible result data is the proven values'
    projection (`check_consistency`).

``verkle`` — the same queries on a Verkle-backed ledger
    (state/commitment/): the entries carry keys+values only, and ONE
    aggregated multi-key opening at the envelope level
    (``proof = {width, commitments, keys, d, pi}``) covers the whole
    page. Key derivation and data-consistency rules are identical to
    ``state``; MPT-backed ledgers never emit this kind (nothing changes
    on their wire).

``merkle`` — GET_TXN. RFC-6962 inclusion of the txn leaf in the ledger's
    Merkle tree at the SIGNED tree size, anchored to the multi-sig's
    txn_root (unlike the legacy ``merkle_info`` field, which cites the
    current, unsigned root a lying node can fabricate).

Both kinds carry the BLS multi-signature (`MultiSignature.verify`) whose
signed value names the root, and a ``result_digest`` binding the envelope
to the exact result it travelled with (= TreeHasher.hash_leaf of the
msgpack of the result minus per-request fields, so the server can batch
digest computation through the vectorized SHA-256 hasher).
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Mapping, Optional, Sequence

from plenum_tpu_torch.common.node_messages import (CONFIG_LEDGER_ID,
                                             DOMAIN_LEDGER_ID,
                                             VALID_LEDGER_IDS)
from plenum_tpu_torch.common.serialization import pack
from plenum_tpu_torch.crypto.multi_signature import MultiSignature
from plenum_tpu_torch.execution.txn import (GET_ATTR, GET_FROZEN_LEDGERS, GET_NYM,
                                      GET_TXN, GET_TXN_AUTHOR_AGREEMENT,
                                      GET_TXN_AUTHOR_AGREEMENT_AML)

READ_PROOF = "read_proof"
KIND_STATE = "state"
KIND_MERKLE = "merkle"
# wide-commitment state (state/commitment/verkle.py): ONE aggregated
# multi-key opening answers the whole key page — the entries carry no
# per-key proof field; the envelope-level "proof" covers them all
KIND_VERKLE = "verkle"

# Default client freshness bound. Anchors refresh when a batch commits OR
# when the primary's periodic freshness batch re-signs idle roots
# (Config.STATE_FRESHNESS_UPDATE_INTERVAL: 300 s default, 600 s in the
# bench/local_pool configs) — the bound must exceed the SLOWEST refresh
# cadence in use plus commit latency, or every read against an idle
# ledger rejects honest anchors as stale and degrades to the ~4n-message
# worst case (full failover ladder + broadcast). 900 s = 1.5x the slowest
# configured interval, with commit-latency headroom.
DEFAULT_FRESHNESS_S = 900.0

# fields of a result that are per-request, not per-content: excluded from
# result_digest so one cached core result serves every asker.
# "shard_proof" (shards/mapping.py) is attached AFTER the node computed
# the digest — a mapping-ownership attachment inside the digest would
# unbind every envelope the moment a shard gate decorates the reply
_PER_REQUEST_FIELDS = ("identifier", "reqId", READ_PROOF, "shard_proof")


def result_core(result: Mapping) -> dict:
    return {k: v for k, v in result.items() if k not in _PER_REQUEST_FIELDS}


def result_digest_preimage(result: Mapping) -> bytes:
    """The bytes whose 0x00-domain leaf hash is the result digest —
    exposed separately so the ReadPlane can batch many results through
    one vectorized hash_leaves dispatch."""
    return pack(result_core(result))


def result_digest(result: Mapping) -> bytes:
    """= TreeHasher.hash_leaf(preimage): sha256(0x00 || msgpack(core))."""
    return hashlib.sha256(b"\x00" + result_digest_preimage(result)).digest()


# --- state-read key plans ---------------------------------------------------
#
# A plan is the client-derivable key chain for a trie-backed query: a list
# of steps, each either ("key", bytes) — key known from the request alone —
# or ("deref", fn) — key derived from the PREVIOUS step's proven value.
# None: this query shape has no plan (e.g. historic-timestamp reads whose
# root is not the signed one) and gets no state envelope.

def _taa_digest_key(ptr: bytes) -> bytes:
    return b"taa:d:" + ptr


def state_read_plan(txn_type: str, op: Mapping
                    ) -> Optional[tuple[int, list]]:
    """-> (ledger_id, steps) or None when the query is not provable."""
    try:
        if txn_type == GET_NYM:
            return DOMAIN_LEDGER_ID, [("key", op["dest"].encode())]
        if txn_type == GET_ATTR:
            digest = hashlib.sha256(op["attr_name"].encode()).hexdigest()
            return DOMAIN_LEDGER_ID, [
                ("key", f"{op['dest']}:attr:{digest}".encode())]
        if txn_type == GET_TXN_AUTHOR_AGREEMENT:
            if op.get("timestamp") is not None:
                return None
            if op.get("digest"):
                return CONFIG_LEDGER_ID, [
                    ("key", _taa_digest_key(op["digest"].encode()))]
            if op.get("version"):
                return CONFIG_LEDGER_ID, [
                    ("key", b"taa:v:" + op["version"].encode()),
                    ("deref", _taa_digest_key)]
            return CONFIG_LEDGER_ID, [("key", b"taa:latest"),
                                      ("deref", _taa_digest_key)]
        if txn_type == GET_TXN_AUTHOR_AGREEMENT_AML:
            if op.get("timestamp") is not None:
                return None
            if op.get("version"):
                return CONFIG_LEDGER_ID, [
                    ("key", b"aml:v:" + op["version"].encode())]
            return CONFIG_LEDGER_ID, [("key", b"aml:latest")]
        if txn_type == GET_FROZEN_LEDGERS:
            return CONFIG_LEDGER_ID, [("key", b"frozen_ledgers")]
    except (KeyError, AttributeError, TypeError):
        return None
    return None


def resolve_plan_keys(steps: Sequence, values: Sequence[Optional[bytes]]
                      ) -> Optional[list[bytes]]:
    """Expected key chain given the (claimed) proven values. A ("deref")
    step's key comes from the previous value; a broken chain (absent
    pointer) legitimately truncates the key list there."""
    keys: list[bytes] = []
    for i, step in enumerate(steps):
        if step[0] == "key":
            keys.append(step[1])
        else:
            if i == 0:
                return None
            prev = values[i - 1] if i - 1 < len(values) else None
            if prev is None:
                break                    # absent pointer: chain ends here
            keys.append(step[1](prev))
    return keys


def check_consistency(txn_type: str, op: Mapping, values: Sequence,
                      result: Mapping) -> bool:
    """EVERY visible result field a client might consume must be exactly
    the proven values' projection (or the request's own echo) — a reply
    whose data, derived metadata (seqNo/txnTime), or echoed query fields
    disagree with its own proof is a lie even when every individual
    proof checks out."""
    from plenum_tpu_torch.common.serialization import unpack
    last = values[-1] if values else None
    data = result.get("data")
    if txn_type == GET_NYM:
        if result.get("dest") != op.get("dest"):
            return False
        if last is None:
            return (data is None and result.get("seqNo") is None
                    and result.get("txnTime") is None)
        rec = unpack(last)
        return (data == rec
                and result.get("seqNo") == rec.get("seqNo")
                and result.get("txnTime") == rec.get("txnTime"))
    if txn_type == GET_ATTR:
        if result.get("dest") != op.get("dest") or \
                result.get("attr_name") != op.get("attr_name"):
            return False
        meta = result.get("meta")
        if last is None:
            return (meta is None and data is None
                    and result.get("seqNo") is None
                    and result.get("txnTime") is None)
        rec = unpack(last)
        if meta != rec or result.get("seqNo") != rec.get("seqNo") or \
                result.get("txnTime") != rec.get("txnTime"):
            return False
        if data is not None:
            # binds the off-state payload to the proven digest
            return hashlib.sha256(
                str(data).encode()).hexdigest() == rec.get("digest")
        return True
    if txn_type in (GET_TXN_AUTHOR_AGREEMENT, GET_TXN_AUTHOR_AGREEMENT_AML):
        if last is None:
            return data is None
        return data == unpack(last)
    if txn_type == GET_FROZEN_LEDGERS:
        if last is None:
            return data in (None, {})
        return data == unpack(last)
    return False


# --- envelope construction (server side) ------------------------------------

def build_state_envelope(ms: MultiSignature, ledger_id: int, root_hex: str,
                         entries: Sequence[tuple[bytes, Optional[bytes],
                                                 bytes]]) -> dict:
    return {
        "kind": KIND_STATE,
        "ledger_id": ledger_id,
        "root_hash": root_hex,
        "entries": [{"key": k.hex(),
                     "value": v.hex() if v is not None else None,
                     "proof": p.hex()} for k, v, p in entries],
        "multi_signature": ms.to_list(),
    }


def verkle_proof_to_wire(proof: Mapping) -> dict:
    """batch_open output (raw bytes) -> the hex-field wire form the
    envelope carries (symmetric with the other kinds' hex discipline)."""
    return {
        "width": int(proof["width"]),
        "commitments": [c.hex() for c in proof["commitments"]],
        "keys": [{"path": [[int(ci), int(slot)] for ci, slot in k["path"]],
                  "term": [k["term"][0]] + [x.hex() for x in k["term"][1:]]}
                 for k in proof["keys"]],
        "d": proof["d"].hex(),
        "pi": proof["pi"].hex(),
    }


def wire_to_verkle_proof(wire: Mapping) -> dict:
    return {
        "width": int(wire["width"]),
        "commitments": [bytes.fromhex(c) for c in wire["commitments"]],
        "keys": [{"path": [[int(ci), int(slot)]
                           for ci, slot in k["path"]],
                  "term": [k["term"][0]] + [bytes.fromhex(x)
                                            for x in k["term"][1:]]}
                 for k in wire["keys"]],
        "d": bytes.fromhex(wire["d"]),
        "pi": bytes.fromhex(wire["pi"]),
    }


def build_verkle_envelope(ms: MultiSignature, ledger_id: int,
                          root_hex: str,
                          entries: Sequence[tuple[bytes, Optional[bytes]]],
                          proof: Mapping) -> dict:
    """entries: the page's (key, value) pairs in plan order; proof: ONE
    aggregated batch_open covering every entry."""
    return {
        "kind": KIND_VERKLE,
        "ledger_id": ledger_id,
        "root_hash": root_hex,
        "entries": [{"key": k.hex(),
                     "value": v.hex() if v is not None else None}
                    for k, v in entries],
        "proof": verkle_proof_to_wire(proof),
        "multi_signature": ms.to_list(),
    }


def build_merkle_envelope(ms: MultiSignature, ledger_id: int, root_hex: str,
                          seq_no: int, tree_size: int,
                          audit_path: Sequence[bytes],
                          last_leaf: Optional[bytes] = None) -> dict:
    env = {
        "kind": KIND_MERKLE,
        "ledger_id": ledger_id,
        "txn_root": root_hex,
        "seq_no": seq_no,
        "tree_size": tree_size,
        "audit_path": [h.hex() for h in audit_path],
        "multi_signature": ms.to_list(),
    }
    if last_leaf is not None:
        # absence envelopes: the last leaf + its inclusion proof bind the
        # CLAIMED tree_size to the signed root (the multi-sig value names
        # no size, so an unbound size would be forgeable)
        env["last_leaf"] = last_leaf.hex()
    return env


# --- verification (client side) ---------------------------------------------

NO_PROOF = "no_proof"          # distinguished: fall back, don't fail over


def _verify_anchor(env: Mapping, bls_keys: Mapping[str, str],
                   freshness_s: float, now, n_nodes,
                   ms_cache: Optional[dict] = None):
    """The anchor preamble every envelope verifier shares: multi-sig
    against the pool keys (memoized via ms_cache when given) + the
    freshness window. -> (MultiSignature, "ok") or (None, reason)."""
    ms = MultiSignature.from_list(list(env["multi_signature"]))
    cache_key = (ms.signature, ms.participants, ms.value)
    verdict = ms_cache.get(cache_key) if ms_cache is not None else None
    if verdict is None:
        verdict = ms.verify(bls_keys, n=n_nodes)
        if ms_cache is not None:
            if len(ms_cache) >= 1024:
                ms_cache.clear()
            ms_cache[cache_key] = verdict
    if not verdict:
        return None, "bad_multi_sig"
    clock = now() if now is not None else time.time()
    if abs(clock - ms.value.timestamp) > freshness_s:
        return None, "stale"
    return ms, "ok"


def verify_page_envelope(env: Mapping, keys: Sequence[bytes],
                         bls_keys: Mapping[str, str],
                         ledger_id: int,
                         freshness_s: float = DEFAULT_FRESHNESS_S,
                         now: Optional[Callable[[], float]] = None,
                         n_nodes: Optional[int] = None
                         ) -> tuple[bool, Optional[list], str]:
    """Verify a ReadPlane.page_envelope against the CLIENT's own intent:
    its key page AND its target ledger (a lying server cannot substitute
    another page — or a signed envelope from a DIFFERENT ledger where
    the same key bytes resolve differently), then multi-sig, freshness,
    signed-root binding, and the proof(s) — one aggregated opening for
    ``verkle``, per-key chains for ``state``.
    -> (ok, values-in-page-order, reason); never raises."""
    try:
        ms, reason = _verify_anchor(env, bls_keys, freshness_s, now,
                                    n_nodes)
        if ms is None:
            return False, None, reason
        root_hex = env["root_hash"]
        if ms.value.state_root_hash != root_hex or \
                ms.value.ledger_id != ledger_id or \
                int(env["ledger_id"]) != ledger_id:
            return False, None, "unsigned_root"
        root = bytes.fromhex(root_hex)
        entries = env["entries"]
        if len(entries) != len(keys):
            return False, None, "key_chain_mismatch"
        values = []
        pairs = []
        for e, key in zip(entries, keys):
            if bytes.fromhex(e["key"]) != bytes(key):
                return False, None, "key_mismatch"
            value = bytes.fromhex(e["value"]) \
                if e.get("value") is not None else None
            values.append(value)
            pairs.append((bytes(key), value))
        kind = env.get("kind")
        if kind == KIND_VERKLE:
            from plenum_tpu_torch.state.commitment.verkle import VerkleState
            if not VerkleState.verify_batch_proof(
                    root, pairs, wire_to_verkle_proof(env["proof"])):
                return False, None, "bad_verkle_proof"
        elif kind == KIND_STATE:
            from plenum_tpu_torch.state.pruning_state import PruningState
            for e, (key, value) in zip(entries, pairs):
                if not PruningState.verify_state_proof(
                        root, key, value, bytes.fromhex(e["proof"])):
                    return False, None, "bad_state_proof"
        else:
            return False, None, "bad_kind"
        return True, values, "ok"
    except Exception:
        return False, None, "malformed"


def verify_read_proof(txn_type: Optional[str], operation: Mapping,
                      result: Mapping,
                      bls_keys: Mapping[str, str],
                      freshness_s: float = DEFAULT_FRESHNESS_S,
                      now: Optional[Callable[[], float]] = None,
                      n_nodes: Optional[int] = None,
                      ms_cache: Optional[dict] = None
                      ) -> tuple[bool, str]:
    """-> (ok, reason). reason == NO_PROOF means the reply carried no
    envelope at all (escalate to the f+1 broadcast); any other falsy
    reason is an affirmative verification FAILURE (fail over to the next
    node). Never raises.

    ms_cache: optional caller-owned {(sig, participants, value): bool} —
    between two batch commits every reply cites the SAME multi-sig, so a
    read-heavy client pays the 2-pairing check once per anchor, not once
    per read (the paper's client-side BLS budget). Freshness is judged
    per call regardless; the cache only skips the pairing."""
    try:
        return _verify(txn_type, operation, result, bls_keys,
                       freshness_s, now, n_nodes, ms_cache)
    except Exception:
        return False, "malformed"


def _verify(txn_type, operation, result, bls_keys, freshness_s, now,
            n_nodes, ms_cache) -> tuple[bool, str]:
    env = result.get(READ_PROOF) if isinstance(result, Mapping) else None
    if not isinstance(env, Mapping):
        return False, NO_PROOF
    kind = env.get("kind")
    if kind not in (KIND_STATE, KIND_MERKLE, KIND_VERKLE):
        return False, NO_PROOF if kind in (None, "none") else "bad_kind"

    # the proof must be about THIS result, not a spliced-in honest one
    claimed = env.get("result_digest")
    if not isinstance(claimed, str) or \
            bytes.fromhex(claimed) != result_digest(result):
        return False, "result_digest_mismatch"

    ms, reason = _verify_anchor(env, bls_keys, freshness_s, now, n_nodes,
                                ms_cache=ms_cache)
    if ms is None:
        return False, reason

    if kind == KIND_STATE:
        return _verify_state(txn_type, operation, result, env, ms)
    if kind == KIND_VERKLE:
        return _verify_verkle(txn_type, operation, result, env, ms)
    return _verify_merkle(operation, result, env, ms)


def _verify_state(txn_type, operation, result, env, ms) -> tuple[bool, str]:
    from plenum_tpu_torch.state.pruning_state import PruningState
    plan = state_read_plan(txn_type, operation)
    if plan is None:
        return False, "unplannable_query"
    if result.get("type") != txn_type:
        return False, "wrong_type_echo"
    ledger_id, steps = plan
    if int(env["ledger_id"]) != ledger_id or \
            ms.value.ledger_id != ledger_id:
        return False, "wrong_ledger"
    root_hex = env["root_hash"]
    if ms.value.state_root_hash != root_hex:
        return False, "unsigned_root"
    root = bytes.fromhex(root_hex)
    entries = env["entries"]
    values = [bytes.fromhex(e["value"]) if e.get("value") is not None
              else None for e in entries]
    expected = resolve_plan_keys(steps, values)
    if expected is None or len(entries) != len(expected):
        return False, "key_chain_mismatch"
    for e, key, value in zip(entries, expected, values):
        if bytes.fromhex(e["key"]) != key:
            return False, "key_mismatch"
        if not PruningState.verify_state_proof(
                root, key, value, bytes.fromhex(e["proof"])):
            return False, "bad_state_proof"
    if not check_consistency(txn_type, operation, values, result):
        return False, "data_mismatch"
    return True, "ok"


def _verify_verkle(txn_type, operation, result, env, ms
                   ) -> tuple[bool, str]:
    """The Verkle twin of _verify_state: same client-derived key chain,
    same signed-root anchoring, same data-consistency projection — but
    the whole page rides ONE aggregated opening (state/commitment/
    verkle.py verify_batch_proof), so a spliced value inside the page
    (one key's value swapped, everything else honest) fails the single
    pairing check, not just its own entry."""
    from plenum_tpu_torch.state.commitment.verkle import VerkleState
    plan = state_read_plan(txn_type, operation)
    if plan is None:
        return False, "unplannable_query"
    if result.get("type") != txn_type:
        return False, "wrong_type_echo"
    ledger_id, steps = plan
    if int(env["ledger_id"]) != ledger_id or \
            ms.value.ledger_id != ledger_id:
        return False, "wrong_ledger"
    root_hex = env["root_hash"]
    if ms.value.state_root_hash != root_hex:
        return False, "unsigned_root"
    entries = env["entries"]
    values = [bytes.fromhex(e["value"]) if e.get("value") is not None
              else None for e in entries]
    expected = resolve_plan_keys(steps, values)
    if expected is None or len(entries) != len(expected):
        return False, "key_chain_mismatch"
    pairs = []
    for e, key, value in zip(entries, expected, values):
        if bytes.fromhex(e["key"]) != key:
            return False, "key_mismatch"
        pairs.append((key, value))
    proof = wire_to_verkle_proof(env["proof"])
    if not VerkleState.verify_batch_proof(bytes.fromhex(root_hex),
                                          pairs, proof):
        return False, "bad_verkle_proof"
    if not check_consistency(txn_type, operation, values, result):
        return False, "data_mismatch"
    return True, "ok"


def _verify_merkle(operation, result, env, ms) -> tuple[bool, str]:
    from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
    req_ledger = operation.get("ledgerId", DOMAIN_LEDGER_ID)
    if req_ledger not in VALID_LEDGER_IDS:
        return False, "wrong_ledger"
    if int(env["ledger_id"]) != req_ledger or \
            ms.value.ledger_id != req_ledger or \
            result.get("ledgerId") != req_ledger:
        return False, "wrong_ledger"
    if result.get("type") != GET_TXN:
        return False, "wrong_type_echo"
    root_hex = env["txn_root"]
    if ms.value.txn_root_hash != root_hex:
        return False, "unsigned_root"
    seq_no = int(env["seq_no"])
    tree_size = int(env["tree_size"])
    if seq_no != int(operation.get("data", -1)):
        return False, "wrong_seq_no"
    data = result.get("data")
    if data is None:
        # absence: provable only as "beyond the signed tree" — bounded
        # staleness (the freshness check bounds how old that tree can be).
        # The signed value names NO tree size, so the claimed size must be
        # bound to the signed root: via the last leaf's inclusion proof at
        # exactly that size (a smaller lied size reconstructs a subtree
        # root, not the signed one), or for an empty tree the root must BE
        # the empty hash.
        if seq_no <= tree_size:
            return False, "absent_within_tree"
        root = bytes.fromhex(root_hex)
        if tree_size == 0:
            if root == hashlib.sha256(b"").digest():
                return True, "ok"
            return False, "unbound_tree_size"
        last_leaf = bytes.fromhex(env["last_leaf"])
        path = [bytes.fromhex(h) for h in env["audit_path"]]
        if not MerkleVerifier().verify_inclusion(
                last_leaf, tree_size - 1, tree_size, path, root):
            return False, "unbound_tree_size"
        return True, "ok"
    if result.get("seqNo") != seq_no:
        return False, "wrong_seq_no"
    path = [bytes.fromhex(h) for h in env["audit_path"]]
    leaf = pack(data)
    if not MerkleVerifier().verify_inclusion(
            leaf, seq_no - 1, tree_size, path, bytes.fromhex(root_hex)):
        return False, "bad_inclusion_proof"
    return True, "ok"
