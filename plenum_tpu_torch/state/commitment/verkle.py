"""Wide-branching Verkle-style state commitment (the TS-Verkle shape).

A `VerkleState` is the `StateCommitment` twin of `PruningState`, built
on KZG vector commitments (kzg.py) instead of an MPT:

* keys are hashed to a 32-byte **stem** (sha256 — uniform, so the tree
  stays balanced no matter the key distribution);
* an internal node has WIDTH children addressed by successive
  log2(WIDTH)-bit chunks of the stem; a subtree holding ONE key
  collapses to a leaf *at the shallowest distinguishing level* (so
  depth ~ log_W(n) — 2 levels at 10k keys for the default width 256);
* a node's commitment C commits to the vector of child scalars:
  leaf slot -> H(0x00 || stem || H(value)), child node slot ->
  H(0x01 || enc(C_child)), empty -> 0;
* the node's **anchor** is sha256(0x02 || width || enc(C)) — the
  32-byte value that rides everywhere an MPT root hash does (BLS
  multi-sig value, ReadPlane anchors, catchup roots), which is why the
  rest of the stack is backend-oblivious; the width is in the preimage
  because slot derivation depends on it (see anchor_of);
* nodes are content-addressed by anchor in the KV store, exactly the
  Trie discipline: both heads are just anchors into one node store, so
  `commit` / `revert_to_head` / historic reads are O(1) pointer moves.

Proofs: a key's path is the chain of node commitments plus ONE opening
per level (slot -> child scalar). `batch_open` aggregates EVERY opening
of a whole key page into one (D, pi) pair (kzg.prove_multi), so a
16-key page costs the page's distinct path commitments + 128 bytes of
opening proof — the bytes-per-verified-read win config13 measures.
Absence is proven fail-closed: an empty slot opens to 0; a slot held by
a DIFFERENT key's leaf opens to that leaf's scalar, and the proof
reveals (other_stem, other_value_hash) so the verifier can check the
occupying stem shares the walked path but differs from the queried one.

Commitment recomputation after writes is deferred exactly like the
trie's `_Dirty` machinery: `head_hash` resolves the whole dirty set,
deepest level first, one batch per level — and with a `pipeline`, each
level's recommit batch rides the crypto pipeline's commitment wave kind
(content-deduped across co-hosted nodes, which all commit the same
batches to the same state).
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.storage.kv_memory import KvMemory

from . import kzg
from .base import BACKEND_VERKLE, StateCommitment, register_backend

DEFAULT_WIDTH = 256

_LEAF = 0
_NODE = 1

_COMMITTED_KEY = b"__committed_head__"


def _scalar_leaf(stem: bytes, value_hash: bytes) -> int:
    return kzg.hash_to_scalar(b"\x00" + stem + value_hash)


def _scalar_node(c_enc: bytes) -> int:
    return kzg.hash_to_scalar(b"\x01" + c_enc)


def anchor_of(c_enc: bytes, width: int) -> bytes:
    """The 32-byte root/node anchor. The WIDTH is part of the preimage:
    slot derivation (`chunk`) depends on it, so an anchor that did not
    bind it would let a lying server re-interpret the signed root at a
    narrower width — remapping a present key's path onto a genuinely
    empty slot and proving false absence with a GENUINE opening (no tau
    knowledge needed; found by review, pinned in
    test_verkle_lied_width_cannot_prove_false_absence)."""
    return hashlib.sha256(b"\x02" + width.to_bytes(2, "big")
                          + c_enc).digest()


def stem_of(key: bytes) -> bytes:
    return hashlib.sha256(key).digest()


def chunk_of(stem: bytes, level: int, bits: int, width: int) -> int:
    """The stem's slot at `level` for a width-(2^bits) tree. THE one
    slot-derivation function — the writer (`VerkleState._chunk`) and the
    static verifier both call it; a diverging twin would make every
    honest proof verify False for deployed clients."""
    bit = level * bits
    byte, off = divmod(bit, 8)
    window = int.from_bytes(stem[byte:byte + 2].ljust(2, b"\0"), "big")
    return (window >> (16 - bits - off)) & (width - 1)


class _VNode:
    """In-memory node. children: slot -> entry, where entry is
    ("leaf", stem, value, key) | ("node", _VNode) | ("ref", anchor) — a
    ref is a persisted child not yet loaded. The leaf keeps the original
    KEY (stems are its sha256) so key-iteration APIs (`as_dict`, genesis
    replay, registry scans) behave exactly like the MPT backend; only
    the stem participates in commitments and proofs. `c_enc`/`f_tau`
    cache the commitment; None = dirty (recomputed at resolution)."""

    __slots__ = ("children", "c_enc", "f_tau")

    def __init__(self, children=None, c_enc=None, f_tau=None):
        self.children = children if children is not None else {}
        self.c_enc = c_enc
        self.f_tau = f_tau

    def clone(self) -> "_VNode":
        return _VNode(dict(self.children))


class VerkleState(StateCommitment):
    BACKEND = BACKEND_VERKLE

    def __init__(self, db=None, width: Optional[int] = None,
                 pipeline=None):
        self.width = width or DEFAULT_WIDTH
        self._bits = self.width.bit_length() - 1
        self._engine = kzg.engine_for(self.width)
        self._db = db if db is not None else KvMemory()
        self._pipeline = pipeline
        # empty-tree constants (commitment of the all-zero vector is the
        # identity; its encoding is the 64-zero-byte infinity form)
        self._empty_enc = kzg.enc_g1(None)
        self.blank_root = anchor_of(self._empty_enc, self.width)
        committed = self._db.try_get(_COMMITTED_KEY) or self.blank_root
        self._committed_root = committed
        # decoded-node cache shared across roots (content-addressed)
        self._decoded: dict[bytes, _VNode] = {}
        self._root: _VNode = self._load_root(committed)
        self.stats = {"commits": 0, "recommitted_nodes": 0,
                      "proofs": 0, "proof_openings": 0}

    # --- plumbing ---------------------------------------------------------

    @property
    def kv(self):
        return self._db

    def close(self) -> None:
        self._db.close()

    def _chunk(self, stem: bytes, level: int) -> int:
        return chunk_of(stem, level, self._bits, self.width)

    # --- persistence ------------------------------------------------------

    def _load_root(self, anchor: bytes) -> _VNode:
        if anchor == self.blank_root:
            return _VNode(c_enc=self._empty_enc, f_tau=0)
        return self._load(anchor)

    def _load(self, anchor: bytes) -> _VNode:
        node = self._decoded.get(anchor)
        if node is not None:
            return node
        enc = self._db.try_get(anchor)
        if enc is None:
            raise KeyError(f"unknown verkle root/node {anchor.hex()}")
        rec = unpack(enc)
        children = {}
        for slot, kind, a, b in rec[1]:
            if kind == _LEAF:
                children[slot] = ("leaf", stem_of(a), b, a)
            else:
                children[slot] = ("ref", a)
        node = _VNode(children, c_enc=rec[0], f_tau=None)
        if len(self._decoded) > (1 << 14):
            self._decoded.clear()
        self._decoded[anchor] = node
        return node

    def _resolve_child(self, entry):
        """entry -> ("leaf", stem, value) | ("node", _VNode)."""
        if entry[0] == "ref":
            return ("node", self._load(entry[1]))
        return entry

    def _persist(self, node: _VNode) -> bytes:
        """Serialize a RESOLVED node (c_enc set, children resolved or
        refs) -> its anchor; writes through the db."""
        rec_children = []
        for slot in sorted(node.children):
            entry = node.children[slot]
            if entry[0] == "leaf":
                rec_children.append([slot, _LEAF, entry[3], entry[2]])
            elif entry[0] == "ref":
                rec_children.append([slot, _NODE, entry[1], b""])
            else:
                child = entry[1]
                rec_children.append([slot, _NODE,
                                     anchor_of(child.c_enc, self.width),
                                     b""])
        anchor = anchor_of(node.c_enc, self.width)
        self._db.put(anchor, pack([node.c_enc, rec_children]))
        self._decoded[anchor] = node
        return anchor

    # --- writes (uncommitted head) ----------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        if value == b"":
            raise ValueError("empty value not allowed (use remove)")
        key = bytes(key)
        self._root = self._set(self._root, stem_of(key), bytes(value),
                               key, 0)

    def _set(self, node: _VNode, stem: bytes, value: bytes, key: bytes,
             level: int) -> _VNode:
        node = node.clone()              # copy-on-write: committed/other
        slot = self._chunk(stem, level)  # roots keep their node objects
        entry = node.children.get(slot)
        if entry is not None:
            entry = self._resolve_child(entry)
        if entry is None:
            node.children[slot] = ("leaf", stem, value, key)
        elif entry[0] == "leaf":
            if entry[1] == stem:
                node.children[slot] = ("leaf", stem, value, key)
            else:
                # split: push both leaves one level down (repeatedly, if
                # their next chunks collide too)
                sub = _VNode()
                sub.children[self._chunk(entry[1], level + 1)] = entry
                sub = self._set(sub, stem, value, key, level + 1)
                node.children[slot] = ("node", sub)
        else:
            node.children[slot] = ("node", self._set(entry[1], stem,
                                                     value, key,
                                                     level + 1))
        return node

    def remove(self, key: bytes) -> bool:
        stem = stem_of(key)
        new_root, changed = self._remove(self._root, stem, 0)
        if changed:
            self._root = new_root if new_root is not None else _VNode(
                c_enc=self._empty_enc, f_tau=0)
        return changed

    def _remove(self, node: _VNode, stem: bytes, level: int):
        slot = self._chunk(stem, level)
        entry = node.children.get(slot)
        if entry is None:
            return node, False
        entry = self._resolve_child(entry)
        if entry[0] == "leaf":
            if entry[1] != stem:
                return node, False
            node = node.clone()
            del node.children[slot]
        else:
            sub, changed = self._remove(entry[1], stem, level + 1)
            if not changed:
                return node, False
            node = node.clone()
            if sub is None:
                del node.children[slot]
            else:
                # collapse a one-leaf subtree back up
                if len(sub.children) == 1:
                    only = self._resolve_child(
                        next(iter(sub.children.values())))
                    if only[0] == "leaf":
                        node.children[slot] = only
                        sub = None
                if sub is not None:
                    node.children[slot] = ("node", sub)
        if not node.children:
            return None, True
        return node, True

    # --- reads ------------------------------------------------------------

    def get(self, key: bytes, committed: bool = True) -> Optional[bytes]:
        if committed:
            return self.get_for_root(key, self._committed_root)
        return self._get(self._root, stem_of(key), 0)

    def get_for_root(self, key: bytes, root_hash: bytes) -> Optional[bytes]:
        return self._get(self._load_root(root_hash), stem_of(key), 0)

    def _get(self, node: _VNode, stem: bytes, level: int) -> Optional[bytes]:
        entry = node.children.get(self._chunk(stem, level))
        if entry is None:
            return None
        entry = self._resolve_child(entry)
        if entry[0] == "leaf":
            return entry[2] if entry[1] == stem else None
        return self._get(entry[1], stem, level + 1)

    def as_dict(self, committed: bool = False) -> dict:
        """{key: value} — leaves retain the original key, so iteration
        semantics match the MPT backend exactly (registry scans, genesis
        replay checks)."""
        root = self._load_root(self._committed_root) if committed \
            else self._root
        out: dict[bytes, bytes] = {}
        self._walk(root, out)
        return out

    def _walk(self, node: _VNode, out: dict) -> None:
        for entry in node.children.values():
            entry = self._resolve_child(entry)
            if entry[0] == "leaf":
                out[entry[3]] = entry[2]
            else:
                self._walk(entry[1], out)

    # --- heads ------------------------------------------------------------

    @property
    def head_hash(self) -> bytes:
        if not self._root.children:
            return self.blank_root
        if self._root.c_enc is not None:
            # clean head: a resolved root is always already persisted
            # (loaded from db, or written by a previous resolution), and
            # writes dirty every ancestor — so this is a pure read, not
            # a re-pack+re-put per call (the audit handler reads every
            # ledger's head_hash on every ordered batch)
            return anchor_of(self._root.c_enc, self.width)
        self._resolve_dirty()
        return self._persist_tree(self._root)

    @property
    def committed_head_hash(self) -> bytes:
        return self._committed_root

    def commit(self, root_hash: Optional[bytes] = None) -> None:
        target = root_hash if root_hash is not None else self.head_hash
        self._committed_root = target
        self._db.put(_COMMITTED_KEY, target)
        self.stats["commits"] += 1

    def revert_to_head(self, root_hash: Optional[bytes] = None) -> None:
        target = root_hash if root_hash is not None else self._committed_root
        self._root = self._load_root(target)

    # --- commitment resolution --------------------------------------------

    def _collect_dirty(self, node: _VNode, level: int,
                       by_level: dict) -> None:
        if node.c_enc is not None:
            return
        by_level.setdefault(level, []).append(node)
        for entry in node.children.values():
            if entry[0] == "node":
                self._collect_dirty(entry[1], level + 1, by_level)

    def _resolve_dirty(self) -> None:
        """Recommit every dirty node, deepest level first so child
        commitments exist when the parent's vector is built. Each level
        is ONE batch — through the pipeline's commitment wave kind when
        wired, else inline through the engine."""
        by_level: dict[int, list] = {}
        self._collect_dirty(self._root, 0, by_level)
        if not by_level:
            return
        for level in sorted(by_level, reverse=True):
            nodes = by_level[level]
            # deeper levels already resolved, so _evals_of sees every
            # child's c_enc — recommit and proof paths share ONE scalar
            # derivation (a diverging twin here would silently fork the
            # prover from its own commitments)
            jobs = [self._evals_of(node) for node in nodes]
            results = self._commit_batch(jobs)
            for node, (f_tau, c_enc) in zip(nodes, results):
                node.f_tau = f_tau
                node.c_enc = c_enc
                self.stats["recommitted_nodes"] += 1

    def _commit_batch(self, jobs: Sequence[dict]) -> list:
        """[evals] -> [(f_tau, c_enc)]; the pipeline seam."""
        if self._pipeline is not None and hasattr(self._pipeline,
                                                  "submit_commitment"):
            staged = [("commit", self.width, tuple(sorted(e.items())))
                      for e in jobs]
            try:
                tok = self._pipeline.submit_commitment(staged)
                out = self._pipeline.collect_commitment(tok)
                if out is not None and all(r is not None for r in out):
                    return out
            except Exception:
                pass                      # inline fallback below
        return [self._engine.commit(e) for e in jobs]

    def recommit_staged(self):
        """Commit-wave family (parallel/commit_wave.py): the staged
        twin of `head_hash` — yields one list of ("commit", width,
        evals) cmt jobs per dirty level (deepest first), receives the
        aligned (f_tau, c_enc) results back, and returns the persisted
        root anchor via StopIteration.value. A per-job None result
        falls back to the inline engine commit, the same degrade
        contract as `_commit_batch`. Byte-identical to `head_hash`
        (golden-vector pinned): same scalar derivation, same per-level
        order, same persist walk."""
        if not self._root.children:
            return self.blank_root
        if self._root.c_enc is None:
            by_level: dict[int, list] = {}
            self._collect_dirty(self._root, 0, by_level)
            for level in sorted(by_level, reverse=True):
                nodes = by_level[level]
                jobs = [self._evals_of(node) for node in nodes]
                results = yield [("commit", self.width,
                                  tuple(sorted(e.items())))
                                 for e in jobs]
                for node, evals, res in zip(nodes, jobs, results):
                    if res is None:
                        res = self._engine.commit(evals)
                    node.f_tau, node.c_enc = res
                    self.stats["recommitted_nodes"] += 1
        return self._persist_tree(self._root)

    def _persist_tree(self, node: _VNode) -> bytes:
        """Persist post-order, demoting each persisted child to a
        ("ref", anchor) entry: without the demotion every materialized
        node would be re-packed and re-put on EVERY head_hash call and
        the in-memory graph would grow monotonically over a node's
        lifetime (reloads ride the bounded `_decoded` cache instead;
        content-addressing makes the in-place swap safe even for node
        objects shared with other roots)."""
        for slot, entry in list(node.children.items()):
            if entry[0] == "node":
                node.children[slot] = ("ref", self._persist_tree(entry[1]))
        return self._persist(node)

    # --- proofs -----------------------------------------------------------

    def generate_state_proof(self, key: bytes,
                             root_hash: Optional[bytes] = None,
                             serialize: bool = False):
        proof = self.batch_open([key], root_hash=root_hash)
        return pack(proof) if serialize else proof

    def batch_open(self, keys: Sequence[bytes],
                   root_hash: Optional[bytes] = None) -> dict:
        """ONE aggregated proof answering every key in the page.

        -> {"commitments": [c_enc...], "keys": [per-key], "d": .., "pi": ..}
        per-key: {"path": [[c_idx, slot]...], "term": terminal} with
        terminal ["leaf"] (value is the caller's entry),
        ["empty"] or ["other", other_stem, other_value_hash].
        All byte fields are raw bytes (the envelope hex-encodes them).
        """
        root_anchor = root_hash if root_hash is not None \
            else self._committed_root
        root = self._load_root(root_anchor)
        if root.c_enc is None:
            raise ValueError("cannot open an unresolved head "
                             "(resolve via head_hash first)")
        commitments: list[bytes] = []
        c_index: dict[bytes, int] = {}

        def cidx(c_enc: bytes) -> int:
            i = c_index.get(c_enc)
            if i is None:
                i = c_index[c_enc] = len(commitments)
                commitments.append(c_enc)
            return i

        # opening set keyed (c_enc, slot) — page keys share path prefixes
        openings: dict[tuple, tuple] = {}
        key_entries = []
        for key in keys:
            stem = stem_of(key)
            node, level, path = root, 0, []
            term = None
            while True:
                slot = self._chunk(stem, level)
                path.append([cidx(node.c_enc), slot])
                entry = node.children.get(slot)
                entry = self._resolve_child(entry) \
                    if entry is not None else None
                if entry is None:
                    openings[(node.c_enc, slot)] = (node, slot, 0)
                    term = ["empty"]
                    break
                if entry[0] == "leaf":
                    vh = hashlib.sha256(entry[2]).digest()
                    y = _scalar_leaf(entry[1], vh)
                    openings[(node.c_enc, slot)] = (node, slot, y)
                    term = ["leaf"] if entry[1] == stem \
                        else ["other", entry[1], vh]
                    break
                child = entry[1]
                openings[(node.c_enc, slot)] = (
                    node, slot, _scalar_node(child.c_enc))
                node, level = child, level + 1
            key_entries.append({"path": path, "term": term})
        # canonical ordering binds prover and verifier transcripts
        ordered = sorted(openings.items())
        prove_set = [(c_enc, node.f_tau if node.f_tau is not None
                      else self._engine.f_tau(self._evals_of(node)),
                      slot, y)
                     for (c_enc, _), (node, slot, y) in ordered]
        d_enc, pi_enc = self._prove(prove_set)
        self.stats["proofs"] += 1
        self.stats["proof_openings"] += len(prove_set)
        return {"width": self.width, "commitments": commitments,
                "keys": key_entries, "d": d_enc, "pi": pi_enc}

    def _evals_of(self, node: _VNode) -> dict:
        evals = {}
        for slot, entry in node.children.items():
            entry = self._resolve_child(entry)
            if entry[0] == "leaf":
                evals[slot] = _scalar_leaf(
                    entry[1], hashlib.sha256(entry[2]).digest())
            else:
                evals[slot] = _scalar_node(entry[1].c_enc)
        return evals

    def _prove(self, prove_set) -> tuple[bytes, bytes]:
        """kzg.prove_multi, through the pipeline's wave kind if wired
        (proof generation dedups across co-hosted read planes)."""
        if self._pipeline is not None and hasattr(self._pipeline,
                                                  "submit_commitment"):
            job = ("multiproof", tuple(prove_set))
            try:
                tok = self._pipeline.submit_commitment([job])
                out = self._pipeline.collect_commitment(tok)
                if out is not None and out[0] is not None:
                    return out[0]
            except Exception:
                pass
        return kzg.prove_multi(prove_set)

    # --- verification (static, client-side) --------------------------------

    @staticmethod
    def verify_state_proof(root_hash: bytes, key: bytes,
                           value: Optional[bytes], proof) -> bool:
        try:
            if isinstance(proof, (bytes, bytearray)):
                proof = unpack(bytes(proof))
            return VerkleState.verify_batch_proof(
                root_hash, [(key, value)], proof)
        except Exception:
            return False

    @staticmethod
    def verify_batch_proof(root_hash: bytes,
                           entries: Sequence[tuple],
                           proof, width: Optional[int] = None) -> bool:
        """entries: [(key, value-or-None)] — the whole page, in the
        caller's order; one entry per proof key. The width comes from
        the proof itself (a lied width cannot make a wrong value verify
        — openings still have to satisfy the pairing against the signed
        root's commitment chain — it can only fail an honest one).
        Fails CLOSED: any malformed structure, wrong slot, unbound
        commitment, stem mismatch, or pairing failure is False, never a
        raise."""
        try:
            w = width if width is not None else int(proof["width"])
            return VerkleState._verify_batch(root_hash, entries, proof, w)
        except Exception:
            return False

    @staticmethod
    def _verify_batch(root_hash, entries, proof, width) -> bool:
        bits = width.bit_length() - 1
        if width < 2 or width > 256 or width & (width - 1):
            return False

        def chunk(stem: bytes, level: int) -> int:
            return chunk_of(stem, level, bits, width)

        commitments = [bytes(c) for c in proof["commitments"]]
        key_entries = proof["keys"]
        if len(key_entries) != len(entries) or not commitments:
            return False
        # the root commitment must BE the signed anchor
        # width is bound INTO the anchor: a lied width changes the
        # recomputed anchor and fails here (see anchor_of)
        if anchor_of(commitments[0], width) != bytes(root_hash):
            return False
        openings: dict[tuple, int] = {}

        def note(c_idx: int, slot: int, y: int) -> bool:
            prev = openings.get((c_idx, slot))
            if prev is not None and prev != y:
                return False              # conflicting claims for one slot
            openings[(c_idx, slot)] = y
            return True

        for (key, value), ke in zip(entries, key_entries):
            stem = stem_of(bytes(key))
            path = ke["path"]
            if not path or path[0][0] != 0:
                return False              # every walk starts at the root
            for level, (c_idx, slot) in enumerate(path):
                if not (0 <= c_idx < len(commitments)
                        and 0 <= slot < width):
                    return False
                if slot != chunk(stem, level):
                    return False          # path must follow THIS key
                if level + 1 < len(path):
                    # interior: the slot opens to the NEXT commitment's
                    # scalar — chain binding, recomputed from the list
                    child_idx = path[level + 1][0]
                    if not (0 <= child_idx < len(commitments)):
                        return False
                    if not note(c_idx, slot,
                                _scalar_node(commitments[child_idx])):
                        return False
            term = ke["term"]
            c_idx, slot = path[-1]
            depth = len(path) - 1
            if term[0] == "leaf":
                if value is None:
                    return False
                y = _scalar_leaf(stem, hashlib.sha256(bytes(value))
                                 .digest())
            elif term[0] == "empty":
                if value is not None:
                    return False
                y = 0
            elif term[0] == "other":
                # absence via a different key's leaf occupying the slot:
                # the occupying stem must share the walked path (else it
                # could not live here) and differ from the queried stem
                if value is not None:
                    return False
                other = bytes(term[1])
                if len(other) != 32 or other == stem:
                    return False
                for lvl in range(depth + 1):
                    if chunk(other, lvl) != chunk(stem, lvl):
                        return False
                y = _scalar_leaf(other, bytes(term[2]))
            else:
                return False
            if not note(c_idx, slot, y):
                return False
        # same canonical ordering the prover used
        verify_set = [(commitments[c_idx], slot, y)
                      for (c_idx, slot), y in sorted(
                          openings.items(),
                          key=lambda kv: (commitments[kv[0][0]],
                                          kv[0][1]))]
        return kzg.verify_multi(verify_set, bytes(proof["d"]),
                                bytes(proof["pi"]))


def _factory(db=None, width=None, pipeline=None):
    return VerkleState(db=db, width=width, pipeline=pipeline)


_factory._cls = VerkleState
register_backend(BACKEND_VERKLE, _factory)
