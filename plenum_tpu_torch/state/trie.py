"""Merkle Patricia Trie (Ethereum shape) over a KV node store.

Reference behavior: state/trie/pruning_trie.py:215 — hex-nibble trie with
RLP-encoded nodes hashed with SHA3-256 (hashlib sha3_256, as the reference's
state/util/utils.py), content-addressed in a KV db so any historic root stays
readable; state proofs are the RLP node lists along a key's path.

Node encodings (standard MPT):
  blank      -> b''
  leaf       -> [hex_prefix(path, t=1), value]
  extension  -> [hex_prefix(path, t=0), ref]
  branch     -> [ref0 .. ref15, value]
A ref is the node's RLP if shorter than 32 bytes, else its sha3 hash (the
RLP stored in the db under that hash).
"""
from __future__ import annotations

import hashlib
from typing import Optional

from plenum_tpu_torch.storage.kv_store import KeyValueStorage
from plenum_tpu_torch.storage.kv_memory import KvMemory

from . import rlp

BLANK_NODE = b""
BLANK_ROOT = hashlib.sha3_256(rlp.encode(b"")).digest()


def sha3(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


# byte -> [hi, lo] nibble pairs; one C-level comprehension beats the
# per-byte shift/mask loop ~3x on the trie-walk hot path
_NIB = [[b >> 4, b & 0x0F] for b in range(256)]


def bytes_to_nibbles(key: bytes) -> list[int]:
    return [n for b in key for n in _NIB[b]]


def hex_prefix_encode(nibbles: list[int], leaf: bool) -> bytes:
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        packed = [((flag + 1) << 4) | nibbles[0]]
        rest = nibbles[1:]
    else:
        packed = [flag << 4]
        rest = nibbles
    for i in range(0, len(rest), 2):
        packed.append((rest[i] << 4) | rest[i + 1])
    return bytes(packed)


def hex_prefix_decode(data: bytes) -> tuple[list[int], bool]:
    if not data:
        raise rlp.RlpError("empty hex-prefix")
    flag = data[0] >> 4
    leaf = bool(flag & 2)
    rest = [n for b in data[1:] for n in _NIB[b]]
    if flag & 1:
        return [data[0] & 0x0F] + rest, leaf
    return rest, leaf


class _Dirty:
    """Deferred ref: a freshly-built node whose RLP+SHA3 (and db write)
    are postponed to the next root_hash resolution, where the WHOLE
    dirty set is encoded+hashed in one native batch call
    (native_codec.encode_hash_many / native/mptcodec.cpp).

    Deferral also deduplicates the spine: k writes in a 3PC batch
    rebuild the root-adjacent nodes k times, and only the LAST version
    of each position is ever hashed — the reference
    (state/trie/pruning_trie.py:215) encodes+hashes every intermediate.

    Invariant: a _Dirty appears only as a DIRECT item of another dirty
    node's list or of root_node (every freshly-built list is wrapped by
    _store before being embedded), so collection/substitution walk one
    level per node. A violation fails loudly in rlp.encode."""
    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node


def _collect_dirty(lst, order: list) -> None:
    """Post-order (children first) over the _Dirty tree."""
    for x in lst:
        if type(x) is _Dirty:
            _collect_dirty(x.node, order)
            order.append(x)


def _substitute(lst, ref_of: dict) -> None:
    for i, x in enumerate(lst):
        if type(x) is _Dirty:
            lst[i] = ref_of[id(x)]


def _collect_dirty_by_height(lst, out: dict) -> int:
    """Bucket the _Dirty tree by height — dirty-set leaves at 0 — and
    return the height of `lst`'s own position. This is the level
    structure the staged commit wave dispatches: everything in bucket h
    references only buckets < h, so one hash wave per bucket (ascending)
    resolves parents strictly after their children, exactly like the
    post-order walk. DFS append order keeps each bucket deterministic,
    so co-hosted replicas staging the same ordered batch emit
    byte-identical level jobs (the cross-submitter dedup contract)."""
    h = 0
    for x in lst:
        if type(x) is _Dirty:
            ch = _collect_dirty_by_height(x.node, out)
            out.setdefault(ch, []).append(x)
            h = max(h, ch + 1)
    return h


class Trie:
    # hashed refs are content-addressed, so a decoded node can be cached
    # forever; the upper levels of the trie repeat on every key's path and
    # their RLP decode dominated the pool write profile. Bounded: drop the
    # oldest half when full (insertion order ~ recency for trie walks).
    _DECODE_CACHE_MAX = 1 << 16

    def __init__(self, db: Optional[KeyValueStorage] = None,
                 root_hash: bytes = BLANK_ROOT,
                 cache: Optional[dict] = None):
        self.db = db if db is not None else KvMemory()
        # content-addressed, so safe to SHARE across Trie instances over
        # the same db (PruningState passes one cache into the throwaway
        # Tries it builds per committed/historic read)
        self._decoded: dict[bytes, object] = cache if cache is not None \
            else {}
        self.root_node = self._decode_ref_root(root_hash)

    # --- refs -------------------------------------------------------------

    def _store(self, node) -> object:
        """node (decoded form) -> ref. Deferred: the inline-vs-hash
        decision and the db write happen at the next root_hash
        resolution (one native batch call for the whole dirty set)."""
        if node == BLANK_NODE:
            return b""
        return _Dirty(node)

    def _load(self, ref):
        if type(ref) is _Dirty:
            return ref.node
        if ref == b"" or ref == BLANK_NODE:
            return BLANK_NODE
        if isinstance(ref, bytes) and len(ref) == 32:
            node = self._decoded.get(ref)
            if node is not None:
                return node
            enc = self.db.try_get(ref)
            if enc is None:
                raise KeyError(f"missing trie node {ref.hex()}")
            node = rlp.decode(enc)
            self._cache_put(ref, node)
            return node
        return ref          # inline node (list)

    def _cache_put(self, h: bytes, node) -> None:
        if len(self._decoded) >= self._DECODE_CACHE_MAX:
            for k in list(self._decoded)[:self._DECODE_CACHE_MAX // 2]:
                del self._decoded[k]
        self._decoded[h] = node

    def _decode_ref_root(self, root_hash: bytes):
        if root_hash == BLANK_ROOT:
            return BLANK_NODE
        node = self._decoded.get(root_hash)
        if node is not None:
            return node
        enc = self.db.try_get(root_hash)
        if enc is None:
            raise KeyError(f"unknown state root {root_hash.hex()}")
        node = rlp.decode(enc)
        self._cache_put(root_hash, node)
        return node

    @property
    def root_hash(self) -> bytes:
        if self.root_node == BLANK_NODE:
            return BLANK_ROOT
        self._resolve_dirty()
        enc = rlp.encode(self.root_node)
        h = sha3(enc)
        self.db.put(h, enc)     # root is always persisted by hash
        return h

    def _resolve_dirty(self) -> None:
        """Encode+hash+persist every deferred node below the root, one
        native batch call for the lot (pure-Python twin when the
        toolchain is absent). Children resolve before parents; a child
        whose RLP is <32 bytes becomes an inline ref (the node itself),
        exactly as the eager path decided per node."""
        root = self.root_node
        if type(root) is not list:
            return
        order: list[_Dirty] = []
        _collect_dirty(root, order)
        if not order:
            return
        from . import native_codec
        encoded = None
        if native_codec.available():
            index = {id(x): i for i, x in enumerate(order)}
            counts, tags, chunks = [], [], []
            ap_t, ap_c = tags.append, chunks.append
            for x in order:
                node = x.node
                counts.append(len(node))
                for it in node:
                    t = type(it)
                    if t is bytes:
                        ap_t(-1)
                        ap_c(it)
                    elif t is _Dirty:
                        ap_t(index[id(it)])
                    else:             # clean inline child (nested list)
                        ap_t(-2)
                        ap_c(rlp.encode(it))
            encoded = native_codec.encode_hash_batch(counts, tags, chunks)
        ref_of: dict[int, object] = {}
        if encoded is not None:
            for x, (enc, h) in zip(order, encoded):
                _substitute(x.node, ref_of)
                if len(enc) < 32:
                    ref_of[id(x)] = x.node
                else:
                    self.db.put(h, enc)
                    self._cache_put(h, x.node)
                    ref_of[id(x)] = h
        else:
            for x in order:
                _substitute(x.node, ref_of)
                enc = rlp.encode(x.node)
                if len(enc) < 32:
                    ref_of[id(x)] = x.node
                else:
                    h = sha3(enc)
                    self.db.put(h, enc)
                    self._cache_put(h, x.node)
                    ref_of[id(x)] = h
        _substitute(root, ref_of)

    def resolve_root_staged(self):
        """Generator twin of `_resolve_dirty` + `root_hash` for the
        fused commit wave (parallel/commit_wave.py): yields one list of
        full sha3 preimages per trie LEVEL (deepest dirty bucket first),
        receives the 32-byte digests back from the wave, and returns
        the new root hash via StopIteration.value. Byte-identical to
        the host path by construction — same RLP encodings, same
        inline-vs-hash (<32 bytes) rule, same db writes/cache fills —
        the property the golden drift vectors pin."""
        root = self.root_node
        if root == BLANK_NODE:
            return BLANK_ROOT
        by_height: dict[int, list[_Dirty]] = {}
        if type(root) is list:
            _collect_dirty_by_height(root, by_height)
        ref_of: dict[int, object] = {}
        for height in sorted(by_height):
            level = by_height[height]
            encs = []
            for x in level:
                _substitute(x.node, ref_of)
                encs.append(rlp.encode(x.node))
            to_hash = [(i, e) for i, e in enumerate(encs) if len(e) >= 32]
            digests = (yield [e for _, e in to_hash]) if to_hash else []
            for (i, enc), h in zip(to_hash, digests):
                x = level[i]
                self.db.put(h, enc)
                self._cache_put(h, x.node)
                ref_of[id(x)] = h
            for i, enc in enumerate(encs):
                if len(enc) < 32:
                    ref_of[id(level[i])] = level[i].node
        if type(root) is list:
            _substitute(root, ref_of)
        enc = rlp.encode(root)
        digests = yield [enc]
        h = digests[0]
        self.db.put(h, enc)     # root is always persisted by hash
        return h

    @root_hash.setter
    def root_hash(self, value: bytes) -> None:
        self.root_node = self._decode_ref_root(value)

    # --- node kind --------------------------------------------------------

    @staticmethod
    def _kind(node) -> str:
        if node == BLANK_NODE:
            return "blank"
        if len(node) == 2:
            _, leaf = hex_prefix_decode(node[0])
            return "leaf" if leaf else "extension"
        return "branch"

    # --- get --------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        return self._get(self.root_node, bytes_to_nibbles(key))

    def _get(self, node, path):
        if node == BLANK_NODE:
            return None
        kind = self._kind(node)
        if kind == "branch":
            if not path:
                return node[16] if node[16] != b"" else None
            sub = self._load(node[path[0]])
            return self._get(sub, path[1:])
        nibbles, leaf = hex_prefix_decode(node[0])
        if leaf:
            return node[1] if nibbles == path else None
        if path[:len(nibbles)] == nibbles:
            return self._get(self._load(node[1]), path[len(nibbles):])
        return None

    # --- set --------------------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        if value == b"":
            raise ValueError("empty value not allowed (use remove)")
        self.root_node = self._set(self.root_node, bytes_to_nibbles(key), value)

    def _set(self, node, path, value):
        if node == BLANK_NODE:
            return [hex_prefix_encode(path, True), value]
        kind = self._kind(node)
        if kind == "branch":
            if not path:
                node = list(node)
                node[16] = value
                return node
            node = list(node)
            sub = self._load(node[path[0]])
            node[path[0]] = self._store(self._set(sub, path[1:], value))
            return node
        nibbles, leaf = hex_prefix_decode(node[0])
        common = 0
        while (common < len(nibbles) and common < len(path)
               and nibbles[common] == path[common]):
            common += 1
        if leaf and nibbles == path:
            return [node[0], value]
        if not leaf and common == len(nibbles):
            # descend into extension
            sub = self._load(node[1])
            new_sub = self._set(sub, path[common:], value)
            return [node[0], self._store(new_sub)]
        # split: build a branch at the divergence point
        branch = [b""] * 16 + [b""]
        # remainder of existing node
        rem = nibbles[common:]
        if leaf:
            if rem:
                branch[rem[0]] = self._store(
                    [hex_prefix_encode(rem[1:], True), node[1]])
            else:
                branch[16] = node[1]
        else:
            if rem:
                if len(rem) == 1:
                    branch[rem[0]] = node[1]
                else:
                    branch[rem[0]] = self._store(
                        [hex_prefix_encode(rem[1:], False), node[1]])
            else:  # common == len(nibbles) handled above
                raise AssertionError("unreachable")
        # remainder of new path
        prem = path[common:]
        if prem:
            branch[prem[0]] = self._store(
                [hex_prefix_encode(prem[1:], True), value])
        else:
            branch[16] = value
        if common:
            return [hex_prefix_encode(path[:common], False), self._store(branch)]
        return branch

    # --- remove -----------------------------------------------------------

    def remove(self, key: bytes) -> bool:
        new_root, changed = self._remove(self.root_node, bytes_to_nibbles(key))
        if changed:
            self.root_node = new_root
        return changed

    def _remove(self, node, path):
        if node == BLANK_NODE:
            return node, False
        kind = self._kind(node)
        if kind == "branch":
            if not path:
                if node[16] == b"":
                    return node, False
                node = list(node)
                node[16] = b""
                return self._normalize_branch(node), True
            sub = self._load(node[path[0]])
            new_sub, changed = self._remove(sub, path[1:])
            if not changed:
                return node, False
            node = list(node)
            node[path[0]] = self._store(new_sub)
            return self._normalize_branch(node), True
        nibbles, leaf = hex_prefix_decode(node[0])
        if leaf:
            return (BLANK_NODE, True) if nibbles == path else (node, False)
        if path[:len(nibbles)] != nibbles:
            return node, False
        new_sub, changed = self._remove(self._load(node[1]), path[len(nibbles):])
        if not changed:
            return node, False
        return self._merge_extension(nibbles, new_sub), True

    def _normalize_branch(self, branch):
        """Collapse a branch left with <2 occupied slots."""
        occupied = [i for i in range(16) if branch[i] != b""]
        has_value = branch[16] != b""
        if len(occupied) + (1 if has_value else 0) > 1:
            return branch
        if has_value:
            return [hex_prefix_encode([], True), branch[16]]
        if not occupied:
            return BLANK_NODE
        i = occupied[0]
        sub = self._load(branch[i])
        return self._merge_extension([i], sub)

    def _merge_extension(self, prefix_nibbles, sub):
        """Prepend prefix_nibbles to sub (collapsing chains)."""
        if sub == BLANK_NODE:
            return BLANK_NODE
        kind = self._kind(sub)
        if kind == "branch":
            if not prefix_nibbles:
                return sub
            return [hex_prefix_encode(prefix_nibbles, False), self._store(sub)]
        nibbles, leaf = hex_prefix_decode(sub[0])
        return [hex_prefix_encode(prefix_nibbles + nibbles, leaf), sub[1]]

    # --- iteration / export ----------------------------------------------

    def to_dict(self) -> dict[bytes, bytes]:
        out = {}
        self._walk(self.root_node, [], out)
        return out

    def _walk(self, node, path, out):
        if node == BLANK_NODE:
            return
        kind = self._kind(node)
        if kind == "branch":
            if node[16] != b"":
                out[self._nibbles_to_bytes(path)] = node[16]
            for i in range(16):
                if node[i] != b"":
                    self._walk(self._load(node[i]), path + [i], out)
            return
        nibbles, leaf = hex_prefix_decode(node[0])
        if leaf:
            out[self._nibbles_to_bytes(path + nibbles)] = node[1]
        else:
            self._walk(self._load(node[1]), path + nibbles, out)

    @staticmethod
    def _nibbles_to_bytes(nibbles) -> bytes:
        assert len(nibbles) % 2 == 0
        return bytes((nibbles[i] << 4) | nibbles[i + 1]
                     for i in range(0, len(nibbles), 2))

    # --- proofs (ref pruning_state.py:105-123) ----------------------------

    def produce_proof(self, key: bytes) -> list[bytes]:
        """RLP-encoded nodes along the path of `key` (root first)."""
        self._resolve_dirty()           # _prove encodes nodes directly
        proof: list[bytes] = []
        self._prove(self.root_node, bytes_to_nibbles(key), proof, True)
        return proof

    def _prove(self, node, path, proof, is_root):
        if node == BLANK_NODE:
            return
        enc = rlp.encode(node)
        if is_root or len(enc) >= 32:
            proof.append(enc)
        kind = self._kind(node)
        if kind == "branch":
            if path:
                self._prove(self._load(node[path[0]]), path[1:], proof, False)
            return
        nibbles, leaf = hex_prefix_decode(node[0])
        if not leaf and path[:len(nibbles)] == nibbles:
            self._prove(self._load(node[1]), path[len(nibbles):], proof, False)

    @staticmethod
    def verify_proof(root_hash: bytes, key: bytes, proof: list[bytes]):
        """-> (present: bool, value or None); raises on malformed proof."""
        db = KvMemory()
        for p in proof:
            db.put(sha3(p), p)
        try:
            trie = Trie(db, root_hash)
            value = trie.get(key)
        except KeyError as e:
            raise rlp.RlpError(f"incomplete proof: {e}")
        return (value is not None, value)
