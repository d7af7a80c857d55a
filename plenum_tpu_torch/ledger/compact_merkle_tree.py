"""Append-only Merkle tree in the RFC-6962 (Certificate Transparency) shape.

Reference behavior: ledger/compact_merkle_tree.py:13 + merkle_verifier.py —
incremental appends keeping O(log n) frontier peaks, inclusion (audit) proofs,
and consistency proofs between two tree sizes. Tree recovery from the hash
store on restart (ref ledger/ledger.py:70-113).

The tree hash of leaves D[0:n] follows the spec recursion: split at the largest
power of two k < n, MTH(D) = H(0x01 || MTH(D[0:k]) || MTH(D[k:n])); the peaks
list is that recursion's right spine.

`extend_batch` is the device entry point: leaf hashes for a whole 3PC batch are
computed in one device call, and each interior level's new nodes in one more
(SURVEY.md §2.1 "vectorized SHA-256 Merkle appends").

The tree keeps its latest append wave: every leaf and interior hash the last
extend computed, keyed (level, index). `inclusion_proofs` builds a committed
batch's audit paths in one pass from it, so the hash store is read only for
nodes older than the wave; `proof_reads` counts those reads.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .hash_store import HashStore
from .tree_hasher import TreeHasher


def _largest_pow2_below(n: int) -> int:
    assert n >= 2
    return 1 << ((n - 1).bit_length() - 1)


class CompactMerkleTree:
    def __init__(self, hasher: Optional[TreeHasher] = None,
                 hash_store: Optional[HashStore] = None):
        self.hasher = hasher or TreeHasher()
        self.hash_store = hash_store or HashStore()
        self.tree_size = 0
        # peaks[i] = root of a complete subtree; sizes strictly decreasing
        # powers of two summing to tree_size, leftmost first.
        self._peaks: list[bytes] = []
        # the latest append wave, (level, index) -> hash: every leaf and
        # interior node the last extend computed; each extend replaces it
        self._wave: dict[tuple[int, int], bytes] = {}
        # hash-store reads made while building audit paths
        self.proof_reads = 0

    # --- appends ----------------------------------------------------------

    def append(self, leaf: bytes) -> None:
        self.extend_batch([leaf])

    def append_hash(self, leaf_hash: bytes) -> None:
        self._extend_hashes([leaf_hash])

    def extend_batch(self, leaves: Sequence[bytes]) -> None:
        """Append many leaves; leaf hashing is one batched hasher call."""
        if not leaves:
            return
        self._extend_hashes(self.hasher.hash_leaves(list(leaves)))

    def _extend_hashes(self, leaf_hashes: list[bytes]) -> None:
        store = self.hash_store
        base = self.tree_size
        wave: dict[tuple[int, int], bytes] = {}
        for i, h in enumerate(leaf_hashes):
            store.put_leaf(base + i, h)
            wave[(0, base + i)] = h
        # Level-by-level: nodes of level k+1 whose children (level k) are now
        # all present. One batched hash call per level — the device path.
        level = 0
        level_start = base          # first index at this level that is new
        level_count = base + len(leaf_hashes)   # total nodes at this level
        get = self._level_hash
        new_at_level: dict[int, bytes] = {i: h for i, h in
                                          zip(range(base, level_count), leaf_hashes)}
        # Fused wave (MTU-style): a hasher advertising hash_wave_levels
        # computes ALL wide interior levels in ONE device program — the
        # per-level host hops below then only run for the narrow top-of-
        # tree spine (<=1 new node per level) the fused program leaves.
        fused = getattr(self.hasher, "hash_wave_levels", None)
        if fused is not None and len(leaf_hashes) >= 2:
            state = self._extend_fused(fused, level, level_start,
                                       level_count, new_at_level, wave)
            if state is not None:
                level, level_start, level_count, new_at_level = state
        while level_count >= 2:
            parent_first = level_start // 2
            parent_count = level_count // 2
            pairs = []
            idxs = []
            for pi in range(parent_first, parent_count):
                if self.hash_store.try_get_node(level + 1, pi) is not None:
                    continue
                l = new_at_level.get(2 * pi) or get(level, 2 * pi)
                r = new_at_level.get(2 * pi + 1) or get(level, 2 * pi + 1)
                pairs.append((l, r))
                idxs.append(pi)
            parents = self.hasher.hash_children_batch(pairs) if pairs else []
            new_parent: dict[int, bytes] = {}
            for pi, h in zip(idxs, parents):
                store.put_node(level + 1, pi, h)
                new_parent[pi] = h
                wave[(level + 1, pi)] = h
            level += 1
            level_start = parent_first
            level_count = parent_count
            new_at_level = new_parent
        self.tree_size += len(leaf_hashes)
        self._wave = wave
        self._peaks = self._compute_peaks(self.tree_size, base)

    def _extend_fused(self, fused, level, level_start, level_count,
                      new_at_level, wave):
        """Run the wide levels of one append wave through the hasher's
        fused device program; -> the per-level loop's continuation state,
        or None when the fused path declines (small wave / missing
        boundary / already-stored parent) and the loop runs from scratch.

        The metadata mirrors the loop exactly: a wave's new nodes are a
        contiguous suffix [level_start, level_count) per level, so at most
        one OLD node (the left boundary at level_start-1, present iff
        level_start is odd) joins each level's pairing, and the count of
        parents formed is (level_count//2) - (level_start//2)."""
        store = self.hash_store
        new_hashes = [new_at_level[i]
                      for i in range(level_start, level_count)]
        bounds, offs, counts = [], [], []
        starts = []                # level_start per fused level
        ls, cnt, m = level_start, level_count, len(new_hashes)
        while m >= 2 and cnt >= 2:
            parent_first = ls // 2
            parent_count = cnt // 2
            p = parent_count - parent_first
            if p <= 0:
                break
            if store.try_get_node(level + len(counts) + 1,
                                  parent_first) is not None:
                return None        # overlap with stored nodes: slow path
            off = ls & 1
            bound = None
            if off:
                try:
                    bound = self._level_hash(level + len(counts), ls - 1)
                except KeyError:
                    return None    # boundary missing: slow path
            starts.append(parent_first)
            bounds.append(bound)
            offs.append(off)
            counts.append(p)
            ls, cnt, m = parent_first, parent_count, p
        if not counts:
            return None
        got = fused(new_hashes, bounds, offs, counts)
        if got is None:
            return None            # hasher declined (below its threshold)
        out_level = level
        new_parent: dict[int, bytes] = new_at_level
        ls2, cnt2 = level_start, level_count
        for l, parents in enumerate(got):
            new_parent = {}
            for j, h in enumerate(parents):
                store.put_node(out_level + 1, starts[l] + j, h)
                new_parent[starts[l] + j] = h
                wave[(out_level + 1, starts[l] + j)] = h
            out_level += 1
            ls2, cnt2 = starts[l], cnt2 // 2
        return out_level, ls2, cnt2, new_parent

    def _level_hash(self, level: int, idx: int) -> bytes:
        """Node (level, idx) for an extend: a peak of the current size from
        the peaks list (the one old node each level of a wave pairs with,
        its left boundary, always is one), else the store's."""
        above = self.tree_size >> level
        if above & 1 and idx == above - 1:
            return self._peaks[bin(above >> 1).count("1")]
        h = self._stored(level, idx)
        if h is None:
            raise KeyError((level, idx))
        return h

    def _stored(self, level: int, idx: int) -> Optional[bytes]:
        if level == 0:
            return self.hash_store.get_leaf(idx)
        return self.hash_store.try_get_node(level, idx)

    def _range_root(self, lo: int, hi: int, memo=None) -> bytes:
        """MTH of leaves [lo, hi): complete aligned subtrees from the wave,
        else the store, recursing on the (right-edge) incomplete ranges.
        With `memo`, one proof-building call's (lo, hi) -> hash, each range
        is resolved once and each hash-store read counts in
        `proof_reads`."""
        if memo is not None:
            h = memo.get((lo, hi))
            if h is not None:
                return h
        n = hi - lo
        assert n >= 1
        h = None
        if n & (n - 1) == 0 and lo % n == 0:
            level = n.bit_length() - 1
            h = self._wave.get((level, lo >> level))
            if h is None:
                if memo is not None:
                    self.proof_reads += 1
                h = self._stored(level, lo >> level)
        if h is None:
            k = _largest_pow2_below(n)
            h = self.hasher.hash_children(self._range_root(lo, lo + k, memo),
                                          self._range_root(lo + k, hi, memo))
        if memo is not None:
            memo[(lo, hi)] = h
        return h

    def _compute_peaks(self, size: int, old_size: int = 0) -> list[bytes]:
        """The size-`size` tree's peaks. Those within the first `old_size`
        leaves are the current peaks of that size, which the two sizes'
        binary forms share; the rest come from the wave first."""
        peaks, lo = [], 0
        while size > 0:
            p = 1 << (size.bit_length() - 1)
            peaks.append(self._peaks[len(peaks)] if lo + p <= old_size
                         else self._range_root(lo, lo + p))
            lo += p
            size -= p
        return peaks

    # --- roots and proofs -------------------------------------------------

    @property
    def root_hash(self) -> bytes:
        if self.tree_size == 0:
            return self.hasher.hash_empty()
        root = self._peaks[-1]
        for peak in reversed(self._peaks[:-1]):
            root = self.hasher.hash_children(peak, root)
        return root

    def merkle_tree_hash(self, lo: int, hi: int) -> bytes:
        if lo == hi == 0:
            return self.hasher.hash_empty()
        return self._range_root(lo, hi)

    def inclusion_proof(self, m: int, n: Optional[int] = None) -> list[bytes]:
        """Audit path for leaf index m (0-based) in the size-n tree
        (RFC 6962 §2.1.1 PATH(m, D[n]))."""
        n = self.tree_size if n is None else n
        if not (0 <= m < n <= self.tree_size):
            raise ValueError(f"leaf {m} out of range for size {n} "
                             f"(tree has {self.tree_size})")
        return self.inclusion_proofs(m, m + 1, n)[0]

    def inclusion_proofs(self, first: int, last: int,
                         n: Optional[int] = None) -> list[list[bytes]]:
        """Audit paths of leaves [first, last) in the size-n tree, each
        equal to inclusion_proof(m, n), in one pass: a walk down the RFC's
        recursion into the subtrees that hold those leaves, each sibling
        root resolved once (from the wave, for a batch just appended) and
        shared by every path below it."""
        n = self.tree_size if n is None else n
        if not (0 <= first <= last <= n <= self.tree_size):
            raise ValueError(f"leaves {first}..{last} out of range for size "
                             f"{n} (tree has {self.tree_size})")
        memo: dict[tuple[int, int], bytes] = {}
        root = self._range_root
        paths: list[list[bytes]] = []

        def walk(lo: int, hi: int, above: list[bytes]) -> None:
            if hi - lo == 1:
                paths.append(above)
                return
            k = lo + _largest_pow2_below(hi - lo)
            if first < k:
                walk(lo, k, [root(k, hi, memo)] + above)
            if last > k:
                walk(k, hi, [root(lo, k, memo)] + above)
        if first < last:
            walk(0, n, [])
        return paths

    def consistency_proof(self, m: int, n: Optional[int] = None) -> list[bytes]:
        """PROOF(m, D[n]) that the size-m tree is a prefix of the size-n tree
        (RFC 6962 §2.1.2)."""
        n = self.tree_size if n is None else n
        if not (0 < m <= n <= self.tree_size):
            raise ValueError(f"bad consistency range {m}..{n} "
                             f"(tree has {self.tree_size})")
        if m == n:
            return []
        return self._subproof(m, 0, n, True)

    def _subproof(self, m: int, lo: int, hi: int, b: bool) -> list[bytes]:
        n = hi - lo
        if m == n:
            return [] if b else [self._range_root(lo, hi)]
        k = _largest_pow2_below(n)
        if m <= k:
            return self._subproof(m, lo, lo + k, b) + [self._range_root(lo + k, hi)]
        return (self._subproof(m - k, lo + k, hi, False)
                + [self._range_root(lo, lo + k)])

    def fork(self) -> "CompactMerkleTree":
        """Copy-on-write fork: shares committed hashes, stages new ones in
        memory. The uncommitted-root path of 3PC batching."""
        from .hash_store import OverlayHashStore
        t = CompactMerkleTree(self.hasher, OverlayHashStore(self.hash_store))
        t.tree_size = self.tree_size
        t._peaks = list(self._peaks)
        return t

    # --- recovery (ref ledger.py:70-113) ----------------------------------

    @classmethod
    def recover(cls, hasher: TreeHasher, hash_store: HashStore) -> "CompactMerkleTree":
        tree = cls(hasher, hash_store)
        size = hash_store.leaf_count
        tree.tree_size = size
        tree._peaks = tree._compute_peaks(size) if size else []
        return tree
