"""The port's copy of tests/test_ledger.py, run on plenum_tpu_torch; roots
and proofs are also held to the reference's on the same inputs, and
the device-hasher case runs the port's plain versions.

Merkle tree / ledger tests: RFC-6962 known-answer vectors, property tests
against a naive reference tree, proofs, recovery, uncommitted staging."""
import hashlib

import pytest

pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st

from plenum_tpu_torch.ledger.tree_hasher import TreeHasher, make_tree_hasher
from plenum_tpu_torch.ledger.hash_store import HashStore
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.storage.kv_file import KvFile
from plenum_tpu_torch.storage.kv_memory import KvMemory


H = TreeHasher()


def naive_mth(leaves):
    """Straight RFC 6962 §2.1 recursion, the independent reference."""
    n = len(leaves)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return hashlib.sha256(b"\x00" + leaves[0]).digest()
    k = 1
    while k * 2 < n:
        k *= 2
    return hashlib.sha256(b"\x01" + naive_mth(leaves[:k]) + naive_mth(leaves[k:])).digest()


def _ref_tree(leaves):
    """The reference's tree over the same leaves."""
    from plenum_tpu.ledger.compact_merkle_tree import \
        CompactMerkleTree as RefTree
    t = RefTree()
    t.extend_batch(leaves)
    return t


# --- RFC 6962 known-answer tests (vectors from the RFC's example tree) ----

def test_empty_tree_root():
    t = CompactMerkleTree()
    assert t.root_hash == hashlib.sha256(b"").digest()
    assert t.root_hash.hex().startswith("e3b0c442")


def test_single_leaf():
    t = CompactMerkleTree()
    t.append(b"")
    # RFC 6962: MTH({d(0)}) = SHA-256(00 ||) = 6e34...
    assert t.root_hash.hex().startswith("6e340b9c")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 33, 100])
def test_root_matches_naive(n):
    leaves = [bytes([i]) * (i % 7 + 1) for i in range(n)]
    t = CompactMerkleTree()
    for l in leaves:
        t.append(l)
    assert t.root_hash == naive_mth(leaves)
    assert t.root_hash == _ref_tree(leaves).root_hash


def test_batch_extend_equals_sequential():
    leaves = [b"txn%d" % i for i in range(57)]
    t1 = CompactMerkleTree()
    for l in leaves:
        t1.append(l)
    t2 = CompactMerkleTree()
    t2.extend_batch(leaves[:13])
    t2.extend_batch(leaves[13:40])
    t2.extend_batch(leaves[40:])
    assert t1.root_hash == t2.root_hash
    assert t1.tree_size == t2.tree_size == 57


@settings(max_examples=30, deadline=None)
@given(st.lists(st.binary(min_size=0, max_size=40), min_size=1, max_size=64),
       st.data())
def test_inclusion_proofs_property(leaves, data):
    t = CompactMerkleTree()
    t.extend_batch(leaves)
    v = MerkleVerifier()
    root = t.root_hash
    m = data.draw(st.integers(min_value=0, max_value=len(leaves) - 1))
    path = t.inclusion_proof(m)
    assert v.verify_inclusion(leaves[m], m, len(leaves), path, root)
    assert path == _ref_tree(leaves).inclusion_proof(m)
    # tampered leaf must fail
    assert not v.verify_inclusion(leaves[m] + b"x", m, len(leaves), path, root)
    # wrong index must fail (unless hash-collision-equivalent position)
    if len(leaves) > 1:
        wrong = (m + 1) % len(leaves)
        assert not v.verify_inclusion(leaves[m], wrong, len(leaves), path, root) or \
            leaves[wrong] == leaves[m]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.binary(min_size=0, max_size=20), min_size=1, max_size=64),
       st.data())
def test_consistency_proofs_property(leaves, data):
    t = CompactMerkleTree()
    v = MerkleVerifier()
    m = data.draw(st.integers(min_value=1, max_value=len(leaves)))
    t.extend_batch(leaves[:m])
    old_root = t.root_hash
    t.extend_batch(leaves[m:])
    new_root = t.root_hash
    proof = t.consistency_proof(m, len(leaves))
    assert v.verify_consistency(m, len(leaves), old_root, new_root, proof)
    assert proof == _ref_tree(leaves).consistency_proof(m, len(leaves))
    if m < len(leaves):
        assert not v.verify_consistency(m, len(leaves), old_root,
                                        hashlib.sha256(b"evil").digest(), proof)


def test_inclusion_proof_historic_size():
    leaves = [b"L%d" % i for i in range(20)]
    t = CompactMerkleTree()
    t.extend_batch(leaves)
    v = MerkleVerifier()
    # proof of leaf 3 in the historic size-10 tree
    t10 = CompactMerkleTree()
    t10.extend_batch(leaves[:10])
    path = t.inclusion_proof(3, 10)
    assert v.verify_inclusion(leaves[3], 3, 10, path, t10.root_hash)
    assert path == _ref_tree(leaves).inclusion_proof(3, 10)


def test_tree_recovery_from_hash_store():
    store = HashStore(KvMemory())
    t = CompactMerkleTree(hash_store=store)
    leaves = [b"x%d" % i for i in range(37)]
    t.extend_batch(leaves)
    root = t.root_hash
    t2 = CompactMerkleTree.recover(TreeHasher(), store)
    assert t2.tree_size == 37
    assert t2.root_hash == root
    t2.append(b"more")
    assert t2.tree_size == 38


def test_torch_tree_hasher_matches_cpu():
    """The reference's device-hasher case on the port's plain versions
    (batches of 2 and up go through them), the root also held to the
    reference's hashlib tree."""
    from plenum_tpu.ledger.compact_merkle_tree import \
        CompactMerkleTree as RefTree
    from plenum_tpu.ledger.tree_hasher import TreeHasher as RefHasher
    leaves = [b"leaf%d" % i for i in range(32)]
    cpu, dev = make_tree_hasher("cpu"), make_tree_hasher("torch", min_batch=2,
                                                         fuse_min=2)
    assert dev.hash_leaves(leaves) == cpu.hash_leaves(leaves)
    pairs = [(hashlib.sha256(b"%d" % i).digest(),
              hashlib.sha256(b"r%d" % i).digest()) for i in range(17)]
    assert dev.hash_children_batch(pairs) == cpu.hash_children_batch(pairs)
    t1, t2 = CompactMerkleTree(cpu), CompactMerkleTree(dev)
    t1.extend_batch(leaves)
    t2.extend_batch(leaves)
    assert t1.root_hash == t2.root_hash
    t3 = RefTree(RefHasher())
    t3.extend_batch(leaves)
    assert t2.root_hash == t3.root_hash


# --- Ledger ---------------------------------------------------------------

def _txn(i):
    return {"txn": {"type": "1", "data": {"i": i}},
            "txnMetadata": {"seqNo": i + 1}}


def test_ledger_append_and_read(tdir):
    l = Ledger()
    infos = l.append_batch([_txn(i) for i in range(10)])
    assert l.size == 10
    assert infos[0]["seqNo"] == 1 and infos[9]["seqNo"] == 10
    assert l.get_by_seq_no(5)["txnMetadata"]["seqNo"] == 5
    v = MerkleVerifier()
    from plenum_tpu_torch.ledger.ledger import txn_to_leaf
    info = l.merkle_info(5)
    assert v.verify_inclusion(txn_to_leaf(l.get_by_seq_no(5)), 4, 10,
                              [bytes.fromhex(h) for h in info["auditPath"]],
                              bytes.fromhex(info["rootHash"]))
    from plenum_tpu.ledger.ledger import Ledger as RefLedger
    ref = RefLedger()
    assert ref.append_batch([_txn(i) for i in range(10)]) == infos
    assert ref.merkle_info(5) == info and ref.root_hash == l.root_hash


def test_ledger_genesis():
    genesis = [_txn(0), _txn(1)]
    l = Ledger(genesis_txns=genesis)
    assert l.size == 2


def test_ledger_uncommitted_staging():
    l = Ledger(genesis_txns=[_txn(0)])
    committed_root = l.root_hash
    root1, size1 = l.append_txns_to_uncommitted([_txn(1), _txn(2)])
    assert size1 == 3 and root1 != committed_root
    assert l.root_hash == committed_root          # committed untouched
    root2, size2 = l.append_txns_to_uncommitted([_txn(3)])
    assert size2 == 4
    # revert last batch
    l.discard_txns(1)
    assert l.uncommitted_size == 3
    assert l.uncommitted_root_hash == root1
    # commit the rest
    txns, infos = l.commit_txns(2)
    assert l.size == 3 and l.root_hash == root1
    assert [i["seqNo"] for i in infos] == [2, 3]
    from plenum_tpu.ledger.ledger import Ledger as RefLedger
    ref = RefLedger(genesis_txns=[_txn(0)])
    assert ref.append_txns_to_uncommitted([_txn(1), _txn(2)]) == \
        (root1, size1)
    assert ref.commit_txns(2)[1] == infos


def test_ledger_uncommitted_root_matches_direct_append():
    l1 = Ledger(genesis_txns=[_txn(0)])
    l1.append_txns_to_uncommitted([_txn(i) for i in range(1, 8)])
    l2 = Ledger(genesis_txns=[_txn(0)])
    l2.append_batch([_txn(i) for i in range(1, 8)])
    assert l1.uncommitted_root_hash == l2.root_hash


def test_ledger_durable_recovery(tdir):
    log = KvFile(tdir + "/log", "txns")
    store = HashStore(KvFile(tdir + "/hs", "hashes"))
    l = Ledger(CompactMerkleTree(hash_store=store), log)
    l.append_batch([_txn(i) for i in range(25)])
    root = l.root_hash
    l.close()
    log2 = KvFile(tdir + "/log", "txns")
    store2 = HashStore(KvFile(tdir + "/hs", "hashes"))
    l2 = Ledger(CompactMerkleTree.recover(TreeHasher(), store2), log2)
    assert l2.size == 25 and l2.root_hash == root
    l2.close()


def test_ledger_recovery_hash_store_lagging(tdir):
    """Txn log ahead of hash store (crash between log write and tree write):
    replay the tail."""
    log = KvFile(tdir + "/log", "txns")
    l = Ledger(CompactMerkleTree(hash_store=HashStore(KvMemory())), log)
    l.append_batch([_txn(i) for i in range(10)])
    root = l.root_hash
    l._log.close()
    # reopen with EMPTY (memory) hash store: full rebuild path
    log2 = KvFile(tdir + "/log", "txns")
    l2 = Ledger(CompactMerkleTree(hash_store=HashStore(KvMemory())), log2)
    assert l2.size == 10 and l2.root_hash == root


def test_fresh_tree_over_persisted_store_recovers(tdir):
    """Review finding: Ledger must recover even when handed a non-recovered
    tree over a persisted hash store."""
    log = KvFile(tdir + "/log", "txns")
    store_kv = KvFile(tdir + "/hs", "hashes")
    l = Ledger(CompactMerkleTree(hash_store=HashStore(store_kv)), log)
    l.append_batch([_txn(i) for i in range(5)])
    root = l.root_hash
    l.close()
    # reopen with a FRESH tree (not CompactMerkleTree.recover)
    l2 = Ledger(CompactMerkleTree(hash_store=HashStore(KvFile(tdir + "/hs", "hashes"))),
                KvFile(tdir + "/log", "txns"))
    assert l2.size == 5
    assert l2.root_hash == root
    assert l2.merkle_info(1)["seqNo"] == 1
    l2.close()


def test_proof_range_errors_are_value_errors():
    t = CompactMerkleTree()
    t.append(b"x")
    with pytest.raises(ValueError):
        t.inclusion_proof(5)
    with pytest.raises(ValueError):
        t.consistency_proof(0, 1)
    l = Ledger()
    with pytest.raises(ValueError):
        l.commit_txns(3)
    with pytest.raises(ValueError):
        l.discard_txns(1)


# --- a committed batch's audit paths, built in one pass ---------------------

# (txns in the ledger before the batch, the batch sizes committed in turn)
_BATCHES = {
    "1_on_empty": (0, [1]),
    "2_on_empty": (0, [2]),
    "3_on_empty": (0, [3]),
    "118_on_empty": (0, [118]),
    "1000_on_empty": (0, [1000]),
    "3_across_128": (126, [3]),
    "118_across_1024": (1000, [118]),
    "to_256_then_past": (254, [2, 1, 3]),
    "118_after_118s": (0, [118, 118, 118]),
}


def _hasher(kind):
    if kind == "hashlib":
        return TreeHasher()
    # the plain versions, every wave of two or more through the fused
    # path; `fused` counts the waves it hashed
    h = make_tree_hasher("torch", min_batch=2, fuse_min=2)
    wave_levels, h.fused = h.hash_wave_levels, 0

    def counted(*args):
        got = wave_levels(*args)
        h.fused += got is not None
        return got
    h.hash_wave_levels = counted
    return h


def _check_infos(ledger, infos, first_seq_no, txns):
    """infos are merkle_info's for each txn, byte for byte, and verify."""
    from plenum_tpu_torch.ledger.ledger import txn_to_leaf
    v = MerkleVerifier()
    assert infos == [ledger.merkle_info(first_seq_no + i)
                     for i in range(len(txns))]
    for i, (info, txn) in enumerate(zip(infos, txns)):
        assert list(info) == ["seqNo", "rootHash", "auditPath", "treeSize"]
        assert info["rootHash"] == ledger.root_hash.hex()
        assert info["treeSize"] == ledger.size
        assert v.verify_inclusion(
            txn_to_leaf(txn), first_seq_no + i - 1, ledger.size,
            [bytes.fromhex(h) for h in info["auditPath"]],
            ledger.root_hash)


@pytest.mark.parametrize("hasher", ["hashlib", "torch"])
@pytest.mark.parametrize("case", sorted(_BATCHES))
def test_a_batchs_infos_equal_per_leaf_merkle_info(case, hasher):
    """append_batch and commit_txns return, for every txn, what
    merkle_info gives, from paths built in one pass over the wave; each
    also equals the reference's append_batch on the same txns."""
    from plenum_tpu.ledger.ledger import Ledger as RefLedger
    before, sizes = _BATCHES[case]
    prefix = [_txn(i) for i in range(before)]
    appended = Ledger(CompactMerkleTree(_hasher(hasher)))
    staged = Ledger(CompactMerkleTree(_hasher(hasher)))
    ref = RefLedger()
    for l in (appended, staged, ref):
        if prefix:
            l.append_batch(prefix)
    seq_no = before
    for size in sizes:
        txns = [_txn(seq_no + i) for i in range(size)]
        fused = getattr(appended.tree.hasher, "fused", 0)
        infos = appended.append_batch(txns)
        staged.append_txns_to_uncommitted(txns)
        committed, staged_infos = staged.commit_txns(size)
        assert committed == txns and staged_infos == infos
        _check_infos(appended, infos, seq_no + 1, txns)
        # the wave: every leaf of the batch, and with two or more leaves
        # the interior nodes the extend (fused or level by level) stored
        wave = appended.tree._wave
        assert {i for lv, i in wave if lv == 0} == \
            set(range(seq_no, seq_no + size))
        assert (size >= 2) == any(lv > 0 for lv, _ in wave)
        if hasher == "torch":
            assert appended.tree.hasher.fused - fused == (size >= 2)
        assert ref.append_batch(txns) == infos
        seq_no += size
    assert appended.root_hash == staged.root_hash == ref.root_hash


@pytest.mark.parametrize("hasher", ["hashlib", "torch"])
def test_the_first_batch_after_recovery_has_no_wave_to_read(tdir, hasher):
    """A tree recovered from a persisted store starts with an empty wave:
    its first batch's paths read the older nodes from the store."""
    from plenum_tpu.ledger.ledger import Ledger as RefLedger
    prefix = [_txn(i) for i in range(130)]
    l = Ledger(CompactMerkleTree(hash_store=HashStore(
        KvFile(tdir + "/hs", "hashes"))), KvFile(tdir + "/log", "txns"))
    l.append_batch(prefix)
    l.close()
    l2 = Ledger(CompactMerkleTree.recover(
        _hasher(hasher), HashStore(KvFile(tdir + "/hs", "hashes"))),
        KvFile(tdir + "/log", "txns"))
    assert l2.size == 130 and l2.tree._wave == {}
    txns = [_txn(130 + i) for i in range(118)]
    l2.append_txns_to_uncommitted(txns)
    _, infos = l2.commit_txns(118)
    _check_infos(l2, infos, 131, txns)
    assert l2.tree.proof_reads > 0
    ref = RefLedger()
    ref.append_batch(prefix)
    assert ref.append_batch(txns) == infos
    l2.close()


def test_the_wave_holds_the_latest_extend_alone(tdir):
    """Each extend replaces the wave; a fork, a recovered tree and a tree
    rebuilt over a reset store start without one."""
    t = CompactMerkleTree()
    t.extend_batch([b"a%d" % i for i in range(5)])
    t.extend_batch([b"b%d" % i for i in range(3)])
    assert {i for lv, i in t._wave if lv == 0} == {5, 6, 7}
    # leaves 5..7 complete nodes (1, 2), (1, 3), (2, 1) and (3, 0)
    assert set(t._wave) == {(0, 5), (0, 6), (0, 7), (1, 2), (1, 3), (2, 1),
                            (3, 0)}
    assert t.fork()._wave == {}
    assert CompactMerkleTree.recover(TreeHasher(), t.hash_store)._wave == {}
    # a hash store ahead of the log: the ledger resets it and rebuilds
    store = HashStore(KvMemory())
    l = Ledger(CompactMerkleTree(hash_store=store),
               KvFile(tdir + "/log", "txns"))
    l.append_batch([_txn(i) for i in range(6)])
    l._log.close()
    store.put_leaf(6, b"\0" * 32)          # a leaf the log never got
    l2 = Ledger(CompactMerkleTree(hash_store=store),
                KvFile(tdir + "/log", "txns"))
    assert l2.size == 6 and l2.root_hash == l.root_hash
    assert {i for lv, i in l2.tree._wave if lv == 0} == set(range(6))
    assert l2.merkle_info(6) == l.merkle_info(6)


class _CountingKv(KvMemory):
    """A KvMemory that counts its reads (try_get and has_key call get)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def get(self, key):
        self.reads += 1
        return super().get(key)


def test_a_batchs_infos_read_the_store_log_n_times():
    """The infos of a 118-txn batch committed on a ~30 k-leaf tree read the
    hash store at most 2 * ceil(log2 n) + 8 times (per-leaf paths over a
    tree with no wave read it ~1,500 times), and proof_reads counts each
    of those reads."""
    import math
    kv = _CountingKv()
    l = Ledger(CompactMerkleTree(hash_store=HashStore(kv)))
    size = 0
    while size < 30_000:
        l.append_batch([_txn(size + i) for i in range(1000)])
        size += 1000
    txns = [_txn(size + i) for i in range(118)]
    l.append_txns_to_uncommitted(txns)
    extend, at = l.tree.extend_batch, {}

    def extend_then_mark(leaves):
        extend(leaves)
        at["reads"], at["proof_reads"] = kv.reads, l.tree.proof_reads
    l.tree.extend_batch = extend_then_mark
    _, infos = l.commit_txns(118)
    n = l.size
    reads = kv.reads - at["reads"]
    assert 0 < reads <= 2 * math.ceil(math.log2(n)) + 8, reads
    assert l.tree.proof_reads - at["proof_reads"] == reads
    _check_infos(l, infos, size + 1, txns)
    # the same paths leaf by leaf over the same store, with no wave
    fresh = CompactMerkleTree.recover(TreeHasher(), l.tree.hash_store)
    r0 = kv.reads
    paths = [fresh.inclusion_proof(m) for m in range(size, n)]
    assert paths == [[bytes.fromhex(h) for h in i["auditPath"]]
                     for i in infos]
    assert kv.reads - r0 > 1000
    assert fresh.proof_reads == kv.reads - r0
