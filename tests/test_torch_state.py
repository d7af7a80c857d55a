"""The port's copy of tests/test_state.py, run on plenum_tpu_torch.

MPT state tests: RLP codec, trie vs dict model (property-based), known
Ethereum root vectors, proofs, commit/revert."""
import hashlib

import pytest

pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st

from plenum_tpu_torch.state import rlp
from plenum_tpu_torch.state.trie import (Trie, BLANK_ROOT, bytes_to_nibbles,
                                         hex_prefix_encode, hex_prefix_decode)
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.storage.kv_memory import KvMemory


# --- RLP ------------------------------------------------------------------

@pytest.mark.parametrize("item,expected", [
    (b"", b"\x80"),
    (b"\x00", b"\x00"),
    (b"\x7f", b"\x7f"),
    (b"\x80", b"\x81\x80"),
    (b"dog", b"\x83dog"),
    ([], b"\xc0"),
    ([b"cat", b"dog"], b"\xc8\x83cat\x83dog"),
    (b"a" * 55, b"\xb7" + b"a" * 55),
    (b"a" * 56, b"\xb8\x38" + b"a" * 56),
])
def test_rlp_known_vectors(item, expected):
    assert rlp.encode(item) == expected
    assert rlp.decode(expected) == (item if not isinstance(item, list) else item)


@settings(max_examples=50, deadline=None)
@given(st.recursive(st.binary(max_size=70),
                    lambda s: st.lists(s, max_size=6), max_leaves=20))
def test_rlp_roundtrip(item):
    assert rlp.decode(rlp.encode(item)) == item


def test_rlp_rejects_noncanonical():
    with pytest.raises(rlp.RlpError):
        rlp.decode(b"\x81\x05")        # single byte <0x80 must be bare
    with pytest.raises(rlp.RlpError):
        rlp.decode(b"\x83do")          # truncated
    with pytest.raises(rlp.RlpError):
        rlp.decode(b"\x83dogX")        # trailing


# --- hex-prefix -----------------------------------------------------------

@pytest.mark.parametrize("nibbles,leaf", [
    ([], False), ([], True), ([1], False), ([1], True),
    ([1, 2], False), ([1, 2, 3], True), (list(range(16)), True),
])
def test_hex_prefix_roundtrip(nibbles, leaf):
    assert hex_prefix_decode(hex_prefix_encode(nibbles, leaf)) == (nibbles, leaf)


# --- trie vs dict model ---------------------------------------------------

def test_empty_root_is_blank():
    t = Trie()
    assert t.root_hash == BLANK_ROOT
    assert t.root_hash == hashlib.sha3_256(rlp.encode(b"")).digest()


def test_ethereum_style_known_root():
    """Single key/value — root must be sha3(rlp([hp(path,leaf), value]))."""
    t = Trie()
    t.set(b"k", b"value")
    expected = hashlib.sha3_256(rlp.encode(
        [hex_prefix_encode(bytes_to_nibbles(b"k"), True), b"value"])).digest()
    assert t.root_hash == expected


@settings(max_examples=40, deadline=None)
@given(st.dictionaries(st.binary(min_size=0, max_size=8),
                       st.binary(min_size=1, max_size=16), max_size=40))
def test_trie_matches_dict(model):
    t = Trie()
    for k, v in model.items():
        t.set(k, v)
    for k, v in model.items():
        assert t.get(k) == v
    assert t.get(b"\xff" * 9) is None
    assert t.to_dict() == model


@settings(max_examples=30, deadline=None)
@given(st.dictionaries(st.binary(min_size=0, max_size=6),
                       st.binary(min_size=1, max_size=8), min_size=1, max_size=30),
       st.data())
def test_trie_insertion_order_independent(model, data):
    keys = list(model)
    perm = data.draw(st.permutations(keys))
    t1, t2 = Trie(), Trie()
    for k in keys:
        t1.set(k, model[k])
    for k in perm:
        t2.set(k, model[k])
    assert t1.root_hash == t2.root_hash


@settings(max_examples=30, deadline=None)
@given(st.dictionaries(st.binary(min_size=0, max_size=6),
                       st.binary(min_size=1, max_size=8), min_size=2, max_size=30),
       st.data())
def test_trie_remove(model, data):
    t = Trie()
    for k, v in model.items():
        t.set(k, v)
    victims = data.draw(st.lists(st.sampled_from(list(model)), unique=True,
                                 min_size=1, max_size=len(model)))
    for k in victims:
        assert t.remove(k)
        assert not t.remove(k)     # second remove is a no-op
    remaining = {k: v for k, v in model.items() if k not in victims}
    assert t.to_dict() == remaining
    # root equals a trie built from scratch with remaining keys
    t2 = Trie()
    for k, v in remaining.items():
        t2.set(k, v)
    assert t.root_hash == t2.root_hash


def test_trie_update_value():
    t = Trie()
    t.set(b"abc", b"1")
    r1 = t.root_hash
    t.set(b"abc", b"2")
    assert t.get(b"abc") == b"2"
    t.set(b"abc", b"1")
    assert t.root_hash == r1


# --- proofs ---------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.dictionaries(st.binary(min_size=1, max_size=6),
                       st.binary(min_size=1, max_size=40), min_size=1, max_size=25),
       st.data())
def test_state_proofs(model, data):
    t = Trie()
    for k, v in model.items():
        t.set(k, v)
    root = t.root_hash
    key = data.draw(st.sampled_from(list(model)))
    proof = t.produce_proof(key)
    present, value = Trie.verify_proof(root, key, proof)
    assert present and value == model[key]
    # absence proof for a key not in the model
    absent = b"\xfe" * 7
    proof2 = t.produce_proof(absent)
    present2, _ = Trie.verify_proof(root, absent, proof2)
    assert not present2


def test_proof_tampering_fails():
    t = Trie()
    for i in range(20):
        t.set(b"key%d" % i, b"val%d" % i)
    root = t.root_hash
    proof = t.produce_proof(b"key7")
    assert PruningState.verify_state_proof(root, b"key7", b"val7", proof)
    assert not PruningState.verify_state_proof(root, b"key7", b"valX", proof)
    assert not PruningState.verify_state_proof(root, b"key7", None, proof)
    # proof against a different root fails cleanly
    t.set(b"more", b"x")
    assert not PruningState.verify_state_proof(t.root_hash, b"key7", b"val7", [])


# --- PruningState commit/revert -------------------------------------------

def test_state_commit_revert_cycle():
    s = PruningState()
    s.set(b"a", b"1")
    s.commit()
    committed = s.committed_head_hash
    # stage uncommitted writes (3PC apply)
    s.set(b"b", b"2")
    s.set(b"a", b"1x")
    assert s.get(b"a", committed=False) == b"1x"
    assert s.get(b"a", committed=True) == b"1"
    assert s.get(b"b", committed=True) is None
    # revert (view change / reject)
    s.revert_to_head()
    assert s.head_hash == committed
    assert s.get(b"b", committed=False) is None
    # re-apply and commit
    s.set(b"b", b"2")
    s.commit()
    assert s.get(b"b", committed=True) == b"2"


def test_state_commit_explicit_root():
    """Commit an intermediate root (batch-by-batch commit of staged writes).

    With pipelined 3PC batches, later batches are applied on top of the one
    being committed — committing an earlier root must NOT rewind the
    uncommitted head (that would drop the in-flight writes)."""
    s = PruningState()
    s.set(b"x", b"1")
    r1 = s.head_hash
    s.set(b"y", b"2")
    r2 = s.head_hash
    s.commit(r1)
    assert s.committed_head_hash == r1
    assert s.get(b"y", committed=True) is None
    # head keeps the in-flight batch applied on top
    assert s.head_hash == r2
    assert s.get(b"y", committed=False) == b"2"
    # committing the head root later promotes it
    s.commit(r2)
    assert s.get(b"y", committed=True) == b"2"


def test_state_durable_reopen(tdir):
    from plenum_tpu_torch.storage.kv_file import KvFile
    db = KvFile(tdir, "state")
    s = PruningState(db)
    s.set(b"k1", b"v1")
    s.set(b"k2", b"v2")
    s.commit()
    root = s.committed_head_hash
    s.set(b"k3", b"uncommitted")
    s.close()
    db2 = KvFile(tdir, "state")
    s2 = PruningState(db2)
    assert s2.committed_head_hash == root
    assert s2.get(b"k1") == b"v1"
    assert s2.get(b"k3", committed=False) is None   # uncommitted lost on crash
    s2.close()


def test_historic_reads():
    s = PruningState()
    s.set(b"k", b"old")
    s.commit()
    r_old = s.committed_head_hash
    s.set(b"k", b"new")
    s.commit()
    assert s.get(b"k") == b"new"
    assert s.get_for_root(b"k", r_old) == b"old"
