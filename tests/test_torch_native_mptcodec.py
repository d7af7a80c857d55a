"""The port's copy of tests/test_native_mptcodec.py, run on plenum_tpu_torch.

In-tree C++ MPT node codec (native/mptcodec.cpp): SHA3-256 and
flat-node RLP, differential-tested against hashlib and the pure-Python
twin. Deliberately NOT wired into the trie hot path: measured through
ctypes at single-node granularity it is ~2x slower than Python rlp +
hashlib sha3 (docs/performance.md "Future directions") — the native
win requires a batch-granularity API. The differential surface keeps
the codec honest until then."""
from __future__ import annotations

import hashlib
import random

import pytest

from plenum_tpu_torch.state import native_codec as nc
from plenum_tpu_torch.state import rlp

pytestmark = pytest.mark.skipif(not nc.available(),
                                reason="native toolchain unavailable")


def test_sha3_matches_hashlib_across_padding_boundaries():
    rng = random.Random(3)
    # rate = 136 bytes for SHA3-256: cover both sides of every boundary
    for n in (0, 1, 55, 56, 135, 136, 137, 271, 272, 273, 4096):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert nc.sha3_native(data) == hashlib.sha3_256(data).digest(), n


def test_flat_node_encode_hash_matches_python_twin():
    rng = random.Random(7)
    for trial in range(300):
        n_items = rng.choice([2, 17])
        node = []
        for _ in range(n_items):
            kind = rng.random()
            if kind < 0.3:
                node.append(b"")
            elif kind < 0.5:
                node.append(bytes([rng.randrange(256)]))  # 1-byte RLP case
            elif kind < 0.8:
                node.append(bytes(rng.randrange(256) for _ in range(32)))
            else:
                node.append(bytes(rng.randrange(256)
                                  for _ in range(rng.randrange(2, 90))))
        enc_py = rlp.encode(node)
        got = nc.encode_hash_flat(node)
        assert got is not None
        assert got[0] == enc_py, (trial, node)
        assert got[1] == hashlib.sha3_256(enc_py).digest()


def test_nested_children_defer_to_python():
    assert nc.encode_hash_flat([b"ab", [b"x", b"y"]]) is None


def test_long_item_prefix_encoding():
    # >55-byte items exercise the multi-byte length prefix
    node = [bytes(200), bytes(56), b"\x7f"]
    got = nc.encode_hash_flat(node)
    assert got is not None and got[0] == rlp.encode(node)


def test_batch_encode_hash_with_backrefs():
    """mptc_encode_hash_batch resolves child refs in-call: <32B children
    splice raw, >=32B children hash-ref — differentially checked against
    a pure-Python post-order resolution."""
    rng = random.Random(11)
    for trial in range(100):
        # build a random 3-node chain: leafish -> mid -> top, plus one
        # clean inline child spliced raw into mid
        leaf = [bytes([0x20 | rng.randrange(16)]),
                bytes(rng.randrange(256)
                      for _ in range(rng.choice([1, 8, 40])))]
        inline_child = [b"\x31", b"v"]
        prepared = [
            [(-1, leaf[0]), (-1, leaf[1])],
            [(-1, b"\x00\x12"), (0, b""), (-2, rlp.encode(inline_child))],
            [(-1, b"\x16"), (1, b"")],
        ]
        got = nc.encode_hash_many(prepared)
        assert got is not None
        # python twin: resolve bottom-up
        enc0 = rlp.encode(leaf)
        ref0 = leaf if len(enc0) < 32 \
            else hashlib.sha3_256(enc0).digest()
        mid = [b"\x00\x12", ref0, inline_child]
        enc1 = rlp.encode(mid)
        ref1 = mid if len(enc1) < 32 else hashlib.sha3_256(enc1).digest()
        top = [b"\x16", ref1]
        enc2 = rlp.encode(top)
        for i, enc in enumerate((enc0, enc1, enc2)):
            assert got[i][0] == enc, (trial, i)
            assert got[i][1] == hashlib.sha3_256(enc).digest()


def test_trie_native_and_python_resolution_agree(monkeypatch):
    """The deferred trie produces IDENTICAL roots/values/proofs whether
    the dirty set resolves through the native batch call or the
    pure-Python twin — across random set/remove batches."""
    from plenum_tpu_torch.state.pruning_state import PruningState

    rng = random.Random(23)
    ops = []
    live = {}
    for _ in range(400):
        k = bytes(rng.randrange(256) for _ in range(rng.choice([3, 8, 20])))
        if live and rng.random() < 0.25:
            k = rng.choice(list(live))
            ops.append(("del", k, None))
            live.pop(k)
        else:
            v = bytes(rng.randrange(1, 256)
                      for _ in range(rng.randrange(1, 120)))
            ops.append(("set", k, v))
            live[k] = v

    def run(native_on):
        st = PruningState()
        roots = []
        for i, (op, k, v) in enumerate(ops):
            if op == "set":
                st.set(k, v)
            else:
                st.remove(k)
            if i % 37 == 0:             # commit-batch boundaries
                roots.append(st.head_hash)
        st.commit()
        roots.append(st.committed_head_hash)
        return st, roots

    with monkeypatch.context() as m:
        m.setattr(nc, "available", lambda: False)
        st_py, roots_py = run(False)
    st_nat, roots_nat = run(True)
    assert roots_py == roots_nat
    for k, v in live.items():
        assert st_nat.get(k, committed=True) == v
        proof = st_nat.generate_state_proof(k)
        assert PruningState.verify_state_proof(
            st_nat.committed_head_hash, k, v, proof)
    gone = [k for op, k, _ in ops if op == "del" and k not in live]
    for k in gone[:10]:
        assert st_nat.get(k, committed=True) is None
