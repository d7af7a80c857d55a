"""The plain reference against published vectors and against the port.

The port (`plenum_tpu_torch`) appears here only as a second witness; the
reference itself must load nothing of it, nor JAX, nor the JAX package.
"""
import hashlib
import json
import random
import subprocess
import sys

import msgpack
import pytest

from port_bench.reference import codec, ed25519, merkle, mpt, pool_check

# RFC 8032 section 7.1, tests 1-3: (secret, public, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8"
     "821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085a"
     "c1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff"
     "9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("secret,public,msg,sig", RFC8032)
def test_rfc8032_vectors(secret, public, msg, sig):
    secret, public, msg, sig = (bytes.fromhex(x) for x in
                                (secret, public, msg, sig))
    assert ed25519.public_key(secret) == public
    assert ed25519.sign(secret, msg) == sig
    assert ed25519.verify(public, msg, sig)
    assert not ed25519.verify(public, msg + b"x", sig)
    bad = bytearray(sig)
    bad[5] ^= 1
    assert not ed25519.verify(public, msg, bytes(bad))


def test_strict_verification_refuses_malleable_and_noncanonical():
    secret, public, msg, sig = (bytes.fromhex(x) for x in RFC8032[1])
    s = int.from_bytes(sig[32:], "little")
    twin = sig[:32] + (s + ed25519.L).to_bytes(32, "little")
    assert not ed25519.verify(public, msg, twin)       # S >= L
    # y = p + 1 encodes the same point as y = 1, non-canonically
    noncanon = (ed25519.P + 1).to_bytes(32, "little")
    assert ed25519.point_decompress(noncanon) is None
    assert not ed25519.verify(noncanon, msg, sig)
    assert not ed25519.verify(public[:31], msg, sig)


def test_ed25519_agrees_with_the_port_on_spoiled_items():
    from plenum_tpu_torch.crypto.ed25519 import make_verifier
    from port_bench.traffic import corpus
    bad = corpus.corrupted_indices(3, 64, 250)
    secret = b"reference-test".ljust(32, b"\0")
    vk = corpus.verkey_of(secret)
    items = [(codec.signing_bytes({k: v for k, v in req.items()
                                   if k != "signature"}),
              codec.b58decode(req["signature"]), vk)
             for req, _, _ in corpus.pool_slice(3, secret, 0, 64,
                                                frozenset(bad))]
    port = make_verifier("cpu").verify_batch(items)
    ref = [ed25519.verify(vk, m, s) for m, s, vk in items]
    assert list(port) == ref
    assert ref.count(False) == len(bad)


def test_merkle_root_rfc6962_and_the_port():
    from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
    assert merkle.root([]) == hashlib.sha256(b"").digest()
    assert merkle.root([b"a"]) == hashlib.sha256(b"\x00a").digest()
    two = hashlib.sha256(b"\x01" + hashlib.sha256(b"\x00a").digest()
                         + hashlib.sha256(b"\x00b").digest()).digest()
    assert merkle.root([b"a", b"b"]) == two
    rng = random.Random(5)
    for n in (1, 2, 3, 5, 8, 13, 100):
        leaves = [rng.randbytes(rng.randrange(1, 90)) for _ in range(n)]
        tree = CompactMerkleTree()
        tree.extend_batch(leaves)
        assert merkle.root(leaves) == tree.root_hash, n


def test_mpt_root_equals_the_port_trie():
    from plenum_tpu_torch.state.trie import Trie
    rng = random.Random(7)
    for n in (0, 1, 2, 3, 17, 300):
        kv = {rng.randbytes(rng.choice([1, 2, 22])):
              rng.randbytes(rng.choice([1, 5, 40])) for _ in range(n)}
        trie = Trie()
        for k, v in kv.items():
            trie.set(k, v)
        assert mpt.root(kv) == trie.root_hash, n


def test_codec_matches_msgpack_and_the_port():
    from plenum_tpu_torch.common.serialization import pack
    from plenum_tpu_torch.utils.base58 import b58encode
    objs = [{"b": 1, "a": [1, -5, 300, 70000, 2 ** 40, -2 ** 40, None, True,
                           False, 1.5, "x" * 40, b"y" * 300]},
            {"txn": {"data": {"dest": "d"}}, "txnMetadata": {"seqNo": 5}},
            list(range(20)), {str(i): i for i in range(20)}]
    for obj in objs:
        assert codec.packb(obj) == pack(obj)
        assert codec.unpackb(codec.packb(obj)) == msgpack.unpackb(
            pack(obj), raw=False)
    rng = random.Random(1)
    for n in (0, 1, 16, 32, 64):
        raw = bytes(2) + rng.randbytes(n)
        assert codec.b58encode(raw) == b58encode(raw)
        assert codec.b58decode(codec.b58encode(raw)) == raw
    payload = {"reqId": 1, "identifier": "x", "operation": {"b": 2, "a": 1}}
    assert codec.signing_bytes(payload) == json.dumps(
        payload, sort_keys=True, separators=(",", ":")).encode()


def test_request_digests_and_nym_state_equal_the_ports():
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import new_txn, set_seq_no, \
        set_txn_time
    from plenum_tpu_torch.execution.handlers.nym import NymHandler
    from port_bench.traffic import corpus
    reqs = corpus.pool_slice(11, b"t" * 32, 0, 6, frozenset({2}))
    txns = []
    for seq, (d, digest, _) in enumerate(reqs, start=1):
        r = Request(d["identifier"], d["reqId"], d["operation"],
                    signature=d["signature"])
        assert r.digest == digest
        txn = new_txn("1", {"dest": d["operation"]["dest"],
                            "verkey": d["operation"]["verkey"]}, r)
        set_seq_no(txn, seq)
        set_txn_time(txn, 1000 + seq)
        txns.append(txn)
        assert pool_check._matches(txn, d)
    from plenum_tpu_torch.state.pruning_state import PruningState

    class Db:
        def get_state(self, _):
            return state
    state = PruningState()
    handler = NymHandler(Db())
    for txn in txns:
        handler.update_state(txn, True)
    assert mpt.root(pool_check.nym_state(txns)) == state.head_hash


def test_the_reference_loads_no_jax_and_nothing_of_the_port():
    code = ("import sys, port_bench.reference.ed25519, "
            "port_bench.reference.merkle, port_bench.reference.mpt, "
            "port_bench.reference.codec, port_bench.reference.pool_check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    loaded = set(eval(proc.stdout))
    assert not loaded & {"jax", "jaxlib", "flax", "plenum_tpu",
                         "plenum_tpu_torch"}, loaded

