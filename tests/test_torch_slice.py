"""Slice 1 of the port end to end against the JAX package: authenticate a
batch of signed requests, then stage, root and commit their txns on a
Merkle ledger. Verdicts, roots, merkle infos and proofs must be equal.

The port runs its "torch" backends (the kernels' plain versions on CPU
tensors) with thresholds low enough that every append wave reaches them;
the reference runs its default hashlib ledger and cpu verifier.
"""
import hashlib

import numpy as np
import pytest
import torch

from plenum_tpu.common.request import Request as RefRequest
from plenum_tpu.crypto.ed25519 import Ed25519Signer as RefSigner
from plenum_tpu.execution.txn import new_txn as ref_new_txn
from plenum_tpu.ledger.ledger import Ledger as RefLedger
from plenum_tpu.node.client_authn import (CoreAuthNr as RefAuthNr,
                                          ReqAuthenticator as RefReqAuth)
from plenum_tpu_torch import ops
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.convert import ledger_from_rows
from plenum_tpu_torch.crypto.ed25519 import (TorchEd25519Verifier,
                                             make_verifier)
from plenum_tpu_torch.execution.txn import NYM, new_txn
from plenum_tpu_torch.ledger.ledger import txn_to_leaf
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger import tree_hasher
from plenum_tpu_torch.ledger.tree_hasher import (TorchTreeHasher,
                                                 make_tree_hasher)
from plenum_tpu_torch.ops.sha256 import to_tensor
from plenum_tpu_torch.node.client_authn import CoreAuthNr, ReqAuthenticator
from plenum_tpu_torch.utils.base58 import b58decode, b58encode

# --- authentication ---------------------------------------------------------

_SIGNERS = [RefSigner(bytes([i + 7]) * 32) for i in range(6)]
_VERKEYS = {s.identifier: s.verkey_b58 for s in _SIGNERS}
# an abbreviated verkey: DID bytes || "~" + the rest of the key
_VERKEYS[_SIGNERS[5].identifier] = "~" + b58encode(_SIGNERS[5].verkey[16:])


def _request_specs():
    """Request kwargs (with signatures) built once, for both packages."""
    rng = np.random.default_rng(31)
    specs = []
    for i in range(14):
        s = _SIGNERS[i % 6]
        kw = dict(identifier=s.identifier, req_id=i + 1,
                  operation={"type": NYM, "dest": f"dest{i}",
                             "verkey": rng.bytes(8).hex()})
        payload = RefRequest(**kw).signing_bytes()
        sig = s.sign(payload)
        if i == 1:                       # one bit of the signature flipped
            b = bytearray(sig); b[int(rng.integers(64))] ^= 4; sig = bytes(b)
        if i == 2:                       # signed by another key
            sig = _SIGNERS[0].sign(payload)
        if i == 3:                       # S >= L
            sig = sig[:32] + (2**253).to_bytes(32, "little")
        if i == 4:                       # unsigned
            specs.append(kw)
            continue
        if i == 5:                       # unknown, non-self-certifying DID
            kw["identifier"] = "unknown-did"
        if i == 6:                       # operation changed after signing
            kw["operation"] = {**kw["operation"], "role": "0"}
        if i == 7:                       # endorsed: both signatures valid
            e = _SIGNERS[1]
            kw["endorser"] = e.identifier
            p2 = RefRequest(**kw).signing_bytes()
            kw["signatures"] = {s.identifier: s.sign_b58(p2),
                                e.identifier: e.sign_b58(p2)}
            specs.append(kw)
            continue
        if i == 8:                       # endorser named but not a signer
            kw["endorser"] = _SIGNERS[3].identifier
            sig = s.sign(RefRequest(**kw).signing_bytes())
        kw["signature"] = b58encode(sig)
        specs.append(kw)
    return specs


_SPECS = _request_specs()


def test_authenticate_batch_matches_reference():
    ref_auth = RefReqAuth()
    ref_auth.register_authenticator(RefAuthNr(get_verkey=_VERKEYS.get))
    ref_reqs = [RefRequest(**kw) for kw in _SPECS]
    want = ref_auth.authenticate_batch(ref_reqs)
    auth = ReqAuthenticator()
    auth.register_authenticator(
        CoreAuthNr(verifier=make_verifier("torch"), get_verkey=_VERKEYS.get))
    reqs = [Request(**kw) for kw in _SPECS]
    got = auth.authenticate_batch(reqs)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [i not in (1, 2, 3, 4, 5, 6, 8)
                            for i in range(len(_SPECS))]
    # the asynchronous seam gives the same verdicts
    tokens = auth.submit_batch(reqs)
    assert auth.collect_batch(tokens, wait=True).tolist() == got.tolist()
    assert auth.token_item_count(tokens) == \
        ref_auth.token_item_count(ref_auth.submit_batch(ref_reqs))


# --- the ledger, at every base alignment ------------------------------------

def _txns(start, n):
    return [new_txn(NYM, {"dest": f"d{start + i}", "role": "2"})
            for i in range(n)]


def _ref_ledger(n):
    ref = RefLedger()
    if n:
        ref.append_batch([ref_new_txn(NYM, t["txn"]["data"])
                          for t in _txns(0, n)])
    return ref


def _port_ledger(ref, min_batch=2):
    return ledger_from_rows(
        ref.txn_log.iterator(), ref.tree.hash_store.kv.iterator(),
        TorchTreeHasher(min_batch=min_batch, fuse_min=min_batch, device="cpu"))


@pytest.mark.parametrize("base", range(34))
def test_ledger_matches_reference_at_base(base):
    ref = _ref_ledger(base)
    port = _port_ledger(ref)
    assert port.size == base and port.root_hash == ref.root_hash
    wave = _txns(base, 3)
    assert port.append_txns_to_uncommitted(wave) == \
        ref.append_txns_to_uncommitted(wave)
    assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    _, infos = port.commit_txns(len(wave))
    _, ref_infos = ref.commit_txns(len(wave))
    assert infos == ref_infos
    n = port.size
    assert port.root_hash == ref.root_hash and n == base + 3
    for m in range(1, n):
        assert port.consistency_proof(m) == ref.consistency_proof(m)
    verifier = MerkleVerifier()
    for info, txn in zip(infos, wave):
        path = [bytes.fromhex(h) for h in info["auditPath"]]
        assert verifier.verify_inclusion(txn_to_leaf(txn), info["seqNo"] - 1,
                                         n, path, port.root_hash)


def _wave_hashlib(new_hashes, bounds, offs, counts):
    """An append wave's levels by hashlib: level l pairs its nodes from the
    old boundary on where offs[l] is 1, and keeps counts[l] parents."""
    cur, levels = list(new_hashes), []
    for l, count in enumerate(counts):
        seq = ([bounds[l]] if offs[l] else []) + cur
        cur = [hashlib.sha256(b"\x01" + seq[2 * i] + seq[2 * i + 1]).digest()
               for i in range(count)]
        levels.append(cur)
    return levels


@pytest.mark.parametrize("base", range(34))
def test_fused_wave_levels_match_hashlib_at_base(base, monkeypatch):
    """fused_wave_levels on the torch backend, as the ledger calls it for
    waves of 3 and 11 txns from every base alignment: one upload of the
    packed inputs, each level a slice of the flat output, every level's
    parents equal to hashlib's, and the ledger's root the reference's."""
    uploads = []

    def upload(words, device):
        uploads.append(words.shape)
        return to_tensor(words, device)

    monkeypatch.setattr(tree_hasher, "to_tensor", upload)
    waves = []

    class Spy(TorchTreeHasher):
        def hash_wave_levels(self, new_hashes, bounds, offs, counts):
            before = len(uploads)
            got = super().hash_wave_levels(new_hashes, bounds, offs, counts)
            depth = (max(2, len(new_hashes)) - 1).bit_length()
            assert len(uploads) == before + 1
            assert got == _wave_hashlib(new_hashes, bounds, offs,
                                        counts[:depth])
            waves.append(len(new_hashes))
            return got

    ref = _ref_ledger(base)
    port = ledger_from_rows(ref.txn_log.iterator(),
                            ref.tree.hash_store.kv.iterator(),
                            Spy(min_batch=2, fuse_min=2, device="cpu"))
    for size in (3, 11):
        wave = _txns(port.size, size)
        port.append_batch(wave)
        ref.append_batch(wave)
        assert port.root_hash == ref.root_hash
    assert waves == [3, 11]


def test_converted_ledger_appends_to_the_same_root():
    ref = _ref_ledger(37)
    port = _port_ledger(ref, min_batch=4)
    assert [t for _, t in port.get_all_txns()] == [t for _, t in ref.get_all_txns()]
    old_root = port.root_hash
    batch = _txns(37, 11)
    port.append_batch(batch)
    ref.append_batch(batch)
    assert port.root_hash == ref.root_hash
    proof = [bytes.fromhex(h) for h in port.consistency_proof(37)]
    assert MerkleVerifier().verify_consistency(37, 48, old_root,
                                               port.root_hash, proof)


def test_torch_hasher_batches_match_hashlib():
    rng = np.random.default_rng(2)
    leaves = [rng.bytes(int(rng.integers(0, 150))) for _ in range(9)]
    dev, host = make_tree_hasher("torch", min_batch=1), make_tree_hasher("cpu")
    assert dev.hash_leaves(leaves) == host.hash_leaves(leaves)
    pairs = [(rng.bytes(32), rng.bytes(32)) for _ in range(5)]
    assert dev.hash_children_batch(pairs) == host.hash_children_batch(pairs)


# --- entry points default to the card and never fall back -------------------

def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert make_verifier().device.type == "cuda"
        assert make_tree_hasher().device.type == "cuda"
        assert CoreAuthNr().verifier.device.type == "cuda"


@pytest.mark.parametrize("build", [
    lambda: make_verifier(), lambda: make_verifier("cuda"),
    lambda: make_tree_hasher(), lambda: make_tree_hasher("cuda"),
    lambda: CoreAuthNr(), lambda: TorchEd25519Verifier(),
    lambda: TorchTreeHasher(), lambda: TorchEd25519Verifier(device="cuda"),
    lambda: ops.default_device()])
def test_entry_points_raise_without_a_gpu(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_unknown_backends_raise():
    with pytest.raises(ValueError):
        make_verifier("jax")
    with pytest.raises(ValueError):
        make_tree_hasher("jax")


def test_base58_roundtrip():
    rng = np.random.default_rng(6)
    for n in (0, 1, 16, 32):
        raw = b"\x00" * int(rng.integers(3)) + rng.bytes(n)
        assert b58decode(b58encode(raw)) == raw
