"""The port's copy of tests/test_bls.py, run on plenum_tpu_torch.

BLS over BN254: pairing properties, sign/verify, aggregation, PoP,
random-linear-combination batch verification
(ref crypto/bls/indy_crypto/bls_crypto_indy_crypto.py behavior)."""
import pytest

from plenum_tpu_torch.crypto import bls as bls_mod
from plenum_tpu_torch.crypto import bn254 as c
from plenum_tpu_torch.crypto.bls import (BlsCryptoSigner, BlsCryptoVerifier,
                                         BlsSignKey, aggregate_sigs,
                                         batch_verify_combined, g1_from_bytes,
                                         g1_to_bytes, verify, verify_multi_sig,
                                         verify_pop)
from plenum_tpu_torch.crypto.multi_signature import (MultiSignature,
                                                     MultiSignatureValue)
from plenum_tpu_torch.utils.base58 import b58decode, b58encode

# Pure-Python pairings run ~10-200x the native multi-pairing; when the
# in-tree C++ toolchain is absent, the pairing-HEAVY property tests (many
# pairings per test) move out of tier-1 so the 870 s budget holds. With
# the native lib built they cost milliseconds and stay in tier-1.
pairing_heavy = pytest.mark.slow if c._NATIVE is None else (lambda f: f)


@pairing_heavy
def test_pairing_bilinearity():
    a, b = 31337, 271828
    e = c.pairing(c.G2_GEN, c.G1_GEN)
    lhs = c.pairing(c.g2_mul(c.G2_GEN, a), c.g1_mul(c.G1_GEN, b))
    assert lhs == c.f12_pow(e, a * b % c.R)
    assert e != c.F12_ONE


def test_group_orders():
    assert c.g1_mul(c.G1_GEN, c.R) is None
    assert c.g2_mul(c.G2_GEN, c.R) is None
    assert c.g2_in_subgroup(c.G2_GEN)


def test_hash_to_g1_deterministic_and_valid():
    p1 = c.hash_to_g1(b"state-root-1")
    p2 = c.hash_to_g1(b"state-root-1")
    p3 = c.hash_to_g1(b"state-root-2")
    assert p1 == p2 != p3
    assert c.g1_is_on_curve(p1) and c.g1_is_on_curve(p3)


def test_sign_verify_roundtrip():
    key = BlsSignKey(seed=b"\x01" * 32)
    sig = key.sign(b"message")
    assert verify(sig, b"message", key.verkey)
    assert not verify(sig, b"other", key.verkey)
    other = BlsSignKey(seed=b"\x02" * 32)
    assert not verify(sig, b"message", other.verkey)


def test_signing_is_deterministic():
    k1 = BlsSignKey(seed=b"\x07" * 32)
    k2 = BlsSignKey(seed=b"\x07" * 32)
    assert k1.verkey == k2.verkey
    assert k1.sign(b"m") == k2.sign(b"m")


@pairing_heavy
def test_multi_sig_aggregate_and_verify():
    keys = [BlsSignKey(seed=bytes([i]) * 32) for i in range(1, 5)]
    msg = b"the-state-root"
    agg = aggregate_sigs([k.sign(msg) for k in keys])
    vks = [k.verkey for k in keys]
    assert verify_multi_sig(agg, msg, vks)
    # missing participant -> fail
    assert not verify_multi_sig(agg, msg, vks[:3])
    # wrong message -> fail
    assert not verify_multi_sig(agg, b"x", vks)
    # aggregated sig is not a valid single sig for any one key
    assert not verify(agg, msg, vks[0])


def test_proof_of_possession():
    key = BlsSignKey(seed=b"\x09" * 32)
    pop = key.generate_pop()
    assert verify_pop(pop, key.verkey)
    other = BlsSignKey(seed=b"\x0a" * 32)
    assert not verify_pop(pop, other.verkey)
    # a message signature must not double as a PoP (domain separation)
    assert not verify_pop(key.sign(b58 := key.verkey.encode()), key.verkey)


def test_provider_seam():
    signer = BlsCryptoSigner(seed=b"\x11" * 32)
    verifier = BlsCryptoVerifier()
    sig = signer.sign(b"root")
    assert verifier.verify_sig(sig, b"root", signer.pk)
    signer2 = BlsCryptoSigner(seed=b"\x12" * 32)
    agg = verifier.create_multi_sig([sig, signer2.sign(b"root")])
    assert verifier.verify_multi_sig(agg, b"root", [signer.pk, signer2.pk])
    assert verifier.verify_key_proof_of_possession(signer.generate_pop(),
                                                   signer.pk)


def test_garbage_inputs_rejected_not_raised():
    key = BlsSignKey(seed=b"\x13" * 32)
    assert not verify("not-base58-!!!", b"m", key.verkey)
    assert not verify(key.sign(b"m"), b"m", "bogus-verkey")
    assert not verify_multi_sig(key.sign(b"m"), b"m", [])


def test_multi_signature_value_roundtrip():
    value = MultiSignatureValue(1, "sr", "psr", "tr", 1234.5)
    ms = MultiSignature("sig58", ("Alpha", "Beta"), value)
    assert MultiSignature.from_list(ms.to_list()) == ms
    assert b"state_root_hash" in value.as_single_value()


def test_duplicate_participant_multisig_rejected():
    """A single colluding node's signature aggregated with itself must NOT
    pass as a quorum multi-sig (rogue self-aggregation)."""
    from plenum_tpu_torch.common.node_messages import PrePrepare
    from plenum_tpu_torch.common.quorums import Quorums
    from plenum_tpu_torch.consensus.bls_bft_replica import (BlsBftReplica,
                                                            BlsKeyRegister)
    from plenum_tpu_torch.crypto.bls import (BlsCryptoSigner, BlsCryptoVerifier,
                                             aggregate_sigs)
    from plenum_tpu_torch.crypto.multi_signature import (MultiSignature,
                                                         MultiSignatureValue)

    signer = BlsCryptoSigner(seed=b"X".ljust(32, b"\0"))
    register = BlsKeyRegister({"X": signer.pk, "Y": "no", "Z": "no", "W": "no"})
    replica = BlsBftReplica(node_name="Y", bls_signer=None,
                            bls_verifier=BlsCryptoVerifier(),
                            key_register=register, quorums=Quorums(4))
    value = MultiSignatureValue(1, "aa", "bb", "cc", 1.0)
    sig = signer.sign(value.as_single_value())
    forged = MultiSignature(signature=aggregate_sigs([sig, sig, sig]),
                            participants=("X", "X", "X"), value=value)
    pp = PrePrepare(inst_id=0, view_no=0, pp_seq_no=2, pp_time=1.0,
                    req_idr=(), discarded=(), digest="d", ledger_id=1,
                    state_root="aa", txn_root="cc", pool_state_root="bb",
                    audit_txn_root="", bls_multi_sig=tuple(forged.to_list()))
    assert replica.validate_pre_prepare(pp, "X") == \
        BlsBftReplica.PPR_BLS_MULTISIG_WRONG


# --- batched (random-linear-combination) verification ------------------------

@pairing_heavy
def test_batch_verify_one_forged_fails_combined_and_names_culprit():
    """The soundness satellite: ONE forged Commit signature in an n-sig
    batch must fail the combined check, and the per-signature fallback must
    name exactly the culprit."""
    keys = [BlsSignKey(seed=bytes([40 + i]) * 32) for i in range(6)]
    msg = b"batch-root-forged"
    items = [(k.sign(msg), msg, k.verkey) for k in keys]
    assert batch_verify_combined(items)
    forged = list(items)
    forged[3] = (keys[3].sign(b"a DIFFERENT value"), msg, keys[3].verkey)
    assert not batch_verify_combined(forged)
    verdicts = BlsCryptoVerifier().batch_verify(forged)
    assert verdicts == [True, True, True, False, True, True]


@pairing_heavy
def test_batch_coefficients_fresh_per_batch(monkeypatch):
    """No replayable combination: the random coefficients must be freshly
    derived on EVERY batch check (an adversary who learns one batch's
    coefficients must gain nothing against the next)."""
    drawn = []
    orig = bls_mod.batch_coefficients
    monkeypatch.setattr(bls_mod, "batch_coefficients",
                        lambda n: drawn.append(orig(n)) or drawn[-1])
    keys = [BlsSignKey(seed=bytes([50 + i]) * 32) for i in range(3)]
    msg = b"batch-root-fresh"
    items = [(k.sign(msg), msg, k.verkey) for k in keys]
    assert batch_verify_combined(items)
    assert batch_verify_combined(items)
    assert len(drawn) == 2 and drawn[0] != drawn[1], \
        "coefficients must differ between two checks of the SAME batch"
    assert all(len(set(cs)) == len(cs) and all(r > 0 for r in cs)
               for cs in drawn)


@pairing_heavy
def test_batch_verify_rejects_cancelling_pair():
    """Why RLC instead of plain aggregation: a signature pair doctored as
    (σ₁+δ, σ₂-δ) still aggregates to the honest sum — plain multi-sig
    verification accepts it — but neither signature is individually valid,
    and the fresh-coefficient combination must reject the pair."""
    k1, k2 = BlsSignKey(seed=b"\x61" * 32), BlsSignKey(seed=b"\x62" * 32)
    msg = b"batch-root-cancel"
    s1 = g1_from_bytes(b58decode(k1.sign(msg)))
    s2 = g1_from_bytes(b58decode(k2.sign(msg)))
    delta = c.g1_mul(c.G1_GEN, 987654321)
    t1 = b58encode(g1_to_bytes(c.g1_add(s1, delta)))
    t2 = b58encode(g1_to_bytes(c.g1_add(s2, c.g1_neg(delta))))
    # plain aggregation is blind to the doctoring...
    assert verify_multi_sig(aggregate_sigs([t1, t2]), msg,
                            [k1.verkey, k2.verkey])
    # ...the random-linear-combination check is not
    assert not batch_verify_combined([(t1, msg, k1.verkey),
                                      (t2, msg, k2.verkey)])
    verdicts = BlsCryptoVerifier().batch_verify([(t1, msg, k1.verkey),
                                                 (t2, msg, k2.verkey)])
    assert verdicts == [False, False]


@pairing_heavy
def test_batch_verify_distinct_messages_one_check():
    """Mixed-message batches still settle in ONE pairing_check of n+1
    pairings (one per distinct message + the combined-signature pair)."""
    keys = [BlsSignKey(seed=bytes([70 + i]) * 32) for i in range(4)]
    items = [(k.sign(b"msg-%d" % i), b"msg-%d" % i, k.verkey)
             for i, k in enumerate(keys)]
    before = dict(c.PAIRING_STATS)
    assert batch_verify_combined(items)
    assert c.PAIRING_STATS["checks"] - before["checks"] == 1
    assert c.PAIRING_STATS["pairings"] - before["pairings"] == len(items) + 1


def test_batch_verify_malformed_input_is_false_not_raise():
    key = BlsSignKey(seed=b"\x44" * 32)
    msg = b"batch-root-malformed"
    items = [(key.sign(msg), msg, key.verkey),
             ("not-base58-!!!", msg, key.verkey),
             (key.sign(msg), msg, "bogus-verkey")]
    verdicts = BlsCryptoVerifier().batch_verify(items)
    assert verdicts == [True, False, False]
    assert not batch_verify_combined(items)


@pairing_heavy
def test_order_time_bad_signer_evicted():
    """Deferred COMMIT verification: one combined pairing check on the happy
    path; on failure, the per-signature fallback isolates the liar, reports
    it, and still produces a quorum multi-sig from the honest remainder."""
    from plenum_tpu_torch.common.node_messages import Commit, PrePrepare
    from plenum_tpu_torch.common.quorums import Quorums
    from plenum_tpu_torch.consensus.bls_bft_replica import (BlsBftReplica,
                                                            BlsKeyRegister)

    signers = {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0"))
               for n in "ABCD"}
    register = BlsKeyRegister({n: s.pk for n, s in signers.items()})
    replica = BlsBftReplica(node_name="A", bls_signer=signers["A"],
                            bls_verifier=BlsCryptoVerifier(),
                            key_register=register, quorums=Quorums(4))
    reported = []
    replica.report_bad_signature = reported.append

    pp = PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.0,
                    req_idr=(), discarded=(), digest="d", ledger_id=1,
                    state_root="aa", txn_root="cc", pool_state_root="bb")
    value = replica._signed_value(pp).as_single_value()
    # D signs the WRONG value (equivocating or buggy)
    sigs = {n: signers[n].sign(value) for n in "ABC"}
    sigs["D"] = signers["D"].sign(b"something else entirely")
    for n, s in sigs.items():
        replica.process_commit(
            Commit(inst_id=0, view_no=0, pp_seq_no=1, bls_sig=s), n)

    ms = replica.process_order((0, 1), pp)
    assert ms is not None, "honest quorum should still yield a multi-sig"
    assert set(ms.participants) == {"A", "B", "C"}
    assert reported == ["D"]
    assert verify_multi_sig(ms.signature, value,
                            [signers[n].pk for n in "ABC"])


def test_order_time_all_honest_single_check():
    """Happy path: the whole COMMIT set settles in ONE combined pairing
    check of 2 pairings — amortized O(1) in pool size, the figure the
    bench's pairings_per_batch counter reports."""
    from plenum_tpu_torch.common.node_messages import Commit, PrePrepare
    from plenum_tpu_torch.common.quorums import Quorums
    from plenum_tpu_torch.consensus.bls_bft_replica import (BlsBftReplica,
                                                            BlsKeyRegister)

    signers = {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0"))
               for n in "ABCD"}
    register = BlsKeyRegister({n: s.pk for n, s in signers.items()})
    verifier = BlsCryptoVerifier()
    replica = BlsBftReplica(node_name="A", bls_signer=signers["A"],
                            bls_verifier=verifier,
                            key_register=register, quorums=Quorums(4))
    # roots distinct from every other test in this module: the process-wide
    # verdict cache would otherwise settle the batch without any pairing
    pp = PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.0,
                    req_idr=(), discarded=(), digest="d", ledger_id=1,
                    state_root="a-single", txn_root="c-single",
                    pool_state_root="b-single")
    value = replica._signed_value(pp).as_single_value()
    for n in "ABCD":
        replica.process_commit(
            Commit(inst_id=0, view_no=0, pp_seq_no=1,
                   bls_sig=signers[n].sign(value)), n)
    before = dict(c.PAIRING_STATS)
    ms = replica.process_order((0, 1), pp)
    assert ms is not None and len(ms.participants) == 4
    assert c.PAIRING_STATS["checks"] - before["checks"] == 1, \
        "expected ONE combined pairing check for the whole COMMIT set"
    assert c.PAIRING_STATS["pairings"] - before["pairings"] == 2, \
        "same-message batch must cost 2 pairings regardless of n"
