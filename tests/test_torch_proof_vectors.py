"""The port's copy of tests/test_proof_vectors.py, run on plenum_tpu_torch.

Golden-vector pin for the state-commitment proof formats.

tools/proof_vectors.py writes canonical (keys -> root -> proof ->
verify) fixtures for BOTH backends into tests/vectors/; this tier-1
test regenerates them in-process and verifies the checked-in bytes with
the current verifiers. A verifier-side encoding drift (transcript
order, domain separator, leaf-scalar preimage, RLP/msgpack layout)
breaks HERE instead of silently invalidating every proof a deployed
client already holds — the exact discipline the wire-format tests apply
to messages.
"""
from __future__ import annotations

import json

import pytest

from plenum_tpu_torch.tools import proof_vectors as pv


@pytest.fixture(scope="module")
def checked_in():
    with open(pv.VECTORS_PATH) as fh:
        return json.load(fh)


def test_vectors_match_and_verify(checked_in):
    problems = pv.check_vectors(checked_in)
    assert not problems, "\n".join(problems)


def test_vectors_cover_both_backends(checked_in):
    assert set(checked_in["backends"]) == {"mpt", "verkle"}
    for backend, vec in checked_in["backends"].items():
        for field in ("root", "single_proof", "absence_proof",
                      "page_proof"):
            assert vec.get(field), f"{backend}.{field} empty"


def test_recommit_roots_fused_matches_host(checked_in):
    """The commit-wave drift pin: the fused recommit root must equal the
    host-resolved root AND the checked-in vector for both commitment
    backends — a staging or kernel change that forks the state root
    breaks here in tier-1, never silently on a running pool."""
    for backend in ("mpt", "verkle"):
        rec = pv.recommit_roots(backend)
        assert rec["fused"] == rec["host"], \
            f"{backend}: fused recommit root drifted from host"
        assert rec["host"] == \
            checked_in["backends"][backend]["recommit_root"], \
            f"{backend}: recommit root drifted from the checked-in vector"


def test_ledger_recommit_root_fused_matches_host(checked_in):
    rec = pv.ledger_recommit_roots()
    assert rec["fused"] == rec["host"]
    assert rec["host"] == checked_in["ledger_recommit_root"]


def test_tampered_vector_fails_closed(checked_in):
    """A flipped byte anywhere in a checked-in proof must verify False —
    the vectors double as a canonical tamper fixture for client code."""
    from plenum_tpu_torch.state.commitment import PruningState, VerkleState
    for backend, cls in (("mpt", PruningState), ("verkle", VerkleState)):
        vec = checked_in["backends"][backend]
        root = bytes.fromhex(vec["root"])
        proof = bytearray(bytes.fromhex(vec["single_proof"]))
        proof[len(proof) // 2] ^= 0x01
        assert not cls.verify_state_proof(
            root, pv.FIXTURE_KEYS[0], pv.FIXTURE_VALUES[0], bytes(proof))
        # and against a different root the honest proof fails too
        bad_root = bytes(32)
        assert not cls.verify_state_proof(
            bad_root, pv.FIXTURE_KEYS[0], pv.FIXTURE_VALUES[0],
            bytes.fromhex(vec["single_proof"]))
