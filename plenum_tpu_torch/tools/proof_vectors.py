"""Golden proof vectors: canonical (keys -> root -> proof -> verify)
fixtures for every state-commitment backend.

A verifier-side encoding drift — a reordered transcript field, a
changed domain separator, a different leaf-scalar preimage — would not
fail any same-process test (prover and verifier drift together); it
would silently invalidate every proof already held by deployed clients.
These vectors pin the full byte-level contract: the committed root
anchor, a single-key proof, a multi-key page proof, and an absence
proof, for a fixed keyset, per backend. tests/test_proof_vectors.py
regenerates them in-process and compares against the checked-in file —
a drift breaks loudly in tier-1 instead of silently on clients.

    python -m plenum_tpu_torch.tools.proof_vectors            # print JSON
    python -m plenum_tpu_torch.tools.proof_vectors --write    # refresh file
    python -m plenum_tpu_torch.tools.proof_vectors --check    # diff vs file
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from plenum_tpu_torch.common.serialization import pack

VECTORS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "vectors",
    "proof_vectors.json")

# the fixed fixture keyset: enough keys to force internal structure at
# every supported width, including a missing key for absence proofs
FIXTURE_KEYS = [b"did:sov:%04d" % i for i in range(24)]
FIXTURE_VALUES = [b"record-%04d" % i for i in range(24)]
MISSING_KEY = b"did:sov:missing"
PAGE = FIXTURE_KEYS[:7] + [MISSING_KEY]

# second write-set for the RECOMMIT vectors: applied on top of the
# committed fixture state, resolved once on the host path and once
# through the fused commit wave — the two roots must be byte-identical
# to each other AND to the checked-in vector, so a kernel or staging
# change can never silently fork the state root
RECOMMIT_KEYS = [b"did:sov:wave:%04d" % i for i in range(17)]
RECOMMIT_VALUES = [b"wave-%04d" % i for i in range(17)]
RECOMMIT_TXNS = [{"seq": i, "v": v.hex()}
                 for i, v in enumerate(RECOMMIT_VALUES)]


def _hex(b: bytes) -> str:
    return b.hex()


def _build_state(backend: str):
    from plenum_tpu_torch.state.commitment import make_state
    st = make_state(backend)
    for k, v in zip(FIXTURE_KEYS, FIXTURE_VALUES):
        st.set(k, v)
    st.commit(st.head_hash)
    return st


def _wave_root(add_family) -> bytes:
    """Resolve one staged family through a real CommitWave on a fresh
    host-engine pipeline (the same trampoline the ordered path runs)."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.commit_wave import CommitWave
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
    wave = CommitWave(CryptoPipeline(CpuEd25519Verifier()))
    add_family(wave)
    return wave.run()["root"]


def recommit_roots(backend: str) -> dict:
    """{"host": hex, "fused": hex}: the second write-set's state root,
    resolved inline vs through the commit wave."""
    from plenum_tpu_torch.state.commitment import make_state

    def build():
        st = make_state(backend)
        for k, v in zip(FIXTURE_KEYS, FIXTURE_VALUES):
            st.set(k, v)
        st.commit(st.head_hash)
        for k, v in zip(RECOMMIT_KEYS, RECOMMIT_VALUES):
            st.set(k, v)
        return st

    host = build().head_hash
    fused = _wave_root(lambda w: w.add("root", build().recommit_staged()))
    return {"host": _hex(host), "fused": _hex(fused)}


def ledger_recommit_roots() -> dict:
    """{"host": hex, "fused": hex}: the staged-ledger shadow root, leaf
    hashing inline vs deferred to the commit wave."""
    from plenum_tpu_torch.ledger.ledger import Ledger

    def build(defer):
        lg = Ledger()
        lg.append_txns_to_uncommitted(list(RECOMMIT_TXNS),
                                      defer_hash=defer)
        return lg

    host = build(False).uncommitted_root_hash
    fused = _wave_root(
        lambda w: w.add("root", build(True).uncommitted_root_staged()))
    return {"host": _hex(host), "fused": _hex(fused)}


def generate() -> dict:
    out: dict = {"version": 1, "keys": [_hex(k) for k in FIXTURE_KEYS],
                 "values": [_hex(v) for v in FIXTURE_VALUES],
                 "page": [_hex(k) for k in PAGE],
                 "backends": {}}
    for backend in ("mpt", "verkle"):
        st = _build_state(backend)
        root = st.committed_head_hash
        single = st.generate_state_proof(FIXTURE_KEYS[0], serialize=True)
        absent = st.generate_state_proof(MISSING_KEY, serialize=True)
        page = st.batch_open(PAGE)
        rec = recommit_roots(backend)
        if rec["fused"] != rec["host"]:
            # NEVER write a forked vector: a fused/host divergence is
            # the exact drift these vectors exist to catch
            raise RuntimeError(
                f"{backend}: fused recommit root {rec['fused']} != "
                f"host root {rec['host']}")
        out["backends"][backend] = {
            "root": _hex(root),
            "single_proof": _hex(bytes(single)),
            "absence_proof": _hex(bytes(absent)),
            "page_proof": _hex(pack(page)),
            "recommit_root": rec["host"],
        }
    lrec = ledger_recommit_roots()
    if lrec["fused"] != lrec["host"]:
        raise RuntimeError(
            f"ledger: fused recommit root {lrec['fused']} != "
            f"host root {lrec['host']}")
    out["ledger_recommit_root"] = lrec["host"]
    return out


def check_vectors(doc: dict) -> list[str]:
    """Re-verify a vector document with the CURRENT verifiers (the
    client-side half of the drift check: old proofs must still verify)
    and re-generate to catch prover-side drift. -> problem list."""
    from plenum_tpu_torch.common.serialization import unpack
    from plenum_tpu_torch.state.commitment import PruningState, VerkleState

    problems = []
    fresh = generate()
    for backend in ("mpt", "verkle"):
        want = doc.get("backends", {}).get(backend)
        got = fresh["backends"][backend]
        if want is None:
            problems.append(f"{backend}: missing from vector file")
            continue
        for field in ("root", "single_proof", "absence_proof",
                      "page_proof", "recommit_root"):
            if want.get(field) != got[field]:
                problems.append(
                    f"{backend}.{field}: regenerated bytes differ from "
                    f"the checked-in vector — an encoding drift would "
                    f"invalidate deployed clients' proofs")
        cls = PruningState if backend == "mpt" else VerkleState
        try:
            root = bytes.fromhex(want["root"])
            if not cls.verify_state_proof(
                    root, FIXTURE_KEYS[0], FIXTURE_VALUES[0],
                    bytes.fromhex(want["single_proof"])):
                problems.append(f"{backend}: checked-in single proof no "
                                f"longer verifies")
            if not cls.verify_state_proof(
                    root, MISSING_KEY, None,
                    bytes.fromhex(want["absence_proof"])):
                problems.append(f"{backend}: checked-in absence proof no "
                                f"longer verifies")
            entries = [(k, FIXTURE_VALUES[FIXTURE_KEYS.index(k)]
                        if k in FIXTURE_KEYS else None) for k in PAGE]
            if not cls.verify_batch_proof(
                    root, entries,
                    unpack(bytes.fromhex(want["page_proof"]))):
                problems.append(f"{backend}: checked-in page proof no "
                                f"longer verifies")
        except Exception as e:
            problems.append(f"{backend}: verification raised "
                            f"{type(e).__name__}: {e}")
    if doc.get("ledger_recommit_root") != fresh["ledger_recommit_root"]:
        problems.append(
            "ledger_recommit_root: regenerated root differs from the "
            "checked-in vector — the staged ledger append no longer "
            "matches the host shadow tree")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true",
                    help="refresh tests/vectors/proof_vectors.json")
    ap.add_argument("--check", action="store_true",
                    help="verify the checked-in vectors against the "
                         "current implementation")
    args = ap.parse_args(argv)
    if args.check:
        try:
            with open(VECTORS_PATH) as fh:
                doc = json.load(fh)
        except OSError as e:
            print(f"proof_vectors: FAIL — cannot read {VECTORS_PATH}: {e}")
            return 1
        problems = check_vectors(doc)
        if problems:
            print(f"proof_vectors: FAIL — {len(problems)} problem(s)")
            for p in problems:
                print(f"  {p}")
            return 1
        print("proof_vectors: ok — both backends match the checked-in "
              "golden vectors")
        return 0
    doc = generate()
    text = json.dumps(doc, indent=1, sort_keys=True)
    if args.write:
        os.makedirs(os.path.dirname(VECTORS_PATH), exist_ok=True)
        with open(VECTORS_PATH, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {VECTORS_PATH}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
