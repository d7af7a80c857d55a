"""The port's replica execution layer against the reference's, byte for
byte: the same seeded genesis and request script through both packages'
`NodeBootstrap` components, four replicas each, every batch
authenticated, applied, BLS-certified and committed as a pool's master
replica does (tools/local_pool.build_pool, node.py's BLS wiring), with no
consensus around it.

The reference side is `plenum_tpu` on hashlib and the CPU verifier
(`crypto_backend="cpu"`); the port side shares one `torch` ring (the
kernels' plain versions on CPU tensors) across its four replicas, as
co-hosted replicas share the card's. Tolerance: none. Verdicts, applied
and discarded digests, the four roots, every store's rows (ledgers,
audit ledger, states, BLS store, ts and seq-no stores), the
multi-signatures and the GET_NYM answers with their proofs must be
equal. Then a reference replica carried into the port, from memory
(`convert`) and from its data directory, resumes with equal roots and
applies a further batch equally."""
from __future__ import annotations

import hashlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import plenum_tpu.common.node_messages as ref_msgs
import plenum_tpu.execution as ref_execution
import plenum_tpu.node.bootstrap as ref_bootstrap
from plenum_tpu.common.quorums import Quorums as RefQuorums
from plenum_tpu.common.request import Request as RefRequest
from plenum_tpu.consensus.bls_bft_replica import BlsBftReplica as RefBlsReplica
from plenum_tpu.crypto.bls import BlsCryptoSigner as RefBlsSigner
from plenum_tpu.crypto.bls import BlsCryptoVerifier as RefBlsVerifier
from plenum_tpu.crypto.ed25519 import Ed25519Signer as RefSigner
from plenum_tpu.execution import txn as ref_txn_lib
from plenum_tpu.tools import local_pool as ref_local_pool
from plenum_tpu_torch import convert
from plenum_tpu_torch.common import node_messages as msgs
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.consensus.bls_bft_replica import BlsBftReplica
from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, BlsCryptoVerifier
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.crypto.multi_signature import MultiSignature
from plenum_tpu_torch.execution import ThreePcBatch
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import GET_NYM, NYM
from plenum_tpu_torch.node.bootstrap import NodeBootstrap, NodeComponents
from plenum_tpu_torch.parallel.pipeline import make_crypto_pipeline
from plenum_tpu_torch.state import rlp
from plenum_tpu_torch.state.trie import Trie
from plenum_tpu_torch.tools import local_pool
from plenum_tpu_torch.utils.base58 import b58decode, b58encode

NAMES = [f"Node{i + 1}" for i in range(4)]
N_PREFILL = 24
N_IDLE = 2            # pre-filled DIDs that hold no role
DOMAIN = msgs.DOMAIN_LEDGER_ID

REF = SimpleNamespace(
    Request=RefRequest, Signer=RefSigner, msgs=ref_msgs, txn=ref_txn_lib,
    ThreePcBatch=ref_execution.ThreePcBatch,
    NodeBootstrap=ref_bootstrap.NodeBootstrap, BlsReplica=RefBlsReplica,
    BlsVerifier=RefBlsVerifier, BlsSigner=RefBlsSigner, Quorums=RefQuorums,
    local_pool=ref_local_pool)
PORT = SimpleNamespace(
    Request=Request, Signer=Ed25519Signer, msgs=msgs, txn=txn_lib,
    ThreePcBatch=ThreePcBatch, NodeBootstrap=NodeBootstrap,
    BlsReplica=BlsBftReplica, BlsVerifier=BlsCryptoVerifier,
    BlsSigner=BlsCryptoSigner,
    Quorums=Quorums, local_pool=local_pool)


def idle_signer(P, k: int):
    return P.Signer(seed=(b"idle-did-%d" % k).ljust(32, b"\0"))


def genesis(P):
    """build_genesis's pool and trustee, the domain pre-filled with
    seeded NYMs (random DIDs and verkeys) and N_IDLE role-less DIDs with
    keys from known seeds."""
    gen, trustee = P.local_pool.build_genesis(NAMES)
    rng = np.random.default_rng(7)
    domain = list(gen[DOMAIN])
    for i in range(N_PREFILL):
        vk = rng.bytes(32)
        data = {"dest": b58encode(vk[:16]), "verkey": b58encode(vk)}
        if i % 3 == 0:
            data["role"] = "101"
        domain.append(P.txn.new_txn(NYM, data))
    for k in range(N_IDLE):
        s = idle_signer(P, k)
        domain.append(P.txn.new_txn(NYM, {"dest": s.identifier,
                                          "verkey": s.verkey_b58}))
    for i, txn in enumerate(domain):
        P.txn.set_seq_no(txn, i + 1)
    gen[DOMAIN] = domain
    return gen, trustee


def requests(P, trustee, batch: int, n: int = 8):
    """n NYMs for fresh DIDs as run_load makes them: n - 2 from the
    trustee, one of them corrupted (authentication rejects it), and one
    signed by a role-less pre-filled DID (authentication accepts it,
    dynamic validation discards it). -> (requests, expected verdicts)."""
    out = []
    for i in range(n - 1):
        user = P.Signer(seed=(b"tb%d-%d" % (batch, i)).ljust(32, b"\0"))
        req = P.Request(trustee.identifier, 100 * batch + i + 1,
                        {"type": NYM, "dest": user.identifier,
                         "verkey": user.verkey_b58})
        req.signature = trustee.sign_b58(req.signing_bytes())
        out.append(req)
    bad = out[batch % (n - 1)]
    sig = bytearray(b58decode(bad.signature))
    sig[batch] ^= 1
    bad.signature = b58encode(bytes(sig))
    idle = idle_signer(P, batch % N_IDLE)
    user = P.Signer(seed=(b"tb-idle-%d" % batch).ljust(32, b"\0"))
    req = P.Request(idle.identifier, 1000 + batch,
                    {"type": NYM, "dest": user.identifier,
                     "verkey": user.verkey_b58})
    req.signature = idle.sign_b58(req.signing_bytes())
    out.insert(3, req)
    expect = [r is not bad for r in out]
    return out, expect


def replica(P, c, name):
    """The master instance's BLS replica on the components' signer,
    register and store (node.py), quorums for n = 4."""
    verifier = (c.pipeline.bls_verifier() if c.pipeline is not None
                else P.BlsVerifier())
    return P.BlsReplica(node_name=name, bls_signer=c.bls_signer,
                        bls_verifier=verifier, key_register=c.bls_register,
                        bls_store=c.bls_store, quorums=P.Quorums(4))


def pp_time_of(k: int) -> float:
    """A batch's pre-prepare time: the primary's clock, a float."""
    return 1_700_000_000.25 + 10 * k


def run_batch(P, reps, reqs, k: int, prev_root):
    """One batch on every replica: authenticate, apply, BLS (the
    primary's pre-prepare, every replica's commit, each replica
    processing the four commits, order), commit. -> everything the
    replicas answered."""
    pp_time = pp_time_of(k)
    verdicts = [c.authenticator.authenticate_batch(reqs).tolist()
                for c, _ in reps]
    accepted = [r for r, ok in zip(reqs, verdicts[0]) if ok]
    applied = [c.executor.apply_batch(DOMAIN, accepted, pp_time, view_no=0,
                                      pp_seq_no=k, primaries=[NAMES[0]])
               for c, _ in reps]
    a = applied[0]
    params = reps[0][1].update_pre_prepare({}, prev_root or "")
    pp = P.msgs.PrePrepare(
        inst_id=0, view_no=0, pp_seq_no=k, pp_time=pp_time,
        req_idr=a.valid_digests, discarded=a.discarded,
        digest=hashlib.sha256("".join(a.valid_digests).encode()).hexdigest(),
        ledger_id=DOMAIN, state_root=a.state_root, txn_root=a.txn_root,
        pool_state_root=a.pool_state_root, audit_txn_root=a.audit_txn_root,
        bls_multi_sig=params.get("bls_multi_sig"))
    pp_faults = [bls.validate_pre_prepare(pp, NAMES[0])
                 for _, bls in reps[1:]]
    commits = [P.msgs.Commit(inst_id=0, view_no=0, pp_seq_no=k,
                             **bls.update_commit({}, pp)) for _, bls in reps]
    for _, bls in reps:
        for name, cm in zip(NAMES, commits):
            bls.process_commit(cm, name)
    mss = [bls.process_order((0, k), pp) for _, bls in reps]
    batch = P.ThreePcBatch(
        ledger_id=DOMAIN, view_no=0, pp_seq_no=k, pp_time=pp_time,
        valid_digests=a.valid_digests,
        state_root=bytes.fromhex(a.state_root),
        txn_root=bytes.fromhex(a.txn_root),
        audit_txn_root=bytes.fromhex(a.audit_txn_root),
        primaries=(NAMES[0],), node_reg=tuple(NAMES))
    committed = [pack(c.executor.commit_batch(batch)) for c, _ in reps]
    return {"verdicts": verdicts, "applied": [tuple(x) for x in applied],
            "pp_faults": pp_faults, "bls_sigs": [cm.bls_sig for cm in commits],
            "multi_sigs": [ms.to_list() for ms in mss],
            "committed": committed, "pp_multi_sig": pp.bls_multi_sig,
            "state_root": a.state_root}


def get_nym(P, c, trustee, did: str, req_id: int) -> dict:
    req = P.Request(trustee.identifier, req_id,
                    {"type": GET_NYM, "dest": did})
    return c.read_manager.get_result(req)


def roots(c) -> dict:
    db = c.db
    out = {}
    for lid in db.ledger_ids:
        out[f"txn{lid}"] = db.get_ledger(lid).root_hash
        st = db.get_state(lid)
        if st is not None:
            out[f"state{lid}"] = st.committed_head_hash
    return out


def check_proof(result: dict, pks: dict) -> None:
    """The GET_NYM answer's state proof verifies against its root, and
    its multi-signature over that root verifies."""
    sp = result["state_proof"]
    root = bytes.fromhex(sp["root_hash"])
    present, got = Trie.verify_proof(root, result["dest"].encode(),
                                     rlp.decode(bytes.fromhex(
                                         sp["proof_nodes"])))
    assert present and unpack(got) == result["data"]
    ms = MultiSignature.from_list(sp["multi_signature"])
    assert ms.value.state_root_hash == sp["root_hash"]
    assert len(ms.participants) >= 3
    assert BlsCryptoVerifier().verify_multi_sig(
        ms.signature, ms.value.as_single_value(),
        [pks[n] for n in ms.participants])


def small_ring():
    return make_crypto_pipeline(
        Config(PIPELINE_MIN_BUCKET=8, PIPELINE_SHA_MIN_BATCH=8), "torch")


def build_pair(tmp_path=None):
    """Four reference replicas and four port replicas (one torch ring)
    on the same genesis."""
    ref_gen, ref_trustee = genesis(REF)
    gen, trustee = genesis(PORT)
    assert pack(ref_gen) == pack(gen)
    ref = [REF.NodeBootstrap(n, genesis_txns=ref_gen,
                             crypto_backend="cpu").build() for n in NAMES]
    pipe = small_ring()
    port = [NodeBootstrap(n, genesis_txns=gen, pipeline=pipe).build()
            for n in NAMES]
    return (ref_trustee, [(c, replica(REF, c, n)) for c, n in zip(ref, NAMES)],
            trustee, [(c, replica(PORT, c, n)) for c, n in zip(port, NAMES)],
            pipe)


@pytest.fixture(scope="module")
def pair():
    """Both pools after the seeded script's three batches, with what
    each batch answered."""
    ref_trustee, ref, trustee, port, pipe = build_pair()
    assert type(port[0][0]) is NodeComponents
    assert [f for f in NodeComponents._fields] == \
        list(ref_bootstrap.NodeComponents._fields)
    genesis_rows = (convert.replica_rows(ref[0][0]),
                    convert.replica_rows(port[0][0]))
    answers = []
    prev = {"ref": None, "port": None}
    for k in (1, 2, 3):
        ref_reqs, expect = requests(REF, ref_trustee, k)
        reqs, _ = requests(PORT, trustee, k)
        assert [r.signature for r in ref_reqs] == [r.signature for r in reqs]
        a_ref = run_batch(REF, ref, ref_reqs, k, prev["ref"])
        a_port = run_batch(PORT, port, reqs, k, prev["port"])
        prev = {"ref": a_ref["state_root"], "port": a_port["state_root"]}
        answers.append((expect, a_ref, a_port, reqs))
    return SimpleNamespace(ref=ref, port=port, pipe=pipe, answers=answers,
                           trustee=trustee, ref_trustee=ref_trustee,
                           genesis_rows=genesis_rows)


def test_genesis_replay_gives_the_reference_stores(pair):
    ref_rows, port_rows = pair.genesis_rows
    assert port_rows == ref_rows
    assert len(ref_rows["domain_log"]) == 1 + N_PREFILL + N_IDLE
    assert len(ref_rows["pool_log"]) == 4


@pytest.mark.parametrize("k", [1, 2, 3])
def test_batch_answers_equal_the_reference(pair, k):
    expect, a_ref, a_port, _ = pair.answers[k - 1]
    assert a_port == a_ref
    n = len(expect)
    for v in a_port["verdicts"]:
        assert v == expect
    for applied in a_port["applied"]:
        assert applied == a_port["applied"][0]
        # one corrupted request rejected in authentication, the
        # role-less author's NYM discarded at dynamic validation
        assert len(applied[4]) == n - 2 and len(applied[5]) == 1
    assert a_port["pp_faults"] == [None] * 3
    assert len({pack(m) for m in a_port["multi_sigs"]}) == 1
    assert tuple(a_port["multi_sigs"][0][1]) == tuple(NAMES)
    # from the second batch on the primary embeds the previous multi-sig
    assert (a_port["pp_multi_sig"] is None) == (k == 1)


def test_every_store_equals_the_reference_after_the_script(pair):
    rows = [convert.replica_rows(c) for c, _ in pair.port]
    ref_rows = [convert.replica_rows(c) for c, _ in pair.ref]
    assert rows[0] == ref_rows[0]
    assert all(r == rows[0] for r in rows[1:] + ref_rows[1:])
    c = pair.port[0][0]
    for lid in c.db.ledger_ids:
        st = c.db.get_state(lid)
        if st is not None:
            assert st.as_dict() == pair.ref[0][0].db.get_state(lid).as_dict()
    audit = c.db.get_ledger(msgs.AUDIT_LEDGER_ID)
    assert audit.size == 3
    # three batches of 6 accepted NYMs on the pre-filled domain
    assert c.db.get_ledger(DOMAIN).size == 1 + N_PREFILL + N_IDLE + 18


def test_get_nym_answers_and_proofs_equal_the_reference(pair):
    _, _, _, reqs = pair.answers[-1]
    did = reqs[0].operation["dest"]
    pks = local_pool.pool_bls_keys(NAMES)
    got = [get_nym(PORT, c, pair.trustee, did, 9001) for c, _ in pair.port]
    want = get_nym(REF, pair.ref[0][0], pair.ref_trustee, did, 9001)
    assert all(pack(g) == pack(want) for g in got)
    assert got[0]["data"]["verkey"] == reqs[0].operation["verkey"]
    check_proof(got[0], pks)


def test_the_ring_carried_the_port_replicas_crypto(pair):
    """One Ed25519 wave per batch for the four replicas, the commit
    waves' levels deduped across them, BLS checks on the ring's default
    engine."""
    st = pair.pipe.stats
    assert st["dispatches"] == 3 and st["dedup_hits"] > 0
    assert st["bls_batches"] > 0 and st["cmt_batches"] > 0
    assert st["cmt_host_fallbacks"] == 0 and st["unpinned_shapes"] == 0


def _resume_and_compare(ref_c, port_c, ref_trustee, trustee, k=4):
    assert roots(port_c) == roots(ref_c)
    ref_reqs, expect = requests(REF, ref_trustee, k)
    reqs, _ = requests(PORT, trustee, k)
    a_ref = run_one(REF, ref_c, ref_reqs, k)
    a_port = run_one(PORT, port_c, reqs, k)
    assert a_port == a_ref and a_port[0] == expect
    assert convert.replica_rows(port_c) == convert.replica_rows(ref_c)


def run_one(P, c, reqs, k):
    """One batch on one replica, without BLS (one signer is no quorum):
    authenticate, apply, commit."""
    verdicts = c.authenticator.authenticate_batch(reqs).tolist()
    accepted = [r for r, ok in zip(reqs, verdicts) if ok]
    a = c.executor.apply_batch(DOMAIN, accepted, pp_time_of(k),
                               view_no=0, pp_seq_no=k, primaries=[NAMES[0]])
    batch = P.ThreePcBatch(
        ledger_id=DOMAIN, view_no=0, pp_seq_no=k,
        pp_time=pp_time_of(k), valid_digests=a.valid_digests,
        state_root=bytes.fromhex(a.state_root),
        txn_root=bytes.fromhex(a.txn_root),
        audit_txn_root=bytes.fromhex(a.audit_txn_root))
    return verdicts, tuple(a), pack(c.executor.commit_batch(batch))


def test_reference_replica_carried_in_memory_resumes(pair):
    ref_c = pair.ref[3][0]
    rows = convert.replica_rows(ref_c)
    port_c = convert.bootstrap_from_rows(NAMES[3], rows,
                                         pipeline=small_ring()).build()
    assert convert.replica_rows(port_c) == rows
    _resume_and_compare(ref_c, port_c, pair.ref_trustee, pair.trustee)
    with pytest.raises(ValueError):
        convert.bootstrap_from_rows("x", rows, data_dir="/nonexistent")


def test_reference_data_dir_reopens_in_the_port(tmp_path):
    ref_gen, ref_trustee = genesis(REF)
    _, trustee = genesis(PORT)
    src = tmp_path / "ref"
    ref_c = REF.NodeBootstrap(NAMES[0], genesis_txns=ref_gen,
                              data_dir=str(src), crypto_backend="cpu").build()
    reqs, expect = requests(REF, ref_trustee, 1)
    assert run_one(REF, ref_c, reqs, 1)[0] == expect
    ref_c.db.close()
    shutil.copytree(src, tmp_path / "port")
    ref_c = REF.NodeBootstrap(NAMES[0], genesis_txns=ref_gen,
                              data_dir=str(src), crypto_backend="cpu").build()
    port_c = NodeBootstrap(NAMES[0], data_dir=str(tmp_path / "port"),
                           crypto_backend="cpu").build()
    assert port_c.db.get_ledger(DOMAIN).size == 1 + N_PREFILL + N_IDLE + 6
    _resume_and_compare(ref_c, port_c, ref_trustee, trustee, k=2)
    ref_c.db.close()
    port_c.db.close()


# --- every write type, every state commitment and store backend ----------

CONFIG = msgs.CONFIG_LEDGER_ID
POOL = msgs.POOL_LEDGER_ID
T = SimpleNamespace(**{n: getattr(txn_lib, n) for n in (
    "ATTRIB", "GET_ATTR", "GET_TXN", "NODE", "TXN_AUTHOR_AGREEMENT",
    "TXN_AUTHOR_AGREEMENT_AML", "TXN_AUTHOR_AGREEMENT_DISABLE",
    "GET_TXN_AUTHOR_AGREEMENT", "GET_TXN_AUTHOR_AGREEMENT_AML",
    "LEDGERS_FREEZE", "GET_FROZEN_LEDGERS")})


def signed(P, signer, req_id, op, taa=None, corrupt=False):
    req = P.Request(signer.identifier, req_id, op, taa_acceptance=taa)
    req.signature = signer.sign_b58(req.signing_bytes())
    if corrupt:
        sig = bytearray(b58decode(req.signature))
        sig[5] ^= 1
        req.signature = b58encode(bytes(sig))
    return req


def mixed_script(P, trustee):
    """Six batches over the three written ledgers, every write type
    NodeBootstrap registers: the TAA and its AML, NYMs with and without an
    acceptance, ATTRIBs, NODE readdressing and BLS key rotation, a ledger
    freeze and the TAA's disabling, with requests that authentication
    rejects, that static validation refuses (a forged proof of possession,
    a base ledger's freeze) and that dynamic validation discards. ->
    [(ledger id, requests, expected verdicts, number refused, number
    discarded)]."""
    import json
    from plenum_tpu_torch.execution.handlers.taa import taa_digest
    user = P.Signer(seed=b"mixed-user".ljust(32, b"\0"))
    idle = idle_signer(P, 0)
    fresh = [P.Signer(seed=(b"mixed-%d" % i).ljust(32, b"\0"))
             for i in range(6)]
    acc = {"taaDigest": taa_digest("agree", "1"), "mechanism": "click",
           "time": int(pp_time_of(2))}
    wave = dict(acc, mechanism="wave")

    def nym(i, rid, taa=None, corrupt=False):
        return signed(P, trustee, rid, {"type": NYM, "dest":
                                        fresh[i].identifier,
                                        "verkey": fresh[i].verkey_b58},
                      taa=taa, corrupt=corrupt)

    def node(signer, rid, name, data):
        return signed(P, signer, rid, {"type": T.NODE, "dest":
                                       f"{name}Dest",
                                       "data": dict(alias=name, **data)})
    vk3, pop3 = P.BlsSigner.generate_keys(b"rotated-node3".ljust(32, b"\0"))
    pop2 = P.BlsSigner(seed=b"forged".ljust(32, b"\0")).generate_pop()
    return [
        (CONFIG, [
            signed(P, trustee, 1, {"type": T.TXN_AUTHOR_AGREEMENT_AML,
                                   "version": "1",
                                   "aml": {"click": "desc"}}),
            signed(P, trustee, 2, {"type": T.TXN_AUTHOR_AGREEMENT,
                                   "version": "1", "text": "agree",
                                   "ratification_ts": 900}),
            signed(P, idle, 3, {"type": T.TXN_AUTHOR_AGREEMENT,
                                "version": "9", "text": "mine",
                                "ratification_ts": 900})],
         [True] * 3, 0, 1),
        (DOMAIN, [
            signed(P, trustee, 4, {"type": NYM, "dest": user.identifier,
                                   "verkey": user.verkey_b58}, taa=acc),
            nym(0, 5),
            nym(1, 6, taa=acc, corrupt=True),
            nym(2, 7, taa=wave),
            nym(3, 8, taa=acc)],
         [True, True, False, True, True], 0, 2),
        (DOMAIN, [
            signed(P, user, 9, {"type": T.ATTRIB, "dest": user.identifier,
                                "raw": json.dumps({"endpoint":
                                                   "10.0.0.9:9702"})},
                   taa=acc),
            signed(P, idle, 10, {"type": T.ATTRIB, "dest": user.identifier,
                                 "raw": json.dumps({"x": 1})}, taa=acc),
            signed(P, user, 11, {"type": T.ATTRIB, "dest": user.identifier,
                                 "enc": "ciphertextblob"}, taa=acc)],
         [True] * 3, 0, 1),
        (POOL, [
            node(trustee, 12, "Node4", {"node_ip": "10.0.0.4",
                                        "node_port": 9701,
                                        "client_ip": "10.0.0.4",
                                        "client_port": 9702}),
            node(trustee, 13, "Node3", {"blskey": vk3, "blskey_pop": pop3}),
            node(trustee, 20, "Node2", {"blskey": vk3, "blskey_pop": pop2}),
            node(idle, 14, "Node2", {"node_port": 9999}),
            node(idle, 15, "Node5", {"services": ["VALIDATOR"]})],
         [True] * 5, 1, 2),
        (CONFIG, [
            signed(P, trustee, 16, {"type": T.LEDGERS_FREEZE,
                                    "ledgers_ids": [909]}),
            signed(P, trustee, 21, {"type": T.LEDGERS_FREEZE,
                                    "ledgers_ids": [DOMAIN]}),
            signed(P, trustee, 17,
                   {"type": T.TXN_AUTHOR_AGREEMENT_DISABLE})],
         [True] * 3, 1, 0),
        (DOMAIN, [nym(4, 18), nym(5, 19, taa=acc)], [True] * 2, 0, 1),
    ]


def mixed_reads(P, trustee) -> list:
    user = P.Signer(seed=b"mixed-user".ljust(32, b"\0"))
    return [P.Request(trustee.identifier, 100 + i, op) for i, op in
            enumerate([
                {"type": T.GET_ATTR, "dest": user.identifier,
                 "attr_name": "endpoint"},
                {"type": GET_NYM, "dest": user.identifier},
                {"type": T.GET_TXN_AUTHOR_AGREEMENT},
                {"type": T.GET_TXN_AUTHOR_AGREEMENT,
                 "timestamp": int(pp_time_of(3))},
                {"type": T.GET_TXN_AUTHOR_AGREEMENT_AML},
                {"type": T.GET_FROZEN_LEDGERS},
                {"type": T.GET_TXN, "ledgerId": POOL, "data": 6},
                {"type": T.GET_TXN, "ledgerId": CONFIG, "data": 3}])]


def run_mixed(P, c, trustee) -> list:
    """The mixed script on one replica: authenticate, validate statically
    as a node does on receipt, apply on the batch's ledger, commit; then
    the reads. -> everything it answered."""
    out = []
    for k, (lid, reqs, expect, n_refused, n_discarded) in \
            enumerate(mixed_script(P, trustee), start=1):
        verdicts = c.authenticator.authenticate_batch(reqs).tolist()
        assert verdicts == expect, k
        accepted, refused = [], []
        for r, ok in zip(reqs, verdicts):
            try:
                c.write_manager.static_validation(r)
            except Exception as e:
                refused.append((type(e).__name__, r.digest, e.reason))
                continue
            if ok:
                accepted.append(r)
        assert len(refused) == n_refused, k
        out.append(refused)
        a = c.executor.apply_batch(lid, accepted, pp_time_of(k), view_no=0,
                                   pp_seq_no=k, primaries=[NAMES[0]])
        assert len(a.discarded) == n_discarded, k
        batch = P.ThreePcBatch(
            ledger_id=lid, view_no=0, pp_seq_no=k, pp_time=pp_time_of(k),
            valid_digests=a.valid_digests,
            state_root=bytes.fromhex(a.state_root),
            txn_root=bytes.fromhex(a.txn_root),
            audit_txn_root=bytes.fromhex(a.audit_txn_root))
        out.append((verdicts, tuple(a), pack(c.executor.commit_batch(batch))))
    out.append([pack(c.read_manager.get_result(r))
                for r in mixed_reads(P, trustee)])
    return out


def all_state(c) -> dict:
    return {lid: c.db.get_state(lid).as_dict() for lid in c.db.ledger_ids
            if c.db.get_state(lid) is not None}


MIXED = {
    "mpt": {},
    "verkle": {"state_commitment": "verkle"},
    "chunked": {"storage_backend": "chunked"},
    "native": {"storage_backend": "native"},
}


@pytest.mark.parametrize("kind", sorted(MIXED))
def test_every_write_type_equals_the_reference(kind, tmp_path):
    """The mixed script through one replica of each package: in memory on
    the port's torch ring (MPT, and Verkle, whose commitments go through
    the ring's cmt lane), and on disk (chunked and native stores, opened
    again after the script). Verdicts, applies, commits, the reads, every
    store's rows and every state equal the reference's."""
    ref_gen, ref_trustee = genesis(REF)
    gen, trustee = genesis(PORT)
    kw = MIXED[kind]
    on_disk = "storage_backend" in kw
    pipe = small_ring()
    jobs = []
    run = pipe._cmt_run

    def counted(chunk):
        jobs.extend(job[0] for job in chunk)
        return run(chunk)
    pipe._cmt_run = counted

    def both(**extra):
        ref_c = REF.NodeBootstrap(
            NAMES[0], genesis_txns=ref_gen, crypto_backend="cpu",
            data_dir=str(tmp_path / "ref") if on_disk else None,
            **kw, **extra).build()
        port_kw = ({"crypto_backend": "cpu"} if on_disk
                   else {"pipeline": pipe})
        port_c = NodeBootstrap(
            NAMES[0], genesis_txns=gen,
            data_dir=str(tmp_path / "port") if on_disk else None,
            **kw, **port_kw, **extra).build()
        return ref_c, port_c

    ref_c, port_c = both()
    assert roots(port_c) == roots(ref_c)
    got = run_mixed(PORT, port_c, trustee)
    assert got == run_mixed(REF, ref_c, ref_trustee)
    assert roots(port_c) == roots(ref_c)
    assert all_state(port_c) == all_state(ref_c)
    assert convert.replica_rows(port_c) == convert.replica_rows(ref_c)
    reads = [unpack(r) for r in got[-1]]
    assert reads[0]["data"] == '{"endpoint": "10.0.0.9:9702"}'
    assert reads[2]["data"] is None and reads[3]["data"]["version"] == "1"
    assert set(reads[5]["data"]) == {"909"}
    assert reads[6]["data"] is not None and reads[7]["data"] is not None
    if not on_disk:
        assert pipe.stats["cmt_host_fallbacks"] == 0
        # the Verkle commitments went through the ring's KZG engine
        assert ("commit" in jobs) == (kind == "verkle")
    if on_disk:
        want = roots(ref_c)
        ref_c.db.close()
        port_c.db.close()
        ref_c, port_c = both()
        assert roots(port_c) == roots(ref_c) == want
        assert all_state(port_c) == all_state(ref_c)
        ref_c.db.close()
        port_c.db.close()
