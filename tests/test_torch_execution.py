"""The port's copy of tests/test_execution.py, run on plenum_tpu_torch.

Execution-layer tests: handlers, write manager lifecycle, audit ledger.

Mirrors the reference's handler/batch-handler unit tests
(plenum/test/req_handler tests, audit_ledger/) at the same seams.
"""
import pytest

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution import (DatabaseManager, LedgerBatchExecutor,
                                        ReadRequestManager, ThreePcBatch,
                                        WriteRequestManager)
from plenum_tpu_torch.execution.database_manager import SEQ_NO_DB_LABEL, TS_STORE_LABEL
from plenum_tpu_torch.execution.exceptions import (InvalidClientRequest,
                                                   UnauthorizedClientRequest)
from plenum_tpu_torch.execution.handlers import (GetNymHandler,
                                                 GetTxnAuthorAgreementAmlHandler,
                                                 GetTxnAuthorAgreementHandler,
                                                 GetTxnHandler, NodeHandler,
                                                 NymHandler,
                                                 TxnAuthorAgreementAmlHandler,
                                                 TxnAuthorAgreementHandler)
from plenum_tpu_torch.execution.handlers import audit as audit_lib
from plenum_tpu_torch.execution.handlers.taa import taa_digest
from plenum_tpu_torch.execution.txn import (NYM, STEWARD, TRUSTEE,
                                            TXN_AUTHOR_AGREEMENT,
                                            TXN_AUTHOR_AGREEMENT_AML)
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.storage.kv_memory import KvMemory
from plenum_tpu_torch.storage.state_ts_store import StateTsStore


TRUSTEE_DID = "trusteeTrusteeTrustee1"
STEWARD_DID = "stewardStewardSteward1"
USER_DID = "userUserUserUserUser11"


def make_db():
    db = DatabaseManager()
    for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
                AUDIT_LEDGER_ID):
        state = None if lid == AUDIT_LEDGER_ID else PruningState()
        db.register_ledger(lid, Ledger(), state)
    db.register_store(TS_STORE_LABEL, StateTsStore(KvMemory()))
    db.register_store(SEQ_NO_DB_LABEL, KvMemory())
    return db


@pytest.fixture
def db():
    return make_db()


def make_managers(db):
    wm = WriteRequestManager(db)
    nym = NymHandler(db)
    wm.register_handler(nym)
    wm.register_handler(NodeHandler(db, nym))
    wm.register_handler(TxnAuthorAgreementHandler(db, nym))
    wm.register_handler(TxnAuthorAgreementAmlHandler(db, nym))
    rm = ReadRequestManager()
    rm.register_handler(GetNymHandler(db))
    rm.register_handler(GetTxnHandler(db))
    rm.register_handler(GetTxnAuthorAgreementHandler(db))
    rm.register_handler(GetTxnAuthorAgreementAmlHandler(db))
    return wm, rm


def nym_req(author, dest, role=None, verkey="vk", req_id=1, taa=None):
    op = {"type": NYM, "dest": dest, "verkey": verkey}
    if role is not None:
        op["role"] = role
    return Request(author, req_id, op, signature="sig", taa_acceptance=taa)


def bootstrap_trustee(wm, pp=1):
    """First NYM into empty state is allowed (pool bootstrap)."""
    req = nym_req(TRUSTEE_DID, TRUSTEE_DID, role=TRUSTEE)
    valid, rejected, roots = wm.apply_batch(DOMAIN_LEDGER_ID, [req],
                                            pp_time=1000.0, view_no=0,
                                            pp_seq_no=pp)
    assert len(valid) == 1 and not rejected
    return roots


class TestNymHandler:
    def test_bootstrap_then_permissioned(self, db):
        wm, _ = make_managers(db)
        bootstrap_trustee(wm)
        # trustee can create
        ok, rej, _ = wm.apply_batch(DOMAIN_LEDGER_ID,
                                    [nym_req(TRUSTEE_DID, USER_DID, req_id=2)],
                                    1001.0, 0, 2)
        assert len(ok) == 1 and not rej
        # a plain user cannot create another DID
        ok, rej, _ = wm.apply_batch(DOMAIN_LEDGER_ID,
                                    [nym_req(USER_DID, "otherDid111", req_id=3)],
                                    1002.0, 0, 3)
        assert not ok and len(rej) == 1

    def test_owner_can_rotate_key_but_not_role(self, db):
        wm, _ = make_managers(db)
        bootstrap_trustee(wm)
        wm.apply_batch(DOMAIN_LEDGER_ID,
                       [nym_req(TRUSTEE_DID, USER_DID, req_id=2)], 1001.0, 0, 2)
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID,
            [nym_req(USER_DID, USER_DID, verkey="newvk", req_id=3)],
            1002.0, 0, 3)
        assert len(ok) == 1
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID,
            [nym_req(USER_DID, USER_DID, role=TRUSTEE, req_id=4)],
            1003.0, 0, 4)
        assert len(rej) == 1

    def test_static_validation(self, db):
        wm, _ = make_managers(db)
        with pytest.raises(InvalidClientRequest):
            wm.static_validation(Request("a", 1, {"type": NYM}))
        with pytest.raises(InvalidClientRequest):
            wm.static_validation(
                Request("a", 1, {"type": NYM, "dest": "d", "role": "99"}))


class TestWriteLifecycle:
    def test_apply_commit_updates_seq_no_and_ts(self, db):
        wm, _ = make_managers(db)
        roots = bootstrap_trustee(wm)
        batch = ThreePcBatch(DOMAIN_LEDGER_ID, 0, 1, 1000.0, ("x",),
                             bytes.fromhex(roots["state_root"]),
                             bytes.fromhex(roots["txn_root"]),
                             bytes.fromhex(roots["audit_txn_root"]))
        committed = wm.commit_batch(batch)
        assert len(committed) == 1
        ledger = db.get_ledger(DOMAIN_LEDGER_ID)
        assert ledger.size == 1
        assert db.get_ledger(AUDIT_LEDGER_ID).size == 1
        assert db.get_store(TS_STORE_LABEL).get(
            DOMAIN_LEDGER_ID, 1000) is not None

    def test_revert_is_exact_inverse(self, db):
        wm, _ = make_managers(db)
        state = db.get_state(DOMAIN_LEDGER_ID)
        root0 = state.head_hash
        ledger = db.get_ledger(DOMAIN_LEDGER_ID)
        bootstrap_trustee(wm)
        assert state.head_hash != root0
        wm.revert_last_batch(DOMAIN_LEDGER_ID)
        assert state.head_hash == root0
        assert ledger.uncommitted_size == 0
        assert db.get_ledger(AUDIT_LEDGER_ID).uncommitted_txns == []

    def test_multi_batch_revert_interleaved(self, db):
        wm, _ = make_managers(db)
        bootstrap_trustee(wm, pp=1)
        state = db.get_state(DOMAIN_LEDGER_ID)
        mid_root = state.head_hash
        wm.apply_batch(DOMAIN_LEDGER_ID,
                       [nym_req(TRUSTEE_DID, USER_DID, req_id=2)], 1001.0, 0, 2)
        assert state.head_hash != mid_root
        wm.revert_last_batch(DOMAIN_LEDGER_ID)
        assert state.head_hash == mid_root
        assert wm.uncommitted_batch_count == 1


class TestAuditLedger:
    def test_audit_snapshot_and_backrefs(self, db):
        wm, _ = make_managers(db)
        for i in range(3):
            r = bootstrap_trustee(wm, pp=i + 1) if i == 0 else \
                wm.apply_batch(DOMAIN_LEDGER_ID,
                               [nym_req(TRUSTEE_DID, f"did{i}xxxxxxxxxxxxxxxx",
                                        req_id=10 + i)],
                               1000.0 + i, 0, i + 1)[2]
            wm.commit_batch(ThreePcBatch(
                DOMAIN_LEDGER_ID, 0, i + 1, 1000.0 + i, (),
                bytes.fromhex(r["state_root"]), b"", b""))
        audit = db.get_ledger(AUDIT_LEDGER_ID)
        assert audit.size == 3
        last = audit_lib.last_audit_txn(audit)
        view_no, pp_seq_no, _ = audit_lib.last_audited_view(audit)
        assert (view_no, pp_seq_no) == (0, 3)
        # domain root is stored literally; pool root is a back-reference
        domain_root = audit_lib.resolve_ledger_root(audit, last, DOMAIN_LEDGER_ID)
        assert domain_root == db.get_ledger(DOMAIN_LEDGER_ID).root_hash.hex()
        pool_root = audit_lib.resolve_ledger_root(audit, last, POOL_LEDGER_ID)
        assert pool_root == db.get_ledger(POOL_LEDGER_ID).root_hash.hex()


class TestTaa:
    def _setup_taa(self, wm):
        roots1 = bootstrap_trustee(wm)
        taa = Request(TRUSTEE_DID, 5,
                      {"type": TXN_AUTHOR_AGREEMENT, "version": "1",
                       "text": "agree", "ratification_ts": 900},
                      signature="s")
        aml = Request(TRUSTEE_DID, 6,
                      {"type": TXN_AUTHOR_AGREEMENT_AML, "version": "1",
                       "aml": {"click": "desc"}}, signature="s")
        ok, rej, roots2 = wm.apply_batch(CONFIG_LEDGER_ID, [aml, taa],
                                         1001.0, 0, 2)
        assert len(ok) == 2, rej
        wm.commit_batch(ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, 1, 1000.0, (),
            bytes.fromhex(roots1["state_root"]), b"", b""))
        wm.commit_batch(ThreePcBatch(
            CONFIG_LEDGER_ID, 0, 2, 1001.0, (),
            bytes.fromhex(roots2["state_root"]), b"", b""))

    def test_domain_write_requires_acceptance(self, db):
        wm, rm = make_managers(db)
        self._setup_taa(wm)
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID, [nym_req(TRUSTEE_DID, USER_DID, req_id=7)],
            1002.0, 0, 3)
        assert len(rej) == 1 and "agreement" in rej[0][1]
        acceptance = {"taaDigest": taa_digest("agree", "1"),
                      "mechanism": "click", "time": 1002}
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID,
            [nym_req(TRUSTEE_DID, USER_DID, req_id=8, taa=acceptance)],
            1003.0, 0, 4)
        assert len(ok) == 1, rej
        # read it back
        res = rm.get_result(Request("x", 9, {"type": "6"}))
        assert res["data"]["version"] == "1"

    def test_historic_taa_read_at_timestamp(self, db):
        """State-as-of-time-T: after TAA v1 (t=1001) and a v2 update
        (t=2000), GET_TAA at timestamp 1500 must return v1, at 2500 v2,
        and before any config batch None (ref
        get_txn_author_agreement_handler.py:46 + state_ts_store.py:38)."""
        wm, rm = make_managers(db)
        self._setup_taa(wm)
        taa2 = Request(TRUSTEE_DID, 7,
                       {"type": TXN_AUTHOR_AGREEMENT, "version": "2",
                        "text": "agree harder", "ratification_ts": 1900},
                       signature="s")
        ok, rej, roots = wm.apply_batch(CONFIG_LEDGER_ID, [taa2],
                                        2000.0, 0, 3)
        assert len(ok) == 1, rej
        wm.commit_batch(ThreePcBatch(
            CONFIG_LEDGER_ID, 0, 3, 2000.0, (),
            bytes.fromhex(roots["state_root"]), b"", b""))
        q = lambda ts: rm.get_result(
            Request("x", 9, {"type": "6", "timestamp": ts}))["data"]
        assert q(1500)["version"] == "1"
        assert q(2500)["version"] == "2"
        assert q(2000)["version"] == "2"    # equal-or-prev: equal hits
        assert q(500) is None               # before any config batch
        # latest (no timestamp) still reads the committed head
        res = rm.get_result(Request("x", 10, {"type": "6"}))
        assert res["data"]["version"] == "2"
        # AML as of time T rides the same root resolution
        aml = rm.get_result(
            Request("x", 11, {"type": "7", "timestamp": 1500}))["data"]
        assert aml is not None and aml["version"] == "1"
        assert rm.get_result(
            Request("x", 12, {"type": "7", "timestamp": 500}))["data"] is None

    def test_bad_mechanism_rejected(self, db):
        wm, _ = make_managers(db)
        self._setup_taa(wm)
        acceptance = {"taaDigest": taa_digest("agree", "1"),
                      "mechanism": "wave", "time": 1002}
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID,
            [nym_req(TRUSTEE_DID, USER_DID, req_id=8, taa=acceptance)],
            1003.0, 0, 3)
        assert len(rej) == 1 and "mechanism" in rej[0][1]


class TestReads:
    def test_get_nym_with_state_proof(self, db):
        wm, rm = make_managers(db)
        roots = bootstrap_trustee(wm)
        wm.commit_batch(ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, 1, 1000.0, (),
            bytes.fromhex(roots["state_root"]), b"", b""))
        res = rm.get_result(Request("x", 1, {"type": "105",
                                             "dest": TRUSTEE_DID}))
        assert res["data"]["verkey"] == "vk"
        sp = res["state_proof"]
        state = db.get_state(DOMAIN_LEDGER_ID)
        from plenum_tpu_torch.state.pruning_state import PruningState as PS
        from plenum_tpu_torch.common.serialization import pack
        value = state.get(TRUSTEE_DID.encode(), committed=True)
        assert PS.verify_state_proof(bytes.fromhex(sp["root_hash"]),
                                     TRUSTEE_DID.encode(), value,
                                     bytes.fromhex(sp["proof_nodes"]))

    def test_get_txn_merkle_proof(self, db):
        wm, rm = make_managers(db)
        roots = bootstrap_trustee(wm)
        wm.commit_batch(ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, 1, 1000.0, (),
            bytes.fromhex(roots["state_root"]), b"", b""))
        res = rm.get_result(Request("x", 1, {"type": "3", "data": 1,
                                             "ledgerId": DOMAIN_LEDGER_ID}))
        assert res["data"] is not None
        assert res["merkle_proof"] is not None


class TestExecutorSeam:
    def test_applied_batch_roots(self, db):
        wm, _ = make_managers(db)
        ex = LedgerBatchExecutor(wm)
        req = nym_req(TRUSTEE_DID, TRUSTEE_DID, role=TRUSTEE)
        applied = ex.apply_batch(DOMAIN_LEDGER_ID, [req], 1000.0, 0, 1)
        assert applied.valid_digests == (req.digest,)
        assert applied.state_root
        assert applied.txn_root
        assert applied.audit_txn_root
        assert ex.ledger_id_for(req) == DOMAIN_LEDGER_ID
        ex.revert_last_batch(DOMAIN_LEDGER_ID)
        assert wm.uncommitted_batch_count == 0


class TestAttribHandler:
    """ATTRIB write + GET_ATTR read (BASELINE config 2's second write type;
    indy-node semantics at the plenum layer — see handlers/attrib.py)."""

    def _managers(self, db):
        from plenum_tpu_torch.execution.handlers.attrib import (
            ATTRIB_STORE_LABEL, AttribHandler, GetAttrHandler)
        wm, rm = make_managers(db)
        db.register_store(ATTRIB_STORE_LABEL, KvMemory())
        wm.register_handler(AttribHandler(db))
        rm.register_handler(GetAttrHandler(db))
        return wm, rm

    def _attrib_req(self, author, dest, raw=None, req_id=10, **extra):
        from plenum_tpu_torch.execution.txn import ATTRIB
        op = {"type": ATTRIB, "dest": dest}
        if raw is not None:
            op["raw"] = raw
        op.update(extra)
        return Request(author, req_id, op, signature="sig")

    def test_owner_sets_attr_and_reads_it_back_with_proof(self, db):
        import json
        from plenum_tpu_torch.execution.txn import GET_ATTR
        wm, rm = self._managers(db)
        bootstrap_trustee(wm)
        wm.apply_batch(DOMAIN_LEDGER_ID,
                       [nym_req(TRUSTEE_DID, USER_DID, req_id=2)],
                       pp_time=1001.0, view_no=0, pp_seq_no=2)
        req = self._attrib_req(USER_DID, USER_DID,
                               raw=json.dumps({"endpoint": "127.0.0.1:99"}))
        valid, rejected, _ = wm.apply_batch(DOMAIN_LEDGER_ID, [req],
                                            pp_time=1002.0, view_no=0,
                                            pp_seq_no=3)
        assert len(valid) == 1 and not rejected
        for seq in (1, 2, 3):
            wm.commit_batch(ThreePcBatch(
                ledger_id=DOMAIN_LEDGER_ID, view_no=0, pp_seq_no=seq,
                pp_time=1002.0, valid_digests=(req.digest,) if seq == 3
                else (),
                state_root=b"", txn_root=b"", audit_txn_root=b""))

        q = Request(USER_DID, 11, {"type": GET_ATTR, "dest": USER_DID,
                                   "attr_name": "endpoint"})
        result = rm.get_result(q)
        assert json.loads(result["data"]) == {"endpoint": "127.0.0.1:99"}
        assert result["meta"]["kind"] == "raw"
        assert result["state_proof"]["proof_nodes"]

    def test_stranger_cannot_set_attr(self, db):
        import json
        wm, _ = self._managers(db)
        bootstrap_trustee(wm)
        for did, rid in ((USER_DID, 2), (STEWARD_DID, 3)):
            wm.apply_batch(DOMAIN_LEDGER_ID,
                           [nym_req(TRUSTEE_DID, did, req_id=rid)],
                           pp_time=1001.0, view_no=0, pp_seq_no=rid)
        req = self._attrib_req(STEWARD_DID, USER_DID,
                               raw=json.dumps({"x": 1}))
        valid, rejected, _ = wm.apply_batch(DOMAIN_LEDGER_ID, [req],
                                            pp_time=1002.0, view_no=0,
                                            pp_seq_no=4)
        assert not valid and len(rejected) == 1

    def test_attr_on_unknown_did_rejected(self, db):
        import json
        wm, _ = self._managers(db)
        bootstrap_trustee(wm)
        req = self._attrib_req(TRUSTEE_DID, "ghostGhostGhostGhost11",
                               raw=json.dumps({"x": 1}))
        valid, rejected, _ = wm.apply_batch(DOMAIN_LEDGER_ID, [req],
                                            pp_time=1002.0, view_no=0,
                                            pp_seq_no=2)
        assert not valid and len(rejected) == 1

    def test_exactly_one_of_raw_enc_hash(self, db):
        import json
        wm, _ = self._managers(db)
        with pytest.raises(InvalidClientRequest):
            wm.static_validation(self._attrib_req(USER_DID, USER_DID))
        with pytest.raises(InvalidClientRequest):
            wm.static_validation(self._attrib_req(
                USER_DID, USER_DID, raw=json.dumps({"a": 1}), enc="blob"))
        with pytest.raises(InvalidClientRequest):
            wm.static_validation(self._attrib_req(
                USER_DID, USER_DID, raw=json.dumps({"a": 1, "b": 2})))
        wm.static_validation(self._attrib_req(USER_DID, USER_DID,
                                              enc="ciphertextblob", req_id=1))


class TestTxnVersionDispatch:
    """Version-keyed handler selection (ref txn_version_controller.py:1,
    write_request_manager.py:113): a v2-format handler serves payloads
    carrying ver="2"; unversioned payloads keep flowing through the
    default handler — no flag day."""

    def _wm_with_v2(self, db):
        from plenum_tpu_torch.common.serialization import unpack as _unpack
        from plenum_tpu_torch.execution.handlers.nym import (NymHandler,
                                                             nym_state_key)

        class NymV2Handler(NymHandler):
            """v2 payload: requires a 'diddoc' field and records it."""

            def static_validation(self, request):
                super().static_validation(request)
                self._require(isinstance(request.operation.get("diddoc"),
                                         str), request,
                              "NYM v2 needs a diddoc")

            def gen_txn(self, request):
                txn = super().gen_txn(request)
                txn["txn"]["data"]["diddoc"] = request.operation["diddoc"]
                return txn

        wm, _ = make_managers(db)
        wm.register_handler(NymV2Handler(db), version="2")
        return wm, nym_state_key, _unpack

    def test_both_versions_apply_through_their_handlers(self, db):
        wm, nym_state_key, _unpack = self._wm_with_v2(db)
        bootstrap_trustee(wm)
        # v1 (no ver field): default handler, no diddoc requirement
        ok, rej, _ = wm.apply_batch(
            DOMAIN_LEDGER_ID, [nym_req(TRUSTEE_DID, USER_DID, req_id=2)],
            1001.0, 0, 2)
        assert len(ok) == 1 and not rej
        # v2 payload without the new field: NACKed by the v2 handler's
        # static validation (the client-intake seam); the v1 payload above
        # sailed through because it routed to the default handler
        op = {"type": NYM, "dest": "v2dest1111", "verkey": "vk", "ver": "2"}
        bad = Request(TRUSTEE_DID, 3, op, signature="sig")
        with pytest.raises(InvalidClientRequest, match="diddoc"):
            wm.static_validation(bad)
        # well-formed v2 payload: applied by the v2 handler, txn stamped
        op = dict(op, diddoc="doc-123")
        good = Request(TRUSTEE_DID, 4, op, signature="sig")
        ok, rej, _ = wm.apply_batch(DOMAIN_LEDGER_ID, [good], 1003.0, 0, 3)
        assert len(ok) == 1 and not rej, rej
        from plenum_tpu_torch.execution import txn as txn_lib
        raw = db.get_state(DOMAIN_LEDGER_ID).get(
            nym_state_key("v2dest1111"), committed=False)
        assert _unpack(raw)["verkey"] == "vk"

    def test_version_stamp_survives_committed_replay(self, db):
        """A v2-minted txn re-applied via the catchup path must dispatch
        to the v2 handler again (the txn carries its format version)."""
        wm, nym_state_key, _unpack = self._wm_with_v2(db)
        bootstrap_trustee(wm)
        op = {"type": NYM, "dest": "v2dest2222", "verkey": "vk",
              "ver": "2", "diddoc": "doc-xyz"}
        req = Request(TRUSTEE_DID, 5, op, signature="sig")
        ok, _, roots = wm.apply_batch(DOMAIN_LEDGER_ID, [req], 1004.0, 0, 2)
        assert len(ok) == 1
        batch = ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, 2, 1004.0, (req.digest,),
            bytes.fromhex(roots["state_root"]),
            bytes.fromhex(roots["txn_root"]),
            bytes.fromhex(roots["audit_txn_root"]))
        wm.commit_batch(ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, 1, 1000.0, (),
            db.get_state(DOMAIN_LEDGER_ID).head_hash,
            b"", b""))
        committed = wm.commit_batch(batch)
        # payload-level stamp (ref get_payload_txn_version); the envelope
        # "ver" stays "1" — it is the txn FORMAT version, not the payload's
        assert committed and committed[0]["txn"].get("ver") == "2"
        assert committed[0].get("ver") == "1"
        # replay into a FRESH db through apply_committed_txn
        db2 = make_db()
        wm2 = self._wm_with_v2(db2)[0]
        for txn in committed:
            wm2.apply_committed_txn(DOMAIN_LEDGER_ID, dict(txn))
        raw = db2.get_state(DOMAIN_LEDGER_ID).get(
            nym_state_key("v2dest2222"), committed=True)
        assert _unpack(raw)["verkey"] == "vk"
