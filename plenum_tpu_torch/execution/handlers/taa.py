"""Transaction Author Agreement handlers (config ledger).

Reference behavior: plenum's TAA family (request_handlers/txn_author_agreement*
— six handlers): a trustee publishes agreement text+version (ratified at a
timestamp); clients must attach a taaAcceptance (digest, mechanism, time) to
domain writes; an AML lists valid acceptance mechanisms; disable retires all
agreements at once. Digest = sha256(version || text).

State layout (config state): "taa:latest" -> digest, "taa:d:<digest>" ->
record, "taa:v:<version>" -> digest, "aml:latest" -> record.
"""
from __future__ import annotations

import hashlib
from typing import Optional

from plenum_tpu_torch.common.node_messages import CONFIG_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.exceptions import UnauthorizedClientRequest
from plenum_tpu_torch.execution.txn import (GET_TXN_AUTHOR_AGREEMENT,
                                            GET_TXN_AUTHOR_AGREEMENT_AML,
                                            TRUSTEE, TXN_AUTHOR_AGREEMENT,
                                            TXN_AUTHOR_AGREEMENT_AML,
                                            TXN_AUTHOR_AGREEMENT_DISABLE)

from .base import ReadRequestHandler, WriteRequestHandler
from .nym import NymHandler

KEY_LATEST = b"taa:latest"
KEY_AML_LATEST = b"aml:latest"


def taa_digest(text: str, version: str) -> str:
    return hashlib.sha256((version + text).encode()).hexdigest()


def _digest_key(digest: str) -> bytes:
    return b"taa:d:" + digest.encode()


def _historic_config_root(db, ts) -> Optional[bytes]:
    """Config-state root committed at-or-before `ts`, via the ts-store
    (ref storage/state_ts_store.py:38 get_equal_or_prev); None when the
    store is absent or no config batch existed yet at that time."""
    ts_store = db.ts_store
    if ts_store is None:
        return None
    return ts_store.get_equal_or_prev(ts, CONFIG_LEDGER_ID)


def _version_key(version: str) -> bytes:
    return b"taa:v:" + version.encode()


class _ConfigWriteHandler(WriteRequestHandler):
    """Shared trustee-only gate for config-ledger writes."""

    def __init__(self, db, txn_type, nym_handler: Optional[NymHandler]):
        super().__init__(db, txn_type, CONFIG_LEDGER_ID)
        self._nym = nym_handler

    def dynamic_validation(self, request: Request, pp_time) -> None:
        if self._nym is None:
            return
        rec = self._nym._read(request.identifier)
        if not rec or rec.get("role") != TRUSTEE:
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                f"{self.txn_type} requires a trustee")


class TxnAuthorAgreementHandler(_ConfigWriteHandler):
    def __init__(self, db, nym_handler=None):
        super().__init__(db, TXN_AUTHOR_AGREEMENT, nym_handler)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        self._require(isinstance(op.get("version"), str) and op["version"],
                      request, "TAA needs a version")
        existing = self.state.get(_version_key(op["version"]), committed=False)
        if existing is None:
            self._require(isinstance(op.get("text"), str), request,
                          "a new TAA version needs text")

    def gen_txn(self, request: Request) -> dict:
        op = request.operation
        data = {"version": op["version"]}
        for f in ("text", "ratification_ts", "retirement_ts"):
            if op.get(f) is not None:
                data[f] = op[f]
        return txn_lib.new_txn(TXN_AUTHOR_AGREEMENT, data, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        data = txn_lib.txn_data(txn)
        version = data["version"]
        prev_digest_raw = self.state.get(_version_key(version), committed=False)
        if prev_digest_raw is not None and "text" not in data:
            # retirement update of an existing version
            digest = prev_digest_raw.decode()
            rec = unpack(self.state.get(_digest_key(digest), committed=False))
            rec.update({k: data[k] for k in ("retirement_ts",) if k in data})
        else:
            digest = taa_digest(data.get("text", ""), version)
            rec = {"text": data.get("text", ""), "version": version,
                   "ratification_ts": data.get("ratification_ts",
                                               txn_lib.txn_time(txn)),
                   "digest": digest, "seqNo": txn_lib.txn_seq_no(txn),
                   "txnTime": txn_lib.txn_time(txn)}
            if "retirement_ts" in data:
                rec["retirement_ts"] = data["retirement_ts"]
        self.state.set(_digest_key(digest), pack(rec))
        self.state.set(_version_key(version), digest.encode())
        if "text" in data:
            self.state.set(KEY_LATEST, digest.encode())


class TxnAuthorAgreementAmlHandler(_ConfigWriteHandler):
    def __init__(self, db, nym_handler=None):
        super().__init__(db, TXN_AUTHOR_AGREEMENT_AML, nym_handler)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        self._require(isinstance(op.get("version"), str) and op["version"],
                      request, "AML needs a version")
        self._require(isinstance(op.get("aml"), dict) and op["aml"], request,
                      "AML needs a non-empty mechanisms map")

    def gen_txn(self, request: Request) -> dict:
        op = request.operation
        data = {"version": op["version"], "aml": op["aml"]}
        if op.get("amlContext") is not None:
            data["amlContext"] = op["amlContext"]
        return txn_lib.new_txn(TXN_AUTHOR_AGREEMENT_AML, data, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        data = txn_lib.txn_data(txn)
        rec = dict(data)
        rec["seqNo"] = txn_lib.txn_seq_no(txn)
        rec["txnTime"] = txn_lib.txn_time(txn)
        self.state.set(KEY_AML_LATEST, pack(rec))
        self.state.set(b"aml:v:" + data["version"].encode(), pack(rec))


class TxnAuthorAgreementDisableHandler(_ConfigWriteHandler):
    def __init__(self, db, nym_handler=None):
        super().__init__(db, TXN_AUTHOR_AGREEMENT_DISABLE, nym_handler)

    def gen_txn(self, request: Request) -> dict:
        return txn_lib.new_txn(TXN_AUTHOR_AGREEMENT_DISABLE, {}, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        # retire every agreement now; clear the latest pointer
        now = txn_lib.txn_time(txn)
        for key, raw in list(self.state.as_dict(committed=False).items()):
            if key.startswith(b"taa:d:"):
                rec = unpack(raw)
                if rec.get("retirement_ts") is None or \
                        rec["retirement_ts"] > now:
                    rec["retirement_ts"] = now
                    self.state.set(key, pack(rec))
        self.state.remove(KEY_LATEST)


class GetTxnAuthorAgreementHandler(ReadRequestHandler):
    """Latest TAA, by digest/version, or AS OF A TIMESTAMP: the ts-store
    maps the query time to the config-state root committed at-or-before it
    and the read runs against that historic root (ref
    request_handlers/get_txn_author_agreement_handler.py:46 +
    storage/state_ts_store.py:38 get_equal_or_prev)."""

    def __init__(self, db):
        super().__init__(db, GET_TXN_AUTHOR_AGREEMENT, CONFIG_LEDGER_ID)

    def get_result(self, request: Request) -> dict:
        op = request.operation
        raw = None
        if op.get("digest"):
            raw = self.state.get(_digest_key(op["digest"]), committed=True)
        elif op.get("version"):
            ptr = self.state.get(_version_key(op["version"]), committed=True)
            if ptr is not None:
                raw = self.state.get(_digest_key(ptr.decode()), committed=True)
        elif op.get("timestamp") is not None:
            root = _historic_config_root(self.db, op["timestamp"])
            if root is not None:
                ptr = self.state.get_for_root(KEY_LATEST, root)
                if ptr is not None:
                    raw = self.state.get_for_root(_digest_key(ptr.decode()),
                                                  root)
        else:
            ptr = self.state.get(KEY_LATEST, committed=True)
            if ptr is not None:
                raw = self.state.get(_digest_key(ptr.decode()), committed=True)
        return {"type": GET_TXN_AUTHOR_AGREEMENT,
                "data": unpack(raw) if raw is not None else None}


class GetTxnAuthorAgreementAmlHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_TXN_AUTHOR_AGREEMENT_AML, CONFIG_LEDGER_ID)

    def get_result(self, request: Request) -> dict:
        op = request.operation
        if op.get("version"):
            raw = self.state.get(b"aml:v:" + op["version"].encode(),
                                 committed=True)
        elif op.get("timestamp") is not None:
            # AML as of time T (ref get_txn_author_agreement_aml_handler:36)
            raw = None
            root = _historic_config_root(self.db, op["timestamp"])
            if root is not None:
                raw = self.state.get_for_root(KEY_AML_LATEST, root)
        else:
            raw = self.state.get(KEY_AML_LATEST, committed=True)
        return {"type": GET_TXN_AUTHOR_AGREEMENT_AML,
                "data": unpack(raw) if raw is not None else None}
