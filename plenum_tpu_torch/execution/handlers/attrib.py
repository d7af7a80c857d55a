"""ATTRIB write + GET_ATTR read handlers (domain ledger).

Reference behavior: the ATTRIB txn type lives downstream in indy-node
(attrib_handler.py there; plenum reserves the type code and the attrib
store label, plenum/common/constants.py:272 ATTRIB_LABEL), but the
BASELINE workload mix (config 2: "mixed NYM/ATTRIB batch") treats it as a
core write type, so it is implemented here at the plenum layer.

Semantics (matching indy-node's): an ATTRIB attaches ONE attribute to an
existing DID, exactly one of
  raw  — a JSON string {"name": value}; stored off-state, digest in state
  enc  — an encrypted blob (string); same storage shape
  hash — a client-side sha256 hex digest; only the digest exists
Authorization: the DID owner or a trustee. State carries
key = dest || ":attr:" || sha256(attr_name_or_kind) and value =
msgpack {digest, kind, seqNo, txnTime} so a GET_ATTR reply can prove
(non-)existence with a state proof; the raw/enc payload itself lives in
the attrib KV store (the reference's attrib DB, ATTRIB_LABEL).
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.exceptions import (InvalidClientRequest,
                                                   UnauthorizedClientRequest)
from plenum_tpu_torch.execution.txn import ATTRIB, GET_ATTR, TRUSTEE

from .base import ReadRequestHandler, WriteRequestHandler
from .nym import nym_state_key

ATTRIB_STORE_LABEL = "attrib"


def _attr_field(op: dict) -> tuple[str, str]:
    """-> (kind, value) for the exactly-one of raw/enc/hash."""
    present = [k for k in ("raw", "enc", "hash") if op.get(k) is not None]
    if len(present) != 1:
        raise ValueError("exactly one of raw/enc/hash required")
    return present[0], op[present[0]]


def _attr_name(kind: str, value: str) -> str:
    if kind == "raw":
        parsed = json.loads(value)
        if not isinstance(parsed, dict) or len(parsed) != 1:
            raise ValueError("raw must be a one-key JSON object")
        return next(iter(parsed))
    return value            # enc/hash: the blob identifies itself


def attrib_state_key(dest: str, kind: str, value: str) -> bytes:
    name_digest = hashlib.sha256(
        _attr_name(kind, value).encode()).hexdigest()
    return f"{dest}:attr:{name_digest}".encode()


class AttribHandler(WriteRequestHandler):
    def __init__(self, db):
        super().__init__(db, ATTRIB, DOMAIN_LEDGER_ID)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        self._require(isinstance(op.get("dest"), str) and op["dest"], request,
                      "ATTRIB needs a dest DID")
        try:
            kind, value = _attr_field(op)
            self._require(isinstance(value, str), request,
                          f"{kind} must be a string")
            _attr_name(kind, value)
        except ValueError as e:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       str(e))

    def dynamic_validation(self, request: Request, pp_time) -> None:
        op = request.operation
        target = self.state.get(nym_state_key(op["dest"]), committed=False)
        if target is None:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       f"unknown DID {op['dest']}")
        if request.identifier != op["dest"]:
            author = self.state.get(nym_state_key(request.identifier),
                                    committed=False)
            role = unpack(author).get("role") if author is not None else None
            if role != TRUSTEE:
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "only the DID owner or a trustee may set attributes")

    def gen_txn(self, request: Request) -> dict:
        op = request.operation
        kind, value = _attr_field(op)
        return txn_lib.new_txn(ATTRIB, {"dest": op["dest"], kind: value},
                               request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        data = txn_lib.txn_data(txn)
        kind, value = _attr_field(data)
        digest = hashlib.sha256(value.encode()).hexdigest()
        self.state.set(
            attrib_state_key(data["dest"], kind, value),
            pack({"digest": digest, "kind": kind,
                  "seqNo": txn_lib.txn_seq_no(txn),
                  "txnTime": txn_lib.txn_time(txn)}))
        store = self.db.get_store(ATTRIB_STORE_LABEL)
        if store is not None and kind != "hash":
            store.put(digest.encode(), value.encode())


class GetAttrHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_ATTR, DOMAIN_LEDGER_ID)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        if not isinstance(op.get("dest"), str) or not op["dest"]:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       "GET_ATTR needs a string dest")
        if not isinstance(op.get("attr_name"), str) or not op["attr_name"]:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       "GET_ATTR needs a string attr_name")

    def get_result(self, request: Request) -> dict:
        op = request.operation
        name_digest = hashlib.sha256(op["attr_name"].encode()).hexdigest()
        key = f"{op['dest']}:attr:{name_digest}".encode()
        raw = self.state.get(key, committed=True)
        meta = unpack(raw) if raw is not None else None
        data: Optional[str] = None
        if meta is not None:
            store = self.db.get_store(ATTRIB_STORE_LABEL)
            if store is not None and meta["kind"] != "hash":
                try:
                    data = store.get(meta["digest"].encode()).decode()
                except KeyError:
                    data = None
        root = self.state.committed_head_hash
        result = {"type": GET_ATTR, "dest": op["dest"],
                  "attr_name": op["attr_name"], "data": data,
                  "meta": meta,
                  "seqNo": meta.get("seqNo") if meta else None,
                  "txnTime": meta.get("txnTime") if meta else None}
        # legacy MPT-format state_proof: skipped on non-mpt ledgers (see
        # GetNymHandler.get_result — a second aggregated opening nothing
        # can verify would be dead weight; read_proof carries the real one)
        from plenum_tpu_torch.state.commitment import (BACKEND_MPT,
                                                       commitment_backend_of)
        if commitment_backend_of(self.state) == BACKEND_MPT:
            proof = self.state.generate_state_proof(key, root_hash=root,
                                                    serialize=True)
            result["state_proof"] = {"root_hash": root.hex(),
                                     "proof_nodes": proof.hex()
                                     if isinstance(proof, bytes) else proof}
            bls_store = self.db.bls_store
            if bls_store is not None:
                sig = bls_store.get(root.hex())
                if sig is not None:
                    result["state_proof"]["multi_signature"] = sig.to_list()
        return result
