"""NYM write + GET_NYM read handlers (domain ledger).

Reference behavior: plenum/server/request_handlers/nym_handler.py (write) and
get_nym... (read, in indy-node proper): a NYM creates or updates a DID record
{verkey, role} in domain state; creation is permissioned (trustee/steward),
updates are owner-or-trustee. Reads answer from committed state with a state
proof + BLS multi-sig so one node's reply is trustworthy
(docs/source/main.md:24).

State layout (our design): key = did utf-8, value = msgpack map
{verkey, role, seqNo, txnTime, from}.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.exceptions import UnauthorizedClientRequest
from plenum_tpu_torch.execution.txn import NYM, GET_NYM, TRUSTEE, STEWARD
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID

from .base import ReadRequestHandler, WriteRequestHandler


def nym_state_key(did: str) -> bytes:
    return did.encode()


class NymHandler(WriteRequestHandler):
    def __init__(self, db):
        super().__init__(db, NYM, DOMAIN_LEDGER_ID)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        self._require(isinstance(op.get("dest"), str) and op["dest"], request,
                      "NYM needs a dest DID")
        role = op.get("role")
        self._require(role in (None, "", TRUSTEE, STEWARD), request,
                      f"unknown role {role!r}")
        vk = op.get("verkey")
        self._require(vk is None or isinstance(vk, str), request,
                      "verkey must be a string")

    def _read(self, did: str, committed: bool = False) -> Optional[dict]:
        raw = self.state.get(nym_state_key(did), committed=committed)
        return unpack(raw) if raw is not None else None

    def dynamic_validation(self, request: Request, pp_time) -> None:
        op = request.operation
        author = self._read(request.identifier)
        target = self._read(op["dest"])
        author_role = author.get("role") if author else None
        # an endorser's role counts toward authorization (indy endorsement
        # semantics); client authN already REQUIRED the endorser's signature
        # whenever the field names one
        roles = {author_role}
        if request.endorser is not None:
            erec = self._read(request.endorser)
            roles.add(erec.get("role") if erec else None)
        if target is None:
            # Creation: trustees and stewards may author; a totally empty
            # state (bootstrap before genesis DIDs) accepts anything so pools
            # can self-initialize.
            if author is None and self.state.head_hash == self.state.committed_head_hash \
                    and not self._any_nym_exists():
                return
            if not roles & {TRUSTEE, STEWARD}:
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "only trustee/steward may create a DID")
        else:
            is_owner = request.identifier == op["dest"]
            if not is_owner and TRUSTEE not in roles:
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "only the owner or a trustee may modify a DID")
            if op.get("role") is not None and TRUSTEE not in roles:
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "role changes require a trustee")

    def _any_nym_exists(self) -> bool:
        return len(self.state.as_dict(committed=False)) > 0

    def gen_txn(self, request: Request) -> dict:
        op = request.operation
        data = {"dest": op["dest"]}
        for f in ("verkey", "role", "alias"):
            if op.get(f) is not None:
                data[f] = op[f]
        return txn_lib.new_txn(NYM, data, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        data = txn_lib.txn_data(txn)
        did = data["dest"]
        existing = self._read(did) or {}
        record = {"verkey": data.get("verkey", existing.get("verkey")),
                  "role": data["role"] if "role" in data else existing.get("role"),
                  "seqNo": txn_lib.txn_seq_no(txn),
                  "txnTime": txn_lib.txn_time(txn),
                  "from": txn_lib.txn_author(txn)}
        self.state.set(nym_state_key(did), pack(record))

    # --- lookups used by client authN ------------------------------------

    def get_verkey(self, did: str, committed: bool = True) -> Optional[str]:
        rec = self._read(did, committed=committed)
        return rec.get("verkey") if rec else None

    def get_role(self, did: str, committed: bool = True) -> Optional[str]:
        rec = self._read(did, committed=committed)
        return rec.get("role") if rec else None


class GetNymHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_NYM, DOMAIN_LEDGER_ID)

    def static_validation(self, request: Request) -> None:
        from plenum_tpu_torch.execution.exceptions import InvalidClientRequest
        dest = request.operation.get("dest")
        if not isinstance(dest, str) or not dest:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       "GET_NYM needs a string dest")

    def get_result(self, request: Request) -> dict:
        did = request.operation.get("dest")
        key = nym_state_key(did)
        raw = self.state.get(key, committed=True)
        data = unpack(raw) if raw is not None else None
        root = self.state.committed_head_hash
        result = {"type": GET_NYM, "dest": did, "data": data,
                  "seqNo": data.get("seqNo") if data else None,
                  "txnTime": data.get("txnTime") if data else None}
        # legacy MPT-format state_proof field: only legacy MPT verifiers
        # consume it, so a non-mpt ledger skips it — generating a second
        # aggregated opening per read that nothing can check would double
        # proof-gen cost for dead wire weight (verkle clients verify the
        # read_proof envelope the ReadPlane attaches)
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
