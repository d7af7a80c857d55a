"""NODE txn handler (pool ledger): add/update validator nodes.

Reference behavior: plenum/server/request_handlers/node_handler.py — a NODE
txn (authored by a steward) declares a validator's network addresses, service
role, and BLS keys; updates are restricted to the owning steward (key rotation,
ip change) or demotion by trustee. The pool manager derives the node registry
from this state (pool_manager.py:99) and quorums recompute on change
(node.py:731 setPoolParams).

State layout: key = dest utf-8, value = msgpack {alias, node_ip, node_port,
client_ip, client_port, services, blskey, blskey_pop, steward, seqNo}.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common.node_messages import POOL_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.exceptions import UnauthorizedClientRequest
from plenum_tpu_torch.execution.txn import NODE, STEWARD, TRUSTEE

from .base import WriteRequestHandler
from .nym import NymHandler

VALIDATOR = "VALIDATOR"

_DATA_FIELDS = ("alias", "node_ip", "node_port", "client_ip", "client_port",
                "services", "blskey", "blskey_pop")


def node_state_key(dest: str) -> bytes:
    return b"node:" + dest.encode()


class NodeHandler(WriteRequestHandler):
    def __init__(self, db, nym_handler: Optional[NymHandler] = None,
                 bls_verifier=None):
        super().__init__(db, NODE, POOL_LEDGER_ID)
        self._nym = nym_handler
        self._bls_verifier = bls_verifier

    def static_validation(self, request: Request) -> None:
        op = request.operation
        self._require(isinstance(op.get("dest"), str) and op["dest"], request,
                      "NODE needs a dest")
        data = op.get("data")
        self._require(isinstance(data, dict), request, "NODE needs data")
        if "services" in data:
            self._require(isinstance(data["services"], (list, tuple)) and
                          all(s == VALIDATOR for s in data["services"]),
                          request, "services may only contain VALIDATOR")
        for port_field in ("node_port", "client_port"):
            if port_field in data:
                self._require(isinstance(data[port_field], int) and
                              0 < data[port_field] < 65536, request,
                              f"bad {port_field}")
        if data.get("blskey") and data.get("blskey_pop") and \
                self._bls_verifier is not None:
            self._require(
                self._bls_verifier.verify_key_proof_of_possession(
                    data["blskey_pop"], data["blskey"]),
                request, "BLS proof-of-possession check failed")

    def _read(self, dest: str) -> Optional[dict]:
        raw = self.state.get(node_state_key(dest), committed=False)
        return unpack(raw) if raw is not None else None

    def _author_role(self, request: Request) -> Optional[str]:
        if self._nym is None:
            return STEWARD          # pool-only deployments skip DID auth
        rec = self._nym._read(request.identifier)
        return rec.get("role") if rec else None

    def dynamic_validation(self, request: Request, pp_time) -> None:
        op = request.operation
        existing = self._read(op["dest"])
        role = self._author_role(request)
        if existing is None:
            if role not in (STEWARD, TRUSTEE):
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "only a steward may add a node")
            if self._steward_has_node(request.identifier):
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "steward already runs a node")
        else:
            is_owner = existing.get("steward") == request.identifier
            demote_only = set(op.get("data", {})) == {"services"}
            if not (is_owner or (role == TRUSTEE and demote_only)):
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "only the owning steward (or trustee demotion) may edit")

    def bls_key_at_root(self, alias: str,
                        pool_root: bytes) -> Optional[str]:
        """BLS verkey a node had when the pool state was at `pool_root`
        (historic MPT read) — the key that actually signed multi-sigs of
        that epoch. Key ROTATION means the current register's key cannot
        verify sigs embedded from just before the rotation batch
        (ref BlsKeyRegisterPoolManager.get_key_by_name(pool_state_root))."""
        for dest, rec in self.all_nodes().items():
            if rec.get("alias") == alias:
                try:
                    raw = self.state.get_for_root(node_state_key(dest),
                                                  pool_root)
                except Exception:
                    return None
                if raw is None:
                    return None
                return unpack(raw).get("blskey")
        return None

    def _steward_has_node(self, steward: str) -> bool:
        for _, rec in self.all_nodes().items():
            if rec.get("steward") == steward:
                return True
        return False

    def gen_txn(self, request: Request) -> dict:
        op = request.operation
        data = {"dest": op["dest"],
                "data": {k: op["data"][k] for k in _DATA_FIELDS
                         if k in op["data"]}}
        return txn_lib.new_txn(NODE, data, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        data = txn_lib.txn_data(txn)
        dest = data["dest"]
        existing = self._read(dest) or {"steward": txn_lib.txn_author(txn)}
        merged = dict(existing)
        merged.update(data.get("data", {}))
        merged["seqNo"] = txn_lib.txn_seq_no(txn)
        self.state.set(node_state_key(dest), pack(merged))

    # --- registry view (pool manager reads this) --------------------------

    def all_nodes(self, committed: bool = False) -> dict[str, dict]:
        out = {}
        for key, raw in self.state.as_dict(committed=committed).items():
            if key.startswith(b"node:"):
                out[key[5:].decode()] = unpack(raw)
        return out
