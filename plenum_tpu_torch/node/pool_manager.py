"""Pool membership: node registry derived from the pool ledger.

Reference behavior: plenum/server/pool_manager.py:99 (TxnPoolManager) +
common/stack_manager.py — the validator registry (name → addresses, verkeys,
services, BLS keys) is read out of pool-ledger state; NODE txns add, demote,
re-key, or re-address validators; every change recomputes f and all quorums
(node.py:731 setPoolParams) and is announced so stacks/replicas can adjust.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.execution.handlers.node import VALIDATOR, NodeHandler


class TxnPoolManager:
    def __init__(self, node_handler: NodeHandler,
                 on_pool_changed: Optional[Callable[[], None]] = None):
        self._nodes = node_handler
        self._on_changed = on_pool_changed or (lambda: None)
        self._cached_reg: dict[str, dict] = {}
        self.reload()

    # --- registry ---------------------------------------------------------

    def reload(self) -> bool:
        """Re-derive the registry from committed pool state; True if changed."""
        reg = {}
        known = set()
        for dest, rec in self._nodes.all_nodes(committed=True).items():
            known.add(rec.get("alias", dest))
            if VALIDATOR in rec.get("services", [VALIDATOR]):
                reg[rec.get("alias", dest)] = {**rec, "dest": dest}
        changed = reg != self._cached_reg
        self._cached_reg = reg
        # every node the pool ledger KNOWS, validator or not: a demoted/
        # not-yet-promoted member may still be served catchup (it must be
        # able to sync before it can be promoted into the validator set)
        self._known_aliases = known
        return changed

    @property
    def known_node_names(self) -> set[str]:
        """Aliases of every pool-ledger node regardless of services."""
        return set(getattr(self, "_known_aliases", set()))

    def pool_changed(self) -> None:
        """Call after a pool-ledger batch commits (ref poolTxnCommitted)."""
        if self.reload():
            self._on_changed()

    @property
    def node_names(self) -> list[str]:
        return sorted(self._cached_reg)

    @property
    def node_count(self) -> int:
        return len(self._cached_reg)

    @property
    def quorums(self) -> Quorums:
        return Quorums(max(self.node_count, 1))

    def node_info(self, name: str) -> Optional[dict]:
        return self._cached_reg.get(name)

    def bls_key_of(self, name: str) -> Optional[str]:
        info = self._cached_reg.get(name)
        return info.get("blskey") if info else None

    def node_ha(self, name: str) -> Optional[tuple[str, int]]:
        info = self._cached_reg.get(name)
        if not info or "node_ip" not in info:
            return None
        return (info["node_ip"], info["node_port"])

    def client_ha(self, name: str) -> Optional[tuple[str, int]]:
        info = self._cached_reg.get(name)
        if not info or "client_ip" not in info:
            return None
        return (info["client_ip"], info["client_port"])
