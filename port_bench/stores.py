"""A stopped node's durable domain ledger and state root, read back from
its store directory, for `reference.pool_check.judge`.

The stores are opened with the port's own store factories
(`node.bootstrap.NodeBootstrap`, which picks the engine the files on disk
were written in), and nothing is replayed: the ledger's leaves and its
root as the node's hash store holds them, and the state's committed head
as the node last committed it (`PruningState.commit` keeps it under
COMMITTED_HEAD). The judge recomputes both from the leaves.
"""
from __future__ import annotations

import os

COMMITTED_HEAD = b"__committed_head__"


def data_dir(base: str, name: str) -> str:
    """Where tools/start_node keeps a node's stores (`--kv file`)."""
    return os.path.join(base, name, "data")


def _bootstrap(base: str, name: str):
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    return NodeBootstrap(name, data_dir=data_dir(base, name),
                         crypto_backend="cpu")


def read_domain(base: str, name: str) -> dict:
    """-> {"leaves": [bytes], "root": bytes, "state_root": bytes}."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    boot = _bootstrap(base, name)
    ledger = boot._ledger(DOMAIN_LEDGER_ID, "domain")
    state_kv = boot._kv("domain_state")
    try:
        return {"leaves": [ledger._log.get(s)
                           for s in range(1, ledger.size + 1)],
                "root": ledger.root_hash,
                "state_root": state_kv.get(COMMITTED_HEAD)}
    finally:
        for store in (ledger._log, ledger.tree.hash_store, state_kv):
            store.close()


def write_state_root(base: str, name: str, root: bytes) -> None:
    """Overwrite a stopped node's committed domain state root (a planted
    fault for the tests)."""
    kv = _bootstrap(base, name)._kv("domain_state")
    try:
        kv.put(COMMITTED_HEAD, root)
    finally:
        kv.close()
