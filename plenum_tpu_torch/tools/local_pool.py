"""Pool tooling for an in-process N-node pool: the genesis every
in-process pool starts from. So far the genesis builders only; the pool
runner (`build_pool`, `run_load`) comes with the consensus layer.
"""
from __future__ import annotations


def pool_bls_keys(names) -> dict:
    """node name -> BLS verkey under the name-seeded derivation every
    in-process genesis uses (build_genesis below, tests/test_pool.py).
    THE one copy: a verifying read client fed keys derived any other way
    would silently reject every proof and fall back to broadcast."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    return {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0")[:32]).pk
            for n in names}


def build_genesis(names, node_data_extra=None):
    """Pool + domain genesis txns for a named node set -> (genesis, trustee).

    node_data_extra: optional {name: dict} merged into each NODE txn's data
    (the TCP runner adds node_ip/node_port/client_ip/client_port here, the
    same fields the reference pool ledger carries)."""
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                       POOL_LEDGER_ID)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NODE, NYM, TRUSTEE

    trustee = Ed25519Signer(seed=b"local-pool-trustee".ljust(32, b"\0"))
    bls_keys = pool_bls_keys(names)
    pool_txns = []
    for i, name in enumerate(names):
        data = {"alias": name, "services": ["VALIDATOR"],
                "blskey": bls_keys[name]}
        if node_data_extra and name in node_data_extra:
            data.update(node_data_extra[name])
        txn = txn_lib.new_txn(NODE, {"dest": f"{name}Dest", "data": data})
        # genesis nodes are steward-owned by the trustee so owner-only
        # NODE edits (BLS key rotation, readdressing) are exercisable
        # against a genesis pool (churn soak, membership fuzz)
        txn["txn"].setdefault("metadata", {})["from"] = trustee.identifier
        txn_lib.set_seq_no(txn, i + 1)
        pool_txns.append(txn)
    nym = txn_lib.new_txn(NYM, {"dest": trustee.identifier,
                                "verkey": trustee.verkey_b58,
                                "role": TRUSTEE})
    txn_lib.set_seq_no(nym, 1)
    return {POOL_LEDGER_ID: pool_txns, DOMAIN_LEDGER_ID: [nym]}, trustee
