"""Pool-genesis generator CLI.

Reference behavior: plenum/common/test_network_setup.py +
scripts/generate_plenum_pool_transactions — build the pool and domain
genesis transaction files for a named node set from their key files.

    python -m plenum_tpu_torch.tools.genesis --base-dir /tmp/pool \
        --nodes Node1:127.0.0.1:9701:9702 Node2:127.0.0.1:9703:9704 ... \
        [--trustee-seed <32 chars>]

Writes <base-dir>/pool_genesis.json and <base-dir>/domain_genesis.json
(one txn per line, the reference's genesis file format family) and prints
the trustee DID. Node keys must already exist (tools.keygen).
"""
from __future__ import annotations

import argparse
import json
import os


def build_genesis_files(base_dir: str, node_specs: list[tuple[str, str, int, int]],
                        trustee_seed: bytes) -> dict:
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NODE, NYM, TRUSTEE
    from plenum_tpu_torch.tools.keygen import load_keys

    trustee = Ed25519Signer(seed=trustee_seed)
    pool_txns = []
    for i, (name, host, node_port, client_port) in enumerate(node_specs):
        keys = load_keys(base_dir, name)
        txn = txn_lib.new_txn(NODE, {
            "dest": keys["verkey_b58"],
            "data": {"alias": name, "services": ["VALIDATOR"],
                     "blskey": keys["bls_pk"],
                     "blskey_pop": keys["bls_pop"],
                     "verkey": keys["verkey"],
                     "node_ip": host, "node_port": node_port,
                     "client_ip": host, "client_port": client_port}})
        txn_lib.set_seq_no(txn, i + 1)
        pool_txns.append(txn)
    nym = txn_lib.new_txn(NYM, {"dest": trustee.identifier,
                                "verkey": trustee.verkey_b58,
                                "role": TRUSTEE})
    txn_lib.set_seq_no(nym, 1)

    os.makedirs(base_dir, exist_ok=True)
    pool_path = os.path.join(base_dir, "pool_genesis.json")
    domain_path = os.path.join(base_dir, "domain_genesis.json")
    with open(pool_path, "w") as f:
        for txn in pool_txns:
            f.write(json.dumps(txn) + "\n")
    with open(domain_path, "w") as f:
        f.write(json.dumps(nym) + "\n")
    return {"pool_genesis": pool_path, "domain_genesis": domain_path,
            "trustee_did": trustee.identifier,
            "trustee_verkey": trustee.verkey_b58}


def load_genesis_files(base_dir: str) -> dict:
    """-> {ledger_id: [txn, ...]} for NodeBootstrap."""
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 POOL_LEDGER_ID)
    out = {}
    for ledger_id, fname in ((POOL_LEDGER_ID, "pool_genesis.json"),
                             (DOMAIN_LEDGER_ID, "domain_genesis.json")):
        path = os.path.join(base_dir, fname)
        with open(path) as f:
            out[ledger_id] = [json.loads(line) for line in f if line.strip()]
    return out


def parse_node_spec(spec: str) -> tuple[str, str, int, int]:
    name, host, node_port, client_port = spec.split(":")
    return name, host, int(node_port), int(client_port)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--nodes", nargs="+", required=True,
                    metavar="NAME:HOST:NODEPORT:CLIENTPORT")
    ap.add_argument("--trustee-seed", default="genesis-trustee-seed")
    args = ap.parse_args(argv)
    specs = [parse_node_spec(s) for s in args.nodes]
    seed = args.trustee_seed.encode().ljust(32, b"\0")[:32]
    print(json.dumps(build_genesis_files(args.base_dir, specs, seed)))


if __name__ == "__main__":
    main()
