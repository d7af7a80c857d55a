"""Start an observer (read follower) as an OS process.

The observer counterpart of tools/start_node: load the pool genesis from a
base dir, derive every validator's client address from the pool ledger,
and run a plenum_tpu_torch.node.observer_node.ObserverNode until killed. Plays
the role of the reference's runnable ObserverNode
(plenum/server/observer/observer_node.py).

    python -m plenum_tpu_torch.tools.start_observer --name obs1 --base-dir /tmp/pool \
        [--f 1] [--data-dir /var/obs1] [--kv file|native|memory] \
        [--backend cuda|cpu|torch]
"""
from __future__ import annotations

import argparse
import asyncio
import json


def main(argv=None):
    from plenum_tpu_torch.common.node_messages import POOL_LEDGER_ID
    from plenum_tpu_torch.node.observer_node import ObserverNode
    from plenum_tpu_torch.tools.genesis import load_genesis_files

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", required=True)
    ap.add_argument("--base-dir", required=True,
                    help="pool dir holding the genesis files")
    ap.add_argument("--f", type=int, default=1,
                    help="push quorum is f+1 content-identical validators")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--kv", default="memory",
                    choices=["memory", "file", "native"])
    ap.add_argument("--client-port", type=int, default=None,
                    help="serve verified reads (read_proof envelopes) to "
                         "clients on this port")
    ap.add_argument("--anchor-lag-max", type=float, default=None,
                    help="serve proofless (clients escalate to a "
                         "validator) once the newest verified anchor is "
                         "older than this; default: "
                         "Config.OBSERVER_ANCHOR_LAG_MAX")
    ap.add_argument("--state-commitment", default="mpt",
                    choices=["mpt", "verkle"],
                    help="MUST match the pool's STATE_COMMITMENT: the "
                         "observer's replicated roots have to land on "
                         "the multi-signed anchors, or every read it "
                         "serves degrades to proofless escalation")
    ap.add_argument("--verkle-width", type=int, default=None,
                    help="pool's VERKLE_WIDTH (verkle pools only)")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "cpu", "torch"],
                    help="the replicated ledgers' hasher: the card, "
                         "hashlib or the kernels' plain versions")
    ap.add_argument("--state-commitment-per-ledger", default=None,
                    help='JSON {"<ledger_id>": "<backend>"} — must match '
                         "the pool's STATE_COMMITMENT_PER_LEDGER; a "
                         "diverging ledger's replicated roots never land "
                         "on the signed anchors (proofless reads)")
    args = ap.parse_args(argv)

    genesis = load_genesis_files(args.base_dir)
    addrs = {}
    for txn in genesis[POOL_LEDGER_ID]:
        data = txn["txn"]["data"]["data"]
        addrs[data["alias"]] = (data["client_ip"], data["client_port"])

    from plenum_tpu_torch.ingress.observer_reads import FROM_CONFIG
    obs = ObserverNode(args.name, genesis, addrs, f=args.f,
                       data_dir=args.data_dir, storage_backend=args.kv,
                       client_port=args.client_port,
                       anchor_lag_max=FROM_CONFIG
                       if args.anchor_lag_max is None
                       else args.anchor_lag_max,
                       state_commitment=args.state_commitment,
                       state_commitment_per_ledger=json.loads(
                           args.state_commitment_per_ledger)
                       if args.state_commitment_per_ledger else None,
                       verkle_width=args.verkle_width,
                       crypto_backend=args.backend)

    async def run():
        stop = asyncio.Event()
        print(json.dumps({"started": args.name,
                          "following": sorted(addrs)}), flush=True)
        await obs.run(stop)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
