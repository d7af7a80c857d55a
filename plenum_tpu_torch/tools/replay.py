"""Offline deterministic replay of a recorded node.

Reference behavior: plenum/recorder replay mode (STACK_COMPANION=2) — rebuild
the node from its genesis and feed the recorded ingress stream back under a
mock clock, reproducing its state evolution without any network.

    python -m plenum_tpu_torch.tools.replay --name Node1 --base-dir /tmp/pool \
        [--backend cuda|cpu|torch]

Prints per-ledger sizes and roots after replay (compare against the live
node's validator info to confirm bit-identical state).
"""
from __future__ import annotations

import argparse
import json
import os


def replay_node(name: str, base_dir: str, backend: str = "cuda") -> dict:
    from plenum_tpu_torch.common.event_bus import ExternalBus
    from plenum_tpu_torch.common.timer import MockTimer
    from plenum_tpu_torch.node import Node, NodeBootstrap
    from plenum_tpu_torch.node.recorder import Recorder, replay
    from plenum_tpu_torch.storage.kv_file import KvFile
    from plenum_tpu_torch.tools.genesis import load_genesis_files
    from plenum_tpu_torch.tools.keygen import load_keys

    keys = load_keys(base_dir, name)
    genesis = load_genesis_files(base_dir)
    rec_dir = os.path.join(base_dir, name, "recorder")
    store = KvFile(rec_dir)
    recorder = Recorder(store, now=lambda: 0.0)

    # fresh components from genesis only — replay rebuilds everything else
    components = NodeBootstrap(
        name, genesis_txns=genesis, crypto_backend=backend,
        bls_seed=bytes.fromhex(keys["bls_seed"])).build()
    # the live node's clock was perf_counter (arbitrary absolute values);
    # seed the mock clock with the first record's timestamp BEFORE building
    # the node, or its repeating timers spin through the whole offset
    first_ts = next((ts for ts, *_ in recorder.iter_records()), 0.0)
    timer = MockTimer(start=first_ts)
    bus = ExternalBus(send_handler=lambda msg, dst: None)   # sends -> sink
    node = Node(name, timer, bus, components)
    n = replay(recorder.iter_records(), node, timer)

    ledgers = {}
    for ledger_id, ledger in components.db.ledgers():
        ledgers[ledger_id] = {"size": ledger.size,
                              "root": ledger.root_hash.hex()}
    return {"name": name, "records_replayed": n, "ledgers": ledgers,
            "last_ordered_3pc": list(node.master_replica.last_ordered_3pc)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", required=True)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "cpu", "torch"])
    args = ap.parse_args(argv)
    print(json.dumps(replay_node(args.name, args.base_dir, args.backend)))


if __name__ == "__main__":
    main()
