"""Unprofiled per-txn cost of the crypto/storage seams in a live pool.

tools/perf_budget (cProfile over the TCP pool) gives the SHAPE of the
per-transaction budget but inflates call-dense Python categories: its wall
timer also charges preemption (5 processes, 1 core) and its CPU timer pays
a syscall per call.  The categories that decide the Amdahl question —
ed25519, BLS, ledger hashing, state trie — all sit behind class-method
seams, so this tool times them EXACTLY, unprofiled: it wraps the methods
with perf_counter accumulators (~1 us per call against ~100 us+ calls,
<2% overhead), runs the real in-process 4-node pool (tools/local_pool:
full authN -> propagate -> 3PC+BLS -> execute pipeline), and reports
seconds-per-category, call counts, and the uninstrumented residual
(consensus bookkeeping + serialization + sim transport + node glue).

A reentrancy guard attributes nested calls to the OUTERMOST category
(e.g. the msgpack pack inside Ledger.commit_txns counts as ledger, not
serde), so category totals never double-count.

    python -m plenum_tpu_torch.tools.micro_costs [--txns 300] [--nodes 4]
"""
from __future__ import annotations

import argparse
import json
import time


class _Accum:
    __slots__ = ("seconds", "calls")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0


class SeamTimer:
    """Wrap (cls, method) seams with accumulating timers, by category."""

    def __init__(self):
        self.accums: dict[str, _Accum] = {}
        self._originals: list[tuple[type, str, object]] = []
        self._active: list[str] = []      # category stack (reentrancy guard)

    def wrap(self, category: str, cls: type, method: str) -> None:
        import types
        orig = cls.__dict__.get(method)
        is_prop = isinstance(orig, property)
        target = orig.fget if is_prop else orig
        if not isinstance(target, types.FunctionType):
            return          # absent or staticmethod: skip
        acc = self.accums.setdefault(category, _Accum())
        timer = self

        def wrapper(*args, __orig=target, __acc=acc, **kwargs):
            if timer._active:              # nested: outer category owns it
                return __orig(*args, **kwargs)
            timer._active.append(category)
            t0 = time.perf_counter()
            try:
                return __orig(*args, **kwargs)
            finally:
                __acc.seconds += time.perf_counter() - t0
                __acc.calls += 1
                timer._active.pop()

        self._originals.append((cls, method, orig))
        setattr(cls, method,
                property(wrapper, orig.fset, orig.fdel) if is_prop
                else wrapper)

    def unwrap_all(self) -> None:
        for cls, method, orig in reversed(self._originals):
            setattr(cls, method, orig)
        self._originals.clear()


def install_seams(timer: SeamTimer) -> None:
    from plenum_tpu_torch.crypto.bls import (BlsCryptoSigner, BlsCryptoVerifier,
                                       BlsSignKey)
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.ledger.ledger import Ledger
    from plenum_tpu_torch.state.pruning_state import PruningState

    timer.wrap("ed25519", CpuEd25519Verifier, "verify_batch")
    for m in ("sign",):
        timer.wrap("bls", BlsCryptoSigner, m)
        timer.wrap("bls", BlsSignKey, m)
    for m in ("verify_sig", "verify_multi_sig", "create_multi_sig",
              "is_wellformed_sig", "verify_key_proof_of_possession"):
        timer.wrap("bls", BlsCryptoVerifier, m)
    for m in ("append", "append_batch", "append_txns_to_uncommitted",
              "commit_txns", "discard_txns", "uncommitted_root_hash",
              "merkle_info", "consistency_proof", "get_by_seq_no"):
        timer.wrap("ledger", Ledger, m)
    for m in ("set", "get", "remove", "commit", "revert_to_head",
              "head_hash", "committed_head_hash", "get_for_root",
              "generate_state_proof", "as_dict"):
        timer.wrap("state", PruningState, m)
    timer.wrap("ledger", Ledger, "uncommitted_root_hash")
    timer.wrap("ledger", Ledger, "root_hash")


def run(n_nodes: int = 4, n_txns: int = 300) -> dict:
    from plenum_tpu_torch.tools.local_pool import run_load

    timer = SeamTimer()
    install_seams(timer)
    try:
        stats = run_load(n_nodes=n_nodes, n_txns=n_txns, backend="cpu")
    finally:
        timer.unwrap_all()

    txns = stats.get("txns_ordered") or 1
    wall_ms = 1000.0 * stats["seconds"] / txns
    cats = {
        k: {"ms_per_txn": round(a.seconds * 1000.0 / txns, 3),
            "calls_per_txn": round(a.calls / txns, 2),
            "us_per_call": round(a.seconds * 1e6 / a.calls, 1)
            if a.calls else None}
        for k, a in sorted(timer.accums.items(),
                           key=lambda kv: -kv[1].seconds)
    }
    measured = sum(v["ms_per_txn"] for v in cats.values())
    off = sum(cats.get(k, {"ms_per_txn": 0.0})["ms_per_txn"]
              for k in ("ed25519", "bls", "ledger"))
    return {
        "pool": stats,
        "txns": txns,
        "wall_ms_per_txn": round(wall_ms, 3),     # all nodes share 1 process
        "categories": cats,
        "measured_ms_per_txn": round(measured, 3),
        "residual_ms_per_txn": round(wall_ms - measured, 3),
        "offloadable_ms_per_txn": round(off, 3),  # ed25519+bls+ledger-merkle
        "offloadable_fraction_of_wall": round(off / wall_ms, 4) if wall_ms else 0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txns", type=int, default=300)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.nodes, args.txns), indent=2))


if __name__ == "__main__":
    main()
