"""Amdahl budget: where does a write transaction's time actually go?

The north star (SURVEY.md:19) is >=10x pool throughput via TPU crypto
offload.  Whether that is reachable is a pure Amdahl question: only the
crypto fraction of per-transaction cost can be offloaded, so the implied
ceiling is 1 / (1 - offloadable_fraction).  This tool measures that
fraction on the REAL pool: it runs the TCP pool (tools/tcp_pool — four OS
processes, encrypted TCP, full 3PC + BLS pipeline) with every node under
cProfile, then folds each node's exclusive-time profile into budget
categories:

    ed25519   client-signature verification (authN hot spot,
              ref plenum/server/client_authn.py:273 / nacl_wrappers.py:62)
    bls       BN254 sign/verify/aggregate on the commit path
              (ref plenum/bls/bls_bft_replica_plenum.py)
    merkle    ledger SHA-256 tree appends + proofs (ref ledger/)
    mpt       state trie SHA3/RLP (ref state/trie/pruning_trie.py)
    serde     wire+ledger serialization, canonical JSON, msgpack
    transport TCP stack, framing, ChaCha20 channel crypto
    idle      event-loop waits (epoll/select/sleep) — NOT offloadable,
              but also not CPU cost: it bounds how much pipelining slack
              the node has at this load
    consensus 3PC bookkeeping (ordering/checkpoint/view-change services)
    node      node orchestration, propagation, execution, storage
    other     everything else (stdlib, interpreter overhead)

Builtin C functions (OpenSSL Ed25519 verify, hashlib digests, msgpack,
socket sends) carry no filename, so their exclusive time is attributed to
the category of their CALLERS, proportionally — pstats records per-caller
splits exactly for this.

Output: one JSON line with per-category exclusive seconds and per-txn
milliseconds for the busiest node, plus the offloadable fraction and the
implied Amdahl ceiling.  docs/performance.md quotes this table.

    python -m plenum_tpu_torch.tools.perf_budget [--nodes 4] [--txns 300]
"""
from __future__ import annotations

import argparse
import json
import os
import pstats
import tempfile

# path fragment -> category; first match wins (order matters: ops/ed25519
# before ops/, crypto/bls before consensus/)
_PATH_RULES = [
    ("crypto/ed25519", "ed25519"),
    ("ops/ed25519", "ed25519"),
    ("node/client_authn", "ed25519"),
    ("crypto/bn254", "bls"),
    ("crypto/bls", "bls"),
    ("crypto/multi_signature", "bls"),
    ("consensus/bls_bft_replica", "bls"),
    ("ops/sha256", "merkle"),
    ("ledger/", "merkle"),
    ("state/", "mpt"),
    ("common/serialization", "serde"),
    ("common/request", "serde"),        # digest computation = hashing the wire form
    ("utils/base58", "serde"),
    ("network/", "transport"),
    ("consensus/", "consensus"),
    ("node/", "node"),
    ("execution/", "node"),
    ("storage/", "node"),
    ("common/", "consensus"),           # buses, stashing, timers, messages
    ("plenum_tpu_torch/", "node"),
]

# builtin-name patterns (checked on the function name) for C calls whose
# caller attribution is ambiguous or absent
_IDLE_BUILTINS = ("epoll", "select", "poll", "kqueue", "sleep",
                  "run_until_complete", "_run_once")


def _category_of_file(filename: str) -> str | None:
    f = filename.replace("\\", "/")
    if "plenum_tpu_torch" in f:
        tail = f.split("plenum_tpu_torch/", 1)[-1]
        for frag, cat in _PATH_RULES:
            if frag.rstrip("/") in ("plenum_tpu_torch",):
                continue
            if tail.startswith(frag) or ("/" + frag) in ("/" + tail):
                return cat
        return "node"
    if "/asyncio/" in f or "selectors.py" in f:
        return "transport"
    if "/json/" in f:
        return "serde"
    return None                      # stdlib/other: resolve via name or bucket


def _category_of_func(func: tuple, callers_cat: str | None) -> str:
    filename, _lineno, name = func
    if filename == "~" or filename.startswith("<"):
        # builtin: name-based idle detection first, else caller's category
        lname = name.lower()
        if any(p in lname for p in _IDLE_BUILTINS):
            return "idle"
        if "sock" in lname or "ssl" in lname:
            return "transport"
        return callers_cat or "other"
    cat = _category_of_file(filename)
    return cat or "other"


def fold_profile(path: str) -> dict[str, float]:
    """pstats file -> {category: exclusive_seconds}."""
    st = pstats.Stats(path)
    # func -> (cc, nc, tt, ct, callers)
    raw = st.stats  # type: ignore[attr-defined]

    def caller_category(callers: dict) -> str | None:
        # dominant caller's file category, weighted by per-caller time
        best_cat, best_t = None, 0.0
        for cfunc, stats in callers.items():
            t = stats[3] if len(stats) >= 4 else 0.0   # cumulative via caller
            cat = _category_of_file(cfunc[0]) if cfunc[0] not in ("~",) \
                else None
            if cat and t >= best_t:
                best_cat, best_t = cat, t
        return best_cat

    out: dict[str, float] = {}
    for func, (_cc, _nc, tt, _ct, callers) in raw.items():
        if tt <= 0.0:
            continue
        cat = _category_of_func(func, caller_category(callers))
        out[cat] = out.get(cat, 0.0) + tt
    return out


def top_functions(path: str, category: str, n: int = 8) -> list[tuple]:
    """The heaviest exclusive-time functions inside one category."""
    st = pstats.Stats(path)
    rows = []
    for func, (_cc, _nc, tt, _ct, callers) in st.stats.items():  # type: ignore
        def _cc_of(c=callers):
            best_cat, best_t = None, 0.0
            for cfunc, s in c.items():
                t = s[3] if len(s) >= 4 else 0.0
                cat = _category_of_file(cfunc[0])
                if cat and t >= best_t:
                    best_cat, best_t = cat, t
            return best_cat
        if _category_of_func(func, _cc_of()) == category:
            rows.append((tt, f"{os.path.basename(func[0])}:{func[1]}:{func[2]}"))
    rows.sort(reverse=True)
    return rows[:n]


def run_budget(n_nodes: int = 4, n_txns: int = 300,
               timeout: float = 180.0) -> dict:
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool

    profile_dir = tempfile.mkdtemp(prefix="plenum_budget_")
    stats = run_tcp_pool(n_nodes=n_nodes, n_txns=n_txns, timeout=timeout,
                         profile_dir=profile_dir)
    txns = stats.get("txns_ordered") or 1
    per_node = {}
    for fn in sorted(os.listdir(profile_dir)):
        if fn.endswith(".pstats"):
            per_node[fn[:-7]] = fold_profile(os.path.join(profile_dir, fn))
    if not per_node:
        return {"error": "no profiles written", "pool": stats}

    def busy(cats: dict) -> float:
        return sum(v for k, v in cats.items() if k != "idle")

    # Which aggregation bounds throughput depends on the host: on a
    # multi-core box nodes run in parallel and the BUSIEST node is the
    # bottleneck; on this 1-core benchmark host all N node processes
    # timeshare one core, so the SUM of busy time across nodes is what
    # 1/TPS must pay.  Report both; docs quote the one matching nproc.
    busiest = max(per_node, key=lambda k: busy(per_node[k]))
    total = {}
    for cats in per_node.values():
        for k, v in cats.items():
            total[k] = total.get(k, 0.0) + v

    def to_ms_per_txn(cats: dict) -> dict:
        return {k: round(v * 1000.0 / txns, 3)
                for k, v in sorted(cats.items(), key=lambda kv: -kv[1])}

    offloadable = ("ed25519", "bls", "merkle")
    busy_sum = busy(total)
    off = sum(total.get(k, 0.0) for k in offloadable)
    frac = off / busy_sum if busy_sum else 0.0
    b = per_node[busiest]
    bfrac = (sum(b.get(k, 0.0) for k in offloadable) / busy(b)) if busy(b) else 0.0
    return {
        "pool": stats,
        "profile_dir": profile_dir,
        "txns": txns,
        "ncpu": os.cpu_count(),
        "sum_ms_per_txn": to_ms_per_txn(total),
        "sum_busy_ms_per_txn": round(busy_sum * 1000.0 / txns, 3),
        "busiest_node": busiest,
        "busiest_ms_per_txn": to_ms_per_txn(b),
        "busiest_busy_ms_per_txn": round(busy(b) * 1000.0 / txns, 3),
        "wall_ms_per_txn": round(
            stats.get("seconds", 0.0) * 1000.0 / txns, 3),
        "offloadable_categories": list(offloadable),
        "offloadable_fraction_sum": round(frac, 4),
        "offloadable_fraction_busiest": round(bfrac, 4),
        "amdahl_ceiling_sum": round(1.0 / (1.0 - frac), 2) if frac < 1 else None,
        "amdahl_ceiling_busiest": round(1.0 / (1.0 - bfrac), 2)
            if bfrac < 1 else None,
    }


def run_differential(n_nodes: int = 4, lo: int = 100, hi: int = 400,
                     timeout: float = 240.0) -> dict:
    """Marginal per-txn budget: profile the pool at two load sizes and
    subtract.  Fixed costs (keygen, genesis, handshakes, initial catchup)
    appear identically in both runs and cancel; what remains is what one
    EXTRA transaction costs — the quantity 1/TPS is made of.

    Caveat recorded in the output: cProfile inflates Python-call-dense
    categories (~2x observed wall slowdown) but not time spent inside a
    single C call, so the crypto fractions below are LOWER bounds; the
    unprofiled primitive microbenches in docs/performance.md bracket them
    from the other side.
    """
    a = run_budget(n_nodes, lo, timeout)
    b = run_budget(n_nodes, hi, timeout)
    if "error" in a or "error" in b:
        return {"error": "profile run failed", "lo": a, "hi": b}
    dtxn = b["txns"] - a["txns"]
    marginal = {}
    for k in set(a["sum_ms_per_txn"]) | set(b["sum_ms_per_txn"]):
        d = (b["sum_ms_per_txn"].get(k, 0.0) * b["txns"]
             - a["sum_ms_per_txn"].get(k, 0.0) * a["txns"]) / dtxn
        marginal[k] = round(d, 3)
    marginal = dict(sorted(marginal.items(), key=lambda kv: -kv[1]))
    busy = sum(v for k, v in marginal.items() if k != "idle")
    off = sum(marginal.get(k, 0.0) for k in ("ed25519", "bls", "merkle"))
    frac = off / busy if busy else 0.0
    return {
        "mode": "differential", "nodes": n_nodes, "lo_txns": lo, "hi_txns": hi,
        "ncpu": os.cpu_count(),
        "lo_pool_tps": a["pool"].get("tps"), "hi_pool_tps": b["pool"].get("tps"),
        "marginal_sum_ms_per_txn": marginal,
        "marginal_busy_ms_per_txn": round(busy, 3),
        "offloadable_fraction": round(frac, 4),
        "amdahl_ceiling": round(1.0 / (1.0 - frac), 2) if frac < 1 else None,
        "profile_dirs": [a["profile_dir"], b["profile_dir"]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txns", type=int, default=300)
    ap.add_argument("--differential", action="store_true",
                    help="two-point run (txns/4 and txns): report MARGINAL "
                         "per-txn cost with fixed startup costs cancelled")
    ap.add_argument("--top", metavar="CATEGORY",
                    help="also list the heaviest functions in CATEGORY "
                         "for the busiest node")
    args = ap.parse_args(argv)
    if args.differential:
        result = run_differential(args.nodes, max(50, args.txns // 4),
                                  args.txns)
        print(json.dumps(result, indent=2))
        return
    result = run_budget(args.nodes, args.txns)
    print(json.dumps(result, indent=2))
    if args.top and "busiest_node" in result:
        path = os.path.join(result["profile_dir"],
                            result["busiest_node"] + ".pstats")
        for tt, where in top_functions(path, args.top):
            print(f"  {tt:8.3f}s  {where}")


if __name__ == "__main__":
    main()
