"""Hash-store reads per 3PC batch made building audit paths: the growth
of each node's domain-tree `proof_reads` counter over its session, four
node processes summed, over Node1's 3PC batches in its session. The
layer: the ledger's group commit (`Ledger.append_batch`), which returns
an audit path for every committed txn. None where a session lacks the
counter."""
from port_bench.tcpsvc_metrics import batches


def read(run):
    sessions = run["collected"].get("sessions") or {}
    n = batches(run)
    if not n or not sessions or any(
            s is None or s.get("proof_reads") is None
            for s in sessions.values()):
        return None
    return sum(s["proof_reads"] for s in sessions.values()) / n
