"""Host ms per 3PC batch in the `execution` layer: its self time in the
program's host spans, four node processes summed over their sessions in
the traced window, over Node1's 3PC batches in its session. The layer:
OrderingService._timed_apply, the uncommitted apply of a batch (MPT,
ledger appends)."""
from port_bench.tcpsvc_metrics import node_ms_per_batch


def read(run):
    return node_ms_per_batch(run, "execution")
