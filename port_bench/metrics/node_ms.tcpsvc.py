"""Host ms per 3PC batch in the `node` layer: its self time in the program's
host spans, four node processes summed over their sessions in the traced
window, over Node1's 3PC batches in its session. The layer: client intake,
static validation, request state, propagates, replies, and each stack's
drain, the delivery of messages into the node."""
from port_bench.tcpsvc_metrics import node_ms_per_batch


def read(run):
    return node_ms_per_batch(run, "node")
