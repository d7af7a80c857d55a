"""Host ms per 3PC batch in the `auth` layer: its self time in the program's
host spans, four node processes summed over their sessions in the traced
window, over Node1's 3PC batches in its session. The layer: client
authentication (CoreAuthNr.submit_batch, collect_batch): the node's side
of the crypto host's call."""
from port_bench.tcpsvc_metrics import node_ms_per_batch


def read(run):
    return node_ms_per_batch(run, "auth")
