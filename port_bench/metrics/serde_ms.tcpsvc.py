"""Host ms per 3PC batch in the `serde` layer: its self time in the program's
host spans, four node processes summed over their sessions in the traced
window, over Node1's 3PC batches in its session. The layer: pack, unpack,
signing_serialize, json_dumps and json_loads, wherever they are called in
the node."""
from port_bench.tcpsvc_metrics import node_ms_per_batch


def read(run):
    return node_ms_per_batch(run, "serde")
