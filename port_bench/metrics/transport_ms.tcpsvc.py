"""Host ms per 3PC batch in the `transport` layer: its self time in the
program's host spans, four node processes summed over their sessions in
the traced window, over Node1's 3PC batches in its session. The layer: the
node stack's send handler (pack once, queue a peer), its flush (pack each
peer's queue, seal with ChaCha20-Poly1305, write), the opening of each
received frame, and the client stack's frame writes
(network/tcp_stack.py)."""
from port_bench.tcpsvc_metrics import node_ms_per_batch


def read(run):
    return node_ms_per_batch(run, "transport")
