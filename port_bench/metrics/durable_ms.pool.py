"""Host ms per 3PC batch in the `durable` layer: its self time in the
program's host spans, four nodes summed over the traced window, over
Node1's 3PC batches in the window. The layer: Node._service_ordered, the
group commit (ledger commit, state commit, storage flush)."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "durable")
