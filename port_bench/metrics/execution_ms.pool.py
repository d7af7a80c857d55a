"""Host ms per 3PC batch in the `execution` layer: its self time in the
program's host spans, four nodes summed over the traced window, over
Node1's 3PC batches in the window. The layer:
OrderingService._timed_apply, the uncommitted apply of a batch (MPT,
ledger appends); four nodes' total, where apply_ms.pool is Node1's mean."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "execution")
