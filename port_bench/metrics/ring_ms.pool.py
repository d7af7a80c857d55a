"""Host ms per 3PC batch in the `ring` layer: its self time in the
program's host spans, four nodes summed over the traced window, over
Node1's 3PC batches in the window. The layer: the device ring's pump,
flush, verdict collection and host SHA and commitment batches."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "ring")
