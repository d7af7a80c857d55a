"""Host ms per 3PC batch in the `serde` layer: its self time in the
program's host spans, four nodes summed over the traced window, over
Node1's 3PC batches in the window. The layer: pack, unpack,
signing_serialize, json_dumps and json_loads, wherever they are called."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "serde")
