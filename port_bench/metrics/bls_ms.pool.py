"""Host ms per 3PC batch in the `bls` layer: its self time in the program's
host spans, four nodes summed over the traced window, over Node1's 3PC
batches in the window. The layer: BLS sign, validate and aggregate-
verify (BlsBftReplica, the ring's BLS flush)."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "bls")
