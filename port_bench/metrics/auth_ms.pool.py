"""Host ms per 3PC batch in the `auth` layer: its self time in the
program's host spans, four nodes summed over the traced window, over
Node1's 3PC batches in the window. The layer: client authentication
(CoreAuthNr.submit_batch, collect_batch) and stage_bytes' host SHA-512
and mod L."""
from port_bench.host_spans_common import ms_per_batch


def read(run):
    return ms_per_batch(run, "auth")
