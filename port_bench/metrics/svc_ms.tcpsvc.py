"""Host ms per 3PC batch in the crypto host: every self second of its
host-span session over the traced window (its top-level spans: `svc`, the
service's own work of taking client batches, cache lookups, dispatching
and landing waves, with the `auth` staging and `serde` inside them), over
Node1's 3PC batches in its session. None where the program's crypto host
has no `svc` layer."""
from port_bench.tcpsvc_metrics import batches, svc_session


def read(run):
    session, n = svc_session(run), batches(run)
    if session is None or not n:
        return None
    return session["top_s"] / n * 1e3
