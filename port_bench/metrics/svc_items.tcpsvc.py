"""Mean signatures per device dispatch of the crypto host after its
coalescing and cache: the crypto service's `dispatched_items` over
`dispatches`, their growth over the window."""
from port_bench.tcpsvc_metrics import svc_ratio


def read(run):
    return svc_ratio(run, "dispatched_items", "dispatches")
