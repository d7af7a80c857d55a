"""Mean wait of a client batch in the crypto host's queue, from its
arrival to the worker's taking it into a wave or answering it from the
verdict cache (ms): the crypto service's `queue_wait_s` over
`queued_jobs`, their growth over the window."""
from port_bench.tcpsvc_metrics import svc_ratio


def read(run):
    return svc_ratio(run, "queue_wait_s", "queued_jobs", 1e3)
