"""Share of the signatures the nodes sent the crypto host that its
verdict cache answered (%): the crypto service's `cache_hits` over
`items`, their growth over the window. Every node verifies every request,
so four nodes could read up to 75 %."""
from port_bench.tcpsvc_metrics import svc_ratio


def read(run):
    return svc_ratio(run, "cache_hits", "items", 100.0)
