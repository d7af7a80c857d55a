"""Share of the traced window in which no operation ran on the card, from
the crypto host's CUDA trace (port_bench/svc_host.py)."""
from port_bench.metrics_common import idle_percent as read  # noqa: F401
