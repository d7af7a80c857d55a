"""K3 + K4's share of their roofline in the traced window (%): the least
time the card could take for the RFC 8032 work of the signatures and
distinct keys the crypto host dispatched in the window
(port_bench/roofline.py; its `stats` counters `dispatched_items` and
`dispatched_keys`, their growth over the window), over K3 + K4's device
time in its trace."""
from port_bench import roofline


def read(run):
    trace = (run["collected"].get("svc_report") or {}).get("trace")
    w = run["collected"].get("svc_window") or {}
    if trace is None or not w.get("dispatched_items") \
            or w.get("dispatched_keys") is None:
        return None
    device_s = roofline.kernel_seconds(trace["device_s_by_name"])
    return roofline.ed25519_roofline_percent(
        w["dispatched_items"], w["dispatched_keys"], device_s)
