"""What the readers of the tcpsvc cell share (`metrics/*.tcpsvc.py`).

A traced run of `traffic/tcp_closed.py` collects each node process's
host-span session (`sessions`, node -> the figures
`common/host_spans.serve_sessions` wrote, None where the program has no
sessions), the crypto host's report (`svc_report`,
`port_bench/svc_host.py`) and its `stats` counters' growth over the window
(`svc_window`). A figure the run lacks reads None.
"""


def batches(run):
    """Node1's 3PC batches in its session; None without one."""
    return run["collected"].get("ordered_batches") or None


def node_ms_per_batch(run, layer: str):
    """The layer's self time, four node processes summed, per 3PC batch
    Node1 ordered in its session (ms)."""
    sessions = run["collected"].get("sessions") or {}
    n = batches(run)
    if not n or not sessions or any(s is None for s in sessions.values()):
        return None
    if any(layer not in s["self_s"] for s in sessions.values()):
        return None
    return sum(s["self_s"][layer] for s in sessions.values()) / n * 1e3


def svc_session(run):
    """The crypto host's host-span session, where the program gives it a
    `svc` layer; else None."""
    report = run["collected"].get("svc_report") or {}
    session = report.get("session")
    if session is None or "svc" not in session["self_s"]:
        return None
    return session


def svc_ratio(run, num: str, den: str, scale: float = 1.0):
    """scale x the growth of one crypto-host counter over another's in
    the window; None where either is missing or the second did not grow."""
    w = run["collected"].get("svc_window") or {}
    if w.get(num) is None or not w.get(den):
        return None
    return scale * w[num] / w[den]
