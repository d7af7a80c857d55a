"""Arithmetic that several per-layer metric readers share."""


def idle_percent(run):
    """100 x (1 - busy / window) of the traced run; None untraced."""
    tr = run.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
