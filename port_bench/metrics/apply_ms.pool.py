"""Mean time Node1 spends applying an ordered batch (execution): its
MetricsCollector accumulator COMMIT_APPLY_TIME, total over count, taken
over the window."""


def read(run):
    c = run["collected"]
    if not c.get("apply_count"):
        return None
    return c["apply_s_total"] / c["apply_count"] * 1e3
