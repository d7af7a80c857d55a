"""95th percentile, over every write sent in the window, of the time from
sending it to the f + 1-th matching REPLY (the clients)."""
from port_bench.stats import percentile


def read(run):
    lat = run["collected"].get("latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
