"""Mean time a device-ring wave takes from its first item staged to its
verdicts resolved (ms), over the waves the ring resolved in the traced
window: the program's wave counter in its host-span recorder."""
from port_bench.host_spans_common import last_session


def read(run):
    session = last_session()
    if session is None or not session["waves"]:
        return None
    return session["wave_wait_s"] / session["waves"] * 1e3
