"""What the host-span readers share.

The program's span recorder (`plenum_tpu_torch.common.host_spans`) is on
while a torch profiler session records, so in a `--trace 1` run its last
session is the measured window. A program without the recorder, or a run
that opened no session, reads None.
"""


def last_session():
    """The recorder's last session, or None."""
    try:
        from plenum_tpu_torch.common.host_spans import RECORDER
    except ImportError:
        return None
    return RECORDER.session()


def ms_per_batch(run, layer: str):
    """The layer's self time over the session, summed over the co-hosted
    nodes, per 3PC batch Node1 ordered in the window (ms)."""
    session = last_session()
    batches = run["collected"].get("ordered_batches")
    if session is None or not batches:
        return None
    return session["self_s"][layer] / batches * 1e3
