"""The port's copy of tests/test_inconsistency_watcher.py, run on plenum_tpu_torch.

NetworkInconsistencyWatcher unit tests (ref inconsistency_watchers.py:5):
the callback fires exactly on the strong-connectivity-then-lost-weak edge.
"""
from plenum_tpu_torch.node.inconsistency_watcher import NetworkInconsistencyWatcher


def _watcher(n=4):
    fired = []
    w = NetworkInconsistencyWatcher(lambda: fired.append(1))
    w.set_nodes([f"N{i}" for i in range(n)])
    return w, fired


def test_fires_after_strong_then_below_weak():
    w, fired = _watcher(4)            # f=1: strong=3 peers, weak=2
    for p in ("N1", "N2", "N3"):
        w.connect(p)                  # strong connectivity reached
    w.disconnect("N1")
    assert not fired                  # 2 left: still >= weak
    w.disconnect("N2")
    assert len(fired) == 1            # 1 left: below weak -> fire


def test_never_fires_without_reaching_strong_first():
    w, fired = _watcher(4)
    w.connect("N1")
    w.connect("N2")                   # weak yes, strong never
    w.disconnect("N1")
    w.disconnect("N2")
    assert not fired


def test_one_shot_until_strong_again():
    w, fired = _watcher(4)
    for p in ("N1", "N2", "N3"):
        w.connect(p)
    for p in ("N1", "N2", "N3"):
        w.disconnect(p)
    assert len(fired) == 1            # no repeat fire on further drops
    w.connect("N1")
    w.disconnect("N1")
    assert len(fired) == 1            # weak alone does not re-arm
    for p in ("N1", "N2", "N3"):
        w.connect(p)                  # strong re-arms
    w.disconnect("N1")
    w.disconnect("N2")
    assert len(fired) == 2


def test_no_fire_before_membership_known():
    fired = []
    w = NetworkInconsistencyWatcher(lambda: fired.append(1))
    w.connect("N1")
    w.disconnect("N1")                # Quorums(0) must not trip anything
    assert not fired


def test_membership_growth_rescales_thresholds():
    w, fired = _watcher(4)
    for p in ("N1", "N2", "N3"):
        w.connect(p)
    w.set_nodes([f"N{i}" for i in range(7)])   # f=2: weak=3 peers
    w.disconnect("N1")                # 2 connected < weak(3) -> fire
    assert len(fired) == 1


def test_bus_events_drive_the_watcher():
    from plenum_tpu_torch.common.event_bus import ExternalBus
    bus = ExternalBus(lambda msg, dst: None)
    fired = []
    w = NetworkInconsistencyWatcher(lambda: fired.append(1), network=bus)
    w.set_nodes(["A", "B", "C", "D"])
    bus.update_connecteds({"B", "C", "D"})
    bus.update_connecteds(set())
    assert len(fired) == 1
