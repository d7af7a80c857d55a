"""The port's copy of tests/test_sim_network.py, run on
plenum_tpu_torch. The multihost case drives the port's
parallel/multihost.py over eight explicit CPU lanes, its mesh held to the
reference's shape.

SimNetwork determinism and fault-injection semantics
(ref plenum/test/simulation/test_sim_network.py behavior)."""
from plenum_tpu_torch.common.node_messages import Checkpoint, Propagate
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.network import (Deliver, Discard, SimNetwork, SimRandom, Stash,
                                match_dst, match_frm, match_type)


def _mk_pool(n=3, seed=7):
    timer = MockTimer()
    net = SimNetwork(timer, SimRandom(seed))
    inboxes = {}
    for i in range(n):
        name = f"N{i}"
        bus = net.create_peer(name)
        inboxes[name] = []
        bus.subscribe(Checkpoint, lambda m, frm, box=inboxes[name]: box.append((m, frm)))
        bus.subscribe(Propagate, lambda m, frm, box=inboxes[name]: box.append((m, frm)))
    net.connect_all()
    return timer, net, inboxes


def _chk(end=10):
    return Checkpoint(inst_id=0, view_no=0, seq_no_start=0, seq_no_end=end,
                      digest="d" * 8)


def test_broadcast_reaches_all_other_peers():
    timer, net, inboxes = _mk_pool()
    net._peers["N0"].send(_chk())
    timer.run_to_completion()
    assert len(inboxes["N1"]) == 1 and len(inboxes["N2"]) == 1
    assert inboxes["N0"] == []
    msg, frm = inboxes["N1"][0]
    assert frm == "N0" and msg.seq_no_end == 10
    # Wire round-trip produced a fresh object, not the sender's instance.
    assert isinstance(msg, Checkpoint)


def test_unicast_and_selector_rules():
    timer, net, inboxes = _mk_pool()
    net.add_rule(Discard(), match_frm("N0"), match_dst("N1"),
                 match_type(Checkpoint))
    net._peers["N0"].send(_chk(), dst=["N1", "N2"])
    timer.run_to_completion()
    assert inboxes["N1"] == []           # discarded
    assert len(inboxes["N2"]) == 1       # delivered


def test_stash_rule_replays_on_removal():
    timer, net, inboxes = _mk_pool()
    rule = net.add_rule(Stash(), match_type(Checkpoint))
    net._peers["N0"].send(_chk())
    timer.run_to_completion()
    assert inboxes["N1"] == [] and inboxes["N2"] == []
    net.remove_rule(rule)
    timer.run_to_completion()
    assert len(inboxes["N1"]) == 1 and len(inboxes["N2"]) == 1


def test_deliver_rule_controls_delay():
    timer, net, inboxes = _mk_pool()
    net.add_rule(Deliver(5.0, 5.0), match_type(Checkpoint))
    net._peers["N0"].send(_chk())
    timer.advance(4.9)
    assert inboxes["N1"] == []
    timer.advance(0.2)
    assert len(inboxes["N1"]) == 1


def test_determinism_same_seed_same_trace():
    traces = []
    for _ in range(2):
        timer, net, inboxes = _mk_pool(n=4, seed=123)
        net.add_rule(Discard(0.5), match_type(Checkpoint))
        for k in range(20):
            net._peers["N0"].send(_chk(end=k))
        timer.run_to_completion()
        traces.append([m.seq_no_end for (m, _) in inboxes["N1"]])
    assert traces[0] == traces[1]


def test_connected_events():
    timer = MockTimer()
    net = SimNetwork(timer)
    seen = []
    b0 = net.create_peer("N0")
    b0.subscribe(type(b0).Connected, lambda m, frm: seen.append(m.name))
    net.create_peer("N1")
    net.connect_all()
    assert seen == ["N1"]
    assert b0.connecteds == {"N1"}


# --- topology-aware fault model ---------------------------------------------
# LinkProfile/Topology/make_topology: per-link latency+jitter+loss+bandwidth,
# all drawn through the fabric's SimRandom so profiled runs stay replayable.

from plenum_tpu_torch.network import LinkProfile, Topology, make_topology


def test_multihost_api_single_process():
    """init_multihost + global_mesh + shard_host_batch drive the sharded
    crypto plane on the single-process job (8 CPU lanes here) — the same
    call sequence a multi-host deployment uses; the mesh's shape is the
    reference's over its 8 virtual devices, and shard_host_batch places
    a row block of the batch on each lane, as the reference's does."""
    import numpy as np
    import torch

    from plenum_tpu.parallel.multihost import global_mesh as ref_global_mesh
    from plenum_tpu_torch.parallel.crypto_plane import ShardedCryptoPlane
    from plenum_tpu_torch.parallel.multihost import (global_mesh,
                                                     init_multihost,
                                                     shard_host_batch)

    pre = init_multihost()                 # single-process: no coordinator
    assert set(pre) >= {"build_dir", "libraries", "warm", "stale"}
    mesh = global_mesh(8, devices=["cpu"] * 8)
    assert mesh.size == 8 and tuple(mesh.shape) == ("inst", "sig")
    assert mesh.devices.shape == ref_global_mesh(8).devices.shape
    assert mesh.local == slice(0, 8) and not mesh.in_group

    arr = np.arange(8 * 4, dtype=np.int64).reshape(8, 4)
    blocks = shard_host_batch(mesh, arr, (("inst", "sig"), None))
    assert [tuple(b.shape) for b in blocks] == [(1, 4)] * 8
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), arr)
    # the plane takes the placed batch as it comes: 8 leaf digests, one
    # a lane, reduce to the root of the whole tree
    from plenum_tpu_torch.ops.sha256 import merkle_reduce_pow2
    leaves = np.arange(64, dtype=np.int32).reshape(8, 8)
    plane = ShardedCryptoPlane(mesh)
    keys = torch.zeros((1, 32), dtype=torch.uint8)
    z = torch.zeros((2, 4, 32), dtype=torch.uint8)
    _, root, _ = plane.step_bytes(
        z, z, keys, torch.zeros((2, 4), dtype=torch.int32), z,
        shard_host_batch(mesh, leaves, (("inst", "sig"), None)))
    assert torch.equal(root, merkle_reduce_pow2(torch.from_numpy(leaves)))


def _timed_pool(n=4, seed=7, topology=None):
    timer = MockTimer()
    net = SimNetwork(timer, SimRandom(seed), topology=topology)
    arrivals = {}
    for i in range(n):
        name = f"N{i}"
        bus = net.create_peer(name)
        arrivals[name] = []
        bus.subscribe(Checkpoint,
                      lambda m, frm, box=arrivals[name], t=timer:
                      box.append((t.get_current_time(), m, frm)))
    net.connect_all()
    return timer, net, arrivals


def test_topology_regions_shape_latency():
    """geo3: same-region delivery is millisecond-scale, cross-region pays
    the inter-region propagation delay."""
    topo = make_topology("geo3", ["N0", "N1", "N2", "N3"])
    # round-robin assignment: N0->geo0, N1->geo1, N2->geo2, N3->geo0
    assert topo.region_of("N0") == topo.region_of("N3") == "geo0"
    assert topo.region_of("N1") == "geo1"
    timer, net, arrivals = _timed_pool(topology=topo)
    net._peers["N0"].send(_chk(), dst=["N3"])       # intra-region
    net._peers["N0"].send(_chk(), dst=["N1"])       # cross-region
    timer.run_to_completion()
    t_intra = arrivals["N3"][0][0]
    t_inter = arrivals["N1"][0][0]
    assert t_intra < 0.01, t_intra
    assert t_inter >= 0.04, t_inter                 # >= base inter delay


def test_lossy_wan_drops_are_counted_and_seeded():
    """lossy_wan drops a seeded fraction cross-region and counts every
    loss; the same seed reproduces the identical loss pattern."""
    traces = []
    for _ in range(2):
        topo = make_topology("lossy_wan", ["N0", "N1"], n_regions=2)
        timer, net, arrivals = _timed_pool(n=2, seed=99, topology=topo)
        for k in range(200):
            net._peers["N0"].send(_chk(end=k), dst=["N1"])
        timer.run_to_completion()
        got = [m.seq_no_end for (_, m, _) in arrivals["N1"]]
        assert net.lost_count > 0
        assert len(got) + net.lost_count == 200
        traces.append((net.lost_count, sorted(got)))
    assert traces[0] == traces[1]


def test_bandwidth_cap_spreads_bursts():
    """A burst over a thin link serializes: the last frame's arrival
    reflects queueing behind the burst, not one flat propagation delay."""
    thin = LinkProfile(base_delay=0.01, jitter=0.0, loss=0.0,
                      bandwidth=10_000.0)          # 10 kB/s
    topo = Topology(["a", "b"], links={("a", "b"): thin,
                                       ("b", "a"): thin})
    topo.assign("N0", "a")
    topo.assign("N1", "b")
    timer, net, arrivals = _timed_pool(n=2, topology=topo)
    for k in range(20):
        net._peers["N0"].send(_chk(end=k), dst=["N1"])
    timer.run_to_completion()
    times = [t for (t, _, _) in arrivals["N1"]]
    assert len(times) == 20
    size = net.tx_msgs["CHECKPOINT"][1] / 20        # bytes per message
    expect_last = 0.01 + 20 * size / 10_000.0
    assert max(times) >= expect_last * 0.9
    # and the spread is real: first arrival well before the last
    assert min(times) < max(times) / 2


def test_explicit_rules_override_topology():
    """Scenario faults compose ON TOP of the WAN profile: a Deliver rule
    still pins its own delay, a Discard still kills the message."""
    topo = make_topology("geo3", [f"N{i}" for i in range(4)])
    timer, net, arrivals = _timed_pool(topology=topo)
    net.add_rule(Deliver(5.0, 5.0), match_dst("N1"))
    net.add_rule(Discard(), match_dst("N2"))
    net._peers["N0"].send(_chk())
    timer.run_to_completion()
    assert arrivals["N1"][0][0] >= 5.0
    assert arrivals["N2"] == []


def test_topology_assigns_churned_peers_deterministically():
    """A peer created after construction (membership churn: a joiner) is
    auto-assigned round-robin — same join order, same placement."""
    topo = make_topology("geo3", ["N0", "N1", "N2"])
    first = topo.region_of("Joiner")
    topo2 = make_topology("geo3", ["N0", "N1", "N2"])
    assert topo2.region_of("Joiner") == first
