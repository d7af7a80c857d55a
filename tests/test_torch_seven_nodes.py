"""The port's copy of tests/test_seven_nodes.py, run on plenum_tpu_torch
(nodes on the CPU; the TCP pool on `cpu`, `slow` as in the reference).

7-node / f=2 pool (a BASELINE.json config): 3 RBFT instances, ordering
under load, and recovery from TWO simultaneous node failures including the
primary. The TCP variant proves the asyncio stack's O(n^2) mesh (42
directed connections) holds up beyond 4 nodes.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network import Discard, match_dst, match_frm

from test_torch_pool import Pool, signed_nym

SEVEN = ["Alpha", "Beta", "Gamma", "Delta", "Epsilon", "Zeta", "Eta"]


def test_seven_node_pool_orders_and_survives_f_failures():
    pool = Pool(names=SEVEN, config=Config(
        Max3PCBatchWait=0.05, PRIMARY_HEALTH_CHECK_FREQ=0.5,
        ORDERING_PROGRESS_TIMEOUT=2.0,
        STATE_FRESHNESS_UPDATE_INTERVAL=3.0))
    node = pool.nodes["Alpha"]
    assert node.f == 2
    assert len(node.replicas) == 3            # f+1 instances

    for i in range(5):
        user = Ed25519Signer(seed=(b"7n-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, user, i + 1))
    pool.run(8.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {6}, sizes

    # cut off the master primary AND one other node (exactly f=2 faults)
    primary = node.master_replica.data.primary_name
    other = next(n for n in pool.names if n != primary)
    for victim in (primary, other):
        pool.net.add_rule(Discard(), match_dst(victim))
        pool.net.add_rule(Discard(), match_frm(victim))
    survivors = [n for n in pool.names if n not in (primary, other)]

    user = Ed25519Signer(seed=b"7n-after-vc".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 10), to=survivors)
    # with exactly n-f=5 live nodes every view change needs ALL survivors
    # timely, so convergence can take several rounds — give it room
    pool.run(60.0)
    for n in survivors:
        assert pool.nodes[n].master_replica.view_no >= 1, \
            f"{n} never left view 0"
        assert pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 7, n
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in survivors}
    assert len(roots) == 1


@pytest.mark.slow
def test_seven_node_pool_over_real_tcp():
    """The asyncio TCP stack at 7 nodes / f=2: 42 directed encrypted
    connections, 7 OS processes, real NYM load ordered pool-wide
    (no scale datum existed for the TCP stack beyond 4)."""
    pytest.importorskip(
        "cryptography",
        reason="the TCP node stack's handshake needs the cryptography package")
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool

    stats = run_tcp_pool(n_nodes=7, n_txns=60, backend="cpu", timeout=120.0)
    assert stats["txns_ordered"] == 60, stats
    assert stats["tps"] > 1.0
    assert stats["p50_latency_ms"] < 30_000


@pytest.mark.parametrize("name", [
    "test_seven_node_pool_orders_and_survives_f_failures",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_seven_nodes as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
