"""The port's copy of tests/test_scale.py, run on plenum_tpu_torch (nodes on
the CPU, `slow` marks where the reference has them);
`signed_node_services` also serves tools/churn_soak.py.

25-node / f=8 pool (the largest BASELINE.json config) + mixed load.

Reference analog: the 25-node replay scenario — quorum math, propagate
fan-out, and BLS aggregation at n=25 are qualitatively different from the
4-node slice (f+1=9 protocol instances, 17-signature aggregates), so a
pool this wide must order writes and stay consistent end to end.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, Reply
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import GET_NYM

from test_torch_pool import Pool, signed_nym

TWENTY_FIVE = [f"N{i:02d}" for i in range(25)]


@pytest.mark.slow
def test_twenty_five_node_pool_orders_and_agrees():
    pool = Pool(names=TWENTY_FIVE, config=Config(
        Max3PCBatchWait=0.05, STATE_FRESHNESS_UPDATE_INTERVAL=600.0))
    node = pool.nodes["N00"]
    assert node.f == 8
    assert len(node.replicas) == 9            # f+1 instances
    assert node.quorums.commit.value == 17    # n - f

    users = []
    for i in range(4):
        user = Ed25519Signer(seed=(b"25n-u%d" % i).ljust(32, b"\0"))
        users.append(user)
        pool.submit(signed_nym(pool.trustee, user, i + 1))
    pool.run(10.0)

    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {5}, sizes                # genesis NYM + 4 writes
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1
    # the ordered batch carries a 17-of-25 BLS aggregate over the state root
    assert any(isinstance(m, Reply) for m, _ in pool.client_msgs["N00"])


@pytest.mark.slow
def test_mixed_read_write_load():
    """Writes and state-proof reads interleaved on the same pool (the
    BASELINE 'mixed load' config): reads answer locally from committed
    state while writes keep ordering."""
    pool = Pool()
    users = []
    for i in range(3):
        user = Ed25519Signer(seed=(b"mx-u%d" % i).ljust(32, b"\0"))
        users.append(user)
        pool.submit(signed_nym(pool.trustee, user, i + 1))
    pool.run(6.0)

    # interleave: reads for committed NYMs + more writes in the same cycles
    from plenum_tpu_torch.common.request import Request
    for i, user in enumerate(users):
        q = Request(pool.trustee.identifier, 100 + i,
                    {"type": GET_NYM, "dest": user.identifier})
        q.signature = pool.trustee.sign_b58(q.signing_bytes())
        pool.submit(q, to=["Alpha"])
    for i in range(3, 6):
        user = Ed25519Signer(seed=(b"mx-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, user, i + 1))
    pool.run(6.0)

    replies = [m for m, _ in pool.client_msgs["Alpha"]
               if isinstance(m, Reply)]
    reads = [m for m in replies if m.result.get("type") == GET_NYM]
    assert len(reads) == 3
    for m in reads:
        assert m.result["data"] is not None
        assert "state_proof" in m.result
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {7}, sizes                # genesis + 6 writes


def signed_node_services(trustee, alias, services, req_id):
    """Trustee services-only NODE edit (promotion/demotion)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import NODE
    req = Request(trustee.identifier, req_id,
                  {"type": NODE, "dest": f"{alias}Dest",
                   "data": {"services": services}})
    req.signature = trustee.sign_b58(req.signing_bytes())
    return req


def test_replicas_grow_when_pool_crosses_f_boundary():
    """Promoting nodes 5..7 moves f from 1 to 2: every node grows a third
    protocol instance with a deterministic primary for the current view,
    and the next view change will select 3 primaries (ref adjustReplicas
    node.py:1260)."""
    seven = ["Alpha", "Beta", "Gamma", "Delta", "Eps", "Zeta", "Eta"]
    pool = Pool(names=seven, validator_names=seven[:4],
                config=Config(Max3PCBatchWait=0.05,
                              STATE_FRESHNESS_UPDATE_INTERVAL=600.0))
    alpha = pool.nodes["Alpha"]
    assert len(alpha.validators) == 4 and alpha.f == 1
    assert len(alpha.replicas) == 2

    for i, alias in enumerate(seven[4:]):
        pool.submit(signed_node_services(pool.trustee, alias,
                                         ["VALIDATOR"], 50 + i))
        pool.run(4.0)

    for name in seven[:4]:
        node = pool.nodes[name]
        assert len(node.validators) == 7, name
        assert node.f == 2 and node.quorums.commit.value == 5
        assert len(node.replicas) == 3, name
        # the NEW instance's rank assignment is deterministic, distinct
        # from the existing ranks, and identical across the pool (the
        # master keeps its view-scoped list until the next view change)
        prims = list(node.replicas[2].data.primaries)
        assert len(prims) == 3 and len(set(prims)) == 3
        assert prims == list(
            pool.nodes["Beta"].replicas[2].data.primaries)
        assert node.replicas[2].data.view_no == \
            node.replicas.master.data.view_no
        assert node.replicas.master.view_changer._instance_count == 3

    # ordering continues at the wider quorum (promoted nodes shadowed the
    # full 3PC history, so they participate from the right state)
    user = Ed25519Signer(seed=b"grown-pool-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 99))
    pool.run(6.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in seven}
    assert sizes == {2}, sizes


def test_bls_key_rotation_keeps_pool_live():
    """Rotating a validator's BLS key (owner NODE edit) must not storm
    view changes: the first PRE-PREPARE after the rotation batch embeds a
    multi-sig made under the OLD key, which validators verify against the
    key register AS OF the sig's pool state root (historic MPT read,
    ref BlsKeyRegisterPoolManager.get_key_by_name(pool_state_root))."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import NODE

    pool = Pool(config=Config(Max3PCBatchWait=0.05,
                              STATE_FRESHNESS_UPDATE_INTERVAL=600.0))
    # traffic before the rotation so multi-sigs exist
    u0 = Ed25519Signer(seed=b"rot-u0".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u0, 1))
    pool.run(5.0)

    new_signer = BlsCryptoSigner(seed=b"gamma-rotated-key".ljust(32, b"\0")[:32])
    req = Request(pool.trustee.identifier, 40,
                  {"type": NODE, "dest": "GammaDest",
                   "data": {"blskey": new_signer.pk,
                            "blskey_pop": new_signer.generate_pop()}})
    req.signature = pool.trustee.sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(5.0)
    # ledger-side rotation landed
    assert pool.nodes["Alpha"].pool_manager.bls_key_of("Gamma") == new_signer.pk
    # the operator restarts Gamma with the new key (simulated in place)
    pool.nodes["Gamma"].replicas.master.bls._signer = new_signer

    for i in range(2, 5):
        u = Ed25519Signer(seed=(b"rot-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, u, i))
        pool.run(4.0)

    # no BLS multi-sig suspicions anywhere, no view change, all ordered
    for name in pool.names:
        node = pool.nodes[name]
        assert node.master_replica.view_no == 0, name
        bad = [e for e in node.spylog if e[0] == "suspicion"
               and e[1][0] == 15]
        assert not bad, (name, bad)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {5}, sizes
    # Gamma's NEW key participates in fresh aggregates
    ms = pool.nodes["Alpha"].replicas.master.bls._recent_multi_sigs
    assert any("Gamma" in m.participants for m in ms.values())


def test_replicas_shrink_when_pool_demotes_below_f_boundary():
    """Demoting 3 of 7 validators moves f back from 2 to 1: instances
    shrink to 2 on every remaining node and the pool keeps ordering at
    the narrower quorum."""
    seven = ["Alpha", "Beta", "Gamma", "Delta", "Eps", "Zeta", "Eta"]
    pool = Pool(names=seven, config=Config(
        Max3PCBatchWait=0.05, STATE_FRESHNESS_UPDATE_INTERVAL=600.0))
    assert len(pool.nodes["Alpha"].replicas) == 3
    for i, alias in enumerate(seven[4:]):
        pool.submit(signed_node_services(pool.trustee, alias, [], 60 + i))
        pool.run(4.0)
    for name in seven[:4]:
        node = pool.nodes[name]
        assert len(node.validators) == 4, name
        assert node.f == 1
        assert len(node.replicas) == 2, name
        assert node.replicas.master.view_changer._instance_count == 2
    user = Ed25519Signer(seed=b"shrunk-pool-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 99))
    pool.run(6.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in seven[:4]}
    assert sizes == {2}, sizes


@pytest.mark.parametrize("name", [
    "test_replicas_grow_when_pool_crosses_f_boundary",
    "test_bls_key_rotation_keeps_pool_live",
    "test_replicas_shrink_when_pool_demotes_below_f_boundary",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_scale as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
