"""The port's copy of tests/test_consensus.py, run on plenum_tpu_torch.

Service-level consensus tests: real Replica services, SimNetwork transport,
MockTimer — no sockets, no node (ref plenum/test/consensus/conftest.py seam)."""
import pytest

from plenum_tpu_torch.common.internal_messages import VoteForViewChange
from plenum_tpu_torch.common.node_messages import (Commit, Ordered, PrePrepare,
                                             Prepare, DOMAIN_LEDGER_ID)
from plenum_tpu_torch.common.internal_messages import ReqKey
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.consensus.batch_executor import SimBatchExecutor
from plenum_tpu_torch.consensus.replica import Replica
from plenum_tpu_torch.network import (Deliver, Discard, SimNetwork, SimRandom,
                                match_frm, match_type)

NODES = ["Alpha", "Beta", "Gamma", "Delta"]


class PoolSim:
    """In-process pool of one replica per node over a seeded SimNetwork."""

    def __init__(self, names=NODES, seed=42, config=None, with_bls=False):
        self.names = list(names)
        self.timer = MockTimer()
        self.net = SimNetwork(self.timer, SimRandom(seed))
        self.config = config or Config()
        self.requests: dict[str, Request] = {}
        self.replicas: dict[str, Replica] = {}
        self.ordered: dict[str, list[Ordered]] = {n: [] for n in self.names}
        self.executors: dict[str, SimBatchExecutor] = {}

        bls_parts = {}
        if with_bls:
            from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, BlsCryptoVerifier
            from plenum_tpu_torch.consensus.bls_bft_replica import (BlsBftReplica,
                                                              BlsKeyRegister)
            signers = {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0"))
                       for n in self.names}
            register = BlsKeyRegister({n: s.pk for n, s in signers.items()})
            for n in self.names:
                bls_parts[n] = BlsBftReplica(
                    node_name=n, bls_signer=signers[n],
                    bls_verifier=BlsCryptoVerifier(), key_register=register)

        for name in self.names:
            bus = self.net.create_peer(name)
            executor = SimBatchExecutor()
            self.executors[name] = executor
            replica = Replica(node_name=name, inst_id=0,
                              validators=self.names, timer=self.timer,
                              network=bus, executor=executor,
                              bls=bls_parts.get(name), config=self.config,
                              get_request=self.requests.get)
            replica.internal_bus.subscribe(
                Ordered, lambda m, n=name: self.ordered[n].append(m))
            self.replicas[name] = replica
        self.net.connect_all()

    def finalize_request(self, req: Request, to=None):
        """Make a request available on (a subset of) nodes, as the propagate
        quorum would."""
        self.requests[req.digest] = req
        for name in (to or self.names):
            self.replicas[name].internal_bus.send(ReqKey(req.digest))

    def run(self, seconds=5.0, step=0.25):
        elapsed = 0.0
        while elapsed < seconds:
            for r in self.replicas.values():
                r.service()
            self.timer.advance(step)
            elapsed += step

    def primary_name(self):
        return self.replicas[self.names[0]].data.primaries[0]


def make_request(i: int) -> Request:
    return Request(identifier=f"client{i % 3}", req_id=1000 + i,
                   operation={"type": "1", "dest": f"did{i}"},
                   signature="sig")


def test_happy_path_orders_batch_on_all_nodes():
    pool = PoolSim()
    req = make_request(0)
    pool.finalize_request(req)
    pool.run(3.0)
    for name in NODES:
        assert len(pool.ordered[name]) == 1, f"{name} did not order"
        o = pool.ordered[name][0]
        assert o.req_idr == (req.digest,)
        assert o.pp_seq_no == 1
    # Deterministic executor: every master applied identical state.
    roots = {pool.ordered[n][0].state_root for n in NODES}
    assert len(roots) == 1


def test_multiple_batches_stay_in_order():
    pool = PoolSim()
    for i in range(5):
        pool.finalize_request(make_request(i))
        pool.run(1.5)
    seqs = [o.pp_seq_no for o in pool.ordered["Beta"]]
    assert seqs == sorted(seqs)
    assert seqs[-1] >= 2
    # All nodes converge to the same ordered log.
    logs = {n: tuple((o.pp_seq_no, o.state_root) for o in pool.ordered[n])
            for n in NODES}
    assert len(set(logs.values())) == 1


def test_batching_coalesces_requests():
    pool = PoolSim()
    reqs = [make_request(i) for i in range(10)]
    for r in reqs:
        pool.requests[r.digest] = r
    # Deliver all ReqKeys before any service cycle: one batch expected.
    for r in reqs:
        for name in NODES:
            pool.replicas[name].internal_bus.send(ReqKey(r.digest))
    pool.run(3.0)
    assert len(pool.ordered["Alpha"]) == 1
    assert len(pool.ordered["Alpha"][0].req_idr) == 10


def test_checkpoint_stabilizes_and_garbage_collects():
    pool = PoolSim(config=Config(CHK_FREQ=2, LOG_SIZE=6))
    for i in range(4):
        pool.finalize_request(make_request(i))
        pool.run(1.5)
    for name in NODES:
        data = pool.replicas[name].data
        assert data.stable_checkpoint >= 2, f"{name} at {data.stable_checkpoint}"
        assert data.low_watermark == data.stable_checkpoint
        ordering = pool.replicas[name].ordering
        assert all(k[1] > data.stable_checkpoint - 1
                   for k in ordering.prePrepares), "GC left stale entries"


def test_non_primary_preprepare_is_rejected():
    pool = PoolSim()
    suspicions = []
    pool.replicas["Beta"].internal_bus.subscribe(
        type(pool.replicas["Beta"]).__mro__ and
        __import__("plenum_tpu_torch.common.internal_messages",
                   fromlist=["RaisedSuspicion"]).RaisedSuspicion,
        lambda m: suspicions.append(m))
    fake = PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=0.0,
                      req_idr=(), discarded=(), digest="bogus",
                      ledger_id=DOMAIN_LEDGER_ID, state_root="x", txn_root="y")
    # Gamma (not the primary) injects a PRE-PREPARE directly into Beta.
    pool.replicas["Beta"].network.process_incoming(fake, "Gamma")
    assert any(s.code == Suspicions.PPR_FRM_NON_PRIMARY.code for s in suspicions)
    assert len(pool.ordered["Beta"]) == 0


def test_view_change_replaces_dead_primary():
    pool = PoolSim()
    pool.finalize_request(make_request(0))
    pool.run(3.0)
    assert all(len(pool.ordered[n]) == 1 for n in NODES)
    old_primary = pool.primary_name()
    assert old_primary == "Alpha"

    # Kill the primary's outbound traffic, then vote (as the monitor would).
    pool.net.add_rule(Discard(), match_frm("Alpha"))
    for name in ["Beta", "Gamma", "Delta"]:
        pool.replicas[name].internal_bus.send(
            VoteForViewChange(Suspicions.PRIMARY_DEGRADED.code))
    pool.run(5.0)

    for name in ["Beta", "Gamma", "Delta"]:
        data = pool.replicas[name].data
        assert data.view_no == 1, f"{name} stuck at view {data.view_no}"
        assert not data.waiting_for_new_view
        assert data.primaries[0] == "Beta"

    # The new primary keeps ordering where the old one left off.
    req = make_request(99)
    pool.finalize_request(req, to=["Beta", "Gamma", "Delta"])
    pool.run(4.0)
    for name in ["Beta", "Gamma", "Delta"]:
        last = pool.ordered[name][-1]
        assert last.req_idr == (req.digest,)
        assert last.view_no == 1
        assert last.pp_seq_no == 2


def test_view_change_reorders_prepared_batch():
    """A batch prepared before the view change must be re-ordered in the new
    view with its original digest (ref calc_batches + re-ordering)."""
    pool = PoolSim()
    req = make_request(0)
    # Block COMMITs so the batch prepares but never orders.
    rule = pool.net.add_rule(Discard(), match_type(Commit))
    pool.finalize_request(req)
    pool.run(3.0)
    assert all(len(pool.ordered[n]) == 0 for n in NODES)
    prepared = [n for n in NODES if pool.replicas[n].data.prepared]
    assert len(prepared) >= 3

    pool.net.remove_rule(rule)
    for name in NODES:
        pool.replicas[name].internal_bus.send(
            VoteForViewChange(Suspicions.PRIMARY_DEGRADED.code))
    pool.run(6.0)

    for name in NODES:
        data = pool.replicas[name].data
        assert data.view_no == 1
        assert not data.waiting_for_new_view
    # The batch ordered in view 1 carrying the view-0 payload.
    for name in NODES:
        assert len(pool.ordered[name]) == 1, f"{name}: {pool.ordered[name]}"
        o = pool.ordered[name][0]
        assert o.req_idr == (req.digest,)
        assert o.view_no == 1
        assert o.original_view_no == 0


def test_out_of_order_commit_quorums_order_sequentially():
    pool = PoolSim(seed=7)
    # Make batch 1's traffic slow so batch 2 completes its quorum first.
    slow = pool.net.add_rule(Deliver(2.0, 2.5), match_type((Prepare, Commit)))
    pool.finalize_request(make_request(0))
    pool.run(0.5)
    pool.net.remove_rule(slow)
    pool.finalize_request(make_request(1))
    pool.run(6.0)
    for name in NODES:
        seqs = [o.pp_seq_no for o in pool.ordered[name]]
        assert seqs == [1, 2], f"{name}: {seqs}"


def test_bls_multi_sig_survives_one_bad_signer():
    """Regression: a batch orders at quorum n-f COMMITs, so with one
    Byzantine signer among the first arrivals the honest aggregate falls
    short at order time; the late honest COMMIT (stale for 3PC — its key is
    already ordered) must still reach the BLS retry, or one bad signer
    suppresses multi-sigs on most of the pool forever."""
    pool = PoolSim(with_bls=True)

    class EvilSigner:
        def __init__(self, inner):
            self._inner = inner
        def sign(self, message):
            return self._inner.sign(b"EVIL " + message)

    evil = pool.names[-1]
    pool.replicas[evil].bls._signer = EvilSigner(
        pool.replicas[evil].bls._signer)
    req = make_request(0)
    pool.finalize_request(req)
    pool.run(5.0)
    assert all(len(pool.ordered[n]) == 1 for n in NODES)
    o = pool.ordered["Alpha"][0]
    for name in NODES:
        ms = pool.replicas[name].bls._recent_multi_sigs.get(o.state_root)
        assert ms is not None, f"{name} never formed a multi-sig"
        assert evil not in ms.participants
        assert len(ms.participants) == 3


def test_bls_multi_sig_collected_on_order():
    pool = PoolSim(with_bls=True)
    req = make_request(0)
    pool.finalize_request(req)
    pool.run(3.0)
    assert all(len(pool.ordered[n]) == 1 for n in NODES)
    # After ordering, each node aggregated a multi-sig over the state root.
    o = pool.ordered["Alpha"][0]
    for name in NODES:
        bls = pool.replicas[name].bls
        ms = bls._recent_multi_sigs.get(o.state_root)
        assert ms is not None, f"{name} has no multi-sig"
        assert len(ms.participants) >= 3
    # Second batch embeds the first batch's multi-sig in its PRE-PREPARE.
    pool.finalize_request(make_request(1))
    pool.run(3.0)
    pp = pool.replicas["Beta"].ordering.prePrepares[(0, 2)]
    assert pp.bls_multi_sig is not None
