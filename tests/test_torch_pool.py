"""The port's copy of tests/test_pool.py, run on plenum_tpu_torch.

End-to-end 4-node pool: signed NYM writes over SimNetwork through the full
stack — client authN (real Ed25519), propagate quorum, 3PC, BLS multi-sig,
ledger+state+audit commit, REPLY with Merkle/state proofs.

This is SURVEY.md §7's "minimum end-to-end slice" — the equivalent of the
reference's sdk_send_random_and_check over txnPoolNodeSet
(plenum/test/conftest.py:695, helper.py:1034).
"""
import contextlib

import pytest

from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, POOL_LEDGER_ID,
                                             Reply, RequestAck, RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import NODE, NYM, TRUSTEE
from plenum_tpu_torch.network import SimNetwork, SimRandom
from plenum_tpu_torch.node import Node, NodeBootstrap
from plenum_tpu_torch.state.pruning_state import PruningState

NODES = ["Alpha", "Beta", "Gamma", "Delta"]


@pytest.fixture
def one_torch_thread():
    """The kernels' plain versions run here on tensors of a few hundred
    elements, where torch's intra-op threads only oversubscribe the host
    (and the test files running beside this one): one thread for the
    test, the process's setting back after it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_genesis(names, validator_names=None):
    """Pool NODE txns (with real BLS verkeys) + a trustee NYM.
    validator_names: subset with services=[VALIDATOR]; the rest start as
    known-but-demoted nodes (services=[]) awaiting promotion."""
    trustee = Ed25519Signer(seed=b"trustee-seed".ljust(32, b"\0"))
    pool_txns = []
    for i, name in enumerate(names):
        bls_pk = BlsCryptoSigner(seed=name.encode().ljust(32, b"\0")[:32]).pk
        services = ["VALIDATOR"] if (validator_names is None
                                     or name in validator_names) else []
        txn = txn_lib.new_txn(NODE, {
            "dest": f"{name}Dest",
            "data": {"alias": name, "services": services,
                     "blskey": bls_pk,
                     "node_ip": "127.0.0.1", "node_port": 9700 + 2 * i,
                     "client_ip": "127.0.0.1", "client_port": 9701 + 2 * i}})
        # genesis nodes are steward-owned by the trustee so owner-only
        # edits (key rotation) are exercisable in tests
        txn["txn"].setdefault("metadata", {})["from"] = trustee.identifier
        txn_lib.set_seq_no(txn, i + 1)
        pool_txns.append(txn)
    nym = txn_lib.new_txn(NYM, {"dest": trustee.identifier,
                                "verkey": trustee.verkey_b58,
                                "role": TRUSTEE})
    txn_lib.set_seq_no(nym, 1)
    return {POOL_LEDGER_ID: pool_txns, DOMAIN_LEDGER_ID: [nym]}, trustee


def CpuConfig(**kw):
    """The port's Config with the nodes' crypto on the CPU: its
    crypto_backend default is the card (the reference's is "cpu"), so the
    ported tests that build their own Config import this as Config."""
    kw.setdefault("crypto_backend", "cpu")
    return Config(**kw)


class Pool:
    def __init__(self, names=NODES, seed=42, config=None, data_dir=None,
                 validator_names=None, verifier=None, tracing=True,
                 pipeline=None):
        self.names = list(names)
        self.timer = MockTimer()
        self.net = SimNetwork(self.timer, SimRandom(seed))
        self.config = config or Config(Max3PCBatchWait=0.05,
                                       crypto_backend="cpu")
        self.verifier = verifier          # shared crypto plane (co-hosted)
        self.pipeline = pipeline          # shared fused crypto pipeline
        self.data_dir = data_dir          # per-node durable storage root
        self.tracing = tracing            # flight recorders on every node
        self.genesis, self.trustee = make_genesis(self.names, validator_names)
        self.client_msgs: dict[str, list] = {n: [] for n in self.names}
        self.nodes: dict[str, Node] = {}
        for name in self.names:
            self.start_node(name)
        self.net.connect_all()
        # conftest dumps every registered pool's flight-recorder rings
        # into the test report when the test fails
        try:
            from conftest import register_pool_for_flight_dump
            register_pool_for_flight_dump(self)
        except ImportError:
            pass

    def _node_data_dir(self, name):
        import os
        return os.path.join(self.data_dir, name) if self.data_dir else None

    def start_node(self, name: str) -> Node:
        """(Re)build a node from genesis + its durable dir and attach it
        to the fabric; used both at pool build and for restart tests."""
        bus = self.net.create_peer(name)
        components = NodeBootstrap(
            name, genesis_txns=self.genesis,
            data_dir=self._node_data_dir(name),
            crypto_backend=self.config.crypto_backend,
            storage_backend=self.config.kv_backend,
            verifier=self.verifier,
            pipeline=self.pipeline,
            state_commitment=self.config.STATE_COMMITMENT,
            state_commitment_per_ledger=(
                self.config.STATE_COMMITMENT_PER_LEDGER),
            verkle_width=self.config.VERKLE_WIDTH).build()
        from plenum_tpu_torch.common.tracing import Tracer
        tracer = Tracer(name, self.timer.get_current_time,
                        clock_domain="shared") if self.tracing else None
        self.nodes[name] = Node(
            name, self.timer, bus, components,
            client_send=lambda msg, client, n=name:
                self.client_msgs[n].append((msg, client)),
            config=self.config, tracer=tracer)
        return self.nodes[name]

    def crash_node(self, name: str) -> None:
        """Hard-stop: drop the node object with NO clean shutdown (no
        close, no compaction) — the durable files are left exactly as the
        last flushed write; the dropped handles leak until GC, as in a
        real crash."""
        self.nodes.pop(name)
        self.net.remove_peer(name)

    def run(self, seconds=5.0, step=0.1):
        elapsed = 0.0
        while elapsed < seconds:
            for node in self.nodes.values():
                node.prod()
            self.timer.advance(step)
            elapsed += step

    def submit(self, request: Request, client="cli1", to=None):
        for name in (to or self.names):
            self.nodes[name].handle_client_message(request.to_dict(), client)

    def replies(self, node_name: str, msg_type=Reply):
        return [m for m, _ in self.client_msgs[node_name]
                if isinstance(m, msg_type)]


def signed_nym(trustee: Ed25519Signer, dest_signer: Ed25519Signer,
               req_id: int) -> Request:
    req = Request(trustee.identifier, req_id,
                  {"type": NYM, "dest": dest_signer.identifier,
                   "verkey": dest_signer.verkey_b58})
    req.signature = trustee.sign_b58(req.signing_bytes())
    return req


@pytest.fixture(scope="module")
def pool():
    return Pool()


def test_nym_write_end_to_end(pool):
    user = Ed25519Signer(seed=b"user-1".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, req_id=1)
    pool.submit(req)
    pool.run(6.0)

    # every node ordered + committed the txn with identical roots
    sizes = {n: pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert all(s == 2 for s in sizes.values()), sizes    # genesis + our txn
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1
    state_roots = {pool.nodes[n].c.db.get_state(DOMAIN_LEDGER_ID)
                   .committed_head_hash for n in pool.names}
    assert len(state_roots) == 1

    # f+1 consistent replies reached the client
    replies = [r for n in pool.names for r in pool.replies(n)]
    assert len(replies) >= pool.nodes["Alpha"].f + 1
    seq_nos = {r.result["txnMetadata"]["seqNo"] for r in replies}
    assert seq_nos == {2}
    # acks were sent before ordering
    acks = [r for n in pool.names for r in pool.replies(n, RequestAck)]
    assert len(acks) == len(pool.names)


def test_bad_signature_rejected(pool):
    user = Ed25519Signer(seed=b"user-2".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, req_id=2)
    req.signature = pool.trustee.sign_b58(b"something else entirely")
    before = {n: len(pool.replies(n, RequestNack)) for n in pool.names}
    pool.submit(req)
    pool.run(2.0)
    nacks = [r for n in pool.names for r in pool.replies(n, RequestNack)
             ][sum(before.values()):]
    assert len(nacks) == len(pool.names)
    assert all("signature" in m.reason for m in nacks)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}      # nothing new ordered


def test_unauthorized_write_gets_rejected(pool):
    """A DID with no role cannot create other DIDs -> Reject after ordering."""
    user = Ed25519Signer(seed=b"user-1".ljust(32, b"\0"))
    other = Ed25519Signer(seed=b"user-3".ljust(32, b"\0"))
    req = Request(user.identifier, 3,
                  {"type": NYM, "dest": other.identifier,
                   "verkey": other.verkey_b58})
    req.signature = user.sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(6.0)
    from plenum_tpu_torch.common.node_messages import Reject
    rejects = [r for n in pool.names for r in pool.replies(n, Reject)]
    assert rejects, "dynamic-validation rejection should Reject to the client"


def test_get_nym_with_proof_and_multisig(pool):
    user = Ed25519Signer(seed=b"user-1".ljust(32, b"\0"))
    q = Request("anyone", 10, {"type": "105", "dest": user.identifier})
    node = pool.nodes["Alpha"]
    node.handle_client_message(q.to_dict(), "cli-q")
    pool.run(1.0)
    replies = [m for m, c in pool.client_msgs["Alpha"]
               if isinstance(m, Reply) and c == "cli-q"]
    assert replies
    res = replies[-1].result
    assert res["data"]["verkey"] == user.verkey_b58
    sp = res["state_proof"]
    value = node.c.db.get_state(DOMAIN_LEDGER_ID).get(
        user.identifier.encode(), committed=True)
    assert PruningState.verify_state_proof(
        bytes.fromhex(sp["root_hash"]), user.identifier.encode(), value,
        bytes.fromhex(sp["proof_nodes"]))
    # BLS multi-sig over a recent state root is attached once batches ordered
    assert "multi_signature" in sp


def test_audit_ledger_tracks_batches(pool):
    audit = pool.nodes["Alpha"].c.db.get_ledger(3)
    if audit.size == 0:      # self-sufficiency when run standalone
        user = Ed25519Signer(seed=b"user-audit".ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, user, req_id=99))
        pool.run(6.0)
    assert audit.size >= 1
    from plenum_tpu_torch.execution.handlers import audit as audit_lib
    view_no, pp_seq_no, primaries = audit_lib.last_audited_view(audit)
    assert view_no == 0 and pp_seq_no >= 1
    assert primaries == pool.nodes["Alpha"].master_replica.data.primaries


@pytest.mark.usefixtures("one_torch_thread")
def test_pool_torch_backend_end_to_end():
    """The full 4-node pool with crypto_backend=torch: every client
    signature is verified by the kernels' plain versions (K3 + K4 on CPU
    tensors; the card's kernels under "cuda") and every ledger uses the
    torch-backed tree hasher."""
    pool = Pool(config=Config(Max3PCBatchWait=0.05, crypto_backend="torch"))
    verifier = pool.nodes["Alpha"].c.authenticator.core_authenticator.verifier
    # the CPU device backends come supervised from the factory (breaker +
    # hedged CPU fallback); the device underneath is the kernel verifier
    from plenum_tpu_torch.parallel.supervisor import SupervisedVerifier
    assert isinstance(verifier, SupervisedVerifier)
    assert type(verifier._device).__name__ == "TorchEd25519Verifier"
    assert type(pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID)
                .tree.hasher).__name__ == "TorchTreeHasher"
    user = Ed25519Signer(seed=b"torch-pool-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(10.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1
    assert pool.replies("Alpha")
    assert verifier.stats["device_batches"] >= 1

    # a bad signature is rejected by the SAME device path
    bad = signed_nym(pool.trustee, Ed25519Signer(
        seed=b"torch-bad-user".ljust(32, b"\0")), 2)
    bad.signature = bad.signature[:-2] + "11"
    pool.submit(bad)
    pool.run(8.0)     # > MAX_AUTH_POLLS prods so the pipelined collect blocks
    from plenum_tpu_torch.common.node_messages import RequestNack
    assert pool.replies("Alpha", RequestNack)
    assert verifier.supervisor_stats()["fallback_batches"] == 0


@pytest.mark.usefixtures("one_torch_thread")
def test_pool_torch_ring_end_to_end():
    """The 4-node pool on one shared ring, as tools/local_pool.build_pool
    wires "torch" (and "cuda" on the card): client-auth Ed25519 waves on
    the kernels' plain versions, BLS batch checks on the ring's BLS lane,
    SHA-256 on its SHA lane; small buckets, since every pad lane is
    verified for real on the CPU."""
    from plenum_tpu_torch.parallel.pipeline import make_crypto_pipeline
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    cfg = Config(Max3PCBatchWait=0.05, crypto_backend="torch",
                 PIPELINE_MIN_BUCKET=8, PIPELINE_SHA_MIN_BATCH=8)
    pipe = make_crypto_pipeline(cfg, "torch")
    pool = Pool(config=cfg, pipeline=pipe)
    for n in pool.names:
        assert pool.nodes[n].c.authenticator.core_authenticator.verifier \
            ._pipeline is pipe
    users = [Ed25519Signer(seed=(b"ring-user-%d" % i).ljust(32, b"\0"))
             for i in range(3)]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, i + 1))
    imposter = Ed25519Signer(seed=b"ring-imposter".ljust(32, b"\0"))
    bad = signed_nym(pool.trustee, Ed25519Signer(
        seed=b"ring-bad".ljust(32, b"\0")), 9)
    bad.signature = imposter.sign_b58(bad.signing_bytes())
    pool.submit(bad)
    pool.run(10.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {4}, sizes
    roots = {pool.nodes[n].c.db.get_state(DOMAIN_LEDGER_ID)
             .committed_head_hash for n in pool.names}
    assert len(roots) == 1
    assert any(m.req_id == 9 for m in pool.replies("Alpha", RequestNack))
    # the four nodes' copies of each signature ride one wave, deduped
    assert pipe.stats["dispatches"] >= 1 and pipe.stats["dedup_hits"] >= 3
    assert pipe.stats["bls_items"] >= 1
    sup = find_supervisor(pipe.verifier())
    assert sup.stats["device_batches"] >= 1
    assert sup.stats["fallback_batches"] == 0


@pytest.mark.usefixtures("one_torch_thread")
def test_pool_sharded_crypto_plane_end_to_end():
    """REAL node traffic through the multi-chip plane: a 4-node pool shares
    one CoalescingVerifier whose device program is ShardedCryptoPlane over
    four explicit CPU shards (the card's kernels under "cuda-sharded") —
    the same plane dryrun_multichip drives, now fed by client authN instead
    of synthetic batches (SURVEY.md §2.3 distributed-comm row)."""
    from plenum_tpu_torch.crypto.ed25519 import CoalescingVerifier
    from plenum_tpu_torch.parallel.crypto_plane import make_sharded_verifier

    sharded = make_sharded_verifier(min_batch=8, devices=["cpu"] * 4)
    shared = CoalescingVerifier(sharded)
    pool = Pool(config=Config(Max3PCBatchWait=0.05,
                              crypto_backend="torch-sharded"),
                verifier=shared)
    # every node's authenticator feeds the ONE shared plane
    for n in pool.names:
        assert pool.nodes[n].c.authenticator.core_authenticator.verifier \
            is shared

    user = Ed25519Signer(seed=b"sharded-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(10.0)
    assert sharded.dispatches >= 1, "no traffic reached the sharded plane"
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1
    assert pool.replies("Alpha")

    # a WELL-FORMED wrong signature must be refused by the device verdict
    # itself (a mangled-encoding sig would be host-rejected before
    # dispatch and prove nothing about the plane)
    imposter = Ed25519Signer(seed=b"sharded-imposter".ljust(32, b"\0"))
    bad = signed_nym(pool.trustee, Ed25519Signer(
        seed=b"sharded-bad".ljust(32, b"\0")), 2)
    bad.signature = imposter.sign_b58(bad.signing_bytes())
    before = sharded.dispatches
    pool.submit(bad)
    pool.run(8.0)
    from plenum_tpu_torch.common.node_messages import RequestNack
    assert pool.replies("Alpha", RequestNack)
    assert sharded.dispatches > before


def test_endorsed_multi_sig_request_orders():
    """A request carrying MULTIPLE signatures (author + endorser) passes
    only if every signer verifies (ref authenticate_multi:84), and a bad
    endorser signature nacks the whole request."""
    pool = Pool(seed=77)
    author = Ed25519Signer(seed=b"ms-author".ljust(32, b"\0"))
    # register the author (no role) so its verkey resolves from state
    pool.submit(signed_nym(pool.trustee, author, 1))
    pool.run(5.0)

    user = Ed25519Signer(seed=b"ms-target".ljust(32, b"\0"))
    req = Request(author.identifier, 2,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": user.verkey_b58},
                  endorser=pool.trustee.identifier)
    payload = req.signing_bytes()
    req.signatures = {author.identifier: author.sign_b58(payload),
                      pool.trustee.identifier: pool.trustee.sign_b58(payload)}
    pool.submit(req)
    pool.run(5.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {3}, sizes

    # same shape but the endorser's signature is broken -> NACK, no txn
    req2 = Request(author.identifier, 3,
                   {"type": NYM, "dest": "X" + user.identifier[1:],
                    "verkey": user.verkey_b58},
                   endorser=pool.trustee.identifier)
    payload2 = req2.signing_bytes()
    sigs = {author.identifier: author.sign_b58(payload2),
            pool.trustee.identifier: pool.trustee.sign_b58(b"wrong")}
    req2.signatures = sigs
    pool.submit(req2, to=["Alpha"])
    pool.run(5.0)
    nacks = pool.replies("Alpha", RequestNack)
    assert any(m.req_id == 3 for m in nacks)
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 3


def test_named_endorser_without_signature_is_nacked():
    """Naming a trustee as endorser WITHOUT their signature must fail
    authentication — otherwise anyone could borrow the trustee's role."""
    pool = Pool(seed=78)
    author = Ed25519Signer(seed=b"imp-author".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, author, 1))
    pool.run(5.0)

    user = Ed25519Signer(seed=b"imp-target".ljust(32, b"\0"))
    req = Request(author.identifier, 2,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": user.verkey_b58},
                  endorser=pool.trustee.identifier)   # named, NOT signing
    req.signature = author.sign_b58(req.signing_bytes())
    pool.submit(req, to=["Alpha"])
    pool.run(5.0)
    assert any(m.req_id == 2 for m in pool.replies("Alpha", RequestNack))
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2


class DeferredVerifier:
    """Ed25519Verifier test double: verdicts computed at submit (C library)
    but withheld from collect until release() — makes the async device
    pipeline's in-flight window controllable from a test."""

    def __init__(self):
        from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
        self._inner = CpuEd25519Verifier()
        self.released = False
        self.submits = []               # item batches, for dispatch counting

    def submit_batch(self, items):
        self.submits.append(list(items))
        return self._inner.verify_batch(items)

    def collect_batch(self, token, wait=True):
        if not (self.released or wait):
            return None
        return token

    def verify_batch(self, items):
        return self.submit_batch(items)


def test_client_copy_parks_on_inflight_propagate_dispatch():
    """A client request arriving while a peer's PROPAGATE of the same bytes
    is already being verified must NOT start a second device dispatch: it
    parks on the digest and settles on the in-flight verdict."""
    pool = Pool()
    beta = pool.nodes["Beta"]
    deferred = DeferredVerifier()
    beta.c.authenticator.core_authenticator.verifier = deferred

    user = Ed25519Signer(seed=b"parked-user".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, req_id=77)

    # Alpha sees the request first and propagates; Beta's propagate-path
    # dispatch goes in flight and stays there (verdict withheld)
    pool.submit(req, to=["Alpha"])
    pool.run(2.0)           # < MAX_AUTH_POLLS prods: Beta must not block
    assert len(deferred.submits) == 1
    assert req.digest in beta._authing

    # now the client's own copy reaches Beta: parked, not re-dispatched
    pool.submit(req, to=["Beta"], client="cli-beta")
    pool.run(1.0)
    assert len(deferred.submits) == 1, "client copy must not re-dispatch"
    assert any(kind == "client" for kind, *_ in beta._authing[req.digest])

    # release the verdict: parked client gets ACKed, request orders
    deferred.released = True
    pool.run(6.0)
    assert len(deferred.submits) == 1
    assert any(isinstance(m, RequestAck) and c == "cli-beta"
               for m, c in pool.client_msgs["Beta"])
    assert any(isinstance(m, Reply) for m, _ in pool.client_msgs["Beta"])
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}


def pool_outcomes(fn, pool_cls, tmp_path=None) -> list:
    """Run the test function `fn` (with `tmp_path` where it takes one) and
    return every `pool_cls` pool it built, as each live node's domain
    ledger size and root and committed state root: the outcome a ported
    case holds to the reference's, whose Pool is another class."""
    import inspect
    made = []
    real_init = pool_cls.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)
    pool_cls.__init__ = init
    try:
        args = ([tmp_path] if "tmp_path" in inspect.signature(fn).parameters
                else [])
        fn(*args)
    finally:
        pool_cls.__init__ = real_init
    out = []
    for pool in made:
        out.append({n: (node.c.db.get_ledger(DOMAIN_LEDGER_ID).size,
                        node.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
                        node.c.db.get_state(DOMAIN_LEDGER_ID)
                        .committed_head_hash)
                    for n, node in sorted(pool.nodes.items())})
    return out


@contextlib.contextmanager
def fresh_bls_caches():
    """Both packages' process-wide BLS verdict caches empty on entry and
    on exit: a run of a reference case (or a second run of a case) beside
    its own file's sees and leaves the caches a fresh process has, so no
    case's checks are answered by another run's verdicts."""
    from plenum_tpu.crypto import bls as ref_bls
    from plenum_tpu_torch.crypto import bls
    caches = (bls._BLS_VERDICTS, ref_bls._BLS_VERDICTS)
    for cache in caches:
        cache.clear()
    try:
        yield
    finally:
        for cache in caches:
            cache.clear()


def held_to_reference(port_fn, ref_fn, tmp_path) -> None:
    """A ported pool case and its reference case, each run once: every
    pool they build ends with the same ledgers and state on every node."""
    import test_pool as ref
    with fresh_bls_caches():
        ours = pool_outcomes(port_fn, Pool, tmp_path / "port"
                             if tmp_path is not None else None)
        theirs = pool_outcomes(ref_fn, ref.Pool, tmp_path / "ref"
                               if tmp_path is not None else None)
    assert ours and ours == theirs
