"""The 4-node pool, held against the reference's: one seeded script (NYM
writes, a bad signature, an unauthorized write, a GET_NYM with proof) runs
on tests/test_pool.py's Pool (plenum_tpu) and on tests/test_torch_pool.py's
(plenum_tpu_torch), both on the `cpu` backend, MockTimer and SimRandom(42):
every ledger root, state root, stored BLS multi-signature and client
message must be byte-equal. Then the port's pool on the `torch` ring (the
kernels' plain versions behind every client signature) runs the same
script and must order the same txns with the same verdicts."""
import pytest

import test_pool as ref
import test_torch_pool as port
from test_torch_pool import one_torch_thread  # noqa: F401 (a fixture)
from plenum_tpu.common.request import Request as RefRequest
from plenum_tpu.crypto.ed25519 import Ed25519Signer as RefSigner
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import NYM

LEDGERS = (0, 1, 2, 3)          # pool, domain, config, audit


def run_script(pool_mod, signer_cls, request_cls, pool) -> dict:
    """The seeded script on `pool` -> what every node holds and answered."""
    users = [signer_cls(seed=(b"parity-user-%d" % i).ljust(32, b"\0"))
             for i in range(5)]
    for i in range(3):
        pool.submit(pool_mod.signed_nym(pool.trustee, users[i], i + 1))
    pool.run(6.0)
    # a signature over other bytes: NACKed by every node's authentication
    bad = pool_mod.signed_nym(pool.trustee, users[3], 4)
    bad.signature = pool.trustee.sign_b58(b"something else entirely")
    pool.submit(bad)
    pool.run(2.0)
    # a DID with no role creates another DID: ordered, then Rejected
    req = request_cls(users[0].identifier, 5,
                      {"type": NYM, "dest": users[4].identifier,
                       "verkey": users[4].verkey_b58})
    req.signature = users[0].sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(6.0)
    q = request_cls("anyone", 10, {"type": "105",
                                   "dest": users[1].identifier})
    pool.nodes["Alpha"].handle_client_message(q.to_dict(), "cli-q")
    pool.run(1.0)

    out = {}
    for name, node in sorted(pool.nodes.items()):
        db = node.c.db
        out[name] = {
            "roots": [db.get_ledger(lid).root_hash for lid in LEDGERS],
            "sizes": [db.get_ledger(lid).size for lid in LEDGERS],
            "state_roots": [db.get_state(lid).committed_head_hash
                            for lid in LEDGERS[:3]],
            "multi_sigs": list(node.c.bls_store.kv.iterator()),
            "domain_txns": [
                pack(db.get_ledger(1).get_by_seq_no(i)["txn"])
                for i in range(1, db.get_ledger(1).size + 1)],
            "messages": [(type(m).__name__, c, pack(m.to_dict()))
                         for m, c in pool.client_msgs[name]],
        }
    return out


@pytest.fixture(scope="module")
def ref_run():
    return run_script(ref, RefSigner, RefRequest, ref.Pool())


@pytest.fixture(scope="module")
def port_run():
    return run_script(port, Ed25519Signer, Request, port.Pool())


@pytest.mark.parametrize("key", ["roots", "sizes", "state_roots",
                                 "multi_sigs", "domain_txns", "messages"])
def test_cpu_pool_is_byte_equal_to_the_reference(ref_run, port_run, key):
    assert list(port_run) == list(ref_run)
    for name in ref_run:
        assert port_run[name][key] == ref_run[name][key], (name, key)


def test_the_script_exercises_every_outcome(port_run):
    """3 writes ordered, the bad signature NACKed, the unauthorized write
    Rejected, the GET_NYM answered with a multi-signed state proof."""
    alpha = port_run["Alpha"]
    assert alpha["sizes"][1] == 1 + 3        # genesis trustee + 3 writes
    kinds = [k for k, _, _ in alpha["messages"]]
    assert kinds.count("RequestNack") == 1 and kinds.count("Reject") == 1
    assert kinds.count("Reply") == 4          # 3 writes + the GET_NYM
    assert alpha["multi_sigs"]
    from plenum_tpu_torch.common.serialization import unpack
    get_nym = unpack([raw for k, c, raw in alpha["messages"]
                      if c == "cli-q"][-1])
    assert "multi_signature" in get_nym["result"]["state_proof"]


@pytest.mark.usefixtures("one_torch_thread")
def test_torch_ring_pool_orders_the_same_txns(port_run):
    """The port's pool on the torch ring (one shared CryptoPipeline, small
    buckets) orders the cpu run's txns with the cpu run's verdicts: the
    same txns, byte for byte, the same ledger and state roots, and the
    same kinds of client message for every request on every node. The
    ring settles a wave on a later prod cycle than the cpu verifier, so a
    batch may be pre-prepared a tick later: the last multi-signature's
    pp_time (and the GET_NYM reply carrying it) may differ, nothing
    ordered does."""
    from plenum_tpu_torch.common.serialization import unpack
    from plenum_tpu_torch.parallel.pipeline import make_crypto_pipeline
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    cfg = Config(Max3PCBatchWait=0.05, crypto_backend="torch",
                 PIPELINE_MIN_BUCKET=8, PIPELINE_SHA_MIN_BATCH=8)
    pipe = make_crypto_pipeline(cfg, "torch")
    ring = run_script(port, Ed25519Signer, Request,
                      port.Pool(config=cfg, pipeline=pipe))

    def verdicts(run):
        return [(k, c, unpack(raw).get("reqId")
                 or unpack(raw).get("result", {}).get("reqId"))
                for k, c, raw in run["messages"]]

    for name in port_run:
        for key in ("domain_txns", "roots", "sizes", "state_roots"):
            assert ring[name][key] == port_run[name][key], (name, key)
        assert verdicts(ring[name]) == verdicts(port_run[name]), name
        assert len(ring[name]["multi_sigs"]) == \
            len(port_run[name]["multi_sigs"])
    assert pipe.stats["dispatches"] >= 1 and pipe.stats["dedup_hits"] >= 3
    assert find_supervisor(pipe.verifier()).stats["fallback_batches"] == 0
