"""The port's StateCommitment subsystem, held to the reference's cases
(tests/test_state_commitment.py): KZG engine, Verkle backend, interface
conformance across backends and the pipeline commitment wave kind, on
the ring's default host KZG engine, and the read plane's verkle
envelopes and multi-key pages on the port's pool, and the cross-shard
read on a verkle-backed shard fabric. The ring takes no default Ed25519
inner in the port, so these rings get the CPU verifier.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
from plenum_tpu_torch.state.commitment import (BACKEND_MPT, BACKEND_VERKLE,
                                               VerkleState,
                                               commitment_backend_of,
                                               engine_for, kzg, make_state,
                                               stem_of)
from plenum_tpu_torch.storage.kv_memory import KvMemory


# --- KZG engine --------------------------------------------------------------

def test_kzg_commit_deterministic_and_width_checked():
    eng = engine_for(16)
    ft1, c1 = eng.commit({3: 17, 9: 99})
    ft2, c2 = eng.commit({9: 99, 3: 17})
    assert (ft1, c1) == (ft2, c2)
    ft3, c3 = eng.commit({3: 17, 9: 98})
    assert c3 != c1
    for bad in (0, 1, 3, 257, 512):
        with pytest.raises(ValueError):
            kzg.KzgEngine(bad)


def test_kzg_multiproof_honest_and_tampered():
    eng = engine_for(32)
    ft_a, c_a = eng.commit({1: 11, 2: 22})
    ft_b, c_b = eng.commit({5: 55})
    prove = [(c_a, ft_a, 1, 11), (c_a, ft_a, 3, 0), (c_b, ft_b, 5, 55)]
    d, pi = kzg.prove_multi(prove)
    ok_set = [(c_a, 1, 11), (c_a, 3, 0), (c_b, 5, 55)]
    assert kzg.verify_multi(ok_set, d, pi)
    # wrong value / wrong slot / swapped values / mangled points: all False
    assert not kzg.verify_multi([(c_a, 1, 12), (c_a, 3, 0),
                                 (c_b, 5, 55)], d, pi)
    assert not kzg.verify_multi([(c_a, 2, 11), (c_a, 3, 0),
                                 (c_b, 5, 55)], d, pi)
    assert not kzg.verify_multi([(c_a, 1, 55), (c_a, 3, 0),
                                 (c_b, 5, 11)], d, pi)
    assert not kzg.verify_multi(ok_set, bytes(64), pi)
    assert not kzg.verify_multi(ok_set, d, d)
    assert not kzg.verify_multi(ok_set, d[:7], pi)
    assert not kzg.verify_multi([], d, pi)          # empty set fails closed
    # transcripts bind the ORDER of openings
    assert not kzg.verify_multi(list(reversed(ok_set)), d, pi)


# --- VerkleState behaviors ---------------------------------------------------

def test_verkle_set_get_remove_and_heads():
    st = make_state("verkle")
    assert commitment_backend_of(st) == BACKEND_VERKLE
    st.set(b"a", b"1")
    st.set(b"b", b"2")
    root1 = st.head_hash
    st.commit(root1)
    assert st.get(b"a") == b"1" and st.get(b"b", committed=False) == b"2"
    # uncommitted write is invisible to committed reads, revert drops it
    st.set(b"c", b"3")
    assert st.get(b"c", committed=True) is None
    assert st.get(b"c", committed=False) == b"3"
    st.revert_to_head()
    assert st.get(b"c", committed=False) is None
    assert st.head_hash == root1
    # remove + re-add round-trips the root exactly (content-addressed)
    st.set(b"c", b"3")
    root2 = st.head_hash
    st.commit(root2)
    assert st.remove(b"c") and not st.remove(b"c")
    assert st.head_hash == root1
    st.set(b"c", b"3")
    assert st.head_hash == root2
    assert st.as_dict(committed=False) == {b"a": b"1", b"b": b"2",
                                           b"c": b"3"}


def test_verkle_historic_roots_and_persistence():
    db = KvMemory()
    st = make_state("verkle", db=db)
    st.set(b"k", b"v1")
    r1 = st.head_hash
    st.commit(r1)
    st.set(b"k", b"v2")
    r2 = st.head_hash
    st.commit(r2)
    assert st.get_for_root(b"k", r1) == b"v1"
    assert st.get_for_root(b"k", r2) == b"v2"
    # a fresh instance over the same db resumes at the committed head
    st2 = make_state("verkle", db=db)
    assert st2.committed_head_hash == r2
    assert st2.get(b"k") == b"v2"
    assert st2.get_for_root(b"k", r1) == b"v1"
    # proofs generated by the reloaded instance verify at both roots
    for root, val in ((r1, b"v1"), (r2, b"v2")):
        p = st2.generate_state_proof(b"k", root_hash=root, serialize=True)
        assert VerkleState.verify_state_proof(root, b"k", val, p)
        assert not VerkleState.verify_state_proof(
            root, b"k", b"other", p)


def test_verkle_roots_deterministic_across_instances_and_orders():
    a = make_state("verkle")
    b = make_state("verkle")
    keys = [(b"k%03d" % i, b"v%03d" % i) for i in range(60)]
    for k, v in keys:
        a.set(k, v)
    for k, v in reversed(keys):
        b.set(k, v)
    assert a.head_hash == b.head_hash


@pytest.mark.parametrize("width", [16, 64, 256])
def test_verkle_widths_prove_and_fail_closed(width):
    st = make_state("verkle", width=width)
    for i in range(40):
        st.set(b"w%d" % i, b"val%d" % i)
    root = st.head_hash
    st.commit(root)
    page = [b"w3", b"w17", b"nope"]
    proof = st.batch_open(page)
    assert proof["width"] == width
    good = [(b"w3", b"val3"), (b"w17", b"val17"), (b"nope", None)]
    assert VerkleState.verify_batch_proof(root, good, proof)
    # splice: one value swapped inside the aggregated answer
    spliced = [(b"w3", b"val17"), (b"w17", b"val3"), (b"nope", None)]
    assert not VerkleState.verify_batch_proof(root, spliced, proof)
    # claimed-present for an absent key / claimed-absent for a present one
    assert not VerkleState.verify_batch_proof(
        root, [(b"w3", b"val3"), (b"w17", b"val17"), (b"nope", b"x")],
        proof)
    assert not VerkleState.verify_batch_proof(
        root, [(b"w3", None), (b"w17", b"val17"), (b"nope", None)], proof)
    # wrong root anchor
    assert not VerkleState.verify_batch_proof(bytes(32), good, proof)


def test_verkle_absence_via_other_stem_is_sound():
    """A slot occupied by a DIFFERENT key's leaf proves absence only
    when the occupying stem shares the walked path; a forged 'other'
    terminal citing an unrelated stem must fail."""
    st = make_state("verkle", width=16)
    st.set(b"occupant", b"val")
    root = st.head_hash
    st.commit(root)
    # find a key whose first chunk collides with the occupant's
    occ_stem = stem_of(b"occupant")
    probe = None
    for i in range(4096):
        k = b"probe%d" % i
        s = stem_of(k)
        if s[0] >> 4 == occ_stem[0] >> 4 and s != occ_stem:
            probe = k
            break
    assert probe is not None
    proof = st.batch_open([probe])
    assert proof["keys"][0]["term"][0] == "other"
    assert VerkleState.verify_batch_proof(root, [(probe, None)], proof)
    # tamper the cited other-stem to something off-path: must fail
    bad = unpack(pack(proof))
    bad["keys"][0]["term"][1] = stem_of(b"unrelated")
    assert not VerkleState.verify_batch_proof(root, [(probe, None)], bad)
    # or to the probe's own stem (claiming the key is its own absence)
    bad2 = unpack(pack(proof))
    bad2["keys"][0]["term"][1] = stem_of(probe)
    assert not VerkleState.verify_batch_proof(root, [(probe, None)], bad2)


def test_verkle_lied_width_cannot_prove_false_absence():
    """The width-forgery the first review round caught: claiming a
    NARROWER width remaps a present key's root slot (chunk() of the top
    stem bits) onto a slot that is genuinely empty at the true width —
    so an ``empty`` terminal opens f(z)=0 with a GENUINE opening, no tau
    knowledge needed. The anchor binds the width precisely to kill this:
    the forged proof's recomputed root anchor no longer matches the
    signed one."""
    st = make_state("verkle", width=256)
    for i in range(8):
        st.set(b"wf%d" % i, b"val%d" % i)
    root = st.head_hash
    st.commit(root)
    target = b"wf3"
    honest = st.batch_open([target])
    root_c = honest["commitments"][0]
    eng = engine_for(256)
    # the forgery: width=2 ⇒ chunk(stem, 0) is the stem's top bit
    top_bit = stem_of(target)[0] >> 7
    ft = st._root.f_tau if st._root.f_tau is not None \
        else eng.f_tau(st._evals_of(st._root))
    d, pi = kzg.prove_multi([(root_c, ft, top_bit, 0)])
    forged = {"width": 2, "commitments": [root_c],
              "keys": [{"path": [[0, top_bit]], "term": ["empty"]}],
              "d": d, "pi": pi}
    # sanity: the opening itself is genuine — f(top_bit) really is 0
    # at the true width-256 tree (slots 0/1 are empty for these stems)
    assert kzg.verify_multi([(root_c, top_bit, 0)], d, pi)
    # ...but the proof must NOT verify absence of the present key
    assert not VerkleState.verify_batch_proof(root, [(target, None)],
                                              forged)
    # and the honest proof still does
    assert VerkleState.verify_batch_proof(root, [(target, b"val3")],
                                          honest)


def test_verkle_empty_tree_roundtrip():
    st = make_state("verkle")
    blank = st.head_hash
    assert blank == st.blank_root
    st.commit(blank)
    proof = st.batch_open([b"anything"])
    assert VerkleState.verify_batch_proof(blank, [(b"anything", None)],
                                          proof)
    assert not VerkleState.verify_batch_proof(
        blank, [(b"anything", b"forged")], proof)


# --- interface conformance ---------------------------------------------------

INTERFACE = ("set", "remove", "get", "get_for_root", "as_dict", "commit",
             "revert_to_head", "generate_state_proof", "batch_open",
             "verify_state_proof", "verify_batch_proof", "close")


@pytest.mark.parametrize("backend", [BACKEND_MPT, BACKEND_VERKLE])
def test_backend_conformance(backend):
    """Both backends expose the full StateCommitment surface and agree
    on its semantics (the duck-typing enforcement the interface
    docstring promises)."""
    st = make_state(backend)
    for name in INTERFACE:
        assert callable(getattr(st, name)), f"{backend} missing {name}"
    assert hasattr(st, "head_hash") and hasattr(st, "committed_head_hash")
    assert hasattr(st, "kv")
    assert commitment_backend_of(st) == backend
    st.set(b"x", b"1")
    root = st.head_hash
    st.commit(root)
    assert st.committed_head_hash == root
    assert st.get(b"x") == b"1" and st.get(b"absent") is None
    assert st.as_dict(committed=True) == {b"x": b"1"}
    cls = type(st)
    single = st.generate_state_proof(b"x", serialize=True)
    assert cls.verify_state_proof(root, b"x", b"1", single)
    assert not cls.verify_state_proof(root, b"x", b"2", single)
    assert not cls.verify_state_proof(root, b"x", b"1", b"\xff\x00junk")
    page = st.batch_open([b"x", b"absent"])
    assert cls.verify_batch_proof(root, [(b"x", b"1"), (b"absent", None)],
                                  page)
    assert not cls.verify_batch_proof(root, [(b"x", b"1"),
                                             (b"absent", b"forged")],
                                      page)
    assert not cls.verify_batch_proof(root, [(b"x", b"1")], page)


def test_make_state_rejects_unknown_backend():
    with pytest.raises(ValueError):
        make_state("merkle-patricia-2000")


# --- pipeline commitment wave kind ------------------------------------------

def test_pipeline_cmt_lane_dedup_and_cache():
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
    pipe = CryptoPipeline(CpuEd25519Verifier(), config=Config())
    job = ("commit", 16, ((2, 123), (7, 456)))
    t1 = pipe.submit_commitment([job, job])         # in-window dup
    out1 = pipe.collect_commitment(t1)
    assert out1[0] == out1[1] and out1[0] is not None
    assert pipe.stats["cmt_unique"] == 1
    t2 = pipe.submit_commitment([job])              # cross-flush cache hit
    out2 = pipe.collect_commitment(t2)
    assert out2[0] == out1[0]
    assert pipe.stats["cache_hits"] >= 1
    # the result matches the engine exactly (a hit can never change it)
    assert out1[0] == engine_for(16).commit({2: 123, 7: 456})
    assert pipe.summary()["cmt"]["batches"] >= 2


def test_pipeline_cmt_engine_failure_degrades_not_raises():
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline

    class Wedged:
        def run_jobs(self, jobs):
            raise RuntimeError("device wedged")

    pipe = CryptoPipeline(CpuEd25519Verifier(), config=Config(),
                          cmt_inner=Wedged())
    st = make_state("verkle", db=KvMemory(), pipeline=pipe)
    st.set(b"k", b"v")
    root = st.head_hash
    st.commit(root)
    p = st.generate_state_proof(b"k", serialize=True)
    assert VerkleState.verify_state_proof(root, b"k", b"v", p)
    assert pipe.stats["cmt_batches"] >= 1


def test_cohosted_states_dedup_recommits_through_ring():
    """Co-hosted nodes committing the same batch to the same state stage
    identical recommit jobs — the ring answers one per distinct vector."""
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
    pipe = CryptoPipeline(CpuEd25519Verifier(), config=Config())
    states = [make_state("verkle", db=KvMemory(), pipeline=pipe)
              for _ in range(3)]
    for st in states:
        for i in range(30):
            st.set(b"d%d" % i, b"v%d" % i)
    roots = {st.head_hash for st in states}
    assert len(roots) == 1
    # replicas 2 and 3 rode the cache: unique jobs ~ one replica's share
    assert pipe.stats["cmt_unique"] * 2 <= pipe.stats["cmt_items"]


# --- read plane: verkle envelopes + the multi-key page -----------------------

@pytest.fixture(scope="module")
def vpool():
    from test_torch_pool import Pool, signed_nym
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    pool = Pool(seed=11, config=Config(Max3PCBatchWait=0.05,
                                       crypto_backend="cpu",
                                       STATE_COMMITMENT="verkle"))
    users = [Ed25519Signer(seed=(b"vp%03d" % i).ljust(32, b"\0")[:32])
             for i in range(6)]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, i + 1))
    pool.run(10.0)
    return pool, users


def test_verkle_pool_serves_verified_reads(vpool):
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF, verify_read_proof
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys
    pool, users = vpool
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {7}, sizes
    keys = pool_bls_keys(pool.names)
    q = Request("t", 1, {"type": GET_NYM, "dest": users[0].identifier})
    result = pool.nodes["Alpha"].read_plane.answer(q)
    env = result[READ_PROOF]
    assert env["kind"] == "verkle"
    assert "proof" not in env["entries"][0]      # no per-entry chains
    ok, reason = verify_read_proof(GET_NYM, q.operation, result, keys,
                                   freshness_s=1e12,
                                   now=pool.timer.get_current_time)
    assert ok, reason
    # tamper the value: fail closed through the ordinary client core
    import copy
    bad = copy.deepcopy(result)
    bad[READ_PROOF]["entries"][0]["value"] = "ab" * 40
    ok, reason = verify_read_proof(GET_NYM, q.operation, bad, keys,
                                   freshness_s=1e12,
                                   now=pool.timer.get_current_time)
    assert not ok


@pytest.mark.parametrize("backend", ["mpt", "verkle"])
def test_page_envelope_roundtrip_and_splice(backend, vpool):
    """ReadPlane.page_envelope: one envelope answers a 4-key page on
    BOTH backends; a spliced page (values swapped between keys) fails
    the client-side page verification on both."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.reads.proofs import verify_page_envelope
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys
    if backend == "verkle":
        pool, users = vpool
    else:
        from test_torch_pool import Pool, signed_nym
        from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
        pool = Pool(seed=12, config=Config(Max3PCBatchWait=0.05,
                                           crypto_backend="cpu"))
        users = [Ed25519Signer(seed=(b"mp%03d" % i).ljust(32, b"\0")[:32])
                 for i in range(6)]
        for i, u in enumerate(users):
            pool.submit(signed_nym(pool.trustee, u, i + 1))
        pool.run(10.0)
    keys = pool_bls_keys(pool.names)
    page = [u.identifier.encode() for u in users[:4]] + [b"absent-did"]
    env = pool.nodes["Alpha"].read_plane.page_envelope(
        DOMAIN_LEDGER_ID, page)
    assert env is not None and env["kind"] == \
        ("verkle" if backend == "verkle" else "state")
    ok, values, reason = verify_page_envelope(
        env, page, keys, DOMAIN_LEDGER_ID, freshness_s=1e12,
        now=pool.timer.get_current_time)
    assert ok, reason
    assert values[-1] is None and all(v is not None for v in values[:4])
    # a page with the client's keys in a different order must fail
    ok, _, reason = verify_page_envelope(
        env, list(reversed(page)), keys, DOMAIN_LEDGER_ID,
        freshness_s=1e12, now=pool.timer.get_current_time)
    assert not ok
    # a signed envelope from a DIFFERENT ledger than the client asked
    # for must fail even though every internal binding is honest
    from plenum_tpu_torch.common.node_messages import CONFIG_LEDGER_ID
    ok, _, reason = verify_page_envelope(
        env, page, keys, CONFIG_LEDGER_ID, freshness_s=1e12,
        now=pool.timer.get_current_time)
    assert not ok and reason == "unsigned_root"
    # splice two values inside the envelope: fail closed on both kinds
    bad = unpack(pack(env))
    e0, e1 = bad["entries"][0], bad["entries"][1]
    e0["value"], e1["value"] = e1["value"], e0["value"]
    ok, _, reason = verify_page_envelope(
        bad, page, keys, DOMAIN_LEDGER_ID, freshness_s=1e12,
        now=pool.timer.get_current_time)
    assert not ok
    # proof-byte production counters sampled the build (multi-key pages
    # ride their own names — never the single-read distributions)
    from plenum_tpu_torch.common.metrics import MetricsName
    name = (MetricsName.READ_PROOF_BYTES_VERKLE_MULTI
            if backend == "verkle"
            else MetricsName.READ_PROOF_BYTES_STATE_MULTI)
    acc = pool.nodes["Alpha"].metrics.accumulators.get(name)
    assert acc is not None and acc.count >= 1


def test_verkle_multikey_deref_chain_aggregates(vpool):
    """The TAA deref chain (2 keys) rides ONE aggregated opening —
    the per-request path exercising the multi-key machinery."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import (GET_TXN_AUTHOR_AGREEMENT,
                                          TXN_AUTHOR_AGREEMENT)
    from plenum_tpu_torch.reads import READ_PROOF, verify_read_proof
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys
    pool, _ = vpool
    taa = Request(pool.trustee.identifier, 99,
                  {"type": TXN_AUTHOR_AGREEMENT, "version": "9",
                   "text": "vkterms"})
    taa.signature = pool.trustee.sign_b58(taa.signing_bytes())
    pool.submit(taa)
    pool.run(6.0)
    q = Request("t", 2, {"type": GET_TXN_AUTHOR_AGREEMENT})
    result = pool.nodes["Beta"].read_plane.answer(q)
    env = result.get(READ_PROOF)
    assert env is not None and env["kind"] == "verkle", result
    assert len(env["entries"]) == 2              # latest -> digest record
    ok, reason = verify_read_proof(
        GET_TXN_AUTHOR_AGREEMENT, q.operation, result,
        pool_bls_keys(pool.names), freshness_s=1e12,
        now=pool.timer.get_current_time)
    assert ok, reason


# --- cross-shard composition -------------------------------------------------

def test_cross_shard_read_composes_with_verkle_backend():
    """A verkle-backed sharded fabric: the composed check (directory
    ownership proof + the owning shard's verkle read proof) verifies
    through the SAME CrossShardReadCheck core, unchanged."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import GET_NYM, NYM
    from plenum_tpu_torch.shards import ShardedSimFabric

    fab = ShardedSimFabric(
        n_shards=2, nodes_per_shard=4, seed=3,
        config=Config(Max3PCBatchWait=0.05, STATE_COMMITMENT="verkle",
                      crypto_backend="cpu"))
    user = None
    for i in range(400):
        u = Ed25519Signer(seed=(b"xvk%d" % i).ljust(32, b"\0")[:32])
        probe = Request(fab.trustee.identifier, 1,
                        {"type": NYM, "dest": u.identifier})
        if fab.router.shard_of(probe) == 1:
            user = u
            break
    assert user is not None
    req = Request(fab.trustee.identifier, 1,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": user.verkey_b58})
    req.signature = fab.trustee.sign_b58(req.signing_bytes())
    assert fab.submit_write(req) == 1
    fab.run(8.0)
    driver = fab.read_driver()
    q = Request("reader", 7, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q, per_node_s=2.0, step_s=0.1)
    assert res is not None and res["data"]["verkey"] == user.verkey_b58
    assert res["read_proof"]["kind"] == "verkle"
    s = driver.stats.summary()
    assert s["single_reply_ok"] == 1 and s["fallbacks"] == 0
    assert s["cross_reads"] == 1 and s["map_proof_failures"] == 0
