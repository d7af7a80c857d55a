"""The port's copy of tests/test_propagate_digest.py, run on plenum_tpu_torch.

Digest-gossip dissemination: digest-only votes, the body-fetch fallback
through MessageReq (with a lying responder in the loop), legacy full-body
wire compat, and the bytes-on-wire reduction itself.

Covers: a node that reaches the f+1 propagate
quorum on digest votes alone must pull the body from a voter and finalize;
one bad/timeout reply must not wedge it; an old node's full-body PROPAGATE
must still be accepted and counted.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.message_base import message_from_dict
from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, MessageRep,
                                             Propagate, PropagateBatch,
                                             Reply)
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network.sim_network import (Discard, Mutate, match_dst,
                                            match_type)

from test_torch_pool import Pool, signed_nym


def _mk_request(pool, req_id):
    user = Ed25519Signer(seed=(b"dg-user%d" % req_id).ljust(32, b"\0")[:32])
    return signed_nym(pool.trustee, user, req_id)


def test_single_submit_orders_via_digest_gossip():
    """The client submits to ONE node only: whoever that is, the pool must
    still finalize and order — through the designated disseminator's body
    broadcast or the digest-vote fetch path."""
    pool = Pool(seed=101)
    req = _mk_request(pool, 1)
    pool.submit(req, to=["Alpha"])
    pool.run(8.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes
    assert pool.replies("Alpha", Reply)


def test_digest_votes_only_vote_never_forwards_without_body():
    """f+1 digest votes with NO body must not finalize/forward; the node
    arms the fetch loop instead (ordering may never cite an absent body)."""
    pool = Pool(seed=102)
    delta = pool.nodes["Delta"]
    req = _mk_request(pool, 2)
    for frm in ("Alpha", "Beta", "Gamma"):
        delta.node_bus.process_incoming(
            Propagate(digest=req.digest, sender_client="cli1"), frm)
    delta.prod()
    state = delta.propagator.requests.get(req.digest)
    assert state is not None
    assert len(state.propagates) == 3          # >= f+1: quorum of votes
    assert state.request is None
    assert not state.finalised and not state.forwarded
    assert req.digest in delta._body_fetches    # fetch loop armed


def test_fetch_fallback_reaches_quorum_then_pulls_body():
    """Delta reaches the f+1 propagate quorum on digest votes alone, and
    the first fetch candidate (Alpha, sorted first) does NOT hold the
    body: the loop must survive the unanswered MessageReq and pull the
    body from the next voter (Gamma, the only holder)."""
    from plenum_tpu_torch.network.sim_network import match_frm
    pool = Pool(seed=103)
    delta = pool.nodes["Delta"]
    # keep the body pinned to Gamma: none of its propagates leave it
    pool.net.add_rule(Discard(), match_type((Propagate, PropagateBatch)),
                      match_frm("Gamma"))
    req = _mk_request(pool, 3)
    pool.submit(req, to=["Gamma"])
    pool.run(2.0)
    assert pool.nodes["Gamma"].propagator.requests.has_body(req.digest)
    assert delta.propagator.requests.get(req.digest) is None

    # quorum of digest votes: Alpha (bodyless) sorts before Gamma (holder)
    for frm in ("Alpha", "Gamma"):
        delta.node_bus.process_incoming(
            Propagate(digest=req.digest, sender_client="cli1"), frm)
    delta.prod()
    assert req.digest in delta._body_fetches
    pool.run(6.0)   # try 1 -> Alpha (no body, times out), try 2 -> Gamma
    state = delta.propagator.requests.get(req.digest)
    assert state is not None and state.request is not None
    assert state.request.digest == req.digest
    assert state.finalised and state.forwarded
    assert req.digest not in delta._body_fetches    # loop stood down


def test_fetch_survives_lying_responder():
    """The first MessageRep body is swapped for a DIFFERENT (validly
    signed) request: it cannot hash to the fetched digest, so the fetch
    loop must retry and still land the real body."""
    pool = Pool(seed=104)
    delta = pool.nodes["Delta"]
    decoy = _mk_request(pool, 98)
    lied = {"n": 0}

    def corrupt_first_rep(msg):
        if isinstance(msg, MessageRep) and msg.msg_type == "PROPAGATE" \
                and lied["n"] == 0:
            lied["n"] += 1
            return MessageRep(msg_type=msg.msg_type, params=msg.params,
                              msg=Propagate(request=decoy.to_dict(),
                                            sender_client=None).to_dict())
        return msg

    from plenum_tpu_torch.network.sim_network import match_frm
    # the body lives only on Gamma; Delta learns of it via digest votes
    pool.net.add_rule(Discard(), match_type((Propagate, PropagateBatch)),
                      match_frm("Gamma"))
    mutate = pool.net.add_rule(Mutate(corrupt_first_rep),
                               match_type(MessageRep), match_dst("Delta"))
    req = _mk_request(pool, 4)
    pool.submit(req, to=["Gamma"])
    pool.run(2.0)
    for frm in ("Beta", "Gamma"):
        delta.node_bus.process_incoming(
            Propagate(digest=req.digest, sender_client="cli1"), frm)
    delta.prod()
    pool.run(12.0)   # Beta times out, Gamma's first reply lies -> retry
    assert lied["n"] == 1, "the mutation never fired"
    state = delta.propagator.requests.get(req.digest)
    assert state is not None and state.request is not None
    assert state.request.digest == req.digest
    assert state.finalised
    pool.net.remove_rule(mutate)


def test_legacy_full_body_propagate_still_counts():
    """Wire compat: an old node's PROPAGATE (full body, no digest field)
    decodes, authenticates, and counts as a body-carrying vote."""
    pool = Pool(seed=105)
    alpha = pool.nodes["Alpha"]
    req = _mk_request(pool, 5)
    legacy_wire = pack({"op": "PROPAGATE", "request": req.to_dict(),
                        "sender_client": "cli-old"})
    msg = message_from_dict(unpack(legacy_wire))
    assert isinstance(msg, Propagate) and msg.digest == ""
    alpha.node_bus.process_incoming(msg, "Beta")
    for _ in range(3):
        alpha.prod()
    state = alpha.propagator.requests.get(req.digest)
    assert state is not None and state.request is not None
    assert "Beta" in state.propagates
    # and the node relayed its own vote (body or digest, per designation)
    assert "Alpha" in state.propagates


def test_mismatched_body_digest_is_dropped():
    """A body that does not hash to the claimed digest is a lie — dropped,
    never counted."""
    pool = Pool(seed=106)
    alpha = pool.nodes["Alpha"]
    req = _mk_request(pool, 6)
    other = _mk_request(pool, 7)
    alpha.node_bus.process_incoming(
        Propagate(request=req.to_dict(), digest=other.digest,
                  sender_client=None), "Beta")
    for _ in range(3):
        alpha.prod()
    assert alpha.propagator.requests.get(req.digest) is None
    state = alpha.propagator.requests.get(other.digest)
    assert state is None or state.request is None


def test_designated_disseminator_is_deterministic():
    pool = Pool(seed=107)
    req = _mk_request(pool, 8)
    flags = [pool.nodes[n].propagator.is_disseminator(req.digest)
             for n in pool.names]
    assert sum(flags) == 1      # exactly one body broadcaster per digest


def test_digest_gossip_off_restores_full_body_flooding():
    from plenum_tpu_torch.config import Config
    pool = Pool(seed=108, config=Config(Max3PCBatchWait=0.05,
                                        crypto_backend="cpu",
                                        DIGEST_GOSSIP=False))
    req = _mk_request(pool, 9)
    pool.submit(req)
    pool.run(6.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes
    # every node's own vote carried the body (sampled via Alpha's state
    # having a body from whichever peer's propagate landed first)
    tx = pool.net.tx_msgs
    assert "PROPAGATE" in tx or "PROPAGATE_BATCH" in tx


def test_propagate_bytes_drop_vs_full_body():
    """The measured point of the whole change: same load, digest-gossip
    on vs off, propagate bytes on the wire must drop >= 2x."""
    from plenum_tpu_torch.config import Config

    def run_one(gossip: bool) -> int:
        pool = Pool(seed=109, config=Config(Max3PCBatchWait=0.05,
                                            crypto_backend="cpu",
                                            DIGEST_GOSSIP=gossip))
        for i in range(5):
            pool.submit(_mk_request(pool, 10 + i))
        pool.run(8.0)
        sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                 for n in pool.names}
        assert sizes == {6}, (gossip, sizes)    # 1 genesis NYM + 5 writes
        tx = pool.net.tx_msgs
        return sum(c[1] for op, c in tx.items()
                   if op in ("PROPAGATE", "PROPAGATE_BATCH"))

    flood = run_one(False)
    gossip = run_one(True)
    assert gossip * 2 <= flood, (gossip, flood)
