"""The port's copy of tests/test_message_req.py, run on plenum_tpu_torch.

MessageReq/MessageRep recovery: a node that misses a single message
recovers it from peers and keeps ordering WITHOUT a full catchup.

Mirrors the reference's message_req_processor.py:13 scenarios over SimNetwork
Discard rules.
"""
import pytest

from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, MessageRep,
                                             MessageReq, PrePrepare, Propagate)
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network import Discard

from test_torch_pool import Pool, signed_nym

FAST = dict(Max3PCBatchWait=0.05, crypto_backend="cpu",
            PRIMARY_HEALTH_CHECK_FREQ=0.5,
            ORDERING_PROGRESS_TIMEOUT=30.0,       # recovery must NOT need it
            STATE_FRESHNESS_UPDATE_INTERVAL=600.0)


def fast_pool(seed, **overrides):
    return Pool(seed=seed, config=Config(**{**FAST, **overrides}))


def no_catchup(node):
    return not any(e[0] == "catchup_started" for e in node.spylog)


def test_dropped_propagates_recovered():
    """Delta never receives any PROPAGATE for a request; the pre-prepare
    referencing it triggers RequestPropagates -> MessageReq(PROPAGATE) and
    Delta orders without catchup (a dropped propagate must not wedge a
    replica until full catchup)."""
    pool = fast_pool(seed=41)
    rule = pool.net.add_rule(
        Discard(), lambda m, f, d: isinstance(m, Propagate) and d == "Delta")

    user = Ed25519Signer(seed=b"mr-user-1".ljust(32, b"\0"))
    # submit to the other three only: Delta can learn of the request ONLY
    # through recovery
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=["Alpha", "Beta", "Gamma"])
    pool.run(10.0)

    delta = pool.nodes["Delta"]
    assert delta.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, \
        "Delta did not recover the dropped PROPAGATE"
    assert delta.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash == \
        pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
    assert no_catchup(delta), "recovery went through catchup, not MessageReq"
    pool.net.remove_rule(rule)


def test_dropped_preprepare_recovered():
    """Delta loses the PRE-PREPARE but sees the PREPARE quorum: it re-requests
    the pre-prepare, validates it against the prepare-certified digest, and
    orders without catchup."""
    pool = fast_pool(seed=43)
    rule = pool.net.add_rule(
        Discard(), lambda m, f, d: isinstance(m, PrePrepare) and d == "Delta"
        and getattr(m, "inst_id", None) == 0)

    user = Ed25519Signer(seed=b"mr-user-2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(10.0)

    delta = pool.nodes["Delta"]
    assert delta.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, \
        "Delta did not recover the dropped PRE-PREPARE"
    assert delta.master_replica.last_ordered_3pc[1] >= 1
    assert no_catchup(delta)
    pool.net.remove_rule(rule)


def test_forged_preprepare_rejected():
    """A lying MessageRep responder cannot inject a pre-prepare: without f+1
    matching PREPARE votes for its digest it is ignored."""
    pool = fast_pool(seed=47)
    delta = pool.nodes["Delta"]
    forged = PrePrepare(
        inst_id=0, view_no=0, pp_seq_no=1, pp_time=0.0,
        req_idr=(), discarded=(), digest="ff" * 32,
        ledger_id=DOMAIN_LEDGER_ID, state_root="aa" * 32, txn_root="bb" * 32)
    delta.node_bus.process_incoming(
        MessageRep(msg_type="PREPREPARE",
                   params={"inst_id": 0, "view_no": 0, "pp_seq_no": 1},
                   msg=forged.to_dict()), "Gamma")
    pool.run(2.0)
    assert (0, 1) not in delta.master_replica.ordering.prePrepares
    assert delta.master_replica.last_ordered_3pc == (0, 0)


def test_message_req_served_from_stores():
    """Direct probe: peers serve PROPAGATE and PREPREPARE from their stores."""
    pool = fast_pool(seed=53)
    user = Ed25519Signer(seed=b"mr-user-3".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)

    alpha = pool.nodes["Alpha"]
    served = []
    alpha.node_bus._send_handler = lambda msg, dst: served.append((msg, dst))

    # the request executed, so the propagate store is freed — but the
    # pre-prepare log still serves
    alpha.message_req.process_message_req(
        MessageReq(msg_type="PREPREPARE",
                   params={"inst_id": 0, "view_no": 0, "pp_seq_no": 1}),
        "Delta")
    assert len(served) == 1
    rep, dst = served[0]
    assert isinstance(rep, MessageRep) and dst == ["Delta"]
    assert rep.msg["pp_seq_no"] == 1

    # unknown keys are silently not served
    alpha.message_req.process_message_req(
        MessageReq(msg_type="PREPREPARE",
                   params={"inst_id": 0, "view_no": 0, "pp_seq_no": 99}),
        "Delta")
    assert len(served) == 1


def test_throttle_dedups_requests():
    pool = fast_pool(seed=59)
    alpha = pool.nodes["Alpha"]
    sent = []
    alpha.node_bus._send_handler = lambda msg, dst: sent.append(msg)
    for _ in range(5):
        alpha.message_req.request("PROPAGATE", {"digest": "abc"})
    assert len(sent) == 1, "identical requests not throttled"
    pool.timer.advance(5.0)
    alpha.message_req.request("PROPAGATE", {"digest": "abc"})
    assert len(sent) == 2, "throttle never expires"
