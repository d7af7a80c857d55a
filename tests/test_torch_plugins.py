"""The port's copy of tests/test_plugins.py, run on plenum_tpu_torch (nodes
on the CPU).

Plugin system: a demo plugin adds a new write txn type + read query and
the pool orders it end-to-end through real consensus.

Reference test model: plenum/test/plugin (the AUCTION/BANK demo plugins
exercised through a looper pool).
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.handlers.base import (ReadRequestHandler,
                                                WriteRequestHandler)
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch import plugins as plugin_lib

from test_torch_pool import Pool, signed_nym

BUY = "9001"          # demo plugin txn type (like the reference's AUCTION)
GET_BAL = "9002"


class BuyHandler(WriteRequestHandler):
    """Accumulates per-DID balances in domain state."""

    def __init__(self, db):
        super().__init__(db, BUY, DOMAIN_LEDGER_ID)

    def static_validation(self, request):
        self._require(isinstance(request.operation.get("amount"), int)
                      and request.operation["amount"] > 0,
                      request, "amount must be a positive int")

    def gen_txn(self, request):
        return txn_lib.new_txn(BUY, {"amount": request.operation["amount"]},
                               request=request)

    def update_state(self, txn, is_committed):
        frm = txn_lib.txn_author(txn)
        amount = txn_lib.txn_data(txn)["amount"]
        key = f"buy:{frm}".encode()
        prev = self.state.get(key, committed=False)
        total = (int(prev.decode()) if prev else 0) + amount
        self.state.set(key, str(total).encode())


class GetBalanceHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_BAL, DOMAIN_LEDGER_ID)

    def get_result(self, request):
        dest = request.operation.get("dest")
        raw = self.state.get(f"buy:{dest}".encode(), committed=True)
        return {"type": GET_BAL, "dest": dest,
                "balance": int(raw.decode()) if raw else 0}


class DemoPlugin:
    name = "demo-buy"

    def __init__(self):
        self.inited_nodes = []

    def get_write_handlers(self, db):
        return [BuyHandler(db)]

    def get_read_handlers(self, db):
        return [GetBalanceHandler(db)]

    def init(self, node):
        self.inited_nodes.append(node.name)


def test_plugin_txn_ordered_through_pool():
    plugin = DemoPlugin()
    plugin_lib.register_plugin(plugin)
    try:
        pool = Pool(config=Config(Max3PCBatchWait=0.05))
    finally:
        plugin_lib.unregister_plugin(plugin)

    assert sorted(plugin.inited_nodes) == sorted(pool.names)
    trustee = pool.trustee
    req = Request(trustee.identifier, 1, {"type": BUY, "amount": 5})
    req.signature = trustee.sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(5.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes

    # second BUY accumulates
    req2 = Request(trustee.identifier, 2, {"type": BUY, "amount": 7})
    req2.signature = trustee.sign_b58(req2.signing_bytes())
    pool.submit(req2)
    pool.run(5.0)

    # the plugin's read handler answers from committed state
    q = Request(trustee.identifier, 3, {"type": GET_BAL,
                                        "dest": trustee.identifier})
    q.signature = trustee.sign_b58(q.signing_bytes())
    pool.submit(q, to=["Alpha"])
    pool.run(2.0)
    replies = pool.replies("Alpha")
    balances = [m.result.get("balance") for m in replies
                if m.result.get("type") == GET_BAL]
    assert balances and balances[-1] == 12

    # invalid amount is nacked by the plugin's static validation
    from plenum_tpu_torch.common.node_messages import RequestNack
    bad = Request(trustee.identifier, 4, {"type": BUY, "amount": -1})
    bad.signature = trustee.sign_b58(bad.signing_bytes())
    pool.submit(bad, to=["Alpha"])
    pool.run(2.0)
    nacks = pool.replies("Alpha", RequestNack)
    assert any("amount" in m.reason for m in nacks)


def test_load_plugin_by_module_path():
    # plugins can be dotted module paths (PLUGIN_ROOT-style loading)
    mod = plugin_lib.load_plugin("plenum_tpu_torch.plugins")
    assert mod in plugin_lib.registered_plugins()
    plugin_lib.unregister_plugin(mod)
    assert mod not in plugin_lib.registered_plugins()


@pytest.mark.parametrize("name", [
    "test_plugin_txn_ordered_through_pool",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_plugins as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
