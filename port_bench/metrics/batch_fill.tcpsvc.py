"""Txns ordered per 3PC batch in Node1's session, from its ledgers: the
domain ledger's growth over the audit ledger's, which takes one txn per
ordered batch (3PC)."""


def read(run):
    c = run["collected"]
    if not c.get("ordered_batches"):
        return None
    return c["ordered_txns"] / c["ordered_batches"]
