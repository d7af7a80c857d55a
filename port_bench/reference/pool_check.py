"""The pool cell's comparison: ledgers, roots and verdicts against the
plain reference.

Given the benchmark's own requests and what the pool answered and
stored, count every way the pool departs from what the configuration
guarantees. Each count must be 0.
"""
from __future__ import annotations

import hashlib
import random

from port_bench.reference import codec, ed25519, merkle, mpt

NYM = "1"


def nym_state(txns: list) -> dict:
    """Domain state after the NYMs, in ledger order, as indy-plenum's NYM
    handler keeps it: DID -> msgpack {verkey, role, seqNo, txnTime, from},
    verkey and role kept from the record a NYM updates unless it names
    them."""
    records: dict[str, dict] = {}
    for txn in txns:
        body = txn.get("txn", {})
        if body.get("type") != NYM:
            continue
        data, meta = body.get("data", {}), txn.get("txnMetadata", {})
        old = records.get(data["dest"], {})
        records[data["dest"]] = {
            "verkey": data.get("verkey", old.get("verkey")),
            "role": data["role"] if "role" in data else old.get("role"),
            "seqNo": meta.get("seqNo"), "txnTime": meta.get("txnTime"),
            "from": body.get("metadata", {}).get("from")}
    return {did.encode(): codec.packb(rec) for did, rec in records.items()}


def _matches(txn: dict, req: dict) -> bool:
    body = txn.get("txn", {})
    meta, data = body.get("metadata", {}), body.get("data", {})
    op = req["operation"]
    payload = {k: v for k, v in req.items() if k != "signature"}
    return (body.get("type") == op["type"] and data.get("dest") == op["dest"]
            and data.get("verkey") == op.get("verkey")
            and meta.get("from") == req["identifier"]
            and meta.get("reqId") == req["reqId"]
            and meta.get("payloadDigest") == hashlib.sha256(
                codec.signing_bytes(payload)).hexdigest())


def judge(reqs: list, sent: dict, answer: dict, outputs: dict,
          trustee_vk: bytes, seed: int, sample: int,
          genesis_txns: int) -> dict:
    """reqs: [(request dict, digest, valid)] by index; sent: index -> time
    sent; answer: index -> ("ack", seqNo, t) | ("nack", t); outputs: node
    -> {"leaves": [bytes], "root", "state_root"}. -> {count name: n}."""
    out = {"unanswered": sum(1 for i in sent if i not in answer),
           "valid_refused": sum(1 for i, a in answer.items()
                                if a[0] == "nack" and reqs[i][2]),
           "forged_acked": sum(1 for i, a in answer.items()
                               if a[0] == "ack" and not reqs[i][2])}
    names = sorted(outputs)
    base = outputs[names[0]]["leaves"]
    out["ledger_disagree"] = sum(
        abs(len(outputs[n]["leaves"]) - len(base))
        + sum(1 for a, b in zip(outputs[n]["leaves"], base) if a != b)
        for n in names[1:])
    out["merkle_mismatch"] = sum(
        1 for n in names
        if merkle.root(outputs[n]["leaves"]) != outputs[n]["root"])

    by_digest = {d: i for i, (_, d, _) in enumerate(reqs)}
    txns, bad, seen = [], 0, set()
    for pos, leaf in enumerate(base, start=1):
        try:
            txn = codec.unpackb(leaf)
        except (ValueError, IndexError, UnicodeDecodeError):
            bad += 1
            continue
        txns.append(txn)
        if txn.get("txnMetadata", {}).get("seqNo") != pos:
            bad += 1
            continue
        if pos <= genesis_txns:
            continue
        i = by_digest.get(txn.get("txn", {}).get("metadata", {})
                          .get("digest"))
        if i is None or not reqs[i][2] or i in seen \
                or not _matches(txn, reqs[i][0]):
            bad += 1
        seen.add(i)
    out["txn_mismatch"] = bad
    digests = [t.get("txn", {}).get("metadata", {}).get("digest")
               for t in txns]
    out["ack_mismatch"] = sum(
        1 for i, a in answer.items() if a[0] == "ack"
        and not (isinstance(a[1], int) and 1 <= a[1] <= len(digests)
                 and digests[a[1] - 1] == reqs[i][1]))
    root = mpt.root(nym_state(txns))
    out["state_mismatch"] = sum(1 for n in names
                                if outputs[n]["state_root"] != root)

    # the verdicts on a sample drawn from the seed: half of it refused
    # requests (all of them where fewer), half accepted ones
    rng = random.Random(f"{seed}|sample")
    answered = sorted(answer)
    picked = []
    for want_ack in (True, False):
        pool = [i for i in answered if (answer[i][0] == "ack") == want_ack]
        picked += rng.sample(pool, min(sample // 2, len(pool)))
    mismatch = 0
    for i in picked:
        req = reqs[i][0]
        payload = {k: v for k, v in req.items() if k != "signature"}
        ok = ed25519.verify(trustee_vk, codec.signing_bytes(payload),
                            codec.b58decode(req["signature"]))
        mismatch += ok != (answer[i][0] == "ack") or ok != reqs[i][2]
    out["reference_verdict_mismatch"] = mismatch
    return out
