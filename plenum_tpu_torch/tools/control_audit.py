"""Control-ledger audit: replay and lint an autopilot decision history.

The autopilot (plenum_tpu_torch/control/autopilot.py) records every decision
as an ordered transaction on the reserved ``CONTROL_LEDGER_ID``. This
tool replays such a ledger and lints the invariants the control plane
promises — the same ones the fuzz suite pins live:

- seqs are strictly increasing from 1; timestamps never run backwards
- every actuation carries attributed evidence (an empty evidence dict
  on a non-hold record means the autopilot acted on nothing)
- every undo (``unpin``/``observer_retire``/``recover``) cites the seq
  of an EARLIER record whose action is the matching forward action
- no record lands on a (policy, subject) pair before a prior record's
  cooldown stamp expires (holds are exempt: a hold IS the ledger's
  account of a blocked intent)

    python -m plenum_tpu_torch.tools.control_audit LEDGER.jsonl [--json]
    python -m plenum_tpu_torch.tools.control_audit --check   # tier-1 self-test

``--check`` audits a synthetic good ledger (must lint clean) and a
corrupted variant per lint rule (each must be caught).
"""
from __future__ import annotations

import argparse
import json
import sys

from plenum_tpu_torch.control import CONTROL_LEDGER_ID, LADDER, REVERT_OF


def audit_records(records: list[dict]) -> list[str]:
    """Lint a control ledger (list of ControlRecord dicts, ledger
    order). -> list of violation strings, [] when clean."""
    problems: list[str] = []
    by_seq: dict[int, dict] = {}
    # (policy, subject) -> latest cooldown_until stamped by a non-hold
    cooldowns: dict[tuple[str, str], float] = {}
    prev_seq, prev_t = 0, float("-inf")
    for rec in records:
        seq = rec.get("seq")
        t = rec.get("t", 0.0)
        action = rec.get("action", "?")
        policy = rec.get("policy", "?")
        subject = rec.get("subject", "?")
        tag = f"seq={seq} {policy}/{action}@{subject}"
        if rec.get("ledger_id") != CONTROL_LEDGER_ID:
            problems.append(f"{tag}: ledger_id {rec.get('ledger_id')} "
                            f"!= {CONTROL_LEDGER_ID}")
        if not isinstance(seq, int) or seq != prev_seq + 1:
            problems.append(f"{tag}: seq not contiguous after {prev_seq}")
        else:
            prev_seq = seq
        if t < prev_t:
            problems.append(f"{tag}: time ran backwards ({t} < {prev_t})")
        prev_t = max(prev_t, t)
        if action != "hold" and not rec.get("evidence"):
            problems.append(f"{tag}: actuation without evidence")
        if action in REVERT_OF:
            cited = by_seq.get(rec.get("cites"))
            if cited is None:
                problems.append(f"{tag}: undo cites no earlier record "
                                f"(cites={rec.get('cites')})")
            elif cited.get("action") != REVERT_OF[action]:
                problems.append(
                    f"{tag}: undo cites seq={rec.get('cites')} "
                    f"({cited.get('action')}), wants "
                    f"{REVERT_OF[action]}")
        if action != "hold":
            key = (policy, subject)
            until = cooldowns.get(key, float("-inf"))
            if t < until:
                problems.append(f"{tag}: fired inside cooldown "
                                f"(t={t} < {until})")
            stamp = rec.get("cooldown_until", 0.0)
            if stamp:
                cooldowns[key] = max(until, stamp)
        if isinstance(seq, int):
            by_seq[seq] = rec
    return problems


def replay(records: list[dict]) -> dict:
    """Fold the ledger into the final control state it describes."""
    state = {"level": 0, "state": LADDER[0], "pins": {},
             "observers": {}, "splits": 0, "merges": 0, "holds": 0}
    for rec in records:
        action = rec.get("action")
        subject = rec.get("subject", "?")
        if action == "hold":
            state["holds"] += 1
        elif action == "split":
            state["splits"] += 1
        elif action == "merge":
            state["merges"] += 1
        elif action == "repin":
            state["pins"][subject] = rec.get("post", {}).get("lane")
        elif action == "unpin":
            state["pins"].pop(subject, None)
        elif action in ("observer_spawn", "observer_retire"):
            state["observers"][subject] = \
                rec.get("post", {}).get("observers")
        elif action in ("degrade", "recover"):
            state["level"] = rec.get("post", {}).get("level",
                                                     state["level"])
            state["state"] = rec.get("post", {}).get("state",
                                                     state["state"])
    return state


# --- the --check self-test ---------------------------------------------------

def _rec(seq, t, policy, action, subject, evidence=None, pre=None,
         post=None, cooldown_until=0.0, cites=None):
    return {"ledger_id": CONTROL_LEDGER_ID, "seq": seq, "t": t,
            "policy": policy, "action": action, "subject": subject,
            "evidence": evidence if evidence is not None else {"e": 1},
            "pre": pre or {}, "post": post or {},
            "cooldown_until": cooldown_until, "cites": cites}


def _good_ledger() -> list[dict]:
    return [
        _rec(1, 10.0, "lane", "repin", "shard0",
             {"sick_lane": 2, "breaker": "open"},
             pre={"lane": 2}, post={"lane": 0}, cooldown_until=40.0),
        _rec(2, 12.0, "reshard", "split", "shard0",
             {"index": 0.9, "hot_shard": 0},
             pre={"shards": [0, 1]}, post={"shards": [0, 1, 2]},
             cooldown_until=42.0),
        _rec(3, 20.0, "observer", "observer_spawn", "r0",
             {"region": "r0", "fast": 2.0},
             pre={"observers": 1}, post={"observers": 2},
             cooldown_until=50.0),
        _rec(4, 30.0, "ladder", "hold", "pool",
             {"wanted": "degrade", "blocked_until": 42.0}),
        _rec(5, 45.0, "ladder", "degrade", "shed_harder",
             {"burning": [["slo_burn.ingress", "N1"]]},
             pre={"level": 0, "state": "normal"},
             post={"level": 1, "state": "shed_harder"},
             cooldown_until=75.0),
        _rec(6, 50.0, "lane", "unpin", "shard0",
             {"healed_lane": 2, "clear_streak": 5},
             pre={"lane": 0}, post={"lane": 2},
             cooldown_until=80.0, cites=1),
        _rec(7, 60.0, "observer", "observer_retire", "r0",
             {"region": "r0", "demand": 3},
             pre={"observers": 2}, post={"observers": 1},
             cooldown_until=90.0, cites=3),
        _rec(8, 80.0, "ladder", "recover", "shed_harder",
             {"clear_for": 5},
             pre={"level": 1, "state": "shed_harder"},
             post={"level": 0, "state": "normal"},
             cooldown_until=110.0, cites=5),
    ]


def self_check() -> int:
    problems = []
    good = _good_ledger()
    got = audit_records(good)
    if got:
        problems.append(f"good ledger did not lint clean: {got}")
    final = replay(good)
    if final["level"] != 0 or final["pins"] or final["splits"] != 1 \
            or final["observers"].get("r0") != 1 or final["holds"] != 1:
        problems.append(f"replay of the good ledger is wrong: {final}")

    def corrupt(mutate, expect: str):
        bad = [dict(r) for r in _good_ledger()]
        mutate(bad)
        found = audit_records(bad)
        if not any(expect in p for p in found):
            problems.append(f"corruption not caught (wanted {expect!r}): "
                            f"{found}")

    corrupt(lambda b: b[2].update(seq=9), "seq not contiguous")
    corrupt(lambda b: b[3].update(t=5.0), "time ran backwards")
    corrupt(lambda b: b[1].update(evidence={}), "without evidence")
    corrupt(lambda b: b[5].update(cites=None), "cites no earlier record")
    corrupt(lambda b: b[5].update(cites=2), "wants repin")
    # an action/undo flap inside one cooldown window — the no-flap pin
    corrupt(lambda b: b[5].update(t=15.0), "fired inside cooldown")
    corrupt(lambda b: b[0].update(ledger_id=100), "ledger_id")

    print(json.dumps({"check": "ok" if not problems else "FAIL",
                      "problems": problems}))
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger", nargs="?",
                    help="jsonl file of control records, or '-' for stdin")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="run the built-in self-test and exit")
    args = ap.parse_args(argv)
    if args.check:
        return self_check()
    if not args.ledger:
        ap.error("ledger required (or --check)")
    fh = sys.stdin if args.ledger == "-" else open(args.ledger)
    try:
        records = [json.loads(line) for line in fh if line.strip()]
    finally:
        if fh is not sys.stdin:
            fh.close()
    problems = audit_records(records)
    final = replay(records)
    if args.json:
        print(json.dumps({"records": len(records), "problems": problems,
                          "final": final}))
    else:
        print(f"{len(records)} control records; final state: {final}")
        for p in problems:
            print(f"  VIOLATION: {p}")
        if not problems:
            print("  clean: every action evidenced, every undo cited, "
                  "no cooldown violations")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
