"""Closed-loop NYM writes into the in-process pool.

The system under test is the port's own entry for a co-hosted pool,
`plenum_tpu_torch.tools.local_pool.build_pool`: n Nodes on one SimNetwork
and one real-time timer, sharing one device ring. The loop keeps
`in_flight` requests unanswered: each is handed to every node, as a
client broadcasting its write does, and counts as answered once f + 1
nodes agree, by REPLYs naming one seqNo and txnTime, or by NACKs. The
requests are signed in set-up; `corrupt_per_1000` of them carry a spoiled
signature and must be refused.

After the window no request is added; the loop runs on until every
request sent in the window has its answer and every node holds the same
ledger (at most `drain_s`). Then the plain reference judges the ledgers,
the roots and the verdicts (`port_bench.reference.pool_check`).
"""
from __future__ import annotations

import gc
import time

from port_bench import device, stats
from port_bench.reference import pool_check
from port_bench.traffic import corpus


class Answers:
    """A request's answer is settled once `quorum` nodes agree: REPLYs
    naming one (seqNo, txnTime), or NACKs. A node's differing REPLY does
    not count toward another's."""

    def __init__(self, quorum: int):
        self.quorum = quorum
        self._acks: dict[int, dict] = {}
        self._nacks: dict[int, set] = {}
        self.answer: dict[int, tuple] = {}   # ("ack", seqNo, t) | ("nack", t)

    def reply(self, i: int, node: str, key: tuple, t: float) -> None:
        who = self._acks.setdefault(i, {}).setdefault(key, set())
        who.add(node)
        if len(who) >= self.quorum and i not in self.answer:
            self.answer[i] = ("ack", key[0], t)

    def nack(self, i: int, node: str, t: float) -> None:
        who = self._nacks.setdefault(i, set())
        who.add(node)
        if len(who) >= self.quorum and i not in self.answer:
            self.answer[i] = ("nack", t)


def _build(ctx):
    from plenum_tpu_torch.tools.local_pool import build_pool
    conf, p = ctx.conf, ctx.params
    overrides = dict(conf["pool_config"], **p.get("program_overrides", {}))
    built = build_pool(conf["deployment"]["nodes"], ctx.backend,
                       seed=ctx.seed, config_overrides=overrides)
    names, nodes = built[0], built[1]
    wait = nodes[names[0]].config.Max3PCBatchWait
    if wait != conf["assumed"]["Max3PCBatchWait"]:
        raise RuntimeError(f"build_pool runs Max3PCBatchWait={wait}, the "
                           "configuration states "
                           f"{conf['assumed']['Max3PCBatchWait']}")
    return built


def _trustee_secret(ctx) -> bytes:
    return ctx.conf["deployment"]["trustee_seed"].encode().ljust(32, b"\0")


def prepare(ctx):
    """Start signing the requests (the last one warms the pool up) while
    the process loads torch and the port."""
    n_req = ctx.params["presigned"]
    bad = corpus.corrupted_indices(ctx.seed, n_req,
                                   ctx.params["corrupt_per_1000"])
    return corpus.Making(corpus.pool_slice, n_req + 1, bad,
                         (ctx.seed, _trustee_secret(ctx)),
                         workers=ctx.workers)


def abandon(prepared) -> None:
    prepared.stop()


def run(ctx) -> dict:
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.common.node_messages import (
        AUDIT_LEDGER_ID, Reject, Reply, RequestNack)
    from plenum_tpu_torch.parallel.supervisor import find_supervisor

    conf, p = ctx.conf, ctx.params
    quorum = conf["guarantees"]["ack_quorum"]
    trustee_secret = _trustee_secret(ctx)
    n_req = p["presigned"]
    # set-up's milestones, in seconds from the process's start
    marks = {"imported": time.perf_counter()}
    making = ctx.prepared if ctx.prepared is not None else prepare(ctx)
    reqs = making.get()
    by_digest = {d: i for i, (_, d, _) in enumerate(reqs)}
    gc.freeze()           # the corpus is the benchmark's, not the pool's
    marks["corpus"] = time.perf_counter()

    (names, nodes, timer, trustee, replies, _, domain_id, plane,
     _) = _build(ctx)
    marks["built"] = time.perf_counter()
    trustee_vk = corpus.verkey_of(trustee_secret)
    if trustee.verkey != trustee_vk:
        raise RuntimeError("the pool's genesis trustee is not the "
                           "configuration's trustee_seed")
    pipe = getattr(plane, "_pipeline", None)
    for hook in ctx.hooks.get("built", ()):
        hook(ctx, {"nodes": nodes, "pipe": pipe})

    def prod_all(trace=None):
        with device.span("prod", trace):
            timer.service()
            for node in nodes.values():
                node.prod()
        if plane is not None:
            with device.span("flush", trace):
                plane.flush()

    def submit(i: int) -> None:
        for name in names:
            nodes[name].handle_client_message(reqs[i][0], "bench")

    # warm-up, as run_load does: one request end to end, then the ring's
    # pad buckets and commit ladder built and pinned before the clock
    warm = n_req
    submit(warm)
    deadline = time.perf_counter() + p["warm_timeout_s"]
    while time.perf_counter() < deadline and not any(
            isinstance(m, Reply) for _, m, _ in replies[names[0]]):
        prod_all()
    if not any(isinstance(m, Reply) for _, m, _ in replies[names[0]]):
        raise RuntimeError("the warm-up request was not answered")
    if pipe is not None:
        pipe.prewarm(pipe.buckets[:2])
        pipe.prewarm_cmt([1, 2, 4, 8])
        pipe.pin()
    marks["warm"] = time.perf_counter()

    sent: dict[int, float] = {}         # request -> when it was sent
    answers = Answers(quorum)
    answer = answers.answer
    seen = {n: 0 for n in names}
    for n in names:                     # the warm-up's answers stay out
        seen[n] = len(replies[n])
    counts = {"unknown_replies": 0}

    def scan() -> None:
        for name in names:
            box = replies[name]
            for ts, msg, _ in box[seen[name]:]:
                if isinstance(msg, Reply):
                    meta = msg.result.get("txnMetadata", {})
                    i = by_digest.get(msg.result.get("txn", {})
                                      .get("metadata", {}).get("digest"))
                    if i == warm:
                        continue
                    if i is None or i not in sent:
                        counts["unknown_replies"] += 1
                        continue
                    answers.reply(i, name, (meta.get("seqNo"),
                                            meta.get("txnTime")), ts)
                elif isinstance(msg, (RequestNack, Reject)):
                    i = msg.req_id - 1
                    if i == warm:
                        continue
                    if i not in sent:
                        counts["unknown_replies"] += 1
                        continue
                    answers.nack(i, name, ts)
            seen[name] = len(box)

    node1 = nodes[names[0]]
    ledgers = node1.c.db

    def snapshot() -> dict:
        acc = node1.metrics.accumulators.get(MetricsName.COMMIT_APPLY_TIME)
        return {"domain": ledgers.get_ledger(domain_id).size,
                "audit": ledgers.get_ledger(AUDIT_LEDGER_ID).size,
                "apply": (acc.total, acc.count) if acc else (0.0, 0),
                "dispatched": pipe.stats["dispatched_items"] if pipe else 0,
                "repeats": pipe.inflight_repeats if pipe else 0}

    in_flight = p["in_flight"]
    trace = device.DeviceTrace() if ctx.trace else None
    before = snapshot()
    setup_s = time.perf_counter() - ctx.t_process
    if trace:
        trace.start()
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    nxt, ran_dry = 0, False
    while time.perf_counter() < t_end:
        with device.span("feed", trace):
            while nxt < n_req and nxt - len(answer) < in_flight:
                sent[nxt] = time.perf_counter()
                submit(nxt)
                nxt += 1
        if nxt == n_req:
            ran_dry = True
        prod_all(trace)
        with device.span("replies", trace):
            scan()
    after = snapshot()
    reading = trace.stop() if trace else None

    # drain: answers due in the window, and every node's ledger alike
    deadline = time.perf_counter() + p["drain_s"]
    while time.perf_counter() < deadline:
        prod_all()
        scan()
        if len(answer) == len(sent) and len({
                nodes[n].c.db.get_ledger(domain_id).size
                for n in names}) == 1:
            break
    memory = device.memory_peak_bytes(1) if ctx.backend == "cuda" else 0

    outputs = {}
    for name in names:
        db = nodes[name].c.db
        ledger = db.get_ledger(domain_id)
        outputs[name] = {
            "leaves": [ledger._log.get(s) for s in range(1, ledger.size + 1)],
            "root": ledger.root_hash,
            "state_root": db.get_state(domain_id).committed_head_hash}
    sup = find_supervisor(plane) if plane is not None else None
    sup_stats = sup.supervisor_stats() if sup is not None else {}
    off_card = (sup_stats.get("fallback_batches", 0)
                + sup_stats.get("hedge_wins", 0))
    # the pool goes before the reference runs
    del nodes, plane, pipe, replies, node1, ledgers, sup
    del prod_all, submit, scan, snapshot
    gc.collect()

    checks = pool_check.judge(
        reqs=reqs, sent=sent, answer=answer, outputs=outputs,
        trustee_vk=trustee_vk, seed=ctx.seed,
        sample=p["reference_sample"],
        genesis_txns=conf["deployment"]["domain_txns_at_start"])
    checks["ran_dry"] = int(ran_dry)
    checks["off_card_waves"] = off_card
    checks["stray_replies"] = counts["unknown_replies"]

    acked_in_window = sum(1 for a in answer.values()
                          if a[0] == "ack" and a[2] <= t_end)
    lat = [answer[i][2] - t for i, t in sent.items()
           if t < t_end and i in answer and answer[i][0] == "ack"]
    failed = sum(1 for i in sent if i not in answer
                 or (answer[i][0] == "ack") != reqs[i][2])
    dt = {k: (after[k] - before[k]) for k in ("domain", "audit",
                                               "dispatched", "repeats")}
    apply_total = after["apply"][0] - before["apply"][0]
    apply_count = after["apply"][1] - before["apply"][1]
    return {
        "setup_s": setup_s,
        "window_s": ctx.seconds,
        "end_to_end": {"write_tps": stats.rate(acked_in_window,
                                               ctx.seconds)},
        "attempted": len(sent),
        "failed": failed,
        "checks": {k: (v, 0) for k, v in checks.items()},
        "memory_peak_bytes": memory,
        "trace": reading,
        "notes": [f"writes acked in the window: {acked_in_window}; "
                  f"latency samples: {len(lat)}; sent: {len(sent)}; "
                  f"corrupted sent: {sum(1 for i in sent if not reqs[i][2])}",
                  f"node1: {dt['domain']} txns in {dt['audit']} 3PC batches; "
                  f"ring: {dt['dispatched']} signatures dispatched, "
                  f"{dt['repeats']} of them repeats in flight; "
                  f"supervisor: {sup_stats.get('breaker_state')}",
                  "set-up milestones (s from the process's start): "
                  + ", ".join(f"{k} {v - ctx.t_process:.3f}"
                              for k, v in marks.items())],
        "collected": {
            "latencies_s": lat,
            "ordered_txns": dt["domain"], "ordered_batches": dt["audit"],
            "apply_s_total": apply_total, "apply_count": apply_count},
    }
