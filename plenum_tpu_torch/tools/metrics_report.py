"""Operator-facing analyzer for flushed node metrics.

Reference behavior: scripts/process_logs + scripts/log_stats — turn a
node's on-disk metrics history into per-metric statistics and a derived
health summary an operator can read. Here the source is the msgpack rows
a KvMetricsCollector flushes (common/metrics.py), one store per node at
<base-dir>/<name>/metrics (written by tools.start_node).

    python -m plenum_tpu_torch.tools.metrics_report <base-dir> [--node Node1]
        [--last 300] [--json]

With no --node, every `<base-dir>/*/metrics` store found is reported
(and the derived pool summary aggregates across them).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def read_store(path: str) -> list[tuple[float, str, dict]]:
    """metrics dir -> [(ts, name, fold)] sorted by ts. GENUINELY
    read-only: never truncates a torn tail or compacts, so it is safe to
    run against a store a live node is appending to."""
    from plenum_tpu_torch.common.metrics import rows_from_kv_items
    from plenum_tpu_torch.storage.kv_file import read_log_readonly
    return rows_from_kv_items(read_log_readonly(path))


def fold_rows(rows: list[tuple[float, str, dict]]) -> dict[str, dict]:
    """Merge per-flush folds into one per-metric fold over the window.

    Each stored fold is {count, sum, min, max} (Accumulator.to_dict).
    `last` keeps the most recent flush's mean — the right reading for
    gauges sampled at flush time (queue depths, RSS).
    """
    out: dict[str, dict] = {}
    for ts, name, fold in rows:
        agg = out.setdefault(name, {
            "count": 0, "sum": 0.0, "min": None, "max": None,
            "first_ts": ts, "last_ts": ts, "last": None, "flushes": 0})
        agg["count"] += fold.get("count", 0)
        agg["sum"] += fold.get("sum", 0.0)
        for k, pick in (("min", min), ("max", max)):
            v = fold.get(k)
            if v is not None:
                agg[k] = v if agg[k] is None else pick(agg[k], v)
        agg["last_ts"] = ts
        agg["flushes"] += 1
        if fold.get("count"):
            agg["last"] = fold["sum"] / fold["count"]
        # commit-path stage rows carry bounded raw samples (metrics.py
        # SAMPLED_NAMES) so the report can print honest p50/p95
        if fold.get("samples"):
            agg.setdefault("samples", []).extend(fold["samples"][:4096])
    for agg in out.values():
        agg["mean"] = agg["sum"] / agg["count"] if agg["count"] else None
    return out


def merge_node_folds(per_node: dict[str, dict[str, dict]]
                     ) -> dict[str, dict]:
    """{node: folds} -> ONE pool-wide folds dict.

    Counts/sums add, min/max fold, and — the part that matters for
    percentiles — the nodes' sampled reservoirs are MERGED (concatenated)
    so pool p50/p95 is computed over the union of samples. Averaging
    per-node percentiles is wrong whenever node distributions differ
    (mean(p95_a, p95_b) is not p95(a ∪ b): two nodes at 1 ms and 100 ms
    "average" to a 50 ms pool p50 that no request ever saw); each node's
    reservoir is an unbiased sample of its own stream, so their union is
    an unbiased sample of the pool stream when streams are comparable in
    size — and honest about modality either way. Pinned by
    tests/test_telemetry.py with deliberately diverging nodes."""
    out: dict[str, dict] = {}
    for _node, folds in sorted(per_node.items()):
        for name, agg in folds.items():
            tgt = out.setdefault(name, {
                "count": 0, "sum": 0.0, "min": None, "max": None,
                "first_ts": agg.get("first_ts"),
                "last_ts": agg.get("last_ts"),
                "last": None, "flushes": 0})
            tgt["count"] += agg.get("count", 0)
            tgt["sum"] += agg.get("sum", 0.0)
            tgt["flushes"] += agg.get("flushes", 0)
            for k, pick in (("min", min), ("max", max),
                            ("first_ts", min), ("last_ts", max)):
                v = agg.get(k)
                if v is not None:
                    tgt[k] = v if tgt[k] is None else pick(tgt[k], v)
            # "last" keeps the newest node's flush-gauge reading
            if agg.get("last") is not None and (
                    tgt["last"] is None
                    or (agg.get("last_ts") or 0) >= (tgt.get("_last_at")
                                                     or float("-inf"))):
                tgt["last"] = agg["last"]
                tgt["_last_at"] = agg.get("last_ts") or 0
            if agg.get("samples"):
                tgt.setdefault("samples", []).extend(agg["samples"])
    for tgt in out.values():
        tgt.pop("_last_at", None)
        tgt["mean"] = tgt["sum"] / tgt["count"] if tgt["count"] else None
    return out


def pool_summary(per_node: dict[str, dict[str, dict]]) -> dict:
    """Pool-wide derived summary over MERGED folds (see merge_node_folds
    — pool percentiles come from the union of the nodes' reservoirs,
    never from averaging per-node percentiles).

    Two classes of figures need more than the merge:

    * the ordered stream is REPLICATED — every node orders the same
      txns, so merged ordered counts are n_nodes x the pool's real
      stream; txns_ordered/tps are de-replicated here;
    * cumulative host gauges (transport bytes, dropped frames) total
      per NODE — the fleet figure is the SUM of per-node run totals,
      and per-host gauges (RSS, GC pause) are reported as the WORST
      node, never as a pool single."""
    merged = merge_node_folds(per_node)
    firsts = [f.get("first_ts") for fs in per_node.values()
              for f in fs.values() if f.get("first_ts") is not None]
    lasts = [f.get("last_ts") for fs in per_node.values()
             for f in fs.values() if f.get("last_ts") is not None]
    span = (max(lasts) - min(firsts)) if firsts and lasts else 0.0
    out = derive_summary(merged, span)
    n = len(per_node)
    out["nodes"] = n

    if n > 1:
        out["txns_ordered"] = int(out["txns_ordered"] / n)
        if out.get("tps"):
            out["tps"] = round(out["tps"] / n, 1)
        # the division assumes ONE replicated stream across all node
        # dirs; a base dir spanning shards (different streams per
        # sub-pool) needs per-shard runs — flag the assumption so the
        # figure can't be read as shard-aware
        out["ordered_dedup"] = "assumes one replicated stream " \
                               "(run per shard for sharded base dirs)"

    def node_cums(name):            # per-node run totals (max = total)
        vals = [fs.get(name, {}).get("max") for fs in per_node.values()]
        return [v for v in vals if v is not None]

    for direction in ("tx", "rx"):
        totals = node_cums(f"transport.{direction}_bytes")
        if totals:
            out[f"transport_{direction}_bytes"] = int(sum(totals))
            if out["txns_ordered"]:
                out[f"transport_{direction}_bytes_per_txn"] = round(
                    sum(totals) / out["txns_ordered"])
    for key, name in (("transport_dropped_frames",
                       "transport.dropped_frames"),
                      ("transport_dropped_sessions",
                       "transport.dropped_sessions")):
        if key in out:
            out[key] = int(sum(node_cums(name)))
    if "propagate_tx_bytes_per_txn" in out and out["txns_ordered"]:
        prop = sum(node_cums("transport.tx.PROPAGATE")) \
            + sum(node_cums("transport.tx.PROPAGATE_BATCH"))
        out["propagate_tx_bytes_per_txn"] = round(
            prop / out["txns_ordered"])
    # per-host gauges: one pool figure is meaningless — name the worst
    for drop, worst_key, vals in (
            ("rss_mb_last", "rss_mb_max_node",
             [v / 1e6 for v in node_cums("process.rss_bytes")]),
            ("gc_pause_s", "gc_pause_s_max_node",
             node_cums("process.gc_pause_time"))):
        out.pop(drop, None)
        if vals:
            out[worst_key] = round(max(vals), 2)
    out.pop("gc_pause_pct", None)
    return out


def derive_summary(folds: dict[str, dict], span_s: float,
                   windowed: bool = False) -> dict:
    """Pool-health figures an operator actually asks for."""
    def s(name):            # total over window
        return folds.get(name, {}).get("sum") or 0.0

    def mean(name):
        return folds.get(name, {}).get("mean")

    def last(name):
        return folds.get(name, {}).get("last")

    txns = s("node.ordered_batch_size")
    # gc_pause_time is a CUMULATIVE counter sampled at each flush. Full
    # run: the latest value (max) IS the run's total, since the timer
    # starts at 0 with the process. Trailing window: the delta across
    # the window's flushes.
    gp = folds.get("process.gc_pause_time", {})
    if windowed and gp.get("flushes", 0) > 1:
        gc_pause = (gp.get("max") or 0.0) - (gp.get("min") or 0.0)
    else:
        gc_pause = gp.get("max") or 0.0
    out = {
        "window_s": round(span_s, 1),
        "txns_ordered": int(txns),
        "tps": round(txns / span_s, 1) if span_s > 0 else None,
        "mean_batch_size": mean("node.ordered_batch_size"),
        "prepare_phase_ms": _ms(mean("consensus.prepare_phase_time")),
        "commit_phase_ms": _ms(mean("consensus.commit_phase_time")),
        "ordering_ms": _ms(mean("consensus.ordering_time")),
        "view_changes": int(s("consensus.view_changes")),
        "suspicions": int(s("consensus.suspicions")),
        "catchups": int(s("consensus.catchups")),
        "client_inbox_depth_max": folds.get("node.client_inbox_depth",
                                            {}).get("max"),
        "propagate_inbox_depth_max": folds.get("node.propagate_inbox_depth",
                                               {}).get("max"),
        "request_queue_depth_max": folds.get("consensus.request_queue_depth",
                                             {}).get("max"),
        "request_queue_depth_mean": mean("consensus.request_queue_depth"),
        "gc_pause_s": round(gc_pause, 2),
        "gc_pause_pct": round(100 * gc_pause / span_s, 2) if span_s else None,
        "rss_mb_last": (last("process.rss_bytes") or 0) / 1e6 or None,
    }

    def cum(name):          # cumulative gauge: latest value = max
        return folds.get(name, {}).get("max")

    # transport silent-loss + byte totals (cumulative TcpStack gauges);
    # dropped counters are reported even at 0 ONCE the stack emits them —
    # "no drops recorded" and "drops metric absent" must read differently
    if "transport.dropped_frames" in folds:
        out["transport_dropped_frames"] = int(cum("transport.dropped_frames"))
        out["transport_dropped_sessions"] = int(
            cum("transport.dropped_sessions") or 0)
    for direction in ("tx", "rx"):
        total = cum(f"transport.{direction}_bytes")
        if total is not None:
            out[f"transport_{direction}_bytes"] = int(total)
            if txns:
                out[f"transport_{direction}_bytes_per_txn"] = round(
                    total / txns)
    propagate_tx = cum("transport.tx.PROPAGATE")
    batch_tx = cum("transport.tx.PROPAGATE_BATCH")
    if (propagate_tx is not None or batch_tx is not None) and txns:
        out["propagate_tx_bytes_per_txn"] = round(
            ((propagate_tx or 0) + (batch_tx or 0)) / txns)

    # post-ordering critical path: per-stage p50/p95 from the raw samples
    # the commit-path timers flush (bls-verify / apply / durable / reply) —
    # a latency regression must localize to a stage, not hide in a mean
    from plenum_tpu_torch.common.metrics import percentile
    for stage in ("bls_verify", "apply", "commit_wave", "durable", "reply"):
        f = folds.get(f"commit_path.{stage}_time", {})
        samples = f.get("samples")
        if samples:
            out[f"{stage}_ms_p50"] = _ms(percentile(samples, 0.5))
            out[f"{stage}_ms_p95"] = _ms(percentile(samples, 0.95))
        elif f.get("mean") is not None:
            out[f"{stage}_ms_mean"] = _ms(f["mean"])
    # batched-BLS acceptance counter: Miller loops per ordered batch
    # (amortized O(1) target: ~2 for a same-message commit set)
    ppb = folds.get("crypto.pairings_per_batch", {})
    if ppb.get("mean") is not None:
        out["pairings_per_batch"] = round(ppb["mean"], 2)
    if "crypto.pairing_checks" in folds:
        out["pairing_checks_total"] = int(cum("crypto.pairing_checks") or 0)
        out["pairings_total"] = int(cum("crypto.pairings") or 0)
    # group-commit coalescing: ordered batches riding one durable flush
    gcb = folds.get("node.group_commit_batches", {})
    if gcb.get("mean") is not None:
        out["group_commit_batches_mean"] = round(gcb["mean"], 2)
    # device-plane observability: dispatch counter (sharded plane) +
    # coalescing-verifier batch stats, which existed as attributes/events
    # but never reached this report
    if "crypto.plane_dispatches" in folds:
        out["plane_dispatches"] = int(cum("crypto.plane_dispatches") or 0)
    sbs = folds.get("crypto.sig_batch_size", {})
    if sbs.get("mean") is not None:
        out["sig_batch_size_mean"] = round(sbs["mean"], 1)
        out["sig_batches_dispatched"] = int(sbs.get("count") or 0)
    if mean("crypto.sig_dispatch_time") is not None:
        out["sig_dispatch_ms_mean"] = _ms(mean("crypto.sig_dispatch_time"))
    if mean("crypto.sig_batch_fill_time") is not None:
        out["sig_batch_fill_ms_mean"] = _ms(
            mean("crypto.sig_batch_fill_time"))
    # plane supervisor: the degraded-mode story an operator actually
    # checks — breaker state (latest gauge), fallback volume, hedge wins,
    # deadline misses, and the dispatch-budget distribution p50/p95
    # (docs/robustness.md "Degraded modes of the crypto plane")
    bs = folds.get("crypto.breaker_state", {})
    if bs.get("last") is not None:
        out["crypto_breaker_state"] = {0: "closed", 1: "half_open",
                                       2: "open"}.get(int(bs["last"]),
                                                      "unknown")
        out["crypto_breaker_opens"] = int(cum("crypto.breaker_opens") or 0)
        out["crypto_fallback_batches"] = int(
            cum("crypto.fallback_batches") or 0)
        out["crypto_fallback_items"] = int(
            cum("crypto.fallback_items") or 0)
        out["crypto_hedge_wins"] = int(cum("crypto.hedge_wins") or 0)
        out["crypto_deadline_misses"] = int(
            cum("crypto.deadline_misses") or 0)
    budget = folds.get("crypto.dispatch_budget", {})
    if budget.get("samples"):
        out["deadline_ms_p50"] = _ms(percentile(budget["samples"], 0.5))
        out["deadline_ms_p95"] = _ms(percentile(budget["samples"], 0.95))
    if "crypto.bls_batch_fallbacks" in folds:
        out["bls_batch_fallbacks"] = int(
            cum("crypto.bls_batch_fallbacks") or 0)
    if "crypto.bls_local_fallbacks" in folds:
        out["bls_local_fallbacks"] = int(
            cum("crypto.bls_local_fallbacks") or 0)
    # fused crypto pipeline (docs/performance.md "Fused device-resident
    # crypto pipeline"): dispatch volume, coalesced items per dispatch
    # (the cross-stage amortization figure), the ring's dedup ratio, pad
    # waste, bucket hit rate, and the steering knobs' latest positions.
    # A rising compiled_shapes after warmup is the recompile-guard alarm.
    pd = folds.get("pipeline.dispatches", {})
    if pd.get("max") is not None:
        section = {
            "dispatches": int(cum("pipeline.dispatches") or 0),
            "dedup_ratio": folds.get("pipeline.dedup_ratio",
                                     {}).get("last"),
            "bucket_hit_rate": folds.get("pipeline.bucket_hit_rate",
                                         {}).get("last"),
            "compiled_shapes": int(
                cum("pipeline.compiled_shapes") or 0),
        }
        ipd = folds.get("pipeline.items_per_dispatch", {})
        if ipd.get("mean") is not None:
            section["items_per_dispatch_mean"] = round(ipd["mean"], 1)
        pw = folds.get("pipeline.pad_waste", {})
        if pw.get("mean") is not None:
            section["pad_waste_mean"] = round(pw["mean"], 3)
        occ = folds.get("pipeline.occupancy", {})
        if occ.get("mean") is not None:
            section["occupancy_mean"] = round(occ["mean"], 1)
            section["occupancy_max"] = occ.get("max")
        pctl = folds.get("pipeline_ctl.flush_wait", {})
        if pctl.get("last") is not None:
            section["controller"] = {
                "flush_wait_ms": _ms(pctl["last"]),
                "bucket_floor": int(folds.get(
                    "pipeline_ctl.bucket_floor", {}).get("last") or 0),
                "decisions": int(cum("pipeline_ctl.decisions") or 0),
            }
        # multi-device ring (docs/performance.md "Multi-device crypto
        # pipeline"): lane count, how many chip breakers are open RIGHT
        # NOW, worst lane backlog, and the dispatch spread (max/mean
        # per-lane dispatches — 1.0 = perfectly even placement; a
        # rising spread means traffic is queueing on one chip)
        lanes = folds.get("pipeline_dev.lanes", {})
        if lanes.get("last"):
            section["devices"] = {
                "lanes": int(lanes["last"]),
                "breakers_open": int(folds.get(
                    "pipeline_dev.breakers_open", {}).get("last") or 0),
                "occupancy_max": folds.get(
                    "pipeline_dev.occupancy_max", {}).get("max"),
                "dispatch_spread": folds.get(
                    "pipeline_dev.dispatch_spread", {}).get("last"),
            }
        # commit-wave (cmt) lane (docs/performance.md "Device-resident
        # ordering"): fused triple-root recommit waves, items and tree
        # levels per run, and how many waves degraded to host recommit —
        # a rising host_fallbacks is the commit-path breaker alarm
        cw = folds.get("pipeline_cmt.waves", {})
        if cw.get("max"):
            section["commit_wave"] = {
                "waves": int(cum("pipeline_cmt.waves") or 0),
                "items": int(cum("pipeline_cmt.items") or 0),
                "levels": int(cum("pipeline_cmt.levels") or 0),
                "host_fallbacks": int(
                    cum("pipeline_cmt.host_fallbacks") or 0),
            }
        # cross-host federation (docs/performance.md "Cross-host crypto
        # federation"): rented remote-host lanes, how much work migrated
        # between backlogged lanes, open remote breakers RIGHT NOW, and
        # the remote dispatch->verdict ship latency — a rising
        # remote_breakers_open means rented capacity is dark and the
        # ring is running host-local
        fl = folds.get("pipeline_fed.remote_lanes", {})
        if fl.get("last"):
            section["federation"] = {
                "remote_lanes": int(fl["last"]),
                "steals": int(folds.get(
                    "pipeline_fed.steals", {}).get("last") or 0),
                "stolen_items": int(folds.get(
                    "pipeline_fed.stolen_items", {}).get("last") or 0),
                "remote_breakers_open": int(folds.get(
                    "pipeline_fed.remote_breakers_open",
                    {}).get("last") or 0),
                "ship_ms_p95": folds.get(
                    "pipeline_fed.ship_ms_p95", {}).get("last"),
            }
        out["crypto_pipeline"] = {k: v for k, v in section.items()
                                  if v is not None}
    # closed-loop batch controller (docs/performance.md "Pipelined
    # ordering"): where the steered knobs sit (latest gauge) and how many
    # decisions the loop has made — a flat decision count under load
    # means the loop is not seeing samples (wrong node, or disabled)
    ctl_size = folds.get("batch_ctl.size", {})
    if ctl_size.get("last") is not None:
        out["batch_controller"] = {
            "batch_size": int(ctl_size["last"]),
            "wait_ms": _ms(folds.get("batch_ctl.wait", {}).get("last")),
            "depth": int(folds.get("batch_ctl.depth", {}).get("last") or 0),
            "coalesce": int(
                folds.get("batch_ctl.coalesce", {}).get("last") or 0),
            "decisions": int(cum("batch_ctl.decisions") or 0),
        }
    # verified read plane (docs/reads.md): volume, cache effectiveness,
    # proof mix, and the proof-generation stage p50/p95 — a read-latency
    # regression must localize to proof gen vs everything else, and a
    # rising proofless share is the operator's signal that clients are
    # paying the f+1 broadcast fallback
    rq = folds.get("read_plane.queries", {})
    if rq.get("count"):
        queries = rq.get("sum") or 0.0
        hits = cum("read_plane.cache_hits") or 0
        section = {
            "queries": int(queries),
            "reads_per_s": round(queries / span_s, 1) if span_s > 0
            else None,
            "cache_hits": int(hits),
            "cache_hit_rate": round(hits / queries, 3) if queries
            else None,
            "proofs_state": int(cum("read_plane.proofs_state") or 0),
            "proofs_merkle": int(cum("read_plane.proofs_merkle") or 0),
            "proofs_verkle": int(cum("read_plane.proofs_verkle") or 0),
            "proofless": int(cum("read_plane.proofless") or 0),
            "anchor_updates": int(
                cum("read_plane.anchor_updates") or 0),
            # one event per tick batch carries len(batch): the mean IS
            # the mean queries-per-tick batch size
            "batch_size_mean": rq.get("mean"),
        }
        gen = folds.get("read_plane.proof_gen_time", {})
        if gen.get("samples"):
            section["proof_gen_ms_p50"] = _ms(
                percentile(gen["samples"], 0.5))
            section["proof_gen_ms_p95"] = _ms(
                percentile(gen["samples"], 0.95))
        elif gen.get("mean") is not None:
            section["proof_gen_ms_mean"] = _ms(gen["mean"])
        # per-kind envelope bytes: what a verified read costs the client
        # to download — the bytes-per-read A/B (config13) reads THESE
        for kind in ("state", "state_multi", "merkle", "verkle",
                     "verkle_multi"):
            pb = folds.get(f"read_plane.proof_bytes_{kind}", {})
            if pb.get("samples"):
                section[f"proof_bytes_{kind}_p50"] = int(
                    percentile(pb["samples"], 0.5))
                section[f"proof_bytes_{kind}_p95"] = int(
                    percentile(pb["samples"], 0.95))
            elif pb.get("mean") is not None:
                section[f"proof_bytes_{kind}_mean"] = int(pb["mean"])
        out["read_plane"] = {k: v for k, v in section.items()
                             if v is not None}
    # ingress plane (docs/ingress.md): admission vs shed volume, the
    # queue-depth and queue-wait distributions an overloaded front door
    # shows first, the auth batch-size histogram the amortization claim
    # rides on, per-client fairness spread, and where the admission
    # controller's knobs ended up
    adm = folds.get("ingress.admitted", {})
    if adm.get("count") or folds.get("ingress.shed", {}).get("count"):
        section = {
            "admitted": int(s("ingress.admitted")),
            "shed": int(s("ingress.shed")),
            "auth_failed": int(s("ingress.auth_fail")),
            "active_clients_last": last("ingress.clients"),
        }
        for metric, label, scale in (
                ("ingress.queue_depth", "queue_depth", 1.0),
                ("ingress.queue_wait", "queue_wait_ms", 1000.0),
                ("ingress.auth_batch", "auth_batch", 1.0)):
            f = folds.get(metric, {})
            samples = f.get("samples")
            if samples:
                section[f"{label}_p50"] = round(
                    percentile(samples, 0.5) * scale, 2)
                section[f"{label}_p95"] = round(
                    percentile(samples, 0.95) * scale, 2)
            elif f.get("mean") is not None:
                section[f"{label}_mean"] = round(f["mean"] * scale, 2)
        ab = folds.get("ingress.auth_batch", {})
        if ab.get("count"):
            section["auth_batches"] = int(ab["count"])
            section["auth_batch_mean"] = round(ab["mean"], 1)
        fs = folds.get("ingress.fairness_spread", {})
        if fs.get("mean") is not None:
            # 1.0 = perfectly even per-batch split across active clients
            section["fairness_spread_mean"] = round(fs["mean"], 2)
            section["fairness_spread_max"] = round(fs.get("max") or 0, 2)
        ctl = folds.get("ingress_ctl.admit_max", {})
        if ctl.get("last") is not None:
            section["controller"] = {
                "admit_max": int(ctl["last"]),
                "watermark": int(
                    folds.get("ingress_ctl.watermark", {}).get("last")
                    or 0),
                "decisions": int(cum("ingress_ctl.decisions") or 0),
            }
        out["ingress"] = {k: v for k, v in section.items()
                          if v is not None}
    # sharding plane (docs/sharding.md): routing volume + per-shard
    # ordering, the cross-shard read ledger (attempts, verified OKs,
    # mapping-proof failures — a rising failure count is the operator's
    # forged/stale-map alarm), and the client-side composed-verification
    # p50/p95 (mapping inclusion + directory pairing + shard anchor)
    sr = folds.get("shards.routed", {})
    if sr.get("count") or folds.get("shards.cross_reads", {}).get("count"):
        section = {
            "routed": int(s("shards.routed")),
            "unroutable": int(s("shards.unroutable")),
            "cross_shard_reads": int(s("shards.cross_reads")),
            "cross_shard_reads_ok": int(s("shards.cross_reads_ok")),
            "map_proof_failures": int(s("shards.map_proof_failures")),
        }
        ob = folds.get("shards.ordered_batches", {})
        if ob.get("count"):
            # one event per shard per snapshot, value = that shard's
            # newly ordered txns since the previous snapshot: sum is
            # the exact total ordered, mean the mean per-shard
            # increment, max the busiest shard's single-poll burst
            section["ordered_total"] = int(ob.get("sum") or 0)
            section["ordered_per_shard_mean"] = round(ob["mean"], 1)
            section["ordered_per_shard_max"] = ob.get("max")
        cv = folds.get("shards.cross_verify_time", {})
        if cv.get("samples"):
            section["cross_verify_ms_p50"] = _ms(
                percentile(cv["samples"], 0.5))
            section["cross_verify_ms_p95"] = _ms(
                percentile(cv["samples"], 0.95))
        elif cv.get("mean") is not None:
            section["cross_verify_ms_mean"] = _ms(cv["mean"])
        # elastic resharding + cross-shard write 2PC (shards/reshard.py,
        # shards/cross_write.py): migration volume, the copy cursor's
        # replays, handoff forwards, fail-closed stale NACKs, the front
        # door's dead-shard fast-NACKs, and the 2PC outcome ledger —
        # zero half-commits is the invariant, so aborts are a first-
        # class figure, not a failure smell
        for key, name in (("reshard_migrations", "shards.reshard_migrations"),
                          ("reshard_copied", "shards.reshard_copied"),
                          ("reshard_forwarded", "shards.reshard_forwarded"),
                          ("reshard_stale_nacks",
                           "shards.reshard_stale_nacks"),
                          ("fast_nacked", "shards.fast_nacks"),
                          ("cross_writes", "shards.xsw_begun"),
                          ("cross_write_commits", "shards.xsw_commits"),
                          ("cross_write_aborts", "shards.xsw_aborts")):
            if folds.get(name, {}).get("count"):
                section[key] = int(s(name))
        out["shards"] = {k: v for k, v in section.items()
                         if v is not None}
    # observer read fan-out: push intake + anchor verification verdicts
    # and the stale-suppression count (proofless escalations to the pool)
    if folds.get("observer.pushes", {}).get("count"):
        out["observer_reads"] = {
            "pushes": int(s("observer.pushes")),
            "ms_adopted": int(s("observer.ms_adopted")),
            "ms_rejected": int(s("observer.ms_rejected")),
            "stale_suppressed": int(s("observer.stale_suppressed")),
        }
    # view-change robustness (docs/robustness.md "Degraded WAN and
    # membership churn"): whole-episode durations p50/p95 + the phase
    # decomposition — a churn regression must read as a p95 shift here,
    # not as an anecdote in a fuzz log
    vcd = folds.get("view_change.duration", {})
    if vcd.get("count"):
        section = {"episodes": int(vcd["count"])}
        if vcd.get("samples"):
            section["duration_s_p50"] = round(
                percentile(vcd["samples"], 0.5), 2)
            section["duration_s_p95"] = round(
                percentile(vcd["samples"], 0.95), 2)
        elif vcd.get("mean") is not None:
            section["duration_s_mean"] = round(vcd["mean"], 2)
        for phase, label in (
                ("consensus.vc_detect_to_vote", "detect_to_vote_s"),
                ("consensus.vc_vote_to_start", "vote_to_start_s"),
                ("consensus.vc_start_to_new_view", "start_to_new_view_s"),
                ("consensus.vc_new_view_to_order", "new_view_to_order_s")):
            f = folds.get(phase, {})
            if f.get("mean") is not None:
                section[label] = round(f["mean"], 2)
        out["view_change"] = section
    # catchup robustness: durations/rounds p50/p95 plus the watchdog's
    # provider switches and kicks, and the terminal degraded flag
    cd = folds.get("catchup.duration", {})
    if cd.get("count") or "catchup.watchdog_kicks" in folds:
        section = {"completed": int(cd.get("count") or 0)}
        if cd.get("samples"):
            section["duration_s_p50"] = round(
                percentile(cd["samples"], 0.5), 2)
            section["duration_s_p95"] = round(
                percentile(cd["samples"], 0.95), 2)
        elif cd.get("mean") is not None:
            section["duration_s_mean"] = round(cd["mean"], 2)
        rounds = folds.get("catchup.rounds", {})
        if rounds.get("samples"):
            section["request_rounds_p95"] = round(
                percentile(rounds["samples"], 0.95), 1)
        elif rounds.get("mean") is not None:
            section["request_rounds_mean"] = round(rounds["mean"], 1)
        section["provider_switches"] = int(
            s("catchup.provider_switches"))
        section["watchdog_kicks"] = int(s("catchup.watchdog_kicks"))
        if folds.get("catchup.degraded", {}).get("max"):
            section["read_only_degraded"] = True
        out["catchup"] = {k: v for k, v in section.items()
                          if v is not None}
    # membership churn: registry-change volume, the validator-count
    # trajectory, and BLS key rotations (each one evicts the old key
    # from the crypto planes' key tables)
    mc = folds.get("membership.pool_changes", {})
    if mc.get("count"):
        vals = folds.get("membership.validators", {})
        out["membership"] = {
            "pool_changes": int(s("membership.pool_changes")),
            "validators_last": int(vals["last"])
            if vals.get("last") is not None else None,
            "validators_min": int(vals["min"])
            if vals.get("min") is not None else None,
            "validators_max": int(vals["max"])
            if vals.get("max") is not None else None,
            "key_rotations": int(s("membership.key_rotations")),
        }
        out["membership"] = {k: v for k, v in out["membership"].items()
                             if v is not None}
    return {k: v for k, v in out.items() if v is not None}


def _ms(v):
    return round(v * 1000, 2) if v is not None else None


def report_node(path: str, last_s: float | None):
    rows = read_store(path)
    if last_s and rows:
        cutoff = rows[-1][0] - last_s
        rows = [r for r in rows if r[0] >= cutoff]
    folds = fold_rows(rows)
    span = (rows[-1][0] - rows[0][0]) if len(rows) > 1 else 0.0
    return folds, derive_summary(folds, span, windowed=last_s is not None)


def _print_table(folds: dict[str, dict]) -> None:
    hdr = f"{'metric':42} {'count':>8} {'mean':>12} {'min':>10} {'max':>10}"
    print(hdr)
    print("-" * len(hdr))
    for name in sorted(folds):
        a = folds[name]
        fmt = lambda v: f"{v:.4g}" if isinstance(v, (int, float)) else "-"
        print(f"{name:42} {a['count']:>8} {fmt(a['mean']):>12}"
              f" {fmt(a['min']):>10} {fmt(a['max']):>10}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("base_dir")
    ap.add_argument("--node", default=None,
                    help="single node name (default: all found)")
    ap.add_argument("--last", type=float, default=None, metavar="SECONDS",
                    help="only the trailing window")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.node:
        paths = [os.path.join(args.base_dir, args.node, "metrics")]
    else:
        paths = sorted(glob.glob(os.path.join(args.base_dir, "*", "metrics")))
    paths = [p for p in paths if os.path.isdir(p)]
    if not paths:
        print(json.dumps({"error": f"no metrics stores under {args.base_dir}"}))
        return 1

    all_out = {}
    per_node_folds: dict[str, dict] = {}
    for p in paths:
        name = os.path.basename(os.path.dirname(p))
        folds, summary = report_node(p, args.last)
        per_node_folds[name] = folds
        all_out[name] = {"summary": summary,
                         "metrics": {k: {kk: vv for kk, vv in v.items()
                                         if kk in ("count", "mean", "min",
                                                   "max", "last")}
                                     for k, v in folds.items()}}
        if not args.json:
            print(f"\n=== {name} ===")
            _print_table(folds)
            print("\nderived:", json.dumps(summary, indent=2))
    if len(per_node_folds) > 1:
        # pool-wide summary over MERGED folds: counts are fleet totals
        # (sums across nodes) and percentiles come from the union of the
        # nodes' sampled reservoirs — never from averaging per-node
        # percentiles (merge_node_folds)
        pool = pool_summary(per_node_folds)
        all_out["_pool"] = {"summary": pool}
        if not args.json:
            print(f"\n=== pool ({pool['nodes']} nodes, merged) ===")
            print(json.dumps(pool, indent=2))
    if args.json:
        print(json.dumps(all_out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
