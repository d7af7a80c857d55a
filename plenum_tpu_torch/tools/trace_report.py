"""Assemble per-node flight-recorder dumps into request latency waterfalls
and pool-level critical-path attribution.

Input: one or more JSON dumps written by `common/tracing.Tracer.dump`
(one per node — a sim pool snapshots in-process, a TCP pool's nodes write
`<base>/<name>/<name>-flight-N.json` automatically on anomalies). Each
dump is a bounded ring of `(t, stage, key, data)` span events stamped on
that node's monotonic clock, plus the clock anchors this module uses to
put every node on ONE timeline:

  * `clock_domain == "shared"` (in-process sim): all nodes read the same
    timer — alignment is the identity.
  * `clock_domain == "wall"` (TCP pool, one perf_counter epoch per
    process): the (mono_anchor, wall_anchor) pair maps each node's times
    onto the wall clock, then a CAUSALITY refinement tightens residual
    skew — a PRE-PREPARE cannot be received before the primary sent it,
    so any negative pp_sent→pp_recv gap shifts the receiver's offset.

Per-request waterfall (stages telescope: their sum equals reply−ingress):

  crypto     ingress -> signature verdict        (auth queue + dispatch)
  propagate  verdict -> f+1 propagate quorum
  queue      quorum  -> batch PRE-PREPARE        (ordering queue wait)
  ordering   PRE-PREPARE -> commit quorum        (3PC: prepare+commit)
  durable    ordered -> group-commit flush
  reply      flush   -> REPLY sent

Pool-level attribution adds `network` (pp_sent on the primary to pp_recv
on each replica, aligned) and the wall-clock `apply`/`durable` stage
durations the events carry, and prints p50/p95 per stage.

    python -m plenum_tpu_torch.tools.trace_report DIR_OR_DUMPS... [--json]
        [--request DIGEST] [--last-n 5]
    python -m plenum_tpu_torch.tools.trace_report --check      # self-test smoke
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional

from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import percentile

# waterfall stage names, in pipeline order, with their span endpoints.
# front_door only exists for requests that entered through the ingress
# plane (ing_admit -> the node-pipeline ingress point: client queue wait
# + the batched auth dispatch); requests hitting the node directly have
# no ing_admit point and the stage folds away — totals stay exact.
_WATERFALL = (
    ("front_door", tracing.ING_ADMIT, tracing.INGRESS),
    ("crypto", tracing.INGRESS, tracing.AUTH),
    ("propagate", tracing.AUTH, tracing.PROPAGATE_QUORUM),
    ("queue", tracing.PROPAGATE_QUORUM, "pp"),
    ("ordering", "pp", tracing.ORDERED),
    ("durable", tracing.ORDERED, tracing.DURABLE),
    ("reply", tracing.DURABLE, tracing.REPLY),
)


def load_dumps(paths) -> list[dict]:
    """Dump files / directories -> the LATEST dump per node (a node that
    auto-dumped on several anomalies leaves a numbered series; the last
    one holds the freshest ring)."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*flight*.json")))
                         or sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            files.append(p)
    latest: dict[str, dict] = {}
    for f in files:
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(d, dict) or "events" not in d:
            continue
        prev = latest.get(d.get("node", "?"))
        if prev is None or d.get("dumped_at", 0) >= prev.get("dumped_at", 0):
            latest[d.get("node", "?")] = d
    return list(latest.values())


def align_offsets(dumps: list[dict]) -> dict[str, float]:
    """Per-node offset added to its event times for one shared timeline:
    wall anchors first, then the causality refinement (receive >= send)."""
    offsets: dict[str, float] = {}
    for d in dumps:
        if (d.get("clock_domain") == "wall"
                and d.get("wall_anchor") is not None):
            offsets[d["node"]] = d["wall_anchor"] - d["mono_anchor"]
        else:
            offsets[d["node"]] = 0.0
    # earliest aligned pp_sent per batch digest (the primary's broadcast)
    sent: dict[str, float] = {}
    for d in dumps:
        off = offsets[d["node"]]
        for t, stage, key, _data in d["events"]:
            if stage == tracing.PP_SENT:
                sent[key] = min(sent.get(key, float("inf")), t + off)
    for d in dumps:
        off = offsets[d["node"]]
        worst = 0.0
        for t, stage, key, _data in d["events"]:
            if stage == tracing.PP_RECV and key in sent:
                worst = min(worst, (t + off) - sent[key])
        if worst < 0.0:
            offsets[d["node"]] = off - worst
    return offsets


class _NodeIndex:
    """One node's events indexed for waterfall lookup (aligned times)."""

    def __init__(self, dump: dict, offset: float):
        self.node = dump["node"]
        # sharded fabrics tag each node's dump with its shard id so the
        # assembled report can attribute waterfalls and hops PER SHARD
        self.shard = (dump.get("tags") or {}).get("shard")
        # router decisions / resolved cross-shard reads seen by this
        # dump's tracer (the fabric tracer, usually)
        self.shard_routes: list[dict] = []
        self.cross_reads: list[dict] = []
        self.first: dict[tuple[str, str], float] = {}
        self.batch_of_req: dict[str, tuple[str, int]] = {}
        self.durable_by_seq: dict[int, float] = {}
        self.stage_durs: dict[str, list[float]] = {}
        self.anomalies: list[tuple[float, str, dict]] = []
        # batch-controller decisions, in order: the control trajectory
        # (knob positions + the stage p95s that moved them)
        self.control: list[tuple[float, dict]] = []
        # fused-pipeline device waves (bucket id, item count, pad waste)
        self.device_waves: list[dict] = []
        for t, stage, key, data in dump["events"]:
            at = t + offset
            self.first.setdefault((stage, key), at)
            if stage == tracing.CONTROLLER:
                self.control.append((at, data or {}))
            if stage in (tracing.PP_SENT, tracing.PP_RECV):
                for req in (data or {}).get("reqs", ()):
                    self.batch_of_req.setdefault(
                        req, (key, (data or {}).get("seq")))
            elif stage == tracing.DURABLE:
                for seq in (data or {}).get("seqs", ()):
                    self.durable_by_seq.setdefault(seq, at)
                if isinstance((data or {}).get("dur"), (int, float)):
                    self.stage_durs.setdefault("durable_wall", []).append(
                        data["dur"])
            elif stage == tracing.APPLY:
                if isinstance((data or {}).get("dur"), (int, float)):
                    self.stage_durs.setdefault("apply_wall", []).append(
                        data["dur"])
            elif stage == tracing.READ_BATCH:
                if isinstance((data or {}).get("proof_dur"), (int, float)):
                    self.stage_durs.setdefault("read_proof_wall",
                                               []).append(data["proof_dur"])
            elif stage == tracing.SHARD_ROUTE:
                self.shard_routes.append(data or {})
            elif stage == tracing.CROSS_SHARD:
                d = data or {}
                self.cross_reads.append(d)
                if isinstance(d.get("dur"), (int, float)):
                    # client-side composed verification + ladder time:
                    # the cross-shard hop as a first-class stage
                    self.stage_durs.setdefault("cross_shard",
                                               []).append(d["dur"])
            elif stage == tracing.DEVICE:
                # fused-pipeline wave: submit->pack->dispatch->collect
                # sub-spans become device_* attribution stages, and the
                # bucket/pad story is summarized per node
                d = data or {}
                for sub in ("queue", "pack", "dispatch"):
                    if isinstance(d.get(sub), (int, float)):
                        self.stage_durs.setdefault(
                            f"device_{sub}", []).append(max(0.0, d[sub]))
                self.device_waves.append(d)
            if stage.startswith(tracing.ANOMALY_PREFIX):
                self.anomalies.append(
                    (at, stage[len(tracing.ANOMALY_PREFIX):], data))

    def request_points(self, digest: str) -> dict[str, Optional[float]]:
        """Timeline points for one request on this node (None = unseen)."""
        batch = self.batch_of_req.get(digest)
        t_pp = t_ord = t_dur = None
        if batch is not None:
            bdigest, seq = batch
            t_pp = min((t for t in (self.first.get((tracing.PP_SENT, bdigest)),
                                    self.first.get((tracing.PP_RECV, bdigest)))
                        if t is not None), default=None)
            t_ord = self.first.get((tracing.ORDERED, bdigest))
            t_dur = self.durable_by_seq.get(seq)
        return {
            tracing.ING_ADMIT: self.first.get((tracing.ING_ADMIT, digest)),
            tracing.INGRESS: self.first.get((tracing.INGRESS, digest)),
            tracing.AUTH: self.first.get((tracing.AUTH, digest)),
            tracing.PROPAGATE_QUORUM:
                self.first.get((tracing.PROPAGATE_QUORUM, digest)),
            "pp": t_pp,
            tracing.ORDERED: t_ord,
            tracing.DURABLE: t_dur,
            tracing.REPLY: self.first.get((tracing.REPLY, digest)),
        }

    def waterfall(self, digest: str) -> Optional[dict]:
        """-> {"stages": {name: seconds}, "total": s, "start": t,
        "end": t} or None when this node saw too little of the request.
        Present consecutive points telescope exactly; a stage whose
        endpoints ran out of order (a replica can admit the PRE-PREPARE
        before its OWN propagate quorum completes) clamps to 0 with the
        slack folded into the surrounding stage — totals stay exact."""
        pts = self.request_points(digest)
        stages: dict[str, float] = {}
        prev_t = None
        for name, frm, to in _WATERFALL:
            t0, t1 = pts.get(frm), pts.get(to)
            if t0 is None and prev_t is not None:
                t0 = prev_t
            if t0 is None or t1 is None:
                continue
            if prev_t is not None:
                # a point earlier than the previous stage's end must not
                # re-count the overlap into this stage — start where the
                # pipeline's covered prefix ends, so stages stay disjoint
                # and the sum telescopes to max(point) - first point
                t0 = max(t0, prev_t)
            stages[name] = max(0.0, t1 - t0)
            prev_t = max(t1, t0)
        if not stages:
            return None
        seen = [t for t in pts.values() if t is not None]
        return {"stages": stages, "total": round(sum(stages.values()), 9),
                "start": min(seen), "end": max(seen)}


def assemble(dumps: list[dict]) -> dict:
    """Cross-node assembly: per-request waterfalls (every node's view of
    every request it traced end to end) + pool attribution inputs."""
    offsets = align_offsets(dumps)
    indexes = [_NodeIndex(d, offsets[d["node"]]) for d in dumps]
    requests: dict[str, dict[str, dict]] = {}
    attribution: dict[str, list[float]] = {}
    for idx in indexes:
        digests = {k for (stage, k) in idx.first
                   if stage == tracing.REPLY and k}
        for digest in digests:
            wf = idx.waterfall(digest)
            if wf is None:
                continue
            requests.setdefault(digest, {})[idx.node] = wf
            for name, dur in wf["stages"].items():
                attribution.setdefault(name, []).append(dur)
        for name, durs in idx.stage_durs.items():
            attribution.setdefault(name, []).extend(durs)
    # network: primary pp_sent -> each replica's pp_recv, aligned
    sent: dict[str, float] = {}
    for idx in indexes:
        for (stage, key), t in idx.first.items():
            if stage == tracing.PP_SENT:
                sent[key] = min(sent.get(key, float("inf")), t)
    for idx in indexes:
        for (stage, key), t in idx.first.items():
            if stage == tracing.PP_RECV and key in sent:
                attribution.setdefault("network", []).append(
                    max(0.0, t - sent[key]))
    anomalies = sorted((a for idx in indexes
                        for a in ((t, idx.node, kind, data)
                                  for t, kind, data in idx.anomalies)))
    controller = {idx.node: idx.control for idx in indexes if idx.control}
    # fused-pipeline device waves: the ring is host-shared, so the
    # last-attached node's tracer holds the full story — merge all
    device = [w for idx in indexes for w in idx.device_waves]
    # sharding plane: group nodes by their dump's shard tag and fold the
    # fabric tracer's routing/cross-read events into one story
    shards: Optional[dict] = None
    by_shard: dict = {}
    for idx in indexes:
        if idx.shard is not None:
            by_shard.setdefault(idx.shard, []).append(idx.node)
    routes = [r for idx in indexes for r in idx.shard_routes]
    cross = [c for idx in indexes for c in idx.cross_reads]
    if by_shard or routes or cross:
        per_shard_routes: dict = {}
        for r in routes:
            sid = r.get("shard")
            per_shard_routes[sid] = per_shard_routes.get(sid, 0) + 1
        shards = {"nodes_by_shard": {str(k): sorted(v)
                                     for k, v in sorted(by_shard.items())},
                  "route_decisions": len(routes),
                  "routes_per_shard": {str(k): v for k, v in
                                       sorted(per_shard_routes.items())},
                  "cross_shard_reads": len(cross),
                  "cross_shard_ok": sum(1 for c in cross if c.get("ok"))}
    return {"nodes": sorted(offsets), "offsets": offsets,
            "requests": requests, "attribution": attribution,
            "anomalies": anomalies, "controller": controller,
            "device": device,
            **({"shards": shards} if shards else {})}


def attribution_summary(report: dict) -> dict:
    """Pool-level critical path: p50/p95 (ms) per stage."""
    out = {}
    for name, durs in sorted(report["attribution"].items()):
        out[name] = {"p50_ms": round(percentile(durs, 0.5) * 1000, 3),
                     "p95_ms": round(percentile(durs, 0.95) * 1000, 3),
                     "n": len(durs)}
    return out


def summarize(report: dict, sample: int = 3) -> dict:
    """Compact summary for the bench line: stage p50/p95 + a few sampled
    waterfalls + how well stage sums cover end-to-end time."""
    attribution = attribution_summary(report)
    sampled = {}
    ratios = []
    for digest, per_node in sorted(report["requests"].items()):
        for node, wf in sorted(per_node.items()):
            span = wf["end"] - wf["start"]
            if span > 0:
                ratios.append(wf["total"] / span)
        if len(sampled) < sample:
            node, wf = sorted(per_node.items())[0]
            sampled[digest[:16]] = {
                "node": node,
                "stages_ms": {k: round(v * 1000, 3)
                              for k, v in wf["stages"].items()},
                "total_ms": round(wf["total"] * 1000, 3)}
    # control trajectory: the steering node's decision count + final knobs
    control = None
    for node, decisions in sorted(report.get("controller", {}).items(),
                                  key=lambda kv: -len(kv[1])):
        control = {"node": node, "decisions": len(decisions),
                   "final": decisions[-1][1]}
        break
    # device waves: bucket histogram + mean pad waste for the bench line
    device = None
    waves = report.get("device") or []
    if waves:
        buckets: dict = {}
        for w in waves:
            buckets[w.get("bucket")] = buckets.get(w.get("bucket"), 0) + 1
        pads = [w["pad"] / w["bucket"] for w in waves
                if w.get("bucket") and isinstance(w.get("pad"), (int, float))]
        device = {"waves": len(waves),
                  "buckets": {str(k): v for k, v in sorted(
                      buckets.items(), key=lambda kv: str(kv[0]))},
                  "pad_waste_mean": round(sum(pads) / len(pads), 3)
                  if pads else None,
                  "mean_coalesced": round(
                      sum(w.get("coalesced", 0) for w in waves)
                      / len(waves), 2)}
    return {
        "requests_traced": len(report["requests"]),
        "attribution": attribution,
        "sampled_waterfalls": sampled,
        # stage sum over observed first->last span: 1.0 = fully attributed
        "stage_sum_ratio_p50": round(percentile(ratios, 0.5), 4)
        if ratios else None,
        "anomalies": len(report["anomalies"]),
        **({"controller": control} if control else {}),
        **({"device": device} if device else {}),
        **({"shards": report["shards"]} if report.get("shards") else {}),
    }


def _print_report(report: dict, last_n: int) -> None:
    print(f"nodes: {', '.join(report['nodes'])}   "
          f"requests traced: {len(report['requests'])}   "
          f"anomalies: {len(report['anomalies'])}")
    print("\ncritical-path attribution (pool, per stage):")
    hdr = f"  {'stage':12} {'p50 ms':>10} {'p95 ms':>10} {'n':>8}"
    print(hdr + "\n  " + "-" * (len(hdr) - 2))
    for name, s in attribution_summary(report).items():
        print(f"  {name:12} {s['p50_ms']:>10} {s['p95_ms']:>10} {s['n']:>8}")
    waves = report.get("device") or []
    if waves:
        n = len(waves)
        pads = [w["pad"] / w["bucket"] for w in waves if w.get("bucket")]
        print(f"\ndevice pipeline: {n} waves, "
              f"mean coalesced {sum(w.get('coalesced', 0) for w in waves) / n:.1f}, "
              f"pad waste {sum(pads) / len(pads):.1%}" if pads else
              f"\ndevice pipeline: {n} waves")
        for w in waves[-last_n:]:
            print(f"  {w.get('kind', '?'):4} bucket={w.get('bucket')} "
                  f"n={w.get('n')} coalesced={w.get('coalesced')} "
                  f"pad={w.get('pad')} queue={1000 * w.get('queue', 0):.2f}ms "
                  f"pack={1000 * w.get('pack', 0):.2f}ms "
                  f"dispatch={1000 * w.get('dispatch', 0):.2f}ms")
    sh = report.get("shards")
    if sh:
        groups = ", ".join(f"shard {k}: {', '.join(v)}"
                           for k, v in sh["nodes_by_shard"].items())
        print(f"\nsharding: {groups or 'no shard-tagged nodes'}")
        print(f"  routes {sh['route_decisions']} "
              f"(per shard {sh['routes_per_shard']}), "
              f"cross-shard reads {sh['cross_shard_reads']} "
              f"({sh['cross_shard_ok']} verified ok)")
    for node, decisions in sorted(report.get("controller", {}).items()):
        print(f"\ncontrol trajectory @{node} ({len(decisions)} decisions):")
        for t, d in decisions[-last_n * 2:]:
            print(f"  {t:.3f} {d.get('verdict', '?'):16} "
                  f"size={d.get('batch_size')} wait={d.get('wait_ms')}ms "
                  f"depth={d.get('depth')} coalesce={d.get('coalesce')} "
                  f"e2e_p95={d.get('e2e_p95_ms')}ms slo={d.get('slo_ms')}ms")
    shown = 0
    for digest, per_node in sorted(report["requests"].items()):
        if shown >= last_n:
            break
        shown += 1
        node, wf = sorted(per_node.items())[0]
        bar = " -> ".join(f"{k} {v * 1000:.2f}ms"
                          for k, v in wf["stages"].items())
        print(f"\n  {digest[:16]}.. @{node}: {bar}"
              f"  (total {wf['total'] * 1000:.2f}ms)")
    if report["anomalies"]:
        print("\nanomaly timeline:")
        for t, node, kind, data in report["anomalies"][-last_n * 4:]:
            print(f"  {t:.3f} {node:10} {kind} {json.dumps(data, default=repr)}")


def _synthetic_dumps() -> list[dict]:
    """Two-node fixture covering every stage, with DIFFERENT wall anchors
    (so --check exercises the alignment path too)."""
    req, batch = "d" * 8, "b" * 8
    primary = {
        "node": "P", "clock_domain": "wall", "tags": {"shard": 0},
        "mono_anchor": 0.0, "wall_anchor": 100.0, "dumped_at": 1.0,
        "anomalies": 0, "events": [
            # sharding plane: a router decision and a resolved verified
            # cross-shard read (dur becomes the cross_shard stage)
            [0.005, tracing.SHARD_ROUTE, req, {"shard": 0, "frm": "cli"}],
            [0.007, tracing.CROSS_SHARD, req,
             {"shard": 1, "ok": True, "dur": 0.002}],
            [0.008, tracing.ING_ADMIT, req, {"frm": "cli"}],
            [0.010, tracing.INGRESS, req, {"frm": "cli"}],
            [0.012, tracing.AUTH, req, {"ok": True}],
            [0.015, tracing.PROPAGATE_QUORUM, req, {"votes": 2}],
            [0.020, tracing.APPLY, "", {"seq": 1, "n": 1, "dur": 0.004}],
            [0.021, tracing.PP_SENT, batch, {"seq": 1, "ledger": 1,
                                             "reqs": [req]}],
            [0.030, tracing.PREPARE_QUORUM, batch, {"seq": 1, "votes": 2}],
            [0.031, tracing.COMMIT_SENT, batch, {"seq": 1}],
            [0.040, tracing.ORDERED, batch, {"seq": 1, "votes": 2}],
            [0.045, tracing.DURABLE, "", {"seqs": [1], "dur": 0.005}],
            [0.046, tracing.REPLY, req, {"seq": 1}],
            # fused-pipeline device wave: the `device` waterfall stage
            # (submit->pack->dispatch->collect spans + bucket/pad story)
            [0.047, tracing.DEVICE, "",
             {"kind": "ed", "bucket": 64, "n": 11, "coalesced": 40,
              "pad": 53, "queue": 0.004, "pack": 0.0005,
              "dispatch": 0.009}],
            # batch-controller decisions: the control trajectory the
            # report must surface next to the waterfalls it steered
            [0.050, tracing.CONTROLLER, "",
             {"verdict": "grow:headroom", "batch_size": 1000,
              "wait_ms": 50.0, "depth": 5, "coalesce": 32,
              "p95_ms": {"queue": 3.0, "ordering": 19.0, "durable": 0.0},
              "e2e_p95_ms": 22.0, "slo_ms": 500.0, "fill": 0.06}],
            [0.055, tracing.CONTROLLER, "",
             {"verdict": "grow:fixed-cost", "batch_size": 1000,
              "wait_ms": 75.0, "depth": 5, "coalesce": 32,
              "p95_ms": {"queue": 3.0, "ordering": 600.0, "durable": 0.0},
              "e2e_p95_ms": 603.0, "slo_ms": 500.0, "fill": 0.06}],
        ]}
    # replica epoch 50s off the primary AND its wall anchor reads 10 ms
    # slow (NTP-grade skew): anchor alignment alone leaves pp_recv BEFORE
    # pp_sent, so --check passes only if the causality refinement runs
    replica = {
        "node": "R", "clock_domain": "wall",
        "mono_anchor": 0.0, "wall_anchor": 149.990, "dumped_at": 1.0,
        "anomalies": 1, "events": [
            [-49.975, tracing.INGRESS, req, {"frm": "cli"}],
            [-49.974, tracing.AUTH, req, {"ok": True}],
            [-49.973, tracing.PROPAGATE_QUORUM, req, {"votes": 2}],
            [-49.972, tracing.PP_RECV, batch, {"seq": 1, "frm": "P",
                                               "reqs": [req]}],
            [-49.960, tracing.ORDERED, batch, {"seq": 1, "votes": 2}],
            [-49.955, tracing.DURABLE, "", {"seqs": [1], "dur": 0.004}],
            [-49.954, tracing.REPLY, req, {"seq": 1}],
            [-49.950, tracing.ANOMALY_PREFIX + "suspicion",
             "", {"code": 1}],
        ]}
    return [primary, replica]


def self_check() -> int:
    """--check: assemble the synthetic fixture and assert the invariants
    the tier-1 smoke rides on. -> process exit code."""
    report = assemble(_synthetic_dumps())
    problems = []
    if set(report["nodes"]) != {"P", "R"}:
        problems.append(f"nodes {report['nodes']}")
    wf = report["requests"].get("d" * 8, {}).get("P")
    if wf is None:
        problems.append("primary waterfall missing")
    else:
        if set(wf["stages"]) != {s for s, _f, _t in _WATERFALL}:
            problems.append(f"stages {sorted(wf['stages'])}")
        span = wf["end"] - wf["start"]
        if abs(wf["total"] - span) > 1e-9:
            problems.append(f"stage sum {wf['total']} != span {span}")
    att = attribution_summary(report)
    for need in ("network", "crypto", "ordering", "durable", "reply",
                 "apply_wall", "device_queue", "device_pack",
                 "device_dispatch", "cross_shard"):
        if need not in att:
            problems.append(f"attribution missing {need}")
    sh = report.get("shards")
    if not sh or sh.get("route_decisions") != 1 \
            or sh.get("cross_shard_ok") != 1 \
            or sh.get("nodes_by_shard", {}).get("0") != ["P"]:
        problems.append(f"shard attribution wrong: {sh}")
    dev = summarize(report).get("device")
    if not dev or dev.get("waves") != 1 or "64" not in dev.get("buckets", {}):
        problems.append(f"device wave summary wrong: {dev}")
    if att.get("network", {}).get("p50_ms", -1) < 0:
        problems.append("causality alignment failed (negative network)")
    if not report["anomalies"]:
        problems.append("anomaly timeline empty")
    ctl = report.get("controller", {}).get("P")
    if not ctl or len(ctl) != 2:
        problems.append(f"controller trajectory missing/short: {ctl}")
    else:
        summary = summarize(report)
        final = summary.get("controller", {}).get("final", {})
        if final.get("verdict") != "grow:fixed-cost":
            problems.append(f"controller final decision wrong: {final}")
    print(json.dumps({"check": "ok" if not problems else "FAIL",
                      "problems": problems,
                      "attribution": att}))
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="dump files or directories holding *flight*.json")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--request", default=None,
                    help="print every node's waterfall for one digest")
    ap.add_argument("--last-n", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="run the built-in assembly self-test and exit")
    args = ap.parse_args(argv)
    if args.check:
        return self_check()
    dumps = load_dumps(args.paths)
    if not dumps:
        print(json.dumps({"error": f"no flight dumps under {args.paths}"}))
        return 1
    report = assemble(dumps)
    if args.request:
        per_node = report["requests"].get(args.request, {})
        print(json.dumps({args.request: per_node}, indent=2, default=repr))
        return 0 if per_node else 1
    if args.json:
        print(json.dumps({"summary": summarize(report),
                          "anomalies": report["anomalies"][-50:]},
                         default=repr))
    else:
        _print_report(report, args.last_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
