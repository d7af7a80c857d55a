"""Pool soak: sustained write load with memory/GC telemetry.

Answers the question the reference's gc_trackers exist for
(common/gc_trackers.py + node.py:180,2283): does a pool under sustained
load leak? Runs the in-process 4-node pool (full authN -> propagate ->
3PC+BLS -> execute pipeline) in WAVES of NYM writes for --seconds, sampling
RSS / gc-tracked objects / gc pause time between waves via the same
sample_process_gauges the node flushes (common/metrics.py), and prints one
JSON summary: per-wave TPS + rss trajectory + first/last deltas.

Bounded-growth is judged by the shared history-plane primitive
(observability/history.py GrowthWatch): the per-wave rss/gc samples
feed a windowed linear fit per gauge, and ``growth_verdicts`` in the
summary says bounded / growing / insufficient — the same verdict rule
the fleet aggregator pages through, instead of a hand-rolled
first-vs-last delta.

    python -m plenum_tpu_torch.tools.soak --seconds 600 [--wave 200] \
        [--backend cuda|cpu|torch]
"""
from __future__ import annotations

import argparse
import json
import time


def run_soak(seconds: float = 600.0, wave: int = 200,
             n_nodes: int = 4, backend: str = "cuda") -> dict:
    from plenum_tpu_torch.common.metrics import (MetricsCollector, MetricsName,
                                           sample_process_gauges)
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.observability.history import GrowthWatch
    from plenum_tpu_torch.tools.local_pool import build_pool

    (names, nodes, timer, trustee,
     replies, Reply, DOMAIN_LEDGER_ID, plane, net) = build_pool(n_nodes, backend)

    # rss/gc-tracked trends judged by the shared growth-verdict rule;
    # cumulative counters (gc pause, gen2 count) grow by design and are
    # reported, not judged
    watch = GrowthWatch(window=max(60.0, seconds), min_points=5,
                        floors={"rss_mb": 64.0, "gc_tracked": 200_000.0})
    t_start = time.perf_counter()

    def sample() -> dict:
        c = MetricsCollector()
        sample_process_gauges(c)
        s = c.summary()
        out = _fold_sample(s, MetricsName)
        t = time.perf_counter() - t_start
        for gauge in ("rss_mb", "gc_tracked"):
            if out.get(gauge) is not None:
                watch.note(gauge, t, out[gauge])
        return out

    def _fold_sample(s, MetricsName) -> dict:
        return {
            "rss_mb": round(
                s[MetricsName.PROCESS_RSS_BYTES]["max"] / 2**20, 1)
            if MetricsName.PROCESS_RSS_BYTES in s else None,
            "gc_tracked": s[MetricsName.GC_TRACKED_OBJECTS]["max"],
            "gc_pause_s": round(s[MetricsName.GC_PAUSE_TIME]["max"], 3),
            "gc_gen2": s.get(MetricsName.GC_GEN2_COLLECTIONS,
                             {"max": 0})["max"],
        }

    t_end = time.perf_counter() + seconds
    waves = []
    samples = [sample()]
    req_no = 0
    wave_no = 0
    while time.perf_counter() < t_end:
        reqs = []
        for _ in range(wave):
            req_no += 1
            user = Ed25519Signer(
                seed=(b"soak%08d" % req_no).ljust(32, b"\0")[:32])
            req = Request(trustee.identifier, req_no,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            req.signature = trustee.sign_b58(req.signing_bytes())
            reqs.append(req)
        t0 = time.perf_counter()
        done = set()
        i = 0
        while len(done) < len(reqs) and time.perf_counter() < t0 + 120:
            while i < len(reqs) and i - len(done) < 256:
                for n in names:
                    nodes[n].handle_client_message(reqs[i].to_dict(), "soak")
                i += 1
            timer.service()
            for node in nodes.values():
                node.prod()
            if plane is not None:
                plane.flush()
            for _, msg, _c in replies[names[0]]:
                if isinstance(msg, Reply):
                    d = msg.result.get("txn", {}).get("metadata", {}) \
                        .get("digest")
                    if d:
                        done.add(d)
            replies[names[0]].clear()
        dt = time.perf_counter() - t0
        wave_no += 1
        waves.append({"wave": wave_no, "ordered": len(done),
                      "tps": round(len(done) / dt, 1) if dt else 0.0})
        samples.append(sample())
        for n in names:
            replies[n].clear()

    first, last = samples[0], samples[-1]
    ledger_sizes = {nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                    for n in names}
    return {
        "seconds": seconds, "waves": len(waves), "wave_size": wave,
        "txns_total": sum(w["ordered"] for w in waves),
        "tps_first_wave": waves[0]["tps"] if waves else None,
        "tps_last_wave": waves[-1]["tps"] if waves else None,
        "rss_mb_start": first["rss_mb"], "rss_mb_end": last["rss_mb"],
        "rss_mb_growth": round((last["rss_mb"] or 0) - (first["rss_mb"] or 0), 1),
        "gc_pause_s_total": last["gc_pause_s"],
        "gc_gen2_collections": last["gc_gen2"],
        "ledgers_agree": len(ledger_sizes) == 1,
        "samples": samples[:: max(1, len(samples) // 10)],
        "growth_verdicts": watch.verdicts(),
        "growth_ok": not any(v.get("verdict") == "growing"
                             for v in watch.verdicts().values()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--wave", type=int, default=200)
    ap.add_argument("--backend", default="cuda",
                    choices=["cpu", "cuda", "torch"])
    args = ap.parse_args(argv)
    print(json.dumps(run_soak(args.seconds, args.wave,
                              backend=args.backend)))


if __name__ == "__main__":
    main()
