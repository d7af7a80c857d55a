"""The cases of tests/test_resilience.py that touch the port's TCP stack
and metrics_report, run on plenum_tpu_torch: the jittered dial backoff
(also held to the reference's schedule for the same dialer and peer) and
the churn sections of the derived summary. The sim-pool churn and
catchup cases wait for the modules they drive (ROADMAP A8)."""
from __future__ import annotations


def test_tcp_dial_backoff_is_the_jittered_one():
    """The reconnect-stampede fix: two dialers' retry schedules differ,
    both bounded by RETRY_MIN doubling to RETRY_MAX."""
    from plenum_tpu_torch.network import tcp_stack
    a = tcp_stack._retry_backoff("Alpha", "Beta")
    g = tcp_stack._retry_backoff("Gamma", "Beta")
    seq_a = [a.next() for _ in range(6)]
    seq_g = [g.next() for _ in range(6)]
    assert seq_a != seq_g
    for k, d in enumerate(seq_a):
        raw = min(tcp_stack.RETRY_MIN * 2 ** k, tcp_stack.RETRY_MAX)
        assert (1 - tcp_stack.RETRY_JITTER) * raw - 1e-9 <= d <= raw + 1e-9


def test_tcp_dial_backoff_replays_the_references():
    """_retry_backoff salts its jitter with the dialer and the peer: the
    port's schedule for each pair is the reference's, delay for delay."""
    from plenum_tpu.network import tcp_stack as ref
    from plenum_tpu_torch.network import tcp_stack
    for dialer, peer in (("Alpha", "Beta"), ("Node1", "Node4")):
        ours = tcp_stack._retry_backoff(dialer, peer)
        theirs = ref._retry_backoff(dialer, peer)
        assert [ours.next() for _ in range(10)] == \
            [theirs.next() for _ in range(10)]
    assert (tcp_stack.RETRY_MIN, tcp_stack.RETRY_MAX,
            tcp_stack.RETRY_JITTER) == (ref.RETRY_MIN, ref.RETRY_MAX,
                                        ref.RETRY_JITTER)


def test_metrics_report_churn_sections():
    from plenum_tpu_torch.tools.metrics_report import derive_summary

    def fold(count=1, total=0.0, samples=None, last=None, mn=None, mx=None):
        return {"count": count, "sum": total, "mean":
                (total / count) if count else None, "min": mn, "max": mx,
                "last": last, "flushes": 1,
                **({"samples": samples} if samples else {})}

    folds = {
        "view_change.duration": fold(3, 6.0, samples=[1.0, 2.0, 3.0]),
        "consensus.vc_detect_to_vote": fold(3, 1.5),
        "catchup.duration": fold(2, 9.0, samples=[4.0, 5.0]),
        "catchup.rounds": fold(2, 7.0, samples=[3.0, 4.0]),
        "catchup.provider_switches": fold(1, 2.0),
        "catchup.watchdog_kicks": fold(4, 4.0),
        "catchup.degraded": fold(1, 1.0, mx=1.0),
        "membership.pool_changes": fold(5, 5.0),
        "membership.validators": fold(5, 23.0, last=5.0, mn=4.0, mx=5.0),
        "membership.key_rotations": fold(2, 2.0),
    }
    out = derive_summary(folds, span_s=100.0)
    vc = out["view_change"]
    assert vc["episodes"] == 3
    assert vc["duration_s_p50"] == 2.0 and vc["duration_s_p95"] == 3.0
    assert vc["detect_to_vote_s"] == 0.5
    cu = out["catchup"]
    assert cu["completed"] == 2 and cu["duration_s_p95"] == 5.0
    assert cu["provider_switches"] == 2 and cu["watchdog_kicks"] == 4
    assert cu["read_only_degraded"] is True
    mem = out["membership"]
    assert mem == {"pool_changes": 5, "validators_last": 5,
                   "validators_min": 4, "validators_max": 5,
                   "key_rotations": 2}
