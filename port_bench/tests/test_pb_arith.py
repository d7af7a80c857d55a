"""The arithmetic: rates, percentiles, the trace's reduction."""
import pytest

from port_bench import device, stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(1500, 30.0) == 50.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_nearest_rank_over_every_sample():
    samples = list(range(1, 101))            # 1..100
    assert stats.percentile(samples, 95) == 95
    assert stats.percentile(reversed(samples), 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    # 20 samples: the 19th smallest, not an interpolation
    assert stats.percentile(list(range(20)), 95) == 18
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_counts_overlap_once():
    assert stats.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_seconds([]) == 0


def test_trace_reading_busy_gaps_and_labels():
    # device work 10-20 and 15-30 (overlapping) and 60-70, inside a window
    # 0-100 (us); the host was in "prod" over 30-60 and "feed" before
    device_ops = [("k_a", 10, 20), ("k_b", 15, 30), ("Memcpy HtoD", 60, 70),
                  ("k_a", 95, 120)]
    host = [("feed", 0, 10), ("prod", 30, 60), ("replies", 70, 95)]
    r = device.reading(device_ops, host, 0, 100, 123.0)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)   # 10-30, 60-70, 95-100
    assert r["device_s_by_name"]["k_a"] == pytest.approx(15e-6)
    assert [g[0] for g in r["idle_gaps"]] == ["prod", "replies", "feed"]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx(
        [30e-6, 25e-6, 10e-6])


def test_trace_reading_without_host_spans():
    r = device.reading([("k", 0, 10)], [], None, None, 2.0)
    assert r["window_s"] == 2.0 and r["busy_s"] == pytest.approx(1e-5)
    assert r["idle_gaps"] == []

