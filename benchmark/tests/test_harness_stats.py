"""The end-to-end arithmetic over every frame of the window."""
import numpy as np
import pytest

from benchmark.harness import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    x = np.random.default_rng(1).exponential(30.0, size=1001)
    assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q))


def test_rate_and_tails_over_all_frames_in_the_window():
    # 100 frames a second for 10 s, 20 ms each; two outside the window
    recs = [(t / 100, t / 100 + 0.020) for t in range(1000)]
    recs += [(-1.0, -0.5), (11.0, 11.5)]
    m = stats.window_metrics(recs, 0.015, 10.015)
    assert m["frames"] == 1000
    assert m["frames_per_s"] == pytest.approx(100.0)
    assert m["latency_p50_ms"] == pytest.approx(20.0)
    assert m["latency_p95_ms"] == pytest.approx(20.0)


def test_a_stall_moves_p95_and_not_p50():
    recs = [(t / 100, t / 100 + 0.020) for t in range(1000)]
    base = stats.window_metrics(recs, 0.0, 10.0)
    # a 1 s stall: the frames due in it wait for its end
    stalled = [(s, max(r, 6.0) if 5.0 <= s < 6.0 else r)
               for s, r in recs]
    m = stats.window_metrics(stalled, 0.0, 10.0)
    assert m["latency_p95_ms"] > 5 * base["latency_p95_ms"]
    assert m["latency_p50_ms"] == pytest.approx(base["latency_p50_ms"])


def test_no_frame_in_the_window_raises():
    with pytest.raises(RuntimeError):
        stats.window_metrics([(0.0, 20.0)], 0.0, 10.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([10, 10, 10, 10]) == 0
    x = [9.0, 10.0, 10.0, 11.0, 12.0, 10.5]
    import statistics
    q1, _, q3 = statistics.quantiles(x, n=4)
    assert stats.spread(x) == pytest.approx((q3 - q1) / statistics.median(x))
