"""The per-second record of the window: aligned columns, rates of the
driver's counters, garbage collections counted."""
import gc
import itertools
import statistics
import time

from benchmark.harness.telemetry import Sampler


def test_series_columns_align_and_probe_counters_become_rates():
    count = itertools.count()
    s = Sampler(lambda: {"batches": next(count) * 10}, period_s=0.05)
    t0 = time.time()
    s.start()
    time.sleep(0.4)
    gc.collect()
    time.sleep(0.1)
    s.stop()
    cols = s.series(t0, time.time())
    n = len(cols["proc_cores"])
    assert n >= 5
    assert all(len(v) == n for v in cols.values())
    # ten a sample, a sample about every 0.05 s
    assert all(r > 0 for r in cols["batches"])
    assert 100 <= statistics.median(cols["batches"]) <= 210
    assert "cores:MainThread" in cols
    assert sum(cols["gc2_ms"]) > 0
    assert s.series(time.time() + 1, time.time() + 2) == {}
