"""A second-by-second record of what the process was doing during the
window, for the run's notes (never for a metric): its CPU time and its
threads' by name (/proc/self/task), the interpreter's garbage collections
and the time they took, and the rates of whatever counters a driver's
`probe` returns (the loop's own). A run whose rate changes mid-window
shows here which of these changed with it.

One thread that wakes once a second; Linux /proc only (elsewhere the
threads' columns are left out). The host's own CPU counters are not read:
in the sandboxed machines that hold the cards /proc/stat reads zero.
"""
from __future__ import annotations

import gc
import os
import threading
import time

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _threads_cpu():
    """{thread name: CPU jiffies} of this process's Python threads (the
    interpreter's names; other threads are the process's rest)."""
    out = {}
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                s = f.read()
        except (OSError, TypeError):
            continue
        fields = s[s.rindex(")") + 2:].split()
        out[t.name] = out.get(t.name, 0) + int(fields[11]) + int(fields[12])
    return out


class Sampler:
    def __init__(self, probe=None, period_s: float = 1.0):
        self.probe = probe
        self.period_s = period_s
        self.rows = []
        self._gc_ms = [0.0, 0.0, 0.0]
        self._gc_n = [0, 0, 0]
        self._gc_t = None
        self._stop = threading.Event()
        self._thread = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            g = info.get("generation", 0)
            self._gc_ms[g] += (time.perf_counter() - self._gc_t) * 1e3
            self._gc_n[g] += 1
            self._gc_t = None

    def _snap(self):
        return {"t": time.time(), "proc": os.times()[:2], "threads": _threads_cpu(),
                "gc_ms": list(self._gc_ms), "gc_n": list(self._gc_n),
                "probe": self.probe() if self.probe else {}}

    def start(self) -> None:
        gc.callbacks.append(self._on_gc)
        self._thread = threading.Thread(target=self._run, name="telemetry",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def _run(self) -> None:
        prev = self._snap()
        while not self._stop.wait(self.period_s):
            cur = self._snap()
            self.rows.append(_delta(prev, cur))
            prev = cur

    def series(self, t0: float, t1: float) -> dict:
        """The seconds that ended inside [t0, t1], as one list a column."""
        rows = [r for r in self.rows if t0 < r["t"] <= t1]
        keys = sorted({k for r in rows for k in r} - {"t"})
        return {k: [r.get(k) for r in rows] for k in keys}


def _delta(a, b) -> dict:
    dt = b["t"] - a["t"]
    row = {"t": b["t"]}
    row["proc_cores"] = round((sum(b["proc"]) - sum(a["proc"])) / dt, 2)
    for name, v in b["threads"].items():
        d = (v - a["threads"].get(name, 0)) / _TICK / dt
        row[f"cores:{name}"] = round(d, 2)
    row["gc2_ms"] = round(b["gc_ms"][2] - a["gc_ms"][2], 2)
    row["gc_ms"] = round(sum(b["gc_ms"]) - sum(a["gc_ms"]), 2)
    pa, pb = a["probe"], b["probe"]
    for k, v in pb.items():
        if isinstance(v, (int, float)) and isinstance(pa.get(k), (int,
                                                                  float)):
            row[k] = round((v - pa[k]) / dt, 2)
    return row
