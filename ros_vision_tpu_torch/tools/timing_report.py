#!/usr/bin/env python
"""Timing report: per-frame CSV -> stats + percentiles + plots + markdown.

Parity with the reference's vision_utils/timing_report.py:10-114: consumes
the measurement-mode CSV (runtime/timing.py columns, same schema as
apriltags_cuda_detector.cu:584-586), prints min/max/mean/std and P95/P99,
writes a markdown report and line/histogram/CDF plots. The port's own copy
of ros_vision_tpu/tools/timing_report.py.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load_csv(path: str):
    import pandas as pd
    return pd.read_csv(path)


def column_stats(series) -> dict:
    v = np.asarray(series, np.float64)
    v = v[np.isfinite(v)]
    if len(v) == 0:
        return {}
    return {
        "count": int(len(v)), "min": float(v.min()), "max": float(v.max()),
        "mean": float(v.mean()), "std": float(v.std()),
        "p50": float(np.percentile(v, 50)),
        "p95": float(np.percentile(v, 95)),
        "p99": float(np.percentile(v, 99)),
    }


def make_report(csv_path: str, out_dir: str | None = None,
                plots: bool = True) -> str:
    df = load_csv(csv_path)
    out_dir = out_dir or os.path.dirname(os.path.abspath(csv_path))
    os.makedirs(out_dir, exist_ok=True)
    cols = [c for c in df.columns if c.endswith("_us")]
    lines = [f"# Timing report — {os.path.basename(csv_path)}", "",
             f"Frames: {len(df)}", "",
             "| metric | min | mean | std | p50 | p95 | p99 | max |",
             "|---|---|---|---|---|---|---|---|"]
    for c in cols:
        s = column_stats(df[c])
        if not s:
            continue
        lines.append(
            f"| {c} | {s['min']:.0f} | {s['mean']:.0f} | {s['std']:.0f} | "
            f"{s['p50']:.0f} | {s['p95']:.0f} | {s['p99']:.0f} | "
            f"{s['max']:.0f} |")
    report = "\n".join(lines) + "\n"
    md_path = os.path.join(out_dir, "timing_report.md")
    with open(md_path, "w") as f:
        f.write(report)

    if plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for kind in ("line", "hist", "cdf"):
            fig, ax = plt.subplots(figsize=(10, 5))
            for c in cols:
                v = np.asarray(df[c], np.float64)
                v = v[np.isfinite(v)]
                if kind == "line":
                    ax.plot(v, label=c, lw=0.7)
                elif kind == "hist":
                    ax.hist(v, bins=60, alpha=0.5, label=c)
                else:
                    sv = np.sort(v)
                    ax.plot(sv, np.linspace(0, 1, len(sv)), label=c)
            ax.legend(fontsize=7)
            ax.set_title(f"timing {kind}")
            ax.set_xlabel("frame" if kind == "line" else "us")
            fig.savefig(os.path.join(out_dir, f"timing_{kind}.png"),
                        dpi=110)
            plt.close(fig)
    return md_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv")
    ap.add_argument("--out-dir")
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args(argv)
    md = make_report(args.csv, args.out_dir, plots=not args.no_plots)
    with open(md) as f:
        print(f.read())


if __name__ == "__main__":
    main()
