#!/usr/bin/env python3
"""Where the device time of K10 table_take_cm and K11 segment_min_max
goes, launch by launch, beside the launch floor, on one CUDA card: an
entry of scripts/mb_torch_phases.py, which says how each ROOT is run.

    python3 scripts/mb_torch_gather_phases.py [ROOT ...]

The inputs are those scripts/mb_torch_kernel_versions.py gather_inputs
makes: K10's (4, 1025, 4) table and (4, 32768) segment ids at 1280x800,
K11's (4, 131072) sorted segment ids and y coordinates at 1920x1080 and
its random ids and values, and K4 on K11's sorted ids (1025 bins). Each
root's K11 is also timed by phase from a -DRVT_SEGMENT_PHASE_CLOCKS build
of its csrc/segment.cu: the tables' start, the points, the push to the
owners' tables (after the wait for the peers' starts, where the kernel
has one), the cluster.sync(), the owners' stores.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mb_torch_phases as phases  # noqa: E402

ENTRY = phases.Entry(
    name="mb_torch_gather_phases",
    inputs=lambda versions, cs, dev: versions.gather_inputs(cs, dev),
    calls=lambda versions, kernel, xs: versions.gather_calls(kernel, xs),
    source="segment.cu",
    clock_flag="RVT_SEGMENT_PHASE_CLOCKS",
    clock_export="rvt_segment_clocks",
    phases=("tables", "points", "push", "cluster_sync", "stores"),
    clocked=("segment_min_max",),
    floor=True)

if __name__ == "__main__":
    sys.exit(phases.main(ENTRY, __file__, sys.argv[1:]))
