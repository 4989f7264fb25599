"""Process/thread scheduling controls (CPU pinning + realtime priority).

Parity with the reference's vision_utils::ProcessScheduler
(process_scheduler.cpp:23-100: pthread_setaffinity_np + SCHED_FIFO). These
knobs pin the HOST frame-pump and publisher threads, which is where jitter
enters the capture->pose latency.
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def set_affinity(cores: list[int], pid: int = 0) -> bool:
    try:
        os.sched_setaffinity(pid, set(cores))
        return True
    except (OSError, AttributeError) as e:
        log.warning("set_affinity(%s) failed: %s", cores, e)
        return False


def set_realtime_priority(priority: int = 80, pid: int = 0) -> bool:
    """SCHED_FIFO at the given priority; requires CAP_SYS_NICE."""
    try:
        os.sched_setscheduler(pid, os.SCHED_FIFO,
                              os.sched_param(priority))
        return True
    except (OSError, AttributeError, PermissionError) as e:
        log.warning("set_realtime_priority(%d) failed: %s", priority, e)
        return False


def apply_performance_config(config, core_index: int = 0) -> bool:
    """Apply the system_config performance_optimization section for the
    core_index-th pipeline worker (launch assigns sequential cores, mirroring
    launch_vision.py:242-255)."""
    if not config.enable_optimizations or not config.available_cpu_cores:
        return False
    core = config.available_cpu_cores[
        core_index % len(config.available_cpu_cores)]
    ok = set_affinity([core])
    ok = set_realtime_priority(config.default_priority) and ok
    return ok
