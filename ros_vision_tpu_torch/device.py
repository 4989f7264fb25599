"""Device helpers: CUDA selection, host-read accounting, constant tables."""
from __future__ import annotations

import time

import torch

from ros_vision_tpu_torch.utils import tracing


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device `index`; raises when no card is present. Never picks
    the CPU in its place — callers that want the CPU say so explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {index} not present "
                           f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def kernel_route(t: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor (launch the kernel), 'cpu' for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")


class HostSyncs:
    """Counts and times the synchronising operations of a detector call:
    device->host reads that steer control flow (the eager counterparts of
    the JAX detector's lax.cond / lax.switch branches) and uploads of
    host-built tables (a blocking copy on a CUDA device). `count` is the
    total; `ns` the host ns spent inside them while tracing.RECORDER is
    on. A call record (tracing.Call) takes both as they grow over its
    call, so a HostSyncs serves one thread at a time."""

    def __init__(self):
        self.count = 0
        self.ns = 0

    def item(self, t: torch.Tensor):
        self.count += 1
        if not tracing.RECORDER.enabled:
            return t.item()
        t0 = time.perf_counter_ns()
        out = t.item()
        self.ns += time.perf_counter_ns() - t0
        return out

    def upload(self, data, device, dtype=None) -> torch.Tensor:
        """torch.as_tensor(data, dtype=dtype, device=device): a host
        table (numpy array or Python sequence) on `device`, with the values
        and dtype torch.tensor gives it."""
        self.count += 1
        if not tracing.RECORDER.enabled:
            return torch.as_tensor(data, dtype=dtype, device=device)
        t0 = time.perf_counter_ns()
        out = torch.as_tensor(data, dtype=dtype, device=device)
        self.ns += time.perf_counter_ns() - t0
        return out


_TABLES: dict = {}      # (str(device), key) -> device_tables' dict


def device_tables(device: torch.device, key, build, syncs: HostSyncs) -> dict:
    """The dict of tables `build(upload)` makes for `key` on `device`,
    built on the device's first call for `key` and kept for every later
    one; `upload(data, dtype=None)` is syncs.upload(data, device, dtype):
    the values and dtype torch.as_tensor gives, counted."""
    k = (str(device), key)
    tabs = _TABLES.get(k)
    if tabs is None:
        tabs = _TABLES.setdefault(k, build(
            lambda data, dtype=None: syncs.upload(data, device, dtype)))
    return tabs


def host_syncs(syncs: HostSyncs | None) -> HostSyncs:
    """`syncs`, or a fresh HostSyncs for a caller that keeps no count."""
    return HostSyncs() if syncs is None else syncs
