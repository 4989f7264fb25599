"""Device helpers: explicit CUDA selection, host-read accounting."""
from __future__ import annotations

import torch


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
    """Counts device->host reads that steer control flow (the eager
    counterparts of the JAX detector's lax.cond / lax.switch branches)."""

    def __init__(self):
        self.count = 0

    def item(self, t: torch.Tensor):
        self.count += 1
        return t.item()
