"""Connected-components labelling of a threshold image (plain PyTorch).

Contract of ros_vision_tpu/ops/ccl.py label_components: same-value
components of a {0, 127, 255} image with 4-way connectivity for 0, 8-way
for 255 (diagonals join only 255 pixels) and 127 pixels as singletons;
each label is the minimum flat pixel index of its component; ranks run
1..MAX_BLOBS over components of >= min_blob pixels in root order (0
elsewhere). One algorithm: min-label hooking plus pointer jumping to a
fixpoint. The hand-written kernel (union-find with atomics) is K2 in
ops/frontend_kernel.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_BLOBS = 2048          # dense big-blob id space (points.h:171 kMaxBlobs)
_BIG = 2 ** 30

# (dy, dx, diagonal?)
_OFFSETS = [
    (0, -1, False), (0, 1, False), (-1, 0, False), (1, 0, False),
    (-1, -1, True), (-1, 1, True), (1, -1, True), (1, 1, True),
]


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = in[y+dy, x+dx], `fill` outside the frame."""
    _, h, w = x.shape
    pad = F.pad(x, (1, 1, 1, 1), value=fill)
    return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _neighbor_min(labels_img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Min label over connectivity-eligible neighbours (and self)."""
    m = labels_img
    not127 = v != 127
    white = v == 255
    for dy, dx, diag in _OFFSETS:
        nv = _shift2d(v, dy, dx, 127)
        nl = _shift2d(labels_img, dy, dx, _BIG)
        ok = not127 & (nv == v)
        if diag:
            ok = ok & white
        m = torch.minimum(m, torch.where(ok, nl, _BIG))
    return m


def finish(p: torch.Tensor, min_blob: int):
    """Per-pixel (sizes, ranks) from converged labels p (B, N)."""
    b, n = p.shape
    idx = p.to(torch.int64)
    sizes_at_root = torch.zeros((b, n), dtype=torch.int32, device=p.device)
    sizes_at_root.scatter_add_(1, idx, torch.ones_like(p))
    root = p == torch.arange(n, dtype=torch.int32, device=p.device)[None]
    is_big_root = root & (sizes_at_root >= min_blob)
    rank = torch.cumsum(is_big_root.to(torch.int32), dim=1, dtype=torch.int32)
    rank = torch.where(is_big_root & (rank <= MAX_BLOBS), rank, 0)
    return (torch.gather(sizes_at_root, 1, idx),
            torch.gather(rank.to(torch.int32), 1, idx))


def label_components(threshim: torch.Tensor, min_blob: int = 25):
    """(B, H, W) uint8 -> (labels, sizes, ranks), each (B, H*W) int32."""
    b, h, w = threshim.shape
    n = h * w
    p = torch.arange(n, dtype=torch.int32,
                     device=threshim.device).expand(b, n).contiguous()
    while True:
        m = _neighbor_min(p.view(b, h, w), threshim).reshape(b, n)
        # hook: p[p[i]] <- min(p[p[i]], m[i]) over i sharing the parent
        pn = p.clone().scatter_reduce_(1, p.to(torch.int64), m,
                                       reduce="amin", include_self=True)
        # pointer jumping, twice
        pn = torch.gather(pn, 1, pn.to(torch.int64))
        pn = torch.gather(pn, 1, pn.to(torch.int64))
        if torch.equal(pn, p):
            break
        p = pn
    sizes, ranks = finish(p, min_blob)
    return p, sizes, ranks
