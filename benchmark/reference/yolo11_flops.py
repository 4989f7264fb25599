"""Floating-point operations of one YOLO11 forward, from its layer shapes.

Counts 2 x the multiply-adds of every convolution (the DFL projection
included) and of the two matrix products of each attention block (q^T k
and v attn^T), as Ultralytics' GFLOPs count convolutions (2 x MACs) at
the model's input size. The shapes come from the frozen reference
(benchmark/reference/yolo11.py) run on torch's "meta" device: no data is
made and nothing is computed.

    flops(scale="n", nc=1, img_size=640, batch=1) -> int
"""
from __future__ import annotations

import torch

from benchmark.reference import yolo11


def flops(scale: str = "n", nc: int = 1, img_size: int = 640,
          batch: int = 1) -> int:
    model = yolo11.YOLO11Torch(nc=nc, scale=scale).to("meta").eval()
    total = [0]

    def conv(m, args, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * k

    def attention(m, args, out):
        b, c, h, w = args[0].shape
        n = h * w
        total[0] += 2 * b * m.num_heads * n * n * (m.key_dim + m.head_dim)

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(attention) for m in model.modules()
              if isinstance(m, yolo11.Attention)]
    detect = model.model[23]

    def head(feats):
        # the branches' convolutions; the DFL's 1x1 over 4 x reg_max bins
        # of every anchor
        for i, f in enumerate(feats):
            detect.cv2[i](f)
            detect.cv3[i](f)
        anchors = sum(f.shape[2] * f.shape[3] for f in feats)
        total[0] += 2 * batch * 4 * anchors * detect.reg_max
    detect.forward = head
    with torch.no_grad():
        model(torch.zeros(batch, 3, img_size, img_size, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]
