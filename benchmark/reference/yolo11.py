"""Plain float32 reference of the Ultralytics YOLO11 detector, from camera
frame to kept detections.

The model is the Ultralytics module tree and state-dict layout
(ultralytics/nn/modules + cfg/models/11/yolo11.yaml: model.0 ..
model.23, model.N.cv1.conv.weight, ...), written apart from the
packages' own models (the module tree of tests/torch_yolo_ref.py), so a
state dict from it exercises the weight converters exactly as a real
YOLO11 checkpoint of the same scale does.
Around it, the serving node's semantics (game_piece_detection_node.cu:
22-23, 347-380; yolo_detection.h:125-182):

  - preprocess: BGR -> RGB, /255, and a resize to the model's square
    input, written as separable triangle-filter weight matrices;
  - detect_raw: the (B, 4 + nc, A) head output, boxes cx, cy, w, h in
    input pixels, sigmoid class scores;
  - nms: per-class greedy NMS in yolo_detection.h's order (a stable
    descending sort of each anchor's best score, conf >= 0.25, IoU > 0.45
    suppresses), over the top `max_detections` candidates;
  - seeded_state_dict: seeded weights in the Ultralytics layout, with
    BatchNorm statistics and affine params and the head's biases drawn
    too, so that the outputs vary from anchor to anchor.

Everything computes in float32, and detect_raw turns TF32 off while it
runs (restoring the settings after). The module imports neither package
of this repository, nor JAX.

Departures from the published description, each as the configuration
states it:

  - the resize antialiases (a triangle filter as wide as the scale),
    as the packages' device resize does (jax.image.resize, torch's
    antialiased bilinear); the upstream node's cv::resize INTER_LINEAR
    does not;
  - NMS keeps the top `max_detections` candidates (100) and runs the
    greedy pass over those alone, the packages' fixed-shape output; the
    upstream parser keeps every candidate;
  - inputs are decoded BGR frames (no MJPG decoding).

control(): the same reference with each convolution's input and weights
rounded through float8_e4m3fn, one precision below the bfloat16 the
configuration's convolutions use.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn


def autopad(k):
    return k // 2


class Conv(nn.Module):
    """Ultralytics Conv: Conv2d(bias=False) + BN(eps=1e-3) + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


def DWConv(c1, c2, k=1, s=1, act=True):
    return Conv(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(
            Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0)
            for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    """Ultralytics C3k2 (a C2f whose blocks are C3k or Bottleneck)."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k else
            Bottleneck(self.c, self.c, shortcut, g)
            for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(self.m(y[-1]) for _ in range(3))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        nh_kd = self.key_dim * num_heads
        h = dim + nh_kd * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x)
        q, k, v = qkv.view(B, self.num_heads,
                           self.key_dim * 2 + self.head_dim, N).split(
            [self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (q.transpose(-2, -1) @ k) * self.scale
        attn = attn.softmax(dim=-1)
        x = (v @ attn.transpose(-2, -1)).view(B, C, H, W) + \
            self.pe(v.reshape(B, C, H, W))
        return self.proj(x)


class PSABlock(nn.Module):
    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1,
                                                         act=False))
        self.add = shortcut

    def forward(self, x):
        x = x + self.attn(x) if self.add else self.attn(x)
        return x + self.ffn(x) if self.add else self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        assert c1 == c2
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(
            PSABlock(self.c, attn_ratio=0.5,
                     num_heads=max(1, self.c // 64)) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = self.m(b)
        return self.cv2(torch.cat((a, b), 1))


class DFL(nn.Module):
    def __init__(self, c1=16):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        self.conv.weight.data[:] = torch.arange(
            c1, dtype=torch.float).view(1, c1, 1, 1)
        self.c1 = c1

    def forward(self, x):
        b, _, a = x.shape
        return self.conv(x.view(b, 4, self.c1, a).transpose(2, 1).softmax(1)
                         ).view(b, 4, a)


class Detect(nn.Module):
    def __init__(self, nc, ch):
        super().__init__()
        self.nc = nc
        self.reg_max = 16
        self.strides = [8, 16, 32]
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          nn.Conv2d(c2, 4 * self.reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                nn.Conv2d(c3, self.nc, 1)) for x in ch)
        self.dfl = DFL(self.reg_max)

    def forward(self, feats):
        shapes = [f.shape for f in feats]
        outs = [torch.cat((self.cv2[i](f), self.cv3[i](f)), 1)
                for i, f in enumerate(feats)]
        # inference decode (Detect._inference): anchors at cell centers
        anchors, strides = [], []
        for (b, _, h, w), s in zip(shapes, self.strides):
            yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                    torch.arange(w, dtype=torch.float32),
                                    indexing="ij")
            anchors.append(torch.stack([xx.reshape(-1) + 0.5,
                                        yy.reshape(-1) + 0.5], 0))
            strides.append(torch.full((1, h * w), float(s)))
        anc = torch.cat(anchors, 1)                   # (2, A)
        strd = torch.cat(strides, 1)                  # (1, A)
        x = torch.cat([o.view(o.shape[0], o.shape[1], -1) for o in outs], 2)
        box, cls = x.split((4 * self.reg_max, self.nc), 1)
        dist = self.dfl(box)                          # (B, 4, A) l,t,r,b
        x1y1 = anc.unsqueeze(0) - dist[:, 0:2]
        x2y2 = anc.unsqueeze(0) + dist[:, 2:4]
        cxy = (x1y1 + x2y2) / 2 * strd.unsqueeze(0)
        wh = (x2y2 - x1y1) * strd.unsqueeze(0)
        return torch.cat((cxy, wh, cls.sigmoid()), 1)  # (B, 4+nc, A)


SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024),
          "m": (0.50, 1.00, 512)}


class YOLO11Torch(nn.Module):
    """Full YOLO11 with Ultralytics layer indexing (model.0 .. model.23)."""

    def __init__(self, nc=1, scale="n"):
        super().__init__()
        depth, width, max_ch = SCALES[scale]

        def ch(c):
            return int(math.ceil(min(c, max_ch) * width / 8) * 8)

        def d(n):
            return max(1, round(n * depth))

        c3k = scale in ("m", "l", "x")
        m = [None] * 24
        m[0] = Conv(3, ch(64), 3, 2)
        m[1] = Conv(ch(64), ch(128), 3, 2)
        m[2] = C3k2(ch(128), ch(256), d(2), c3k, 0.25)
        m[3] = Conv(ch(256), ch(256), 3, 2)
        m[4] = C3k2(ch(256), ch(512), d(2), c3k, 0.25)
        m[5] = Conv(ch(512), ch(512), 3, 2)
        m[6] = C3k2(ch(512), ch(512), d(2), True)
        m[7] = Conv(ch(512), ch(1024), 3, 2)
        m[8] = C3k2(ch(1024), ch(1024), d(2), True)
        m[9] = SPPF(ch(1024), ch(1024), 5)
        m[10] = C2PSA(ch(1024), ch(1024), d(2))
        m[11] = nn.Upsample(scale_factor=2, mode="nearest")
        m[12] = nn.Identity()   # Concat
        m[13] = C3k2(ch(1024) + ch(512), ch(512), d(2), c3k)
        m[14] = nn.Upsample(scale_factor=2, mode="nearest")
        m[15] = nn.Identity()   # Concat
        m[16] = C3k2(ch(512) + ch(512), ch(256), d(2), c3k)
        m[17] = Conv(ch(256), ch(256), 3, 2)
        m[18] = nn.Identity()   # Concat
        m[19] = C3k2(ch(256) + ch(512), ch(512), d(2), c3k)
        m[20] = Conv(ch(512), ch(512), 3, 2)
        m[21] = nn.Identity()   # Concat
        m[22] = C3k2(ch(512) + ch(1024), ch(1024), d(2), True)
        m[23] = Detect(nc, (ch(256), ch(512), ch(1024)))
        self.model = nn.ModuleList(m)

    def forward(self, x):
        m = self.model
        x = m[1](m[0](x))
        x = m[3](m[2](x))
        p3 = m[4](x)
        p4 = m[6](m[5](p3))
        x = m[8](m[7](p4))
        p5 = m[10](m[9](x))
        u = m[11](p5)
        h4 = m[13](torch.cat([u, p4], 1))
        u = m[14](h4)
        h3 = m[16](torch.cat([u, p3], 1))
        dwn = m[17](h3)
        h4b = m[19](torch.cat([dwn, h4], 1))
        dwn = m[20](h4b)
        h5 = m[22](torch.cat([dwn, p5], 1))
        return m[23]([h3, h4b, h5])


CONF_THRESHOLD = 0.25   # game_piece_detection_node.cu:22
IOU_THRESHOLD = 0.45    # game_piece_detection_node.cu:23


def seeded_state_dict(seed: int, nc: int = 1, scale: str = "n") -> dict:
    """A YOLO11Torch(nc, scale) state dict drawn from `seed` (numpy's
    PCG64): convolution kernels normal with std 1/sqrt(fan in), BatchNorm
    scale U(0.5, 1.5), bias U(-0.3, 0.3), mean U(-0.5, 0.5), var
    U(0.5, 2), the head's last 1x1 biases U(-1, 1); the DFL projection
    stays arange. Float32 tensors, keys in the module's order."""
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x9011])
    sd = YOLO11Torch(nc=nc, scale=scale).state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked") or ".dfl." in k:
            out[k] = v.clone()
            continue
        leaf = k.rsplit(".", 1)[1]
        if v.ndim == 4:
            a = rng.normal(0.0, 1.0 / math.sqrt(v[0].numel()), v.shape)
        else:
            lo, hi = {"weight": (0.5, 1.5), "bias": (-0.3, 0.3),
                      "running_mean": (-0.5, 0.5),
                      "running_var": (0.5, 2.0)}[leaf]
            if ".bn." not in k:
                lo, hi = -1.0, 1.0          # a plain conv's bias
            a = rng.uniform(lo, hi, v.shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def model_from(state_dict: dict, nc: int = 1,
               scale: str = "n") -> "YOLO11Torch":
    model = YOLO11Torch(nc=nc, scale=scale).eval()
    model.load_state_dict(state_dict)
    return model


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float32: row i holds the weights of output sample i
    over the input samples, a triangle filter centred at (i + 0.5) s - 0.5
    with s = n_in / n_out, as wide as max(s, 1) samples either side,
    normalised over the samples inside the frame."""
    s = n_in / n_out
    width = max(s, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float32) + 0.5) * s - 0.5
    j = torch.arange(n_in, dtype=torch.float32)
    w = (1.0 - (j[None, :] - centre[:, None]).abs() / width).clamp_min(0.0)
    return w / w.sum(1, keepdim=True)


def preprocess(bgr, size: int) -> torch.Tensor:
    """(B, H, W, 3) or (H, W, 3) uint8 BGR -> (B, 3, size, size) float32
    RGB in [0, 1], resized with resize_weights along each axis."""
    x = torch.as_tensor(np.asarray(bgr))
    if x.ndim == 3:
        x = x[None]
    x = x.flip(-1).to(torch.float32) / 255.0            # (B, H, W, 3) RGB
    wy = resize_weights(x.shape[1], size)
    wx = resize_weights(x.shape[2], size)
    x = x.permute(0, 3, 1, 2)                            # (B, 3, H, W)
    return torch.matmul(torch.matmul(wy, x), wx.T).contiguous()


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(torch.float32)


@contextlib.contextmanager
def control(model: nn.Module):
    """While the block runs, every convolution of `model` sees its input
    and its weights rounded through float8_e4m3fn."""
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    saved = [m.weight.data for m in convs]
    hooks = [m.register_forward_pre_hook(lambda m, a: (_fp8(a[0]),))
             for m in convs]
    for m, w in zip(convs, saved):
        m.weight.data = _fp8(w)
    try:
        yield model
    finally:
        for h in hooks:
            h.remove()
        for m, w in zip(convs, saved):
            m.weight.data = w


@torch.no_grad()
def detect_raw(model: nn.Module, bgr, size: int) -> torch.Tensor:
    """(B, 4 + nc, A) float32 head output for camera frames `bgr`."""
    with no_tf32():
        return model(preprocess(bgr, size)).float()


def _corners(boxes: torch.Tensor):
    return (boxes[..., 0] - boxes[..., 2] / 2,
            boxes[..., 1] - boxes[..., 3] / 2,
            boxes[..., 0] + boxes[..., 2] / 2,
            boxes[..., 1] + boxes[..., 3] / 2)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of cx, cy, w, h boxes a (..., 4) and b (..., 4), float32, each
    step one rounding: corners, the intersection's sides clamped at 0,
    its area, the union as (area a + area b) - intersection."""
    ax1, ay1, ax2, ay2 = _corners(a)
    bx1, by1, bx2, by2 = _corners(b)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def candidates(raw: torch.Tensor, max_detections: int = 100,
               conf: float = CONF_THRESHOLD) -> list:
    """Per row of raw (B, 4 + nc, A): the top `max_detections` anchors by
    their best class score, a stable descending sort (the lower anchor
    first among equal scores) with scores under `conf` counted as 0: a
    dict of boxes (K, 4), scores (K,), classes (K,), anchors (K,) and
    live (K,), the candidates at or over `conf`."""
    out = []
    for r in raw.float():
        score, cls = r[4:].max(0)
        score = torch.where(score >= conf, score, torch.zeros_like(score))
        order = np.argsort(-score.numpy(), kind="stable")[:max_detections]
        idx = torch.from_numpy(order)
        out.append({"boxes": r[:4, idx].T.contiguous(), "scores": score[idx],
                    "classes": cls[idx], "anchors": idx,
                    "live": score[idx] > 0})
    return out


def nms(raw: torch.Tensor, max_detections: int = 100,
        conf: float = CONF_THRESHOLD, iou_threshold: float = IOU_THRESHOLD):
    """Greedy per-class NMS per row of raw (B, 4 + nc, A): candidates()
    taken in order, each kept unless a kept earlier candidate of its class
    overlaps it by IoU > iou_threshold. Each row's candidates() dict with
    `kept` (K,) bool added."""
    rows = candidates(raw, max_detections, conf)
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    for c in rows:
        kept = torch.zeros_like(c["live"])
        for i in range(len(kept)):
            if not c["live"][i]:
                continue
            rivals = kept[:i] & (c["classes"][:i] == c["classes"][i])
            if rivals.any():
                ov = iou(c["boxes"][:i][rivals], c["boxes"][i])
                if bool((ov > thr).any()):
                    continue
            kept[i] = True
        c["kept"] = kept
    return rows
