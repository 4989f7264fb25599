"""YOLOv11-compatible detector in PyTorch (NCHW).

The port of ros_vision_tpu/models/yolo.py: the same Ultralytics YOLO11
inference graph (n/s/m scales) as torch modules, named as the flax
modules are (m0 ... m22, cv1/cv2/cv3, attn/qkv/pe/proj, cv2_i_j, cv3_i_j_k),
so `from_flax` / `to_flax` carry a flax variables tree across by name.
The output contract is the reference parser's (yolo_detection.h:125-182):
(B, 4 + num_classes, anchors) with xywh box rows in input-pixel units and
sigmoid class scores, anchors in row-major (h, w) order per stride.

Precision follows the flax model run at a compute dtype: every ConvBN's
convolution runs in that dtype, its BatchNorm in f32 statistics with the
result rounded to the dtype; the head's last 1x1 convolutions, the DFL
softmax and the class sigmoid run in f32 (flax promotes them to the f32
params).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def autopad(k: int) -> int:
    return k // 2


class ConvBN(nn.Module):
    """Conv2d + BatchNorm (eps 1e-3) + SiLU (Ultralytics Conv)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, s: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, s, autopad(k),
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.conv(x.to(self.conv.weight.dtype))
        bn = self.bn
        # f32 statistics on a low-precision x: the result keeps x's dtype
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True,
                 e: float = 0.5, k: tuple = (3, 3)):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBN(in_ch, c_, k[0])
        self.cv2 = ConvBN(c_, out_ch, k[1])
        self.add = shortcut and in_ch == out_ch

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP bottleneck with 3 convs (kernel-size-3 bottlenecks)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBN(in_ch, c_, 1)
        self.cv2 = ConvBN(in_ch, c_, 1)
        self.n = n
        for j in range(n):
            setattr(self, f"m{j}", Bottleneck(c_, c_, True, 1.0, (3, 3)))
        self.cv3 = ConvBN(2 * c_, out_ch, 1)

    def forward(self, x):
        a = self.cv1(x)
        b = self.cv2(x)
        for j in range(self.n):
            a = getattr(self, f"m{j}")(a)
        return self.cv3(torch.cat([a, b], 1))


class C3k2(nn.Module):
    """Ultralytics v11 C3k2: fast CSP with 2 convs and n inner blocks."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 c3k: bool = False, e: float = 0.5):
        super().__init__()
        c_ = int(out_ch * e)
        self.cv1 = ConvBN(in_ch, 2 * c_, 1)
        self.n = n
        for j in range(n):
            setattr(self, f"m{j}", C3k(c_, c_, 2) if c3k
                    else Bottleneck(c_, c_, True, 0.5, (3, 3)))
        self.cv2 = ConvBN((2 + n) * c_, out_ch, 1)

    def forward(self, x):
        outs = list(self.cv1(x).chunk(2, 1))
        cur = outs[1]
        for j in range(self.n):
            cur = getattr(self, f"m{j}")(cur)
            outs.append(cur)
        return self.cv2(torch.cat(outs, 1))


class SPPF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int = 5):
        super().__init__()
        c_ = in_ch // 2
        self.k = k
        self.cv1 = ConvBN(in_ch, c_, 1)
        self.cv2 = ConvBN(4 * c_, out_ch, 1)

    def forward(self, x):
        x = self.cv1(x)
        outs = [x]
        for _ in range(3):
            # pads with -inf, as flax's max_pool does
            x = F.max_pool2d(x, self.k, 1, self.k // 2)
            outs.append(x)
        return self.cv2(torch.cat(outs, 1))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = self.head_dim // 2
        nh = num_heads
        self.qkv = ConvBN(dim, nh * (self.key_dim * 2 + self.head_dim), 1,
                          act=False)
        self.pe = ConvBN(dim, dim, 3, groups=dim, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)

    def forward(self, x):
        b, _, h, w = x.shape
        n = h * w
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        # the flax model reshapes NHWC channels as (heads, 2*kd + hd)
        qkv = self.qkv(x).flatten(2).transpose(1, 2)
        q, k, v = qkv.reshape(b, n, nh, kd * 2 + hd).split([kd, kd, hd], -1)
        attn = torch.einsum("bnhk,bmhk->bhnm", q, k) / math.sqrt(kd)
        attn = attn.softmax(-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        out = out.reshape(b, n, self.dim).transpose(1, 2).reshape(
            b, self.dim, h, w)
        vr = v.reshape(b, n, nh * hd).transpose(1, 2).reshape(
            b, nh * hd, h, w)
        out = out + self.pe(vr)
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = Attention(dim, num_heads)
        self.ffn0 = ConvBN(dim, dim * 2, 1)
        self.ffn1 = ConvBN(dim * 2, dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn1(self.ffn0(x))


class C2PSA(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int = 1):
        super().__init__()
        c_ = out_ch // 2
        self.cv1 = ConvBN(in_ch, 2 * c_, 1)
        self.n = n
        for j in range(n):
            setattr(self, f"m{j}", PSABlock(c_, max(1, c_ // 64)))
        self.cv2 = ConvBN(2 * c_, out_ch, 1)

    def forward(self, x):
        a, b_ = self.cv1(x).chunk(2, 1)
        for j in range(self.n):
            b_ = getattr(self, f"m{j}")(b_)
        return self.cv2(torch.cat([a, b_], 1))


@dataclasses.dataclass(frozen=True)
class YoloScale:
    depth: float
    width: float
    max_channels: int


SCALES = {
    "n": YoloScale(0.50, 0.25, 1024),
    "s": YoloScale(0.50, 0.50, 1024),
    "m": YoloScale(0.50, 1.00, 512),
}
STRIDES = (8, 16, 32)


class YOLOv11(nn.Module):
    """Ultralytics YOLO11 detection model (inference graph).

    Input (B, 3, H, W) float in [0,1]; output (B, 4 + nc, anchors) f32 —
    the tensor contract of the reference's engine output
    (yolo_detection.h:148-156 reads [1, 4+C, P])."""

    def __init__(self, num_classes: int = 1, scale: str = "n",
                 reg_max: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.scale = scale
        self.reg_max = reg_max
        ch, d = self.ch, self.depth
        c3k = scale in ("m", "l", "x")
        # backbone — module names are the Ultralytics layer indices
        self.m0 = ConvBN(3, ch(64), 3, 2)                             # P1
        self.m1 = ConvBN(ch(64), ch(128), 3, 2)                       # P2
        self.m2 = C3k2(ch(128), ch(256), d(2), c3k, 0.25)
        self.m3 = ConvBN(ch(256), ch(256), 3, 2)                      # P3
        self.m4 = C3k2(ch(256), ch(512), d(2), c3k, 0.25)
        self.m5 = ConvBN(ch(512), ch(512), 3, 2)                      # P4
        self.m6 = C3k2(ch(512), ch(512), d(2), True)
        self.m7 = ConvBN(ch(512), ch(1024), 3, 2)                     # P5
        self.m8 = C3k2(ch(1024), ch(1024), d(2), True)
        self.m9 = SPPF(ch(1024), ch(1024), 5)
        self.m10 = C2PSA(ch(1024), ch(1024), d(2))
        # head (FPN/PAN)
        self.m13 = C3k2(ch(1024) + ch(512), ch(512), d(2), c3k)
        self.m16 = C3k2(ch(512) + ch(512), ch(256), d(2), c3k)
        self.m17 = ConvBN(ch(256), ch(256), 3, 2)
        self.m19 = C3k2(ch(256) + ch(512), ch(512), d(2), c3k)
        self.m20 = ConvBN(ch(512), ch(512), 3, 2)
        self.m22 = C3k2(ch(512) + ch(1024), ch(1024), d(2), True)
        # detect head with DFL
        c2 = max(16, ch(256) // 4, reg_max * 4)
        c3 = max(ch(256), min(num_classes, 100))
        for i, f in enumerate((ch(256), ch(512), ch(1024))):
            # box branch (Ultralytics Detect.cv2[i]): Conv3, Conv3, 1x1
            setattr(self, f"cv2_{i}_0", ConvBN(f, c2, 3))
            setattr(self, f"cv2_{i}_1", ConvBN(c2, c2, 3))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            # cls branch (Detect.cv3[i]): two depthwise-separable stages
            # then the scoring 1x1
            setattr(self, f"cv3_{i}_0_0", ConvBN(f, f, 3, groups=f))
            setattr(self, f"cv3_{i}_0_1", ConvBN(f, c3, 1))
            setattr(self, f"cv3_{i}_1_0", ConvBN(c3, c3, 3, groups=c3))
            setattr(self, f"cv3_{i}_1_1", ConvBN(c3, c3, 1))
            setattr(self, f"cv3_{i}_2", nn.Conv2d(c3, num_classes, 1))

    def ch(self, c: int) -> int:
        s = SCALES[self.scale]
        return int(math.ceil(min(c, s.max_channels) * s.width / 8) * 8)

    def depth(self, n: int) -> int:
        return max(1, round(n * SCALES[self.scale].depth))

    def set_compute_dtype(self, dtype: torch.dtype) -> "YOLOv11":
        """ConvBN convolutions compute in `dtype` (their weights cast to
        it); BatchNorm statistics and the head's last 1x1 convolutions stay
        f32, as flax keeps them."""
        for mod in self.modules():
            if isinstance(mod, ConvBN):
                mod.conv.to(dtype)
        return self

    def forward(self, x):
        x = self.m1(self.m0(x))
        x = self.m3(self.m2(x))
        p3 = self.m4(x)
        p4 = self.m6(self.m5(p3))
        x = self.m8(self.m7(p4))
        p5 = self.m10(self.m9(x))

        up = F.interpolate(p5, scale_factor=2, mode="nearest")
        h4 = self.m13(torch.cat([up, p4], 1))
        up = F.interpolate(h4, scale_factor=2, mode="nearest")
        h3 = self.m16(torch.cat([up, p3], 1))
        h4b = self.m19(torch.cat([self.m17(h3), h4], 1))
        h5 = self.m22(torch.cat([self.m20(h4b), p5], 1))

        box_outs, cls_outs, anchors, stride_arr = [], [], [], []
        for i, (f, s) in enumerate(zip((h3, h4b, h5), STRIDES)):
            bx = getattr(self, f"cv2_{i}_0")(f)
            bx = getattr(self, f"cv2_{i}_1")(bx)
            bx = getattr(self, f"cv2_{i}_2")(bx.float())
            cl = f
            for j in ("0_0", "0_1", "1_0", "1_1"):
                cl = getattr(self, f"cv3_{i}_{j}")(cl)
            cl = getattr(self, f"cv3_{i}_2")(cl.float())
            b, _, hgt, wid = f.shape
            box_outs.append(bx.permute(0, 2, 3, 1).reshape(b, -1,
                                                           4 * self.reg_max))
            cls_outs.append(cl.permute(0, 2, 3, 1).reshape(b, -1,
                                                           self.num_classes))
            yy, xx = torch.meshgrid(
                torch.arange(hgt, dtype=torch.float32, device=f.device),
                torch.arange(wid, dtype=torch.float32, device=f.device),
                indexing="ij")
            anchors.append(torch.stack([xx.reshape(-1) + 0.5,
                                        yy.reshape(-1) + 0.5], -1))
            stride_arr.append(torch.full((hgt * wid,), float(s),
                                         dtype=torch.float32,
                                         device=f.device))
        box = torch.cat(box_outs, 1)             # (B, A, 4*reg_max)
        cls = torch.cat(cls_outs, 1)             # (B, A, nc)
        anc = torch.cat(anchors, 0)              # (A, 2)
        strd = torch.cat(stride_arr, 0)[None, :, None]

        # DFL: distribution -> distances
        bdist = box.reshape(box.shape[0], box.shape[1], 4,
                            self.reg_max).softmax(-1)
        proj = torch.arange(self.reg_max, dtype=torch.float32,
                            device=box.device)
        dist = (bdist * proj).sum(-1)            # (B, A, 4) l,t,r,b
        x1y1 = anc[None] - dist[..., 0:2]
        x2y2 = anc[None] + dist[..., 2:4]
        cxy = (x1y1 + x2y2) / 2 * strd
        wh = (x2y2 - x1y1) * strd
        out = torch.cat([cxy, wh, cls.sigmoid()], -1)
        return out.transpose(1, 2)               # (B, 4+nc, A)


# ---- weights across packages ---------------------------------------------
# torch state-dict suffix -> (flax collection, flax leaf path); the module
# path in between is the same in both, "." in torch, "/" in flax
_LEAVES = {
    "conv.weight": ("params", "Conv_0/kernel"),
    "bn.weight": ("params", "BatchNorm_0/scale"),
    "bn.bias": ("params", "BatchNorm_0/bias"),
    "bn.running_mean": ("batch_stats", "BatchNorm_0/mean"),
    "bn.running_var": ("batch_stats", "BatchNorm_0/var"),
    "weight": ("params", "kernel"),      # the head's plain 1x1 convs
    "bias": ("params", "bias"),
}


def flax_key(torch_key: str) -> str | None:
    """The flattened flax variables key of a state-dict key
    ("m2.m0.cv1.conv.weight" -> "params/m2/m0/cv1/Conv_0/kernel"); None
    for torch-only buffers (BatchNorm's num_batches_tracked)."""
    if torch_key.endswith("num_batches_tracked"):
        return None
    for suffix, (coll, leaf) in _LEAVES.items():
        if torch_key.endswith("." + suffix):
            path = torch_key[:-len(suffix) - 1].replace(".", "/")
            return f"{coll}/{path}/{leaf}"
    raise KeyError(f"no flax counterpart for {torch_key!r}")


def _flatten(tree, prefix: str = "") -> dict:
    """Nested mapping (a flax variables tree) or flat "/"-keyed dict ->
    flat {"params/.../kernel": array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def from_flax(model: YOLOv11, variables) -> YOLOv11:
    """Fill `model` in place from the JAX package's variables tree (nested,
    or flattened with "/" as its .npz files are): conv kernels HWIO (grouped
    ones (kh, kw, in/groups, out)) -> OIHW, BatchNorm scale/bias and
    batch_stats mean/var as they are. Raises on a missing key, a left-over
    key or a shape that does not fit."""
    flat = _flatten(variables)
    used = set()
    with torch.no_grad():
        for tkey, t in model.state_dict().items():
            fkey = flax_key(tkey)
            if fkey is None:
                continue
            if fkey not in flat:
                raise KeyError(f"flax variables lack {fkey!r} (for {tkey})")
            a = np.array(flat[fkey], np.float32)      # a writable copy
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{fkey}: shape {a.shape} does not fit "
                                 f"{tkey} {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            used.add(fkey)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"flax variables not used by the model: {extra[:5]}"
                       f"{' ...' if len(extra) > 5 else ''}")
    return model


def to_flax(model: YOLOv11) -> dict:
    """The flat "/"-keyed f32 numpy variables of `model`, as the JAX
    package's save_params writes them (kernels back to HWIO)."""
    flat = {}
    for tkey, t in model.state_dict().items():
        fkey = flax_key(tkey)
        if fkey is None:
            continue
        a = t.detach().float().cpu().numpy()
        flat[fkey] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return flat


def init_weights(model: YOLOv11, generator: torch.Generator) -> YOLOv11:
    """Seeded random init in the flax defaults' family: conv kernels
    lecun-normal (truncated at 2 sigma), conv biases 0, BatchNorm identity
    (scale 1, bias 0, mean 0, var 1)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model
