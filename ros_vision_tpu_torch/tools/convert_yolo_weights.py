#!/usr/bin/env python
"""Convert Ultralytics YOLO11 .pt weights to the game-piece engine's .npz.

The port of scripts/convert_yolo_weights.py, with no JAX: it writes the
same flat "/"-keyed .npz (flax layout: conv kernels HWIO, BatchNorm
scale/bias under params and mean/var under batch_stats) that both
packages' ModelInference load, key for key and bit for bit. The reference
converts trained models to TensorRT engines
(utils/detection_tools/convert_to_onnx.py + trtexec).

The model names every submodule after its Ultralytics path (models/yolo.py:
m0..m22, cv1/cv2/m0..., cv2_{i}_{j} / cv3_{i}_{a}_{b} in the detect head),
so conversion is a deterministic name translation, not an order walk
(Ultralytics state-dict order differs from call order inside C2f-family
blocks). Each torch tensor maps to exactly one leaf: conv kernels
(OIHW -> HWIO), BatchNorm gamma/beta -> params scale/bias, running
mean/var -> batch_stats, and the detect head's final 1x1 conv weights AND
biases. The fixed DFL projection conv is validated (arange) and dropped:
the model applies the projection analytically. Any key with no leaf, any
shape mismatch, a DFL projection that is not arange or a leaf never
assigned refuses the conversion, and nothing is written.

Usage: python -m ros_vision_tpu_torch.tools.convert_yolo_weights \\
           model.pt out.npz [--num-classes N] [--scale n]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def torch_state_to_flat(pt_path: str) -> dict:
    """The checkpoint's state dict as f32 numpy arrays (a full Ultralytics
    checkpoint {"model": module}, a module, or a bare state dict)."""
    import torch
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return {k: v.float().numpy() for k, v in sd.items()}


_BN_LEAVES = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def translate_key(key: str, detect_idx: int):
    """Ultralytics state-dict key -> (collection, path, kind), "dfl", or
    None to skip. kind: 'conv' (transpose OIHW->HWIO) or 'leaf' (copy)."""
    toks = key.split(".")
    if toks[0] == "model":
        toks = toks[1:]
    if not toks or not toks[0].isdigit():
        return None
    idx = int(toks[0])
    rest = toks[1:]
    if rest and rest[-1] == "num_batches_tracked":
        return None

    if idx == detect_idx:
        if rest[0] == "dfl":
            return "dfl"                      # validated by caller, dropped
        branch, i = rest[0], rest[1]
        if branch == "cv2":
            j = rest[2]
            if j == "2":                      # final plain Conv2d (w + b)
                leaf = "kernel" if rest[3] == "weight" else "bias"
                return ("params", (f"cv2_{i}_2", leaf),
                        "conv" if leaf == "kernel" else "leaf")
            mod, tail = f"cv2_{i}_{j}", rest[3:]
        elif branch == "cv3":
            a = rest[2]
            if a == "2":
                leaf = "kernel" if rest[3] == "weight" else "bias"
                return ("params", (f"cv3_{i}_2", leaf),
                        "conv" if leaf == "kernel" else "leaf")
            b = rest[3]
            mod, tail = f"cv3_{i}_{a}_{b}", rest[4:]
        else:
            return None
        return _convbn_leaf((mod,), tail)

    # non-detect module: walk nested names
    path = [f"m{idx}"]
    i = 0
    while i < len(rest) - 2:
        t = rest[i]
        if t in ("m", "ffn") and i + 1 < len(rest) and rest[i + 1].isdigit():
            path.append(f"{t}{rest[i + 1]}")
            i += 2
        elif t in ("cv1", "cv2", "cv3", "attn", "qkv", "pe", "proj"):
            path.append(t)
            i += 1
        else:
            return None
    return _convbn_leaf(tuple(path), rest[i:])


def _convbn_leaf(path: tuple, tail: list):
    """(..., 'conv', 'weight') / (..., 'bn', <leaf>) under a ConvBN."""
    if tail == ["conv", "weight"]:
        return ("params", path + ("Conv_0", "kernel"), "conv")
    if len(tail) == 2 and tail[0] == "bn" and tail[1] in _BN_LEAVES:
        coll, leaf = _BN_LEAVES[tail[1]]
        return (coll, path + ("BatchNorm_0", leaf), "leaf")
    return None


def convert(pt_path: str, out_path: str, num_classes: int = 1,
            scale: str = "n") -> None:
    """Write `out_path` from the Ultralytics checkpoint `pt_path`; raise
    SystemExit, writing nothing, on any mapping problem."""
    from ros_vision_tpu_torch.models import yolo

    src = torch_state_to_flat(pt_path)
    out = yolo.to_flax(yolo.YOLOv11(num_classes=num_classes, scale=scale))
    detect_idx = max(int(k.split(".")[1]) for k in src
                     if k.startswith("model.") and k.split(".")[1].isdigit())

    assigned = set()
    problems = []
    for tk, tv in src.items():
        tr = translate_key(tk, detect_idx)
        if tr is None:
            continue
        if tr == "dfl":
            proj = tv.reshape(-1)
            if not np.allclose(proj, np.arange(len(proj))):
                problems.append(f"dfl projection is not arange: {tk}")
            continue
        coll, path, kind = tr
        fk = "/".join((coll,) + path)
        if fk not in out:
            problems.append(f"no flax leaf for {tk} -> {(coll,) + path}")
            continue
        w = np.transpose(tv, (2, 3, 1, 0)) if kind == "conv" else tv
        if w.shape != out[fk].shape:
            problems.append(
                f"shape mismatch {tk} {w.shape} -> {fk} {out[fk].shape}")
            continue
        out[fk] = np.ascontiguousarray(w, np.float32)
        assigned.add(fk)

    for k in out:
        if k not in assigned:
            problems.append(f"flax leaf never assigned: {k}")
    if problems:
        for p in problems:
            print(f"ERROR: {p}", file=sys.stderr)
        raise SystemExit(
            f"{len(problems)} mapping problems; refusing to write a "
            "partially converted checkpoint")

    np.savez(out_path, **out)
    print(f"wrote {out_path} ({len(assigned)} tensors)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert Ultralytics YOLO11 .pt weights to the "
                    "game-piece engine's .npz (no JAX needed)")
    ap.add_argument("pt_path")
    ap.add_argument("out_path")
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--scale", default="n")
    args = ap.parse_args(argv)
    convert(args.pt_path, args.out_path, args.num_classes, args.scale)


if __name__ == "__main__":
    main()
