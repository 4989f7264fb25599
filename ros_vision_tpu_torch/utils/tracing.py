"""Stage-level tracing and debug taps for the PyTorch detector.

Counterpart of ros_vision_tpu/utils/tracing.py. The reference has three
observability tiers (SURVEY section 5): per-stage CUDA events with running
averages (apriltag_gpu.cu:1113-1165), ~20 Copy*To debug taps
(apriltag_gpu.h:98-183), and a --sync flag forcing synchronize+check after
every kernel (cuda_frc971.cu:5-26). Here:

  - stage_taps(): runs the pipeline stage by stage and returns every
    intermediate (threshold image, labels, boundary points, segment stats,
    quads, decode fields) as numpy, under the JAX package's key names — the
    Copy*To tier.
  - StageTimer: times each stage between CUDA events over `reps` queued
    calls with one synchronize, with running averages — the event tier.
  - check mode: stage_taps(check=True) validates invariants after every
    stage (value sets, id ranges, finite corners and poses) and raises
    RuntimeError with the failing stage's name — the --sync tier.

The stages run the detector's own kernels on a CUDA tensor: K1 threshold,
then K2 ranks at 1280x800 or the flood CCL (K6, K7) at 1920x1080, as
ops/frontend_kernel.frontend_route picks, K3 boundary compaction and
cluster_and_fit's K4 histograms. On a CPU tensor they run the plain
versions, and the CCL stage is ops/ccl.label_components, as the JAX
package's taps use on the CPU. For a trace of whole calls use
torch.profiler around detect_raw.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _stages(det):
    """The per-stage callables of a TorchDetector, in pipeline order. Each
    takes (gray, state) and returns the dict it adds to the state."""
    from ros_vision_tpu_torch.ops import ccl, decode as dec, pose as poseops
    from ros_vision_tpu_torch.ops import frontend_kernel as fk, quadfit
    from ros_vision_tpu_torch.ops.threshold_kernel import (
        adaptive_threshold_fused)
    cfg = det.config
    qcfg = det._qcfg
    fam = det.family
    cm = det._code_matrix
    syncs = det.host_syncs

    def intrinsics(gray):
        rows = torch.as_tensor(det.default_intrinsics(gray.shape[0]),
                               device=gray.device)
        return rows[:, :4], rows[:, 4:9]

    def s_threshold(gray, st):
        decim, t = adaptive_threshold_fused(gray)
        return {"decimated": decim, "threshim": t}

    def s_ccl(gray, st):
        # the detector's own front end on the card; the plain CCL that the
        # JAX taps use on the CPU
        t = st["threshim"]
        if t.device.type == "cpu":
            labels, sizes, ranks = ccl.label_components(t)
        elif fk.frontend_route(*t.shape[1:]) == "flood":
            labels, sizes, ranks = ccl.label_components_flood(t)
        else:
            labels, sizes, ranks = fk.label_components(t)
        return {"labels": labels, "sizes": sizes, "ranks": ranks}

    def s_boundary(gray, st):
        t = st["threshim"]
        key, pack2, counts = fk.boundary_compact(
            t, st["ranks"].view(t.shape), qcfg.max_boundary_pixels,
            qcfg.max_points)
        return {"pts": {"key": key, "pack2": pack2}, "counts": counts}

    def s_quadfit(gray, st):
        return quadfit.cluster_and_fit(st["pts"], st["decimated"], qcfg,
                                       syncs)

    def s_refine(gray, st):
        c = dec.adjust_pixel_centers(st["corners"])
        if cfg.refine_edges:
            use_dist = any(cfg.dist)
            intr, dist = intrinsics(gray)
            c = dec.refine_edges(gray, c, st["quad_valid"],
                                 intr if use_dist else None,
                                 dist if use_dist else None,
                                 reversed_border=fam.reversed_border,
                                 syncs=syncs)
        return {"corners_full": c}

    def s_decode(gray, st):
        return dec.decode_quads(gray, st["corners_full"], st["quad_valid"],
                                fam, cm)

    def s_pose(gray, st):
        fx, fy, cx, cy = intrinsics(gray)[0].unbind(1)
        r, t, e = poseops.estimate_poses(st["H"], cfg.tag_size, fx, fy,
                                         cx, cy)
        return {"pose_R": r, "pose_t": t, "pose_err": e}

    return [("threshold", s_threshold), ("ccl", s_ccl),
            ("boundary", s_boundary), ("quadfit", s_quadfit),
            ("refine", s_refine), ("decode", s_decode), ("pose", s_pose)]


def _batch(det, gray) -> torch.Tensor:
    g = torch.as_tensor(gray, device=det.device)
    return (g[None] if g.ndim == 2 else g).contiguous()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def stage_taps(det, gray, check: bool = False) -> dict:
    """Run the pipeline stage by stage, returning all intermediates
    (numpy). With check=True, validate invariants after each stage and
    raise RuntimeError naming the first failing stage."""
    g = _batch(det, gray)
    state: dict = {}
    with torch.inference_mode():
        for name, fn in _stages(det):
            state.update(fn(g, state))
            if check:
                _check_stage(name, state, det)
    return _to_numpy(state)


def _check_stage(name: str, st: dict, det) -> None:
    def fail(msg):
        raise RuntimeError(f"stage '{name}' invariant violated: {msg}")

    def a(key):
        return st[key].cpu().numpy()

    if name == "threshold":
        if not np.isin(a("threshim"), [0, 127, 255]).all():
            fail("threshold values outside {0,127,255}")
    elif name == "ccl":
        lab = a("labels")
        n = lab.shape[1]
        if lab.min() < 0 or lab.max() >= n:
            fail("label out of range")
        if (a("sizes") < 1).any():
            fail("component size < 1")
    elif name == "boundary":
        c = a("counts")
        if (c < 0).any() or (c > det._qcfg.max_points).any():
            fail("boundary count out of range")
    elif name == "quadfit":
        q = a("corners")
        v = a("quad_valid")
        if not np.isfinite(q[v]).all():
            fail("non-finite quad corners")
    elif name == "decode":
        h = a("hamming")
        ok = a("ok")
        if ok.any() and h[ok].max() > 2:
            fail("accepted decode with hamming > 2")
    elif name == "pose":
        ok = a("ok")
        t = a("pose_t")
        if ok.any() and not np.isfinite(t[ok]).all():
            fail("non-finite pose")


class StageTimer:
    """Queued per-stage timing with running averages (the CUDA-event tier).

    Each stage runs once on the previous stages' outputs, then `reps` more
    times back to back: on a CUDA tensor between two CUDA events with one
    synchronize at the end (a stage's own host reads, such as
    cluster_and_fit's, still wait inside the window); on a CPU tensor on
    time.perf_counter."""

    def __init__(self, det):
        self.det = det
        self.averages: dict = {}
        self._n = 0

    def measure(self, gray, reps: int = 10) -> dict:
        """ms per call of each stage on `gray` (H, W) or (B, H, W)."""
        g = _batch(self.det, gray)
        cuda = g.device.type == "cuda"
        state: dict = {}
        times = {}
        with torch.inference_mode():
            for name, fn in _stages(self.det):
                out = fn(g, state)                  # warm-up, and the output
                if cuda:
                    stream = torch.cuda.current_stream(g.device)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    for _ in range(reps):
                        fn(g, state)
                    end.record(stream)
                    end.synchronize()
                    times[name] = start.elapsed_time(end) / reps
                else:
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn(g, state)
                    times[name] = (time.perf_counter() - t0) / reps * 1e3
                state.update(out)
        self._n += 1
        for k, v in times.items():
            avg = self.averages.get(k, v)
            self.averages[k] = avg + (v - avg) / self._n
        return times

    def report(self) -> str:
        lines = [f"{k:>10}: {v:8.2f} ms (avg)"
                 for k, v in self.averages.items()]
        total = sum(self.averages.values())
        lines.append(f"{'total':>10}: {total:8.2f} ms")
        return "\n".join(lines)
