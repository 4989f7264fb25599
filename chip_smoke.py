#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ros_vision_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits nonzero and prints no result.
Phases, each of which raises (and so exits nonzero) on failure:
  1. build the kernels (one nvcc per csrc/*.cu, all started together,
     sm_90a) from the checkout;
  2. kernel checks: each of the eleven kernels against its plain PyTorch
     version on the card, bit-exact, timed two ways beside its plain
     version and, where one PyTorch call computes the same function, that
     call: call_ms, the median of 20 single calls each between its own
     CUDA events (what the eager path pays, the host's enqueue included),
     and device_ms, 20 calls enqueued behind a torch.cuda._sleep that
     outlasts their enqueue (checked on the host clock and by the first
     event still pending), so the device runs them back to back (the
     row's ms; a plain version or library call that makes the host wait
     on the device keeps its call time there, marked "call"); beside the
     bound (bytes over the HBM rate or operations over the core rate),
     which compares with device_ms. K1-K3 at the 1280x800 tag36h11
     path's shapes (the 4-tag bench scene at B=4 with four noise seeds,
     plus one cluttered frame that overflows both boundary caps) and
     again at 1920x1080; K2 and K6 (the tiled union-find) also on
     staircase (255 diagonals through the tiles' corners), spiral and comb
     planes at 640x400 and 960x540 and on two ragged frames, K6 with flat
     indices, the packed per-root table and random values, each call
     checked to make its C launcher's fixed number of device launches
     (K2 6, K6 4) and repeated 10 times with identical outputs; K4 and
     K9 on the inputs that one use_pallas_sort cluster_and_fit call gives
     them on those batches:
     K4 on the segment ids and peak segments at (4, 32768) and
     (4, 131072), one kernel launch a call; K9 on the four sorts at
     K = 8192, 32768 and 131072 plus random, duplicate, sentinel, K=1000,
     payload (num_keys < operands) and K=200000 rows, bit-exact against
     the network's plain version (payload order included), one kernel
     launch a call up to N = 131,072; K6, K7 and K12 at 1920x1080 (bench
     scene B=4 and a cluttered frame past the 2048-blob rank space); K8
     at 1280x800 B=4 with 448, 0 and 1 sweeps; K10 at B=4 S=1025 C=4
     K=32768; K11 at B=4 K=131072 S=1025;
  3. detector at 1280x800 and at 1920x1080: TorchDetector at B=1 and B=4
     on the bench scene (1.5x layout at 1080p) — ids [0, 42, 100, 311] in
     every row, corners within 0.1 px of the same detector's plain path on
     the CPU and within 1 px of the rendered corners, and exactly the
     front end's kernel set launched (K2 at 1280x800, K6 + K7 at
     1920x1080); then TorchDetector(use_pallas_sort=True) at B=4 at both
     sizes, its packed output bit-identical to the default's, its kernel
     set the path's plus K9 with 4 K9 calls and 4 kernel launches per
     call (K4: one kernel launch per call on every detector path);
  4. the other ops/ccl.py entry points: label_components_hybrid (K8),
     flood_ranks (K6, K7, K12) and label_components_flood with
     broadcast="flood" (K6, K7), each held against the plain CCL;
  5. system: the port's VisionSystem with 4 mock cameras at 1280x800, each
     showing its own tags, spun for >= 20 batches; each camera publishes
     its own ids with finite robot-frame poses.
K10 and K11 have no caller on any path (nor in the JAX package outside
its tests), so their launches read 0.
Every path of phases 3-5 runs with the launch counts set to 0 just before
it and read just after; the launches of the kernels line sum those runs.
On every path the device launches that the C launchers of K2, K4 and K6
report equal their fixed number per call times the calls.
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BENCH_IDS = [0, 42, 100, 311]
W, H = 1280, 800
W2, H2 = 1920, 1080
# At noise sigma 1 the flat background of a 1920x1080 bench frame
# thresholds into speckle that fills the point and segment caps, and the
# JAX detector finds none of the tags there; sigma 0.75 keeps all four.
NOISE_1080 = 0.75
REPS = 20
REPEATS = 10      # repeated calls of K2 and K6 on each plane, compared
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores (the rate bound_ms uses for the integer and float work here)
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
# kernels each path must launch; every other kernel must not launch there
PATH_800 = {"adaptive_threshold", "rank_image", "boundary_compact",
            "value_histogram"}
PATH_1080 = {"adaptive_threshold", "propagate_fixpoint", "label_histogram",
             "boundary_compact", "value_histogram"}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_scene(seed: int, width: int = W, height: int = H,
                noise: float = 1.0):
    """The bench.py scene (4 tags at 1280x800, noise sigma 1), its layout
    scaled by width / 1280 for other frame sizes."""
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                simple_square_corners)
    s = width / W
    return render_scene(
        [0, 42, 311, 100],
        [simple_square_corners(300 * s, 250 * s, 90 * s),
         simple_square_corners(800 * s, 400 * s, 110 * s, angle_deg=20),
         simple_square_corners(450 * s, 600 * s, 70 * s, angle_deg=-35),
         simple_square_corners(1000 * s, 600 * s, 60 * s, angle_deg=50)],
        width, height, noise_sigma=noise, seed=seed)


def clutter_frame(seed: int = 7, width: int = W,
                  height: int = H) -> np.ndarray:
    """A 12x12-px black/white checkerboard with 10% of its blocks flipped:
    thousands of 4-connected black blobs above the 25-px minimum and
    boundary everywhere, so the 2048-blob rank space and both boundary
    caps overflow."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:height // 12 + 1, :width // 12 + 1]
    blocks = ((yy + xx) % 2) ^ (rng.random(yy.shape) < 0.1)
    img = np.kron(blocks * 200 + 20, np.ones((12, 12)))[:height, :width]
    return (img + rng.normal(0, 2.0, img.shape)).clip(0, 255).astype(np.uint8)


def staircase_plane(h: int, w: int, period: int = 32,
                    seed: int = 0) -> np.ndarray:
    """(1, h, w) threshold plane: 1-px white (255) diagonals of both slopes
    every `period` px on black (0), 1% of pixels 127. The diagonals join
    only through 8-way white links, cross the CCL tiles' corners, and cut
    the black into 4-connected diamonds."""
    yy, xx = np.mgrid[:h, :w]
    white = ((xx + yy) % period == 0) | ((xx - yy) % period == 0)
    out = np.where(white, 255, 0).astype(np.uint8)
    out[np.random.default_rng(seed).random((h, w)) < 0.01] = 127
    return out[None]


def spiral_plane(h: int, w: int) -> np.ndarray:
    """(1, h, w) threshold plane: one square spiral of 1-px white path,
    rings 2 px apart, on black: one white and one black component, each
    winding through every CCL tile."""
    out = np.zeros((h, w), np.uint8)
    y0, x0, y1, x1 = 0, 0, h - 1, w - 1
    while y1 - y0 >= 4 and x1 - x0 >= 4:
        out[y0, x0:x1 + 1] = 255
        out[y0:y1 + 1, x1] = 255
        out[y1, x0:x1 + 1] = 255
        out[y0 + 2:y1 + 1, x0] = 255
        out[y0 + 2, x0:x0 + 3] = 255          # step into the next ring
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return out[None]


def comb_plane(h: int, w: int) -> np.ndarray:
    """(1, h, w) threshold plane: white teeth on the odd columns joined by
    a white bottom row, black teeth on the even columns joined by a black
    top row: two components that cross every tile border many times."""
    out = np.zeros((h, w), np.uint8)
    out[:, 1::2] = 255
    out[0] = 0
    out[-1] = 255
    return out[None]


def ragged_planes(b: int, h: int, w: int, seed: int = 11) -> np.ndarray:
    """(b, h, w) threshold planes of smooth random blobs of 0 and 255 with
    10% 127, for shapes that are no multiple of the CCL tile."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((b, h // 4 + 1, w // 4 + 1))
    field = np.kron(coarse, np.ones((4, 4)))[:, :h, :w]
    field = field + 0.15 * rng.random((b, h, w))
    out = np.where(field > 0.55, 255, 0).astype(np.uint8)
    out[rng.random((b, h, w)) < 0.1] = 127
    return out


def check_kernel_set(what: str, counts: dict, must: set) -> None:
    """Every kernel of `must` launched, every other kernel not."""
    check(all(counts[k] > 0 for k in must)
          and all(c == 0 for k, c in counts.items() if k not in must),
          f"{what}: expected launches of exactly {sorted(must)}, got "
          f"{counts}")


def check_device_launches(what: str, counts: dict) -> None:
    """The device launches that the C launchers of K2, K4 and K6 reported
    over a path's run: their fixed number per call times the calls."""
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    kernels = _build.kernel_counts()
    for name, per_call in (("rank_image", fk.RANK_LAUNCHES),
                           ("propagate_fixpoint", ck.FIXPOINT_LAUNCHES),
                           ("value_histogram", 1)):
        check(kernels[name] == per_call * counts[name],
              f"{what}: {name} made {kernels[name]} device launches in "
              f"{counts[name]} calls, not {per_call} each")


def call_ms(fn, reps: int = REPS) -> float:
    """Median over `reps` single calls of fn(), each between its own pair
    of CUDA events: what the eager main path pays per call, the host's
    enqueue included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms() -> float:
    """torch.cuda._sleep's cycles per ms on this card (measured once)."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)                     # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _SLEEP_CYCLES_PER_MS[0]


def host_waits(fn) -> bool:
    """Whether fn() makes the host wait on the device (an .item(), a
    blocking copy, torch.equal): torch's sync debug mode raises on one."""
    import torch
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()


def device_ms(fn, est_ms: float, reps: int = REPS) -> float | None:
    """Device time per call of fn(): the calls are enqueued behind a
    torch.cuda._sleep that outlasts their enqueue, between two CUDA
    events, so the device runs them back to back and the host's enqueue
    is not in the time. The sleep is checked to have outlasted the
    enqueue on the host clock and by the first event still pending when
    the last call is enqueued; it is lengthened once if not, and then one
    call is tried alone (a function of hundreds of launches fills the
    launch queue, and the host then waits for the device). None where fn
    makes the host wait on the device or no sleep outlasts one call's
    enqueue. est_ms is fn's call time; the calls are as many as fit in
    ~200 ms."""
    import torch
    if host_waits(fn):
        return None
    many = max(1, min(reps, int(200 / max(est_ms, 1e-3))))
    for n in sorted({many, 1}, reverse=True):
        sleep_ms = 5.0 + 2.0 * n * est_ms
        for _ in range(2):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
            a.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            covered = not a.query()
            b.synchronize()
            if covered and enqueue_ms < sleep_ms:
                return a.elapsed_time(b) / n
            sleep_ms *= 4.0
    return None


def both_ms(fn) -> dict:
    """call_ms and device_ms of fn(); device_ms None where it cannot be
    taken apart from the host (see device_ms)."""
    c = call_ms(fn)
    return dict(call_ms=c, device_ms=device_ms(fn, c))


def max_abs_err(name: str, got, want) -> float:
    """Max abs difference of each output from its plain version; raises
    unless every output is bit-exact (same shape and dtype, zero
    difference; float outputs are compared by their bits)."""
    import torch
    err = 0.0
    for g, w in zip(got, want, strict=True):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
              f"{w.dtype}")
        if g.dtype.is_floating_point:
            g = g.contiguous().view(torch.int32)
            w = w.contiguous().view(torch.int32)
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
        check(d == 0 and torch.equal(g, w),
              f"{name} differs from its plain version (max abs err {d})")
        err = max(err, float(d))
    return err


def bound_ms(inputs, outputs, ops: float = 0.0):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM_BYTES_S and
    the operations over CORE_OPS_S. -> (ms, "bytes" or "operations")."""
    import torch

    def nbytes(ts):
        if isinstance(ts, torch.Tensor):
            return ts.numel() * ts.element_size()
        return sum(nbytes(t) for t in ts)

    t_bytes = (nbytes(inputs) + nbytes(outputs)) / HBM_BYTES_S
    t_ops = ops / CORE_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(dev, bench4, clutter, bench4_1080, clutter_1080):
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import gather_kernel as gk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import segments as segs
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    from ros_vision_tpu_torch.ops import threshold_kernel as tk

    results = []
    g4 = torch.from_numpy(bench4).to(dev)
    gc = torch.from_numpy(clutter[None]).to(dev)
    g2 = torch.from_numpy(bench4_1080).to(dev)
    gc2 = torch.from_numpy(clutter_1080[None]).to(dev)
    k_cap = 32768                          # auto max_points at 1280x800
    p_cap = qf.QuadFitConfig(max_points=k_cap).max_boundary_pixels
    k_cap2 = 131072                        # auto max_points at 1920x1080
    p_cap2 = qf.QuadFitConfig(max_points=k_cap2).max_boundary_pixels

    def timings(kernel, plain, library) -> dict:
        """ms / call_ms of the kernel, plain_ms / plain_call_ms of its
        plain version and library_ms / library_call_ms of the library call
        (None where there is none): ms, plain_ms and library_ms are device
        times (device_ms). Where a plain version or library call makes the
        host wait on the device, its device time cannot be taken apart
        from the host; its call time stands there and its *_ms_kind says
        "call"."""
        t = both_ms(kernel)
        check(t["device_ms"] is not None,
              "a kernel's device time could not be taken apart from its "
              "enqueue")
        out = dict(ms=t["device_ms"], call_ms=t["call_ms"])
        for tag, fn in (("plain", plain), ("library", library)):
            if fn is None:
                out.update({f"{tag}_ms": None, f"{tag}_call_ms": None})
                continue
            t = both_ms(fn)
            dms = t["device_ms"]
            out[f"{tag}_ms"] = t["call_ms"] if dms is None else dms
            out[f"{tag}_ms_kind"] = "call" if dms is None else "device"
            out[f"{tag}_call_ms"] = t["call_ms"]
        return out

    def shape_entry(at, kernel, plain, inputs, library=None, ops=0.0):
        """Times and bound of a kernel at one shape (see timings)."""
        bound, by = bound_ms(inputs, kernel(), ops)
        return dict(at=at, **timings(kernel, plain, library), bound_ms=bound,
                    bound_by=by)

    def record(name, src, replaces, err, kernel, plain, at, inputs,
               library=None, ops=0.0, also=()):
        """The kernel's row: its times, its plain version's and (where one
        PyTorch call computes the same function) the library call's on the
        same inputs; the bound from the inputs and the kernel's outputs;
        `also` holds the same at the path's other shapes."""
        results.append(dict(
            name=name, route="cuda", source=f"ros_vision_tpu_torch/csrc/{src}",
            replaces=replaces, max_abs_err=err,
            **shape_entry(at, kernel, plain, inputs, library, ops),
            also=list(also)))

    def flat_init(t):
        b, h, w = t.shape
        idx = torch.arange(h * w, dtype=torch.int32, device=dev)
        return idx.view(1, h, w).expand(b, h, w).contiguous()

    # K1, also at 1920x1080
    err = max(max_abs_err("adaptive_threshold", tk.adaptive_threshold_fused(g),
                          tk.adaptive_threshold_plain(g))
              for g in (g4, gc, g2, gc2))
    record("adaptive_threshold", "threshold.cu",
           "ros_vision_tpu/ops/threshold_pallas.py:122", err,
           lambda: tk.adaptive_threshold_fused(g4),
           lambda: tk.adaptive_threshold_plain(g4), "1280x800 B=4", [g4],
           also=[shape_entry("1920x1080 B=4",
                             lambda: tk.adaptive_threshold_fused(g2),
                             lambda: tk.adaptive_threshold_plain(g2), [g2])])
    d4, t4 = tk.adaptive_threshold_plain(g4)
    _, tc = tk.adaptive_threshold_plain(gc)
    d2, t2 = tk.adaptive_threshold_plain(g2)
    _, tc2 = tk.adaptive_threshold_plain(gc2)

    # the union-find kernels (K2, K6) also on planes made to break a tiled
    # labelling: 255 diagonals through the tiles' corners, a spiral and a
    # comb whose components cross every tile, at both path widths, and
    # ragged frames (no multiple of the tile)
    adversarial = {
        f"{name} {w}x{h}": torch.from_numpy(make(h, w)).to(dev)
        for h, w in ((H // 2, W // 2), (H2 // 2, W2 // 2))
        for name, make in (("staircase", staircase_plane),
                           ("spiral", spiral_plane), ("comb", comb_plane))}
    adversarial["ragged 963x541 B=2"] = torch.from_numpy(
        ragged_planes(2, 541, 963)).to(dev)
    adversarial["ragged 53x37 B=3"] = torch.from_numpy(
        ragged_planes(3, 37, 53)).to(dev)

    def device_launches(counter, call, want: int, what: str):
        """call(), checking that its C launcher made `want` device
        launches, and that REPEATS more calls (their atomics racing in
        other orders) give the same outputs."""
        before = counter.kernels
        out = call()
        made = counter.kernels - before
        check(made == want, f"{what}: {made} device launches in one call, "
              f"not {want}")
        for _ in range(REPEATS):
            again = call()
            check(all(torch.equal(a, b) for a, b in zip(
                (out,) if isinstance(out, torch.Tensor) else out,
                (again,) if isinstance(again, torch.Tensor) else again)),
                  f"{what}: a repeated call gave other outputs")
        return out

    # K2 (labels, sizes and ranks; the clutter frame overflows the ranks)
    err = 0.0
    for what, t in [("bench 640x400 B=4", t4), ("clutter 640x400", tc),
                    *adversarial.items()]:
        got = device_launches(fk.rank_launches,
                              lambda: fk.label_components(t),
                              fk.RANK_LAUNCHES, f"rank_image on {what}")
        err = max(err, max_abs_err(f"rank_image on {what}", got,
                                   fk.label_components_plain(t)))
    print(f"  rank_image: bit-exact on the bench, clutter and "
          f"{len(adversarial)} adversarial planes, {fk.RANK_LAUNCHES} "
          "device launches a call")
    nblobs = int(fk.label_components_plain(tc)[2].max().item())
    print(f"  clutter frame: max rank {nblobs} (rank space 2048)")
    record("rank_image", "ccl.cu",
           "ros_vision_tpu/ops/frontend_pallas.py:505", err,
           lambda: fk.rank_image(t4), lambda: fk.label_components_plain(t4),
           "1280x800 B=4", [t4])
    r4 = fk.label_components_plain(t4)[2].view(t4.shape)
    rc = fk.label_components_plain(tc)[2].view(tc.shape)
    r2 = fk.label_components_plain(t2)[2].view(t2.shape)
    rc2 = fk.label_components_plain(tc2)[2].view(tc2.shape)
    print(f"  1920x1080 frames: max rank {r2.amax(dim=(1, 2)).tolist()} "
          f"(bench), {int(rc2.max().item())} (clutter; rank space 2048)")
    check(int(rc2.max().item()) == ccl.MAX_BLOBS,
          "the 1920x1080 clutter frame does not overflow the rank space")
    # the entry point keeps the JAX package's packing: rank 2048 -> -2048
    check(int(ccl.label_components(tc2)[2].min().item()) == -ccl.MAX_BLOBS,
          "ccl.label_components does not return -2048 for the 2048th blob")

    # K3 (the bench scene and the clutter frame overflow the caps), also
    # at 960x540 where the stage-A cap clamps to 80 rows
    err = 0.0
    for t, r, pc, kc in ((t4, r4, p_cap, k_cap), (tc, rc, p_cap, k_cap),
                         (t2, r2, p_cap2, k_cap2), (tc2, rc2, p_cap2, k_cap2)):
        key, pack2, counts = fk.boundary_compact(t, r, pc, kc)
        pts, cref = qf.boundary_points_capped(
            t, r.reshape(r.shape[0], -1), pc, kc)
        err = max(err, max_abs_err("boundary_compact", (key, pack2, counts),
                                   (pts["key"], pts["pack2"], cref)))
        maskbits, _ = qf.boundary_masks(t, r)
        emitting = ((maskbits & 0xF) != 0).sum(dim=(1, 2)).tolist()
        print(f"  boundary {t.shape[2]}x{t.shape[1]}: emitting px {emitting}"
              f" (stage-A cap "
              f"{qf.boundary_block_rows(pc, t.shape[2]) * t.shape[2]}),"
              f" points {counts.tolist()} (cap {kc})")
    record("boundary_compact", "boundary.cu",
           "ros_vision_tpu/ops/frontend_pallas.py:749", err,
           lambda: fk.boundary_compact(t4, r4, p_cap, k_cap),
           lambda: qf.boundary_points_capped(t4, r4.reshape(4, -1), p_cap,
                                             k_cap), "1280x800 B=4", [t4, r4],
           also=[shape_entry(
               "1920x1080 B=4",
               lambda: fk.boundary_compact(t2, r2, p_cap2, k_cap2),
               lambda: qf.boundary_points_capped(t2, r2.reshape(4, -1),
                                                 p_cap2, k_cap2), [t2, r2])])

    # the sort operands and histogram inputs of one use_pallas_sort
    # cluster_and_fit call on the bench batches: at the narrow 1280x800
    # width (8192), the full 1280x800 width (32768) and 1920x1080 (131072)
    key, pack2, _ = fk.boundary_compact(t4, r4, p_cap, k_cap)
    key2, pack22, _ = fk.boundary_compact(t2, r2, p_cap2, k_cap2)
    captured = {}
    for label, pts, decim, k in (
            ("1280x800 K=8192", {"key": key[:, :8192],
                                 "pack2": pack2[:, :8192]}, d4, 8192),
            ("1280x800 K=32768", {"key": key, "pack2": pack2}, d4, k_cap),
            ("1920x1080 K=131072", {"key": key2, "pack2": pack22}, d2,
             k_cap2)):
        captured[label] = capture_calls(pts, decim, k)

    # K4 on those histogram inputs (segment ids, then peak segments; one
    # kernel launch a call), plus out-of-range values
    seg, peak = captured["1280x800 K=32768"]["hists"]
    seg2, peak2 = captured["1920x1080 K=131072"]["hists"]
    rng = np.random.default_rng(3)
    odd = torch.from_numpy(rng.integers(-5, 1100, (4, 8192),
                                        dtype=np.int32)).to(dev)
    err = 0.0
    for v in [odd] + [h for c in captured.values() for h in c["hists"]]:
        before = gk.launches.kernels
        got = gk.histogram(v, 1025)
        check(gk.launches.kernels - before == 1,
              f"value_histogram made {gk.launches.kernels - before} kernel "
              "launches in one call, not 1")
        err = max(err, max_abs_err("value_histogram", (got,),
                                   (gk.value_histogram_plain(v, 1025),)))
    hist_out = torch.zeros((4, 1025), dtype=torch.int32, device=dev)

    def k4(v):
        v64, ones = v.to(torch.int64), torch.ones_like(v)
        return dict(kernel=lambda: gk.histogram(v, 1025),
                    plain=lambda: gk.value_histogram_plain(v, 1025),
                    library=lambda: hist_out.scatter_add_(1, v64, ones),
                    inputs=[v])

    record("value_histogram", "histogram.cu",
           "ros_vision_tpu/ops/gather_pallas.py:168", err,
           at="1280x800 B=4 K=32768 (segment ids)", **k4(seg),
           also=[shape_entry(at, **k4(v)) for at, v in (
               ("1920x1080 B=4 K=131072 (segment ids)", seg2),
               ("1280x800 B=4 K=32768 (peak segments)", peak),
               ("1920x1080 B=4 K=131072 (peak segments)", peak2))])

    # K6 at 960x540: flat indices (the labels of label_components_flood),
    # the packed per-root table (its broadcast="flood"; INT32_MAX off the
    # roots), the clutter frame, and the adversarial planes with flat
    # indices and with random values (INT32_MAX and 2^30 among them)
    n2 = t2.shape[1] * t2.shape[2]
    init2, initc2 = flat_init(t2), flat_init(tc2)
    lab2 = ccl.propagate_fixpoint(t2, init2).view(4, n2)
    labc2 = ccl.propagate_fixpoint(tc2, initc2).view(1, n2)
    counts2 = ccl.label_histogram(lab2)
    packed2 = ccl.packed_root_table(counts2, 25).view(t2.shape)
    cases = [("bench 960x540 B=4, flat indices", t2, init2),
             ("bench 960x540 B=4, packed root table", t2, packed2),
             ("clutter 960x540, flat indices", tc2, initc2)]
    for what, t in adversarial.items():
        vals = rng.integers(0, 2 ** 31 - 1, t.shape, dtype=np.int64)
        vals.reshape(-1)[:2] = [2 ** 31 - 1, 2 ** 30]
        cases += [(f"{what}, flat indices", t, flat_init(t)),
                  (f"{what}, random values", t,
                   torch.from_numpy(vals.astype(np.int32)).to(dev))]
    err = 0.0
    for what, t, v in cases:
        got = device_launches(ck.fixpoint_launches,
                              lambda: ck.propagate_fixpoint(t, v),
                              ck.FIXPOINT_LAUNCHES,
                              f"propagate_fixpoint on {what}")
        err = max(err, max_abs_err(f"propagate_fixpoint on {what}", (got,),
                                   (ccl.propagate_fixpoint(t, v),)))
    print(f"  propagate_fixpoint: bit-exact on {len(cases)} plane and value "
          f"sets, {ck.FIXPOINT_LAUNCHES} device launches a call")
    record("propagate_fixpoint", "flood.cu",
           "ros_vision_tpu/ops/ccl_pallas.py:312", err,
           lambda: ck.propagate_fixpoint(t2, init2),
           lambda: ccl.propagate_fixpoint(t2, init2), "1920x1080 B=4",
           [t2, init2])

    # K7 on converged labels and on random labels, some outside [0, N)
    rnd = rng.integers(-1000, n2 + 5000, (4, n2)).astype(np.int32)
    rnd[:, :3] = [-1, n2, 2 ** 31 - 1]
    rnd = torch.from_numpy(rnd).to(dev)
    err = max(max_abs_err("label_histogram", (ck.label_histogram(v),),
                          (ccl.label_histogram(v),))
              for v in (lab2, labc2, rnd))
    lab2_64 = lab2.to(torch.int64)
    ones2 = torch.ones_like(lab2)
    lhist_out = torch.zeros_like(lab2)
    record("label_histogram", "flood.cu",
           "ros_vision_tpu/ops/ccl_pallas.py:376", err,
           lambda: ck.label_histogram(lab2),
           lambda: ccl.label_histogram(lab2), "1920x1080 B=4", [lab2],
           library=lambda: lhist_out.scatter_add_(1, lab2_64, ones2))

    # K12 at n = 518,400: the rank table of the bench labels, and random
    # labels (some outside [0, N)) over a random table
    rank_v2 = ccl.dense_ranks(counts2 >= 25)
    rnd_v = torch.from_numpy(rng.integers(0, 2049, (4, n2),
                                          dtype=np.int32)).to(dev)
    err = max(max_abs_err("rank_gather", (gk.rank_gather(lab, tab),),
                          (gk.rank_gather_plain(lab, tab),))
              for lab, tab in ((lab2, rank_v2), (rnd, rnd_v)))
    record("rank_gather", "gather.cu",
           "ros_vision_tpu/ops/gather_pallas.py:340", err,
           lambda: gk.rank_gather(lab2, rank_v2),
           lambda: gk.rank_gather_plain(lab2, rank_v2), "1920x1080 B=4",
           [lab2, rank_v2],
           library=lambda: torch.gather(rank_v2, 1, lab2_64))

    # K8 at 1280x800 B=4: the hybrid CCL's first round (448 sweeps), 0, 1;
    # its least work is 8 neighbour mins per pixel per sweep
    init4 = flat_init(t4)
    err = max(max_abs_err("propagate", (ck.propagate(t4, init4, k),),
                          (ccl.propagate(t4, init4, k),))
              for k in (448, 0, 1))
    record("propagate", "flood.cu",
           "ros_vision_tpu/ops/ccl_pallas.py:405", err,
           lambda: ck.propagate(t4, init4, 448),
           lambda: ccl.propagate(t4, init4, 448), "1280x800 B=4, 448 sweeps",
           [t4, init4], ops=448 * 8 * t4.numel())

    # K9 on the operands of cluster_and_fit's four sorts, at each width:
    # bit-exact against the network's plain version, one kernel launch a
    # call; their times go into the row's `also`
    err = 0.0
    sort_shapes = []
    for label, calls in captured.items():
        sorts = calls["sorts"]
        check([(len(ops), nk) for ops, nk in sorts]
              == [(2, 2), (1, 1), (2, 2), (3, 3)],
              f"{label}: cluster_and_fit sorts "
              f"{[(len(o), nk) for o, nk in sorts]}")
        for ops, nk in sorts:
            err = max(err, sort_err(ops, nk))
            sort_shapes.append(shape_entry(
                f"{label}, {len(ops)} plane(s)",
                lambda: sk.sort_tpu(ops, nk), lambda: sk.sort_plain(ops, nk),
                ops, library=library_sort(ops),
                ops=2 * ops[0].numel() * (ops[0].shape[1] - 1)
                .bit_length()))

    def b4(lo, hi, k):
        """(4, k) int32 uniform in [lo, hi) on the card."""
        return torch.from_numpy(rng.integers(lo, hi, (4, k), dtype=np.int64)
                                .astype(np.int32)).to(dev)

    sentinel = torch.full((4, 32768), qf.KEY_INVALID, dtype=torch.int32,
                          device=dev)
    sentinel[:, ::700] = b4(0, 1 << 22, 32768)[:, ::700]
    peak = [b4(0, 65, 1000), -b4(0, 1 << 30, 1000),
            torch.arange(1000, dtype=torch.int32, device=dev).expand(
                4, 1000).contiguous()]
    # random, duplicate, sentinel and peak-pattern rows, payload planes
    # (num_keys < operands) and N = 262,144 past one cluster's 131,072
    for ops, nk in (([b4(0, 1 << 22, 131072), b4(0, 1 << 22, 131072)], 2),
                    ([b4(0, 7, 32768), b4(0, 5, 32768)], 2),
                    ([sentinel, torch.zeros_like(sentinel)], 2),
                    (peak, 3), ([b4(-2 ** 31, 2 ** 31 - 1, 1000)], 1),
                    ([b4(0, 50, 8192), b4(-1000, 1000, 8192)], 1),
                    ([b4(0, 9, 131072), b4(0, 3, 131072), b4(-9, 9, 131072)],
                     1),
                    ([b4(0, 50, 16385), b4(-5, 5, 16385)], 1),
                    ([b4(0, 1000, 200000), b4(0, 1 << 20, 200000)], 1)):
        err = max(err, sort_err(ops, nk))
    ops = captured["1920x1080 K=131072"]["sorts"][0][0]
    record("sort_tpu", "sort.cu", "ros_vision_tpu/ops/sort_pallas.py:146",
           err, lambda: sk.sort_tpu(ops, 2), lambda: sk.sort_plain(ops, 2),
           "1920x1080 B=4 K=131072, (pair key, payload) as keys", ops,
           library=library_sort(ops), ops=2 * ops[0].numel() * 17,
           also=sort_shapes)

    # K10 at the shape of cluster_and_fit's (B, NSEG1, 4) per-segment table
    # gathered at its (B, 32768) segment ids; random indices (some outside
    # [0, S)) over a table with -0.0, inf and NaN entries
    table = torch.from_numpy(rng.normal(0, 100, (4, 1025, 4)).astype(
        np.float32)).to(dev)
    odd_tab = table.clone()
    odd_tab[0, 5] = torch.tensor([-0.0, float("inf"), float("nan"), -1.0])
    odd_idx = b4(-5, 1030, 32768)
    odd_idx[:, :64] = 5
    err = max(max_abs_err("table_take_cm", (gk.take_cm(tab, ix),),
                          (gk.table_take_cm_plain(tab, ix),))
              for tab, ix in ((table, seg), (odd_tab, odd_idx)))
    table_t = table.transpose(1, 2)
    seg64 = seg.to(torch.int64)[:, None, :].expand(4, 4, seg.shape[1])
    record("table_take_cm", "gather.cu",
           "ros_vision_tpu/ops/gather_pallas.py:95", err,
           lambda: gk.take_cm(table, seg),
           lambda: gk.table_take_cm_plain(table, seg),
           "1280x800 B=4 S=1025 C=4 K=32768", [table, seg],
           library=lambda: torch.gather(table_t, 2, seg64))

    # K11 at 1920x1080: the y extents of the (B, 131072) segments (the
    # role of cluster_and_fit's ykey sort), and random ids (some outside
    # [0, S)) with values past +-2^30
    key_s2, pack2_s2 = qf._sort2(key2, pack22)
    seg2 = segs.segment_ids_from_sorted_keys(
        key_s2, valid=key_s2 < qf.KEY_INVALID, max_segments=1024)
    y2 = qf.unpack_payload(pack2_s2)[1].contiguous()
    rnd_seg, rnd_val = b4(-20, 1045, 131072), b4(-2 ** 31, 2 ** 31 - 1, 131072)
    err = max(max_abs_err("segment_min_max", gk.segment_min_max(sg, v, 1025),
                          gk.segment_min_max_plain(sg, v, 1025))
              for sg, v in ((seg2, y2), (rnd_seg, rnd_val)))
    seg2_64 = seg2.to(torch.int64)
    mn_out = torch.full((4, 1025), 2 ** 30, dtype=torch.int32, device=dev)
    mx_out = torch.full_like(mn_out, -2 ** 30)
    record("segment_min_max", "segment.cu",
           "ros_vision_tpu/ops/gather_pallas.py:251", err,
           lambda: gk.segment_min_max(seg2, y2, 1025),
           lambda: gk.segment_min_max_plain(seg2, y2, 1025),
           "1920x1080 B=4 S=1025 K=131072", [seg2, y2],
           library=lambda: (mn_out.scatter_reduce_(1, seg2_64, y2, "amin"),
                            mx_out.scatter_reduce_(1, seg2_64, y2, "amax")))
    for r in results:
        for e in [r] + r["also"]:
            print(f"  {r['name']} at {e['at']}: kernel {e['ms']:.4f} ms "
                  f"device / {e['call_ms']:.4f} call; plain "
                  f"{e['plain_ms']:.4f} ({e['plain_ms_kind']}) / "
                  f"{e['plain_call_ms']:.4f} call; library "
                  + ("none" if e["library_ms"] is None else
                     f"{e['library_ms']:.4f} ({e['library_ms_kind']}) / "
                     f"{e['library_call_ms']:.4f} call")
                  + f"; bound {e['bound_ms']:.5f} ms ({e['bound_by']})")
        print(f"  {r['name']}: max abs err {r['max_abs_err']} (bit-exact)")
    return results, dict(t4=t4, t2=t2)


def capture_calls(pts: dict, decim, k: int) -> dict:
    """The sort_tpu operands (with num_keys) and the value_histogram inputs
    of one cluster_and_fit call with use_pallas_sort on these points."""
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    sorts, hists = [], []
    real_sort, real_hist = sk.sort_tpu, qf.histogram

    def sort_recording(operands, num_keys=1):
        operands = list(operands)
        sorts.append(([o.contiguous().clone() for o in operands], num_keys))
        return real_sort(operands, num_keys)

    def hist_recording(values, num_values):
        check(num_values == 1025, f"histogram of {num_values} bins")
        hists.append(values.contiguous().clone())
        return real_hist(values, num_values)

    sk.sort_tpu, qf.histogram = sort_recording, hist_recording
    try:
        qf.cluster_and_fit(pts, decim, qf.QuadFitConfig(
            max_points=k, use_pallas_sort=True))
    finally:
        sk.sort_tpu, qf.histogram = real_sort, real_hist
    check(len(hists) == 2, f"cluster_and_fit made {len(hists)} histograms")
    return dict(sorts=sorts, hists=hists)


def library_sort(ops: list):
    """One stable torch.sort computing K9's function where every operand is
    a key: of the plane itself, or of one int64 packing of the planes, each
    offset by its minimum into the bits its range needs (the operands of
    cluster_and_fit's sorts need at most 60: at 131,072, 11 bits of
    segment, 32 of -errbits and 17 of position for the peak sort); None
    where they need more than 63. The packing is made here, outside the
    timed call, and its sort is checked to order the planes as K9's plain
    version does."""
    import torch
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    if len(ops) == 1:
        return lambda: torch.sort(ops[0], dim=1, stable=True)
    lows = [int(o.min().item()) for o in ops]
    bits = [(int(o.max().item()) - lo).bit_length()
            for o, lo in zip(ops, lows)]
    if sum(bits) > 63:
        return None

    def pack(planes):
        packed = torch.zeros(planes[0].shape, dtype=torch.int64,
                             device=planes[0].device)
        for p, lo, nb in zip(planes, lows, bits):
            packed = (packed << nb) | (p.to(torch.int64) - lo)
        return packed

    packed = pack(ops)
    check(torch.equal(torch.sort(packed, dim=1, stable=True)[0],
                      pack(sk.sort_plain(ops, len(ops)))),
          f"the int64 packing of {len(ops)} planes does not sort as K9")
    return lambda: torch.sort(packed, dim=1, stable=True)


def sort_err(ops: list, num_keys: int) -> float:
    """K9 against the network's plain version, every plane bit-exact
    (payload order included), and against the stable plain version where
    every operand is a key; the C launcher's count of kernel launches
    equals the plan's, which is 1 for N <= 131,072."""
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    before = sk.launches.kernels
    got = sk.sort_tpu(ops, num_keys)
    made = sk.launches.kernels - before
    plan = sk.sort_plan(ops[0].shape[1], len(ops))
    check(made == plan.launches and (plan.n > 131072 or made == 1),
          f"sort_tpu at K={ops[0].shape[1]} made {made} kernel launches "
          f"(plan {plan.launches})")
    err = max_abs_err("sort_tpu", got, sk.sort_network_plain(ops, num_keys))
    if num_keys == len(ops):
        err = max(err, max_abs_err("sort_tpu vs stable sorts", got,
                                   sk.sort_plain(ops, num_keys)))
    return err


def match_corners(dets, placed_list, tol: float, what: str) -> float:
    """Max distance from each detected corner to the nearest rendered
    corner of the same tag."""
    worst = 0.0
    placed = {p.tag_id: p.corners for p in placed_list}
    for d in dets:
        ref = placed[d.tag_id]
        dist = np.linalg.norm(d.corners[:, None, :] - ref[None], axis=-1)
        worst = max(worst, float(dist.min(axis=1).max()))
    check(worst < tol, f"{what}: corner error {worst:.4f} px >= {tol}")
    return worst


def detector_phase(dev, bench4, placed, must: set):
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    _, height, width = bench4.shape
    kw = dict(width=width, height=height, fx=900.0, fy=900.0,
              cx=width / 2, cy=height / 2, estimate_pose=True)
    det = TorchDetector(device=dev, **kw)
    cpu = TorchDetector(device="cpu", **kw)
    det.detect(bench4)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    out = {}
    for b in (1, 4):
        frames = bench4[:b]
        s0 = det.host_syncs.count
        rows = det.detect(frames)
        syncs = det.host_syncs.count - s0
        rows_cpu = cpu.detect(frames)
        for i, (dets, dets_cpu) in enumerate(zip(rows, rows_cpu)):
            ids = [d.tag_id for d in dets]
            check(ids == BENCH_IDS, f"B={b} row {i}: ids {ids}")
            check([d.tag_id for d in dets_cpu] == ids,
                  f"B={b} row {i}: CPU plain path ids differ")
            dc = max(float(np.abs(x.corners - y.corners).max())
                     for x, y in zip(dets, dets_cpu))
            dp = max(float(np.abs(x.pose_t - y.pose_t).max())
                     for x, y in zip(dets, dets_cpu))
            check(dc < 0.1, f"B={b} row {i}: {dc:.4f} px from CPU plain")
            dr = match_corners(dets, placed, 1.0, f"B={b} row {i}")
            print(f"  B={b} row {i}: ids {ids}; corners vs CPU plain "
                  f"{dc:.5f} px, vs rendered {dr:.4f} px; pose_t vs CPU "
                  f"{dp * 1e3:.4f} mm")
        g = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            det.detect_raw_packed(g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        out[b] = dict(ms_per_frame=ms / b, host_syncs_per_call=syncs)
        print(f"  B={b}: {ms / b:.3f} ms/frame ({ms:.3f} ms/call, median of "
              f"{REPS}, host clock incl. sync), {syncs} host syncs/call")
    counts = _build.counts()
    print(f"  launches in the detector phase: {counts}")
    check_kernel_set(f"detector {width}x{height}", counts, must)
    check_device_launches(f"detector {width}x{height}", counts)
    return out, counts


def pallas_sort_phase(dev, bench4, must: set):
    """TorchDetector(use_pallas_sort=True) at B=4 against the default
    configuration on the same batch: bit-identical packed outputs, the
    bench ids in every row, exactly the path's kernels plus sort_tpu, 4
    sort_tpu launches per call (one cluster_and_fit); the two
    configurations' call times taken in turns."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    _, height, width = bench4.shape
    kw = dict(width=width, height=height, fx=900.0, fy=900.0,
              cx=width / 2, cy=height / 2, estimate_pose=True)
    det = TorchDetector(device=dev, **kw)
    det_ps = TorchDetector(device=dev, use_pallas_sort=True, **kw)
    g = torch.from_numpy(np.ascontiguousarray(bench4)).to(dev)
    want = det.detect_raw_packed(g)
    det_ps.detect_raw_packed(g)                           # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    got = det_ps.detect_raw_packed(g)
    torch.cuda.synchronize()
    counts = _build.counts()
    print(f"  launches in one use_pallas_sort call: {counts}")
    check_kernel_set(f"use_pallas_sort detector {width}x{height}", counts,
                     must | {"sort_tpu"})
    kernels = _build.kernel_counts()
    check(counts["sort_tpu"] == 4 and kernels["sort_tpu"] == 4,
          f"sort_tpu: {counts['sort_tpu']} calls and {kernels['sort_tpu']} "
          "kernel launches, not 4 of each")
    check(counts["value_histogram"] == 2,
          f"value_histogram: {counts['value_histogram']} calls, not 2")
    check_device_launches(f"use_pallas_sort detector {width}x{height}",
                          counts)
    max_abs_err("use_pallas_sort packed output", (got,), (want,))
    for i, dets in enumerate(det_ps.unpack(got)):
        ids = [d.tag_id for d in dets]
        check(ids == BENCH_IDS, f"use_pallas_sort row {i}: ids {ids}")
    times = {"default": [], "use_pallas_sort": []}
    for _ in range(REPS):
        for name, d in (("default", det), ("use_pallas_sort", det_ps)):
            t0 = time.perf_counter()
            d.detect_raw_packed(g)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"  B=4 {width}x{height}: packed output bit-identical to the "
          f"default; ids {BENCH_IDS} in every row; ms/call default "
          f"{ms['default']:.3f}, use_pallas_sort {ms['use_pallas_sort']:.3f}"
          f" (medians of {REPS}, in turns, host clock incl. sync)")
    return ms, counts


def ccl_paths_phase(t4, t2):
    """The ops/ccl.py entry points off the detector: each run with the
    counts reset, its launches read, and its output held against the
    plain CCL on the card (ccl.label_components for the hybrid, which
    shares its rank packing; K2's plain version, ranks 1..2048, for the
    flood entry points)."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.device import HostSyncs
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import frontend_kernel as fk

    paths = {
        "label_components_hybrid (1280x800 B=4)":
            (lambda syncs: ccl.label_components_hybrid(t4, syncs=syncs),
             lambda: ccl.label_components(t4), {"propagate"}),
        "flood_ranks (1920x1080 B=4)":
            (lambda syncs: (ccl.flood_ranks(t2),),
             lambda: fk.label_components_plain(t2)[2:],
             {"propagate_fixpoint", "label_histogram", "rank_gather"}),
        "label_components_flood broadcast=flood (1920x1080 B=4)":
            (lambda syncs: ccl.label_components_flood(t2, broadcast="flood"),
             lambda: fk.label_components_plain(t2),
             {"propagate_fixpoint", "label_histogram"}),
    }
    launches = {}
    for name, (run, plain, must) in paths.items():
        syncs = HostSyncs()
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        got = run(syncs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _build.counts()
        max_abs_err(name, got, plain())
        check_kernel_set(name, counts, must)
        check_device_launches(name, counts)
        print(f"  {name}: bit-exact vs the plain CCL; {ms:.3f} ms (one "
              f"call, host clock incl. sync), {syncs.count} host syncs; "
              f"launches {counts}")
        launches[name] = counts
    return launches


class RecordingSender:
    """Stands in for the NT4 AprilTagDataSender: records each publish."""

    def __init__(self):
        self.values = []
        self.lock = threading.Lock()

    def send_value(self, flat):
        with self.lock:
            self.values.append((time.time(), list(flat)))

    def send_protobuf(self, data):
        pass


def system_phase(dev, min_batches: int = 20):
    import torch
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                simple_square_corners)
    from ros_vision_tpu_torch.config.loader import ConfigLoader
    from ros_vision_tpu_torch.runtime.camera import MockCamera
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.launch import VisionSystem

    scenes_ids = {"mock0": [0, 42], "mock1": [100, 311], "mock2": [7, 23],
                  "mock3": [55, 210, 400]}
    layouts = [(300, 250, 90, 0), (800, 400, 110, 20), (450, 600, 70, -35)]
    scenes = {}
    for ident, ids in scenes_ids.items():
        scenes[ident] = render_scene(
            ids, [simple_square_corners(x, y, s, a)
                  for x, y, s, a in layouts[:len(ids)]],
            W, H, noise_sigma=1.0, seed=len(scenes))[0]
    locs = ["center_front", "left_front", "right_front", "back"]
    rot = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cfg = {"camera_mounted_positions": {
               ident: {"location": loc, "format": "MJPG", "height": H,
                       "width": W, "frame_rate": 100,
                       "api_preference": "ANY"}
               for ident, loc in zip(scenes_ids, locs)},
           "extrinsics": {loc: {"rotation": rot, "offset": [0.0, 0.0, 0.0]}
                          for loc in locs}}
    cfg_dir = ROOT / "build" / "chip_smoke"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = cfg_dir / "system_config.json"
    cfg_path.write_text(json.dumps(cfg))
    ConfigLoader.set_config_file_path(str(cfg_path))

    def factory(ident, idx):
        frame = scenes[ident]

        def read(n):
            time.sleep(0.01)                 # a 100 fps camera
            return frame
        return MockCamera(width=W, height=H, frame_factory=read)

    senders = {loc: RecordingSender() for loc in locs}
    system = VisionSystem(
        device=dev, enable_viewer=False, enable_nt=False,
        camera_map={ident: i for i, ident in enumerate(scenes_ids)},
        camera_factory=factory, tag_sender=senders,
        detector_overrides=dict(fx=900.0, fy=900.0, cx=640.0, cy=400.0))
    try:
        # warm-up batches outside the measured run
        system.start()
        for _ in range(3):
            system.spin_once()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for s in senders.values():
            s.values.clear()
        _build.reset_counts()
        spinner = threading.Thread(target=system.spin, name="spin")
        t0 = time.monotonic()
        spinner.start()
        deadline = t0 + 300
        while time.monotonic() < deadline and (
                system.spin_stats is None
                or system.spin_stats["batches"] < min_batches):
            time.sleep(0.05)
        batches = system.spin_stats["batches"] if system.spin_stats else 0
        elapsed = time.monotonic() - t0
    finally:
        system._running = False
        if "spinner" in locals():
            spinner.join(timeout=60)
        system.stop()
        ConfigLoader.set_config_file_path(None)
        ConfigLoader.reload_config()
    counts = _build.counts()
    check(batches >= min_batches, f"only {batches} batches spun")
    print(f"  launches in the system phase: {counts}")
    check_kernel_set("system run", counts, PATH_800)
    check_device_launches("system run", counts)
    lat = []
    for ident, loc in zip(scenes_ids, locs):
        vals = senders[loc].values
        full = 0
        for t_recv, flat in vals:
            rows = np.asarray(flat, np.float64).reshape(-1, 5)
            ids = sorted(int(v) for v in rows[:, 1])
            check(set(ids) <= set(scenes_ids[ident]),
                  f"{ident}: published foreign ids {ids}")
            check(np.isfinite(rows).all(), f"{ident}: non-finite pose")
            if ids == sorted(scenes_ids[ident]):
                full += 1
                lat.append((t_recv - rows[0, 0]) * 1e3)
        check(full >= min_batches // 2,
              f"{ident}: its ids {scenes_ids[ident]} published in only "
              f"{full} of {len(vals)} batches")
        print(f"  {ident} ({loc}): ids {scenes_ids[ident]} in {full} of "
              f"{len(vals)} publishes")
    fps = batches / elapsed
    p50 = statistics.median(lat)
    print(f"  {batches} batches in {elapsed:.2f} s: {fps:.2f} fps per "
          f"camera, capture->publish p50 {p50:.1f} ms, spin stats "
          f"{system.spin_stats}")
    return counts, dict(fps_per_camera=fps, p50_latency_ms=p50)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.device import require_cuda

    dev = require_cuda()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)

    t0 = time.monotonic()
    _build.LIBRARY.get()
    built = _build.LIBRARY.build_seconds
    print(f"[build] kernels ready in {time.monotonic() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'})")
    for line in _build.LIBRARY.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    bench = [bench_scene(seed) for seed in range(4)]
    bench4 = np.stack([img for img, _ in bench])
    bench_1080 = [bench_scene(seed, W2, H2, NOISE_1080) for seed in range(4)]
    bench4_1080 = np.stack([img for img, _ in bench_1080])

    print("[kernels]")
    kernels, planes = kernel_phase(dev, bench4, clutter_frame(), bench4_1080,
                                   clutter_frame(width=W2, height=H2))
    paths = {}
    print(f"[detector {W}x{H}]")
    det, paths["detector 1280x800"] = detector_phase(
        dev, bench4, bench[0][1], PATH_800)
    print(f"[detector {W2}x{H2}]")
    det_1080, paths["detector 1920x1080"] = detector_phase(
        dev, bench4_1080, bench_1080[0][1], PATH_1080)
    sorted_ms = {}
    print(f"[use_pallas_sort detector {W}x{H}]")
    sorted_ms["1280x800"], paths["use_pallas_sort 1280x800"] = \
        pallas_sort_phase(dev, bench4, PATH_800)
    print(f"[use_pallas_sort detector {W2}x{H2}]")
    sorted_ms["1920x1080"], paths["use_pallas_sort 1920x1080"] = \
        pallas_sort_phase(dev, bench4_1080, PATH_1080)
    print("[ccl entry points]")
    paths.update(ccl_paths_phase(planes["t4"], planes["t2"]))
    print("[system]")
    paths["system"], system = system_phase(dev)
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths.values())
    print(json.dumps({"detector": {str(b): v for b, v in det.items()},
                      "detector_1080": {str(b): v
                                        for b, v in det_1080.items()},
                      "use_pallas_sort_b4_ms_per_call": sorted_ms,
                      "system": system}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
