#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ros_vision_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits nonzero and prints no result.
Phases, each of which raises (and so exits nonzero) on failure:
  1. build the kernels (one nvcc per csrc/*.cu, all started together,
     sm_90a) from the checkout;
  2. kernel checks: each of the eleven kernels against its plain PyTorch
     version on the card, bit-exact (P1 and P2 within limits), timed two
     ways beside its plain
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
     again at 1920x1080; K1 (one launch a call) also on a 1288x808 B=2
     batch (W % 16 == 8) and a batch whose pointer is not 16-byte
     aligned; K3 (one thread-block cluster launch a call) also on the
     two ragged frames below with caps that overflow and caps that do
     not; each K1 and K3 call checked to make its C launcher's one device
     launch and repeated 10 times with identical outputs; K2 and K6 (the
     tiled union-find) also on
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
     scene B=4 and a cluttered frame past the 2048-blob rank space), K7
     (one cooperative launch a call) on the bench, clutter and random
     labels, an unaligned batch and a batch of more chunks than the
     co-resident grid holds; K8 (one launch a round of
     PROPAGATE_HALO sweeps kept in shared memory) at 1280x800 B=4, on the
     union-find planes and ragged frames and on a plane with values
     outside {0, 127, 255} (the kernel's masked path) with 0, 1, T, T+1 and 448
     sweeps (T = PROPAGATE_HALO), each K7 and K8 call checked to make its
     C launcher's device launches and repeated 10 times with identical
     outputs; K10 (one launch a call) at B=4 S=1025 C=4 K=32768, also at
     C = 1, 3, 4 and 9, K = 32771 and on a table with -0.0, inf and NaN;
     K11 (one thread-block cluster launch a call) at B=4 K=131072 S=1025
     on the path's sorted ids and on random ids, also at K = 131075, B = 1,
     B = 12, S above segment_plan's cap and with every id outside [0, S);
     each K10 and K11 call checked to make its C launcher's one device
     launch and repeated 10 times with identical outputs; P1
     (estimate_poses, not a Pallas kernel: the JAX function's
     lax.fori_loops) on the homographies of one TorchDetector call on
     each bench batch (B=4, the 8-slot tail tier), the same padded with
     zero slots to the 128-slot fallback, and seeded_homographies' 4x128
     batch (0.5-6 m, tilts to 70 degrees, the planar ambiguity, zero and
     NaN slots), one device launch a call, 10 repeats bit-identical,
     within pose_limits of its plain version on the card (not bit-exact:
     f32 sums in other orders), timed also on one slot (its dependent
     chain, beside the chain counted from the code: POSE_CHAIN), its
     plain version's device time from the profiler; P2
     (refine_edges, not a Pallas kernel: the JAX function's
     _refine_edges_core with its lax.fori_loop undistortion) on the
     corners one TorchDetector call hands refine_edges on each bench
     batch (B=4, the 8-slot tier) and on the same moved by a seeded
     N(0, 0.6 px), each with a zero and a NaN slot a row, at every sample
     grid tier (32, 64, 128), without distortion and with LENS_DIST, with
     the normal border and the reversed one on the inverted frames: one
     device launch a call, 10 repeats bit-identical, corners within
     REFINE_LIMIT_PX (1e-3 px) of its plain version on the card and
     non-finite in the same places (the order of its moment sums is its
     own), timed at the path's shapes with and without distortion, with
     a NaN slot a row beside the path's own corners, at the 128-sample
     tier and on one slot, its plain version's device time
     from the profiler. Before the kernel rows, the launch floor: device
     and call time of torch.cuda._sleep(0), one launch of a kernel that
     does nothing;
  3. detector at 1280x800 and at 1920x1080: TorchDetector at B=1 and B=4
     on the bench scene (1.5x layout at 1080p) — ids [0, 42, 100, 311] in
     every row, corners within 0.1 px of the same detector's plain path on
     the CPU and within 1 px of the rendered corners, pose_t within 1 mm
     and pose_R within 1e-3 of it, and exactly the front end's kernel set
     launched (K2 at 1280x800, K6 + K7 at 1920x1080, P1 and P2); then
     TorchDetector(use_pallas_sort=True) at B=4 at both
     sizes, its packed output bit-identical to the default's, its kernel
     set the path's plus K9 with 4 K9 calls and 4 kernel launches per
     call (K4: one kernel launch per call on every detector path);
  4. the other ops/ccl.py entry points: label_components_hybrid (K8),
     flood_ranks (K6, K7, K12) and label_components_flood with
     broadcast="flood" (K6, K7), each held against the plain CCL;
  5. system: the port's VisionSystem with 4 mock cameras at 1280x800, each
     showing its own tags, spun for >= 20 batches; each camera publishes
     its own ids with finite robot-frame poses;
  6. rectify (ops/rectify.py) at 1280x800 B=4 on the lens of
     tests/test_rectify.py scaled to 1280 px (k1 = -0.25): Rectifier alone
     and behind each Bayer pattern's debayer, within 1 grey level of the
     same Rectifier on the CPU (the share of pixels that differ printed),
     none of the port's kernels launched; then the bench tags rendered at
     their lens-distorted corners, rectified on the card and detected by
     TorchDetector: the bench ids in every row, corners within 1 px of the
     ideal ones, the 1280x800 path's kernels launched; then the calibrated
     camera's path ([calibrated detector]): the same lens-moved frames
     detected directly by TorchDetector(**LENS, dist=LENS_DIST,
     estimate_pose=True), whose refine_edges fits in undistorted
     coordinates (P2 with its undistortion), on the card and on the CPU at
     B=1 and B=4: the bench ids in every row, corners within 1 px of the
     lens-moved truth and 0.1 px of the CPU, pose_t within 1 mm and pose_R
     within 1e-3 of the CPU, the 1280x800 kernel set; ms/frame at B=1 and
     B=4 beside the same detector without the distortion, in turns;
  7. game piece: YOLOv11n at 640x640, one class, seeded weights (BatchNorm
     and head biases drawn too), bf16 — the deployed gamepiece_yolo11n
     configuration. 1280x800 BGR frames through preprocess_device, infer
     and the scale-back at B=1 and B=4, none of the port's kernels
     launched; the card's raw (B, 5, 8400) within GP_BF16_TOL of the
     port's f32 forward on the CPU, and the card's f32 forward (TF32 off)
     within GP_F32_TOL; the card's NMS on the CPU's raw output equal to
     the CPU's in every slot; the weights through save_params /
     load_params give identical outputs; GamePieceNode.process_frame where
     cv2 imports; ms/frame of infer (forward + NMS) and of the NMS alone at
     B=1 and B=4, medians of 20, and the device-busy share and top device
     operations from torch.profiler;
  8. train (models/train.py): YOLOv11n at 640x640, one class, f32, B=8,
     from the seeded weights, on synthetic game-piece batches. One
     make_train_step step on the card (TF32 off) against the same step on
     the CPU: loss, box_loss, cls_loss and mean_iou within 1e-4 relative,
     each parameter's gradient within 1e-3 of its max-abs; train() for 30
     steps on one repeated batch at learning_rate 2e-3: the last loss below
     0.7x the first and mean_iou up (tests/test_train.py's criteria);
     BatchNorm running statistics bit-identical after training; the bf16
     infer after training equal to a fresh engine's on the save_params of
     the trained weights and different from before; none of the port's
     kernels launched; ms a step (median of 20, the TF32 state printed),
     peak device memory and the profiler's busy share and top operations;
  9. extrinsic calibration (calib/extrinsic.py): four 1280x800 cameras
     (fx = fy = 900) at the robot's corners (ring_cameras), tags of
     0.1651 m 1-4 m out, each rendered whole in exactly the two cameras of
     one adjacent pair; build_frameset_from_images through
     TorchDetector(estimate_pose=True) on the card (the 1280x800 kernel
     set, K1 1, K2 6, K3 1, K4 1 device launches a call; every detection
     one of the rendered tags in a camera of its pair, >= 8 tags a pair
     seen by both); solve_extrinsics on the card, 2,500 iterations at
     3e-2 with front_left frozen: each free camera within 1 degree and
     2 cm of the truth, the anchor exactly its guess; the CPU's solve of
     the same frameset within the same limits, its difference from the
     card's printed beside the CPU's own move when the inputs move by
     1e-7; tests/test_calib_launch.py's two-camera rig solved on the card
     and the CPU for 1,000 iterations, within 0.01 degree and 1e-4 m of
     each other, and for 2,500 on the card within the truth's limits;
     ms per detected image and per solver iteration;
 10. tf32: TorchDetector writes none of the TF32 settings
     (matmul.allow_tf32, cudnn.allow_tf32, the float32 matmul
     precision), and its B=4 packed output at 1280x800 and 1920x1080 is
     bit-identical with TF32 allowed everywhere and with TF32 off (phase 8
     times the train step both ways, in turns);
 11. tracing (utils/tracing.py): stage_taps(check=True) on the B=4 bench
     batches through exactly the path's kernels, the taps' ids and
     hamming equal to detect_raw's and their corners within 0.1 px; the
     recorder's spans (host ms a detect_raw_packed call, 5 calls, no
     synchronize between them) at B=1 and B=4, both sizes; one B=4 call's
     synchronising operations as HostSyncs counts them (reads and table
     uploads), as its call record holds them and as
     torch.cuda.set_sync_debug_mode("warn") warns of them, all equal;
 12. quadfit_graph (ops/quadfit.GraphRunner): cluster_and_fit's eager,
     capturing and replaying calls bit-identical to its eager stages in
     every returned tensor, at 1280x800 (32,768 slots) and 1920x1080
     (the narrow 32,768 and the full 131,072), on the bench batch and on
     one that takes the stable windowed-error branch, use_pallas_sort off
     and on; launches counted as the eager call's; one synchronising
     operation a replayed call; results kept through later replays; the
     three kinds of call under torch.profiler; host ms eager vs replayed;
 13. decode_graph (ops/decode.GraphRunner): decode_quads' eager,
     capturing and replaying calls bit-identical to its eager body in
     every returned tensor, on the detector's unrefined corners at
     1280x800 B=1 and B=4 and 1920x1080 B=4, in 8, 32 and 128 slots; no
     synchronising operation in a replayed call; results kept through
     later replays; a warm B=4 detect_raw_packed call's 4 synchronising
     operations, host_syncs == call record == sync debug mode; host ms
     eager vs replayed;
 14. mesh (parallel/mesh.py): detect_raw and detect_raw_packed of a
     detector sharded by TorchDetector.use_mesh over [cuda:0, cuda:0]
     on the 1280x800 B=4 batch; the ok mask in
     every slot and every output in the accepted slots bit-identical to
     the unsharded B=4 call and to per-row B=1 calls; ms a call of both;
 15. soak (tools/soak.py) against the f64 oracle: parity on 100 seeds,
     hard on 50 with --audit-misses, gate on 4; no mismatch, no miss the
     oracle does not share, the flood path's kernels (320x160, 640x400);
 16. bench: python -m ros_vision_tpu_torch.bench in a subprocess with
     BENCH_ENV's cuts; its last line parsed, tags_ok, every key of
     bench.py's record filled (the golden photo's marked skipped when the
     photo is absent); its headline, sweep, streaming and stage lines.
Each of phases 10-16 prints its seconds beside the card's name and power
limit.
K10 and K11 have no caller on any path (nor in the JAX package outside
its tests), so their launches read 0.
Every path of phases 3-15 runs with the launch counts set to 0 just
before it and read just after; the launches of the kernels line sum those runs.
On every path the device launches that the C launchers of K1, K2, K3, K4,
K6, K7, K10, K11, P1 and P2 report equal their fixed number per call
times the calls (K1 1, K2 6, K3 1, K4 1, K6 4, K7 1, K10 1, K11 1, P1 1,
P2 1), and K8's equal its plan's (one a round of PROPAGATE_HALO sweeps)
summed over its calls. P1 launches on every path whose detector
estimates poses, P2 on every detector path (and the soak's gate).
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
REPEATS = 10      # repeated calls of a kernel on each input, compared
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores (the rate bound_ms uses for the integer and float work here)
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
# the INT32 pipe's rate, where integer min and select run: 64 lanes an SM
# a clock on 132 SMs at the 1.98 GHz boost clock (a second figure for K8's
# bound, printed beside bound_ms)
INT32_OPS_S = 64 * 132 * 1.98e9
# the lens of tests/test_rectify.py (fx = fy = 300 at 320 px wide, k1 =
# -0.25) scaled 4x to 1280 px wide, centred on the 1280x800 frame
LENS = dict(fx=1200.0, fy=1200.0, cx=640.0, cy=400.0)
LENS_DIST = (-0.25, 0.08, 0.001, -0.001, 0.0)


def lens_for(width: int, height: int) -> dict:
    """LENS scaled to a frame `width` px wide and centred on it (LENS
    itself at 1280x800)."""
    s = width / W
    return dict(fx=LENS["fx"] * s, fy=LENS["fy"] * s, cx=width / 2,
                cy=height / 2)

BAYER = ("RGGB", "BGGR", "GRBG", "GBRG")
# YOLOv11n game-piece engine, the deployed gamepiece_yolo11n configuration
GP_SIZE = 640
# card bf16 against the CPU's f32 forward: boxes (input px) and scores;
# bf16 against f32 measured 0.12 px and 5.8e-4 on the CPU
GP_BF16_TOL = (1.0, 5e-3)
# card f32 (cuDNN, TF32 off) against the CPU's f32 forward
GP_F32_TOL = (0.1, 1e-4)
# kernels each path must launch; every other kernel must not launch there
PATH_800 = {"adaptive_threshold", "rank_image", "boundary_compact",
            "value_histogram", "refine_edges", "estimate_poses"}
PATH_1080 = {"adaptive_threshold", "propagate_fixpoint", "label_histogram",
             "boundary_compact", "value_histogram", "refine_edges",
             "estimate_poses"}
# f32 operations of one slot of P1 (csrc/pose.cuh), a division or square
# root counted as one: the polar rotation's start, 8 Newton steps and sign
# check; an orthogonal-iteration step without its polar rotation; the
# final error; and, once a slot, the corners and rays, the projectors and
# G, the homography start (without its polar rotation) and the mirror
POSE_POLAR_OPS = 29 + 8 * 59 + 14
POSE_STEP_OPS = 330 + POSE_POLAR_OPS
POSE_OPS = (72 + 163 + 54 + POSE_POLAR_OPS + 160
            + 2 * (50 * POSE_STEP_OPS + 168))
# the dependent chain of one orthogonal-iteration step of P1's lane form
# (csrc/pose.cuh), counted from the code: the operations in a row, each
# waiting on the one before. Shuffle rounds: the data columns, their
# norms, one a Newton step, the polar factor for its sign. f32
# operations: the rotated corner 3, the translation 1 + 12 + 3, the
# projection 4, a data column 8, the cross 2, a norm 3, the geometric mean
# 1, the scaled column 1, the polar start 8, a Newton step 7 (the cross
# 2, the det 3, add, mul), the sign 6. Divisions: the mean q, the scale,
# the polar start 2, one a Newton step; square roots: a norm, the
# geometric mean, the polar start. A slot runs 2 x 50 steps in a row.
POSE_CHAIN = dict(shuffle_rounds=2 + 8 + 1, f32_ops=3 + 16 + 4 + 8 + 2 + 3
                  + 1 + 1 + 8 + 8 * 7 + 6, divisions=4 + 8, square_roots=3,
                  steps=2 * 50)
# f32 operations that refine_edges needs (refine_work counts them on a
# call's data), each computed once, a division, square root, floor or f64
# atan2/cos/sin counted as one, compares and selects not, the camera's
# 2 p1 and 2 p2 once: per finite edge its normal, length, sample count and
# midpoint (15), its normal times the 33 union offsets (66) and its line
# fit (19); per live sample (s < ns) its origin (8) and its 33 union
# positions (66), whose middle 25 are the terms' points; per term of
# weight > 0 (a zero weight adds nothing to finite sums) its weight (2),
# its six moments (13) and the undistortion of its point (4 + 25 steps of
# 30 + 4); per corner of a valid finite slot the intersection (13) and the
# distortion (38)
REFINE_EDGE_OPS = 15 + 66 + 19
REFINE_SAMPLE_OPS = 8 + 66
REFINE_TERM_OPS = 2 + 13
REFINE_UNDISTORT_OPS = 4 + 25 * 30 + 4
REFINE_CORNER_OPS = 13
REFINE_DISTORT_OPS = 38


# the card's name and power limit (nvidia-smi), printed beside the times
CARD = ""


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_scene(seed: int, width: int = W, height: int = H,
                noise: float = 1.0, scale: float | None = None):
    """The bench.py scene (4 tags at 1280x800, noise sigma 1), its layout
    scaled by `scale`, by default width / 1280, for other frame sizes."""
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                simple_square_corners)
    s = width / W if scale is None else scale
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


def _axis_angle(axis: np.ndarray, ang: np.ndarray) -> np.ndarray:
    """(N, 3) unit axes, (N,) angles -> (N, 3, 3) f64 rotations."""
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = np.zeros_like(x)
    k = np.stack([np.stack([zero, -z, y], -1), np.stack([z, zero, -x], -1),
                  np.stack([-y, x, zero], -1)], -2)
    s, c = np.sin(ang)[:, None, None], (1 - np.cos(ang))[:, None, None]
    return np.eye(3) + s * k + c * (k @ k)


def seeded_homographies(b: int, nq: int, seed: int = 0,
                        tag_size: float = 0.1651, width: int = 1280,
                        height: int = 800, noise_px: float = 0.5) -> dict:
    """A numpy-seeded estimate_poses input for checks: (B, NQ, 3, 3) f32
    detection homographies and per-row (B,) f32 intrinsics (fx 600-1400,
    fy within 2% of fx, the centre within 40 px of the frame's).

    Each slot is a tag 0.5-6 m out whose centre projects inside the frame,
    its normal tilted 0-70 degrees from the sight line, its corners
    projected with Gaussian noise of `noise_px` px (every fourth slot
    within 0.5 degree of the sight line and without noise: the planar
    ambiguity, sin_a ~ 0) and fitted by a homography scaled by a random
    factor of either sign. The last slot of
    each row is all zero and the one before it NaN (when NQ >= 3)."""
    rng = np.random.default_rng(seed)
    n = b * nq
    fx = rng.uniform(600, 1400, b)
    fy = fx * rng.uniform(0.98, 1.02, b)
    cx = width / 2 + rng.uniform(-40, 40, b)
    cy = height / 2 + rng.uniform(-40, 40, b)
    row = np.repeat(np.arange(b), nq)
    # the tag centre: a pixel inside the frame, 0.5-6 m along its ray
    u = rng.uniform(0.1, 0.9, n) * width
    v = rng.uniform(0.1, 0.9, n) * height
    ray = np.stack([(u - cx[row]) / fx[row], (v - cy[row]) / fy[row],
                    np.ones(n)], -1)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    t = ray * rng.uniform(0.5, 6.0, n)[:, None]
    # the tag's z axis (into the tag) along the ray, then tilted about an
    # axis in the tag plane, then turned about its normal
    zc = np.array([0.0, 0.0, 1.0])
    to_ray = np.cross(zc, ray)
    sin_r = np.linalg.norm(to_ray, axis=-1)
    align = _axis_angle(to_ray / np.maximum(sin_r, 1e-12)[:, None],
                        np.arctan2(sin_r, ray[:, 2]))
    near = np.arange(n) % 4 == 0
    tilt = np.deg2rad(np.where(near, rng.uniform(0, 0.5, n),
                               rng.uniform(0, 70, n)))
    phi = rng.uniform(0, 2 * np.pi, n)
    tilt_axis = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)], -1)
    yaw_axis = np.tile(zc, (n, 1))
    rot = align @ _axis_angle(tilt_axis, tilt) @ _axis_angle(
        yaw_axis, rng.uniform(-np.pi, np.pi, n))
    tcs = np.array([[-1, 1], [1, 1], [1, -1], [-1, -1]], np.float64)
    obj = np.c_[tcs * tag_size / 2, np.zeros(4)]
    cam = obj[None] @ rot.transpose(0, 2, 1) + t[:, None, :]
    px = fx[row, None] * cam[..., 0] / cam[..., 2] + cx[row, None]
    py = fy[row, None] * cam[..., 1] / cam[..., 2] + cy[row, None]
    noise = np.where(near, 0.0, noise_px)[:, None]
    px = px + noise * rng.standard_normal(px.shape)
    py = py + noise * rng.standard_normal(py.shape)
    # the homography tag (x, y) in [-1, 1]^2 -> pixels, h22 = 1 (DLT)
    a = np.zeros((n, 8, 8))
    rhs = np.zeros((n, 8))
    for k, (x, y) in enumerate(tcs):
        a[:, 2 * k] = np.stack([np.full(n, x), np.full(n, y), np.ones(n),
                                np.zeros(n), np.zeros(n), np.zeros(n),
                                -x * px[:, k], -y * px[:, k]], -1)
        a[:, 2 * k + 1] = np.stack([np.zeros(n), np.zeros(n), np.zeros(n),
                                    np.full(n, x), np.full(n, y), np.ones(n),
                                    -x * py[:, k], -y * py[:, k]], -1)
        rhs[:, 2 * k], rhs[:, 2 * k + 1] = px[:, k], py[:, k]
    h = np.c_[np.linalg.solve(a, rhs[..., None])[..., 0], np.ones(n)]
    scale = rng.uniform(0.5, 2.0, n) * rng.choice([-1.0, 1.0], n)
    H = (h * scale[:, None]).reshape(b, nq, 3, 3).astype(np.float32)
    if nq >= 3:
        H[:, -1] = 0.0
        H[:, -2] = np.nan
    f32 = np.float32
    return dict(H=H, fx=fx.astype(f32), fy=fy.astype(f32),
                cx=cx.astype(f32), cy=cy.astype(f32))


# f32's unit roundoff
U32 = 2.0 ** -24
# factors of pose_limits' rounding terms for R, t and err
POSE_ROUNDING = (16.0, 8.0, 8.0)


def pose_limits(t, err, tag_size: float) -> dict:
    """Per-slot limits for two f32 estimate_poses results that round in
    other orders, from the reference's t (N, 3) and err (N,), with
    s = tag_size / 2 and kappa = (|t| / s)^2, the condition number of the
    depth solve: R 1e-3 + 16 U32 kappa; t 1e-4 m + 8 U32 kappa |t|; err
    1e-3 relative + 8 (2 U32 |t| sqrt(kappa)) sqrt(err), the residuals'
    rounding carried into their squares. Each rounding term's factor is
    about 2.5x the largest that two of the f32 versions (P1, the plain
    version on the card and on the CPU, the JAX function) needed on
    seeded batches out to 6 m (PERF.md §6); with the 0.1651 m tag at 1 m
    the terms add 1.4e-4, 7e-5 m and 1.2e-5 sqrt(err)."""
    d = np.linalg.norm(t, axis=-1)
    s = tag_size / 2
    kappa = (d / s) ** 2
    c_r, c_t, c_e = POSE_ROUNDING
    return dict(R=1e-3 + c_r * U32 * kappa, t=1e-4 + c_t * U32 * kappa * d,
                err=1e-3 * np.abs(err) + c_e * 2 * U32 * d * np.sqrt(kappa)
                * np.sqrt(np.abs(err)))


def pose_agreement(what: str, got, candidates, tag_size: float) -> dict:
    """Raise unless an estimate_poses result `got` (R, t, err) has its
    non-finite values where the plain version's choice from `candidates`
    (pose.pose_candidates_plain) has them and, on the finite slots,
    lies within pose_limits of that choice; or, where the two candidates'
    errors lie within the err limit of each other (a tie that rounding
    decides), within pose_limits of the other candidate. -> the largest
    differences (err relative), the largest share of a limit used and the
    ties taken the other way."""
    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)

    first, second, sin_a = candidates
    r1, t1, e1 = (host(x) for x in first)
    r2, t2, e2 = (host(x) for x in second)
    sin_a = host(sin_a)
    use2 = (e2 < e1) & (sin_a > 1e-8)
    want = (np.where(use2[..., None, None], r2, r1),
            np.where(use2[..., None], t2, t1), np.where(use2, e2, e1))
    other = (np.where(use2[..., None, None], r1, r2),
             np.where(use2[..., None], t1, t2), np.where(use2, e1, e2))
    got = tuple(host(x) for x in got)
    check(all((np.isfinite(a) == np.isfinite(b)).all()
              for a, b in zip(got, want)),
          f"{what}: non-finite outputs in other places")
    fin = (np.isfinite(want[0]).all((-1, -2)) & np.isfinite(want[1]).all(-1)
           & np.isfinite(want[2]))

    def used(ref):
        """Per finite slot, the share of each limit that got uses."""
        lim = pose_limits(ref[1][fin], ref[2][fin], tag_size)
        diff = dict(R=np.abs(got[0] - ref[0]).max((-1, -2))[fin],
                    t=np.abs(got[1] - ref[1]).max(-1)[fin],
                    err=np.abs(got[2] - ref[2])[fin])
        return diff, {k: diff[k] / np.maximum(lim[k], 1e-300) for k in lim}

    diff, share = used(want)
    near = np.maximum.reduce(list(share.values())) <= 1
    tie = ((sin_a > 1e-8) & (np.abs(e1 - e2) <= pose_limits(
        want[1], np.minimum(np.abs(e1), np.abs(e2)), tag_size)["err"]))[fin]
    odiff, oshare = used(other)
    flipped = ~near & tie & (np.maximum.reduce(list(oshare.values())) <= 1)
    bad = ~near & ~flipped
    for k in diff:
        diff[k] = np.where(flipped, odiff[k], diff[k])
        share[k] = np.where(flipped, oshare[k], share[k])
    limit_used = {k: float(v.max(initial=0)) for k, v in share.items()}
    check(not bad.any(), f"{what}: {int(bad.sum())} slots outside "
          f"pose_limits of either candidate (share of the limit used "
          f"{limit_used})")
    rel = diff["err"] / np.maximum(np.abs(want[2][fin]), 1e-300)
    return dict(slots=int(fin.size), finite=int(fin.sum()),
                ties_other_way=int(flipped.sum()),
                max_abs=float(max(d.max(initial=0) for d in diff.values())),
                max_R=float(diff["R"].max(initial=0)),
                max_t=float(diff["t"].max(initial=0)),
                max_err_rel=float(rel.max(initial=0)),
                limit_used=limit_used)


def check_kernel_set(what: str, counts: dict, must: set) -> None:
    """Every kernel of `must` launched, every other kernel not."""
    check(all(counts[k] > 0 for k in must)
          and all(c == 0 for k, c in counts.items() if k not in must),
          f"{what}: expected launches of exactly {sorted(must)}, got "
          f"{counts}")


def check_device_launches(what: str, counts: dict,
                          propagate: int = 0) -> None:
    """The device launches that the C launchers of K1, K2, K3, K4, K6, K7,
    K10, K11, P1 and P2 reported over a path's run: their fixed number per
    call times the calls; and K8's: `propagate`, the sum of its calls'
    plans."""
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    kernels = _build.kernel_counts()
    for name, per_call in (("adaptive_threshold", tk.LAUNCHES),
                           ("rank_image", fk.RANK_LAUNCHES),
                           ("boundary_compact", fk.BOUNDARY_LAUNCHES),
                           ("propagate_fixpoint", ck.FIXPOINT_LAUNCHES),
                           ("label_histogram", ck.HISTOGRAM_LAUNCHES),
                           ("value_histogram", 1), ("table_take_cm", 1),
                           ("segment_min_max", 1), ("estimate_poses", 1),
                           ("refine_edges", 1)):
        check(kernels[name] == per_call * counts[name],
              f"{what}: {name} made {kernels[name]} device launches in "
              f"{counts[name]} calls, not {per_call} each")
    check(kernels["propagate"] == propagate,
          f"{what}: propagate made {kernels['propagate']} device launches, "
          f"not its plans' {propagate}")


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


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz; run it right after the card
    was busy: it reads the idle clock otherwise)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


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
    from ros_vision_tpu_torch.ops import decode as dec
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import gather_kernel as gk
    from ros_vision_tpu_torch.ops import pose
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import segments as segs
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    from ros_vision_tpu_torch.ops import threshold_kernel as tk

    floor = both_ms(lambda: torch.cuda._sleep(0))
    print(f"  launch floor, torch.cuda._sleep(0): {floor['device_ms']:.4f} "
          f"ms device / {floor['call_ms']:.4f} call")
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

    def device_launches(counter, call, want: int, what: str):
        """call(), checking that its C launcher made `want` device
        launches, and that REPEATS more calls (their atomics racing in
        other orders) give the same outputs."""
        before = counter.kernels
        out = call()
        made = counter.kernels - before
        check(made == want, f"{what}: {made} device launches in one call, "
              f"not {want}")
        def bits(t):      # compared bit for bit, so NaN equals itself
            return t.contiguous().view(torch.uint8)

        for _ in range(REPEATS):
            again = call()
            check(all(torch.equal(bits(a), bits(b)) for a, b in zip(
                (out,) if isinstance(out, torch.Tensor) else out,
                (again,) if isinstance(again, torch.Tensor) else again)),
                  f"{what}: a repeated call gave other outputs")
        return out

    # K1, also at 1920x1080, on a W % 16 == 8 batch (1288x808: a lone
    # 8-byte load ends every row) and on a batch whose pointer is not
    # 16-byte aligned (the kernel's byte loads)
    rng = np.random.default_rng(3)
    g_w8 = torch.from_numpy(np.stack([bench_scene(s, 1288, 808)[0]
                                      for s in range(2)])).to(dev)
    flat = torch.empty(g4.numel() + 8, dtype=torch.uint8, device=dev)
    g_odd = flat[8:].view(g4.shape)
    g_odd.copy_(g4.flip(2))
    check(g_odd.data_ptr() % 16 == 8, "the unaligned K1 batch is aligned")
    err = 0.0
    for what, g in (("1280x800 bench B=4", g4), ("1280x800 clutter", gc),
                    ("1920x1080 bench B=4", g2), ("1920x1080 clutter", gc2),
                    ("1288x808 B=2", g_w8), ("1280x800 unaligned B=4", g_odd)):
        got = device_launches(tk.launches,
                              lambda: tk.adaptive_threshold_fused(g),
                              tk.LAUNCHES, f"adaptive_threshold on {what}")
        err = max(err, max_abs_err(f"adaptive_threshold on {what}", got,
                                   tk.adaptive_threshold_plain(g)))
    print(f"  adaptive_threshold: bit-exact on 6 batches, {tk.LAUNCHES} "
          "device launch a call")
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
    # at 960x540 where the stage-A cap clamps to 80 rows, and on the two
    # ragged frames with the 1920x1080 caps (963x541 overflows both, 53x37
    # neither) and with small caps (both overflow): one cluster launch a
    # call, 10 repeated calls identical (slots cross the cluster's blocks)
    ragged = [adversarial[f"ragged {what}"] for what in ("963x541 B=2",
                                                         "53x37 B=3")]
    cases = [(t4, r4, p_cap, k_cap), (tc, rc, p_cap, k_cap),
             (t2, r2, p_cap2, k_cap2), (tc2, rc2, p_cap2, k_cap2)]
    for t in ragged:
        r = fk.label_components_plain(t)[2].view(t.shape)
        cases += [(t, r, p_cap2, k_cap2), (t, r, 300, 400)]
    err = 0.0
    for t, r, pc, kc in cases:
        what = f"{t.shape[2]}x{t.shape[1]} B={t.shape[0]} caps {pc}/{kc}"
        key, pack2, counts = device_launches(
            fk.boundary_launches, lambda: fk.boundary_compact(t, r, pc, kc),
            fk.BOUNDARY_LAUNCHES, f"boundary_compact on {what}")
        pts, cref = qf.boundary_points_capped(
            t, r.reshape(r.shape[0], -1), pc, kc)
        err = max(err, max_abs_err(f"boundary_compact on {what}",
                                   (key, pack2, counts),
                                   (pts["key"], pts["pack2"], cref)))
        maskbits, _ = qf.boundary_masks(t, r)
        emitting = ((maskbits & 0xF) != 0).sum(dim=(1, 2)).tolist()
        print(f"  boundary {what}: emitting px {emitting} (stage-A cap "
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

    # K7 on converged labels (bench B=4, clutter B=1 and B=4), on random
    # labels, some outside [0, N), on a batch whose pointer is not 16-byte
    # aligned, and on a batch of more chunks than the grid's co-resident
    # blocks, so that a block takes several chunks and reads its earlier
    # ones again after the grid barrier: one cooperative launch a call, 10
    # repeated calls identical
    rnd = rng.integers(-1000, n2 + 5000, (4, n2)).astype(np.int32)
    rnd[:, :3] = [-1, n2, 2 ** 31 - 1]
    rnd = torch.from_numpy(rnd).to(dev)
    clutter4 = torch.from_numpy(np.stack([
        clutter_frame(s, W2, H2) for s in range(7, 11)])).to(dev)
    labc4 = ccl.propagate_fixpoint(
        tk.adaptive_threshold_plain(clutter4)[1], flat_init(t2)).view(4, n2)
    unaligned = torch.empty(4 * n2 + 1, dtype=torch.int32, device=dev)
    unaligned = unaligned[1:].view(4, n2)
    unaligned.copy_(lab2)
    # an SM holds at most 2048 threads, K7's blocks 512 (csrc/flood.cu
    # kHistThreads) and take chunks of 8192 labels (kHistChunk); the H100
    # has 132 SMs
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    most_resident = 2048 // 512 * sms
    many = torch.cat([lab2, labc4, rnd] * (
        -(-(most_resident + 1) * 8192 // (12 * n2)))).contiguous()
    check(many.numel() > most_resident * 8192,
          f"{many.numel()} labels fill no more than {most_resident} "
          "chunks")
    sets = (("bench labels B=4", lab2), ("clutter labels B=1", labc2),
            ("clutter labels B=4", labc4), ("random labels", rnd),
            ("unaligned bench labels", unaligned),
            (f"bench, clutter and random labels B={many.shape[0]} "
             f"({-(-many.numel() // 8192)} chunks)", many))
    err = 0.0
    for what, v in sets:
        got = device_launches(ck.histogram_launches,
                              lambda: ck.label_histogram(v),
                              ck.HISTOGRAM_LAUNCHES,
                              f"label_histogram on {what}")
        err = max(err, max_abs_err(f"label_histogram on {what}", (got,),
                                   (ccl.label_histogram(v),)))
    print(f"  label_histogram: bit-exact on {len(sets)} label sets, "
          f"{ck.HISTOGRAM_LAUNCHES} device launch a call")
    lab2_64 = lab2.to(torch.int64)
    ones2 = torch.ones_like(lab2)
    lhist_out = torch.zeros_like(lab2)
    labc4_64 = labc4.to(torch.int64)
    record("label_histogram", "flood.cu",
           "ros_vision_tpu/ops/ccl_pallas.py:376", err,
           lambda: ck.label_histogram(lab2),
           lambda: ccl.label_histogram(lab2), "1920x1080 B=4", [lab2],
           library=lambda: lhist_out.scatter_add_(1, lab2_64, ones2),
           also=[shape_entry(
               "1920x1080 B=4 clutter labels",
               lambda: ck.label_histogram(labc4),
               lambda: ccl.label_histogram(labc4), [labc4],
               library=lambda: lhist_out.scatter_add_(1, labc4_64, ones2)),
                 shape_entry(
               "1920x1080 B=4 random labels",
               lambda: ck.label_histogram(rnd),
               lambda: ccl.label_histogram(rnd), [rnd])])

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

    # K8 at 1280x800 B=4 (flat indices and random values), on the
    # union-find planes, the ragged frames and a plane with other values
    # than the threshold's (flat indices), with the hybrid
    # CCL's first round (448 sweeps), 0, 1, T and T + 1 sweeps (T sweeps a
    # launch); each call makes its plan's launches, 10 repeated calls
    # identical; its least work is 8 neighbour mins per pixel per sweep
    init4 = flat_init(t4)
    vals4 = rng.integers(-5, 2 ** 31 - 1, t4.shape, dtype=np.int64)
    vals4.reshape(-1)[:2] = [2 ** 31 - 1, 2 ** 30]
    vals4 = torch.from_numpy(vals4.astype(np.int32)).to(dev)
    cases = [("bench 640x400 B=4, flat indices", t4, init4),
             ("bench 640x400 B=4, random values", t4, vals4)]
    cases += [(f"{what}, flat indices", t, flat_init(t))
              for what, t in adversarial.items()]
    # a patch of values outside {0, 127, 255}: the tiles that see it take
    # the kernel's masked path, the others its two planes
    mixed = ragged_planes(2, H // 2, W // 2, seed=3)
    y, x = H // 8, W // 6
    mixed[:, y:y + 40, x:x + 60] = rng.choice([5, 200, 0, 255], (2, 40, 60))
    mixed = torch.from_numpy(mixed).to(dev)
    cases.append(("640x400 B=2, values outside {0, 127, 255}", mixed,
                  flat_init(mixed)))
    halo = ck.PROPAGATE_HALO
    err = 0.0
    for what, t, v in cases:
        for k in (0, 1, halo, halo + 1, 448):
            plan = ck.propagate_plan(t.shape[1], t.shape[2], k)
            check(plan.launches <= -(-k // halo) + 1,
                  f"propagate plan of {plan.launches} launches for {k}")
            got = device_launches(ck.propagate_launches,
                                  lambda: ck.propagate(t, v, k),
                                  plan.launches,
                                  f"propagate on {what}, {k} sweeps")
            err = max(err, max_abs_err(f"propagate on {what}, {k} sweeps",
                                       (got,), (ccl.propagate(t, v, k),)))
    print(f"  propagate: bit-exact on {len(cases)} planes at 0, 1, {halo}, "
          f"{halo + 1} and 448 sweeps, ceil(n / {halo}) device launches a "
          f"call ({ck.propagate_plan(H // 2, W // 2, 448).launches} at 448)")
    ops8 = 448 * 8 * t4.numel()
    print(f"  propagate: its 448 sweeps' {ops8} neighbour mins take "
          f"{ops8 / INT32_OPS_S * 1e3:.4f} ms at the INT32 pipe's "
          f"{INT32_OPS_S / 1e12:.2f} T/s (bound_ms takes "
          f"{CORE_OPS_S / 1e12:.0f})")
    record("propagate", "flood.cu",
           "ros_vision_tpu/ops/ccl_pallas.py:405", err,
           lambda: ck.propagate(t4, init4, 448),
           lambda: ccl.propagate(t4, init4, 448), "1280x800 B=4, 448 sweeps",
           [t4, init4], ops=ops8)

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
    # gathered at its (B, 32768) segment ids; C = 1, 3, 4 and 9 (C = 4 the
    # kernel's float4 rows), a ragged K = 32771 (its scalar path), and
    # random indices (some outside [0, S)) over a table with -0.0, inf and
    # NaN entries: one device launch a call, 10 repeated calls identical
    table = torch.from_numpy(rng.normal(0, 100, (4, 1025, 4)).astype(
        np.float32)).to(dev)
    odd_tab = table.clone()
    odd_tab[0, 5] = torch.tensor([-0.0, float("inf"), float("nan"), -1.0])
    odd_idx = b4(-5, 1030, 32768)
    odd_idx[:, :64] = 5
    cases = [("path ids, C=4", table, seg),
             ("non-finite table", odd_tab, odd_idx)]
    for c in (1, 3, 4, 9):
        tab_c = torch.from_numpy(rng.normal(0, 100, (4, 1025, c)).astype(
            np.float32)).to(dev)
        cases += [(f"C={c}", tab_c, seg),
                  (f"C={c} K=32771", tab_c, b4(-5, 1030, 32771))]
    err = 0.0
    for what, tab, ix in cases:
        got = device_launches(gk.take_launches, lambda: gk.take_cm(tab, ix),
                              1, f"table_take_cm on {what}")
        err = max(err, max_abs_err(f"table_take_cm on {what}", (got,),
                                   (gk.table_take_cm_plain(tab, ix),)))
    print(f"  table_take_cm: bit-exact on {len(cases)} inputs, 1 device "
          "launch a call")
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
    # [0, S)) with values past +-2^30; a ragged K = 131075, one row, a
    # B = 12 batch, S above segment_plan's cap of segments a cluster
    # holds (two slices), and ids all outside [0, S) (-1, S, INT32_MAX,
    # INT32_MIN): one device launch a call, 10 repeated calls identical
    key_s2, pack2_s2 = qf._sort2(key2, pack22)
    seg2 = segs.segment_ids_from_sorted_keys(
        key_s2, valid=key_s2 < qf.KEY_INVALID, max_segments=1024)
    y2 = qf.unpack_payload(pack2_s2)[1].contiguous()

    def rows(b, lo, hi, k):
        return torch.from_numpy(rng.integers(lo, hi, (b, k), dtype=np.int64)
                                .astype(np.int32)).to(dev)

    wide = (-2 ** 31, 2 ** 31 - 1)
    rnd_seg, rnd_val = b4(-20, 1045, 131072), b4(*wide, 131072)
    cap = gk.SEG_MAX_SLICE + 1
    outside = torch.tensor([-1, 1025, 2 ** 31 - 1, -2 ** 31],
                           dtype=torch.int32, device=dev)
    cases = [("path ids", seg2, y2, 1025),
             ("random ids", rnd_seg, rnd_val, 1025),
             ("path ids K=131075", torch.cat([seg2, seg2[:, -3:]], 1),
              torch.cat([y2, y2[:, :3]], 1), 1025),
             ("path ids B=1", seg2[:1], y2[:1], 1025),
             ("random ids B=12", rows(12, -20, 1045, 131072),
              rows(12, *wide, 131072), 1025),
             (f"random ids S={cap}", b4(-20, cap + 20, 131072), rnd_val,
              cap),
             ("ids all outside [0, S)", outside[b4(0, 4, 131072).long()],
              rnd_val, 1025)]
    err = 0.0
    for what, sg, v, s in cases:
        got = device_launches(gk.minmax_launches,
                              lambda: gk.segment_min_max(sg, v, s), 1,
                              f"segment_min_max on {what}")
        err = max(err, max_abs_err(f"segment_min_max on {what}", got,
                                   gk.segment_min_max_plain(sg, v, s)))
    print(f"  segment_min_max: bit-exact on {len(cases)} inputs, 1 device "
          "launch a call")
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
    # P1 on the homographies of one TorchDetector call on each bench batch
    # (B=4, the 8-slot tail tier), the same padded with zero slots to the
    # 128-slot fallback (their outputs NaN), and seeded_homographies'
    # 4x128 batch (0.5-6 m, tilts to 70 degrees, the planar ambiguity, an
    # all-zero and a NaN slot a row): one device
    # launch a call, 10 repeated calls bit-identical, within pose_limits of
    # the plain version on the card
    pose_cases = {}
    for at, frames in (("1280x800 B=4", bench4), ("1920x1080 B=4",
                                                  bench4_1080)):
        h, tag_size, *intr = capture_pose_args(dev, frames)
        check(h.shape[1] == 8, f"{at}: the detector's pose stage ran "
              f"{h.shape[1]} slots, not the 8-slot tier")
        pose_cases[f"{at}, 8-slot tier"] = (h, intr)
        pose_cases[f"{at}, padded to 128 slots"] = (
            torch.nn.functional.pad(h, (0, 0, 0, 0, 0, 128 - h.shape[1])),
            intr)
    seeded = seeded_homographies(4, 128)
    pose_cases["seeded 4x128"] = (
        torch.from_numpy(seeded["H"]).to(dev),
        [torch.from_numpy(seeded[k]).to(dev) for k in ("fx", "fy", "cx",
                                                       "cy")])
    err, agree = 0.0, {}
    for what, (h, intr) in pose_cases.items():
        got = device_launches(
            pose.launches, lambda: pose.estimate_poses(h, tag_size, *intr),
            1, f"estimate_poses on {what}")
        agree[what] = a = pose_agreement(
            f"estimate_poses on {what}", got,
            pose.pose_candidates_plain(h, tag_size, *intr), tag_size)
        err = max(err, a["max_abs"])
        print(f"  estimate_poses on {what}: {a['finite']} of {a['slots']} "
              f"slots finite, non-finite ones in the plain version's "
              f"places; R {a['max_R']:.3e}, t {a['max_t']:.3e} m, err "
              f"{a['max_err_rel']:.3e} relative from the plain version "
              f"(share of pose_limits used {a['limit_used']}; "
              f"{a['ties_other_way']} candidate ties taken the other way); "
              "1 device launch a call, 10 repeats bit-identical")

    def p1(case):
        h, intr = pose_cases[case]
        return dict(kernel=lambda: pose.estimate_poses(h, tag_size, *intr),
                    plain=lambda: pose.estimate_poses_plain(h, tag_size,
                                                            *intr),
                    inputs=[h, *intr], ops=pose_slots_run(h, *intr)
                    * POSE_OPS)

    tier = "1280x800 B=4, 8-slot tier"
    one = (pose_cases[tier][0][:1, :1], [v[:1] for v in pose_cases[tier][1]])
    pose_cases["one slot"] = one
    record("estimate_poses", "pose.cu", "ros_vision_tpu/ops/pose.py:107",
           err, at=tier, **p1(tier),
           also=[shape_entry(at, **p1(at)) for at in (
               "1920x1080 B=4, 8-slot tier",
               "1280x800 B=4, padded to 128 slots",
               "1920x1080 B=4, padded to 128 slots", "seeded 4x128",
               "one slot")])
    row = results[-1]
    row["tolerance"] = "pose_limits"
    row["agreement"] = agree
    # the plain version enqueues ~14,000 launches, which fill the launch
    # queue, so its device time is the profiler's sum of its kernels
    for e in [row] + row["also"]:
        _, dev_ms, n, _ = device_busy_share(p1(e["at"])["plain"], calls=1)
        e["plain_profiled_ms"], e["plain_launches"] = dev_ms, n
    chain_ms = row["also"][-1]["ms"] - floor["device_ms"]
    mhz = sm_clock_mhz()
    row["chain"] = dict(POSE_CHAIN, one_slot_ms=row["also"][-1]["ms"],
                        floor_ms=floor["device_ms"], chain_ms=chain_ms,
                        sm_clock_mhz=mhz, cycles=chain_ms * mhz * 1e3,
                        cycles_a_step=chain_ms * mhz * 1e3
                        / POSE_CHAIN["steps"])
    print(f"  estimate_poses: one slot alone (one warp, its dependent "
          f"chain) {row['also'][-1]['ms']:.4f} ms device; {POSE_OPS} f32 "
          "operations a slot; the chain counted from the code, a step: "
          f"{POSE_CHAIN['shuffle_rounds']} shuffle rounds, "
          f"{POSE_CHAIN['f32_ops']} f32 operations, "
          f"{POSE_CHAIN['divisions']} divisions, "
          f"{POSE_CHAIN['square_roots']} square roots in a row, "
          f"{POSE_CHAIN['steps']} steps; one slot less the launch floor "
          f"{chain_ms:.4f} ms = {row['chain']['cycles']:,.0f} cycles at "
          f"{mhz:.0f} MHz (nvidia-smi clocks.sm), "
          f"{row['chain']['cycles_a_step']:,.0f} a step")

    # P2 on the corners one TorchDetector call hands refine_edges on each
    # bench batch (B=4, the 8-slot tier) and the same moved by a seeded
    # N(0, 0.6 px), each with a zero and a NaN slot a row; every sample
    # grid tier; no distortion and LENS_DIST (the lens centred on the
    # frame); the normal border, and the reversed one on the inverted
    # frames: within REFINE_LIMIT_PX of the plain version on the card,
    # non-finite in the same places, one device launch a call, 10 repeats
    # bit-identical
    rng = np.random.default_rng(14)
    refine_inputs, path_tier, err, worst = {}, {}, 0.0, {}
    for at, frames in (("1280x800 B=4", bench4), ("1920x1080 B=4",
                                                   bench4_1080)):
        g, c, v, rb = capture_refine_args(dev, frames)
        check(c.shape[1] == 8 and not rb, f"{at}: refine ran {c.shape[1]} "
              f"slots (reversed border {rb}), not the 8-slot tier")
        b = c.shape[0]
        # the detector's (B, 9) intrinsics row, handed over as two views
        row = torch.tensor([[*lens_for(g.shape[2], g.shape[1]).values(),
                             *LENS_DIST]] * b, dtype=torch.float32,
                           device=dev)
        lens = (row[:, :4], row[:, 4:9])
        refine_inputs[at] = (g, c, v, lens)
        path_tier[at] = dec.REFINE_ALPHA_TIERS[dec.refine_tier(c, v)]
        moved = c + torch.from_numpy(rng.normal(
            0, 0.6, tuple(c.shape)).astype(np.float32)).to(dev)
        extra = torch.zeros((b, 2, 4, 2), device=dev)
        extra[:, 1] = float("nan")
        v_ex = torch.cat([v, torch.ones((b, 2), dtype=torch.bool,
                                        device=dev)], 1)
        for corners_at, cc in (("detector corners", c), ("moved", moved)):
            cc = torch.cat([cc, extra], 1).contiguous()
            for rev in (False, True):
                gg = (255 - g) if rev else g
                for lens_at, lr in (("dist 0", (None, None)),
                                    ("LENS_DIST", lens)):
                    for n_alpha in dec.REFINE_ALPHA_TIERS:
                        what = (f"refine_edges on {at} {corners_at}, "
                                f"{lens_at}, {n_alpha} samples, "
                                f"{'reversed' if rev else 'normal'} border")
                        got = device_launches(
                            dec.launches, lambda: dec._refine_edges_cuda(
                                gg, cc, v_ex, *lr, n_alpha, rev), 1, what)
                        want = dec.refine_edges_plain(gg, cc, v_ex, *lr,
                                                      n_alpha, rev)
                        e = refine_err(what, got, want)
                        err = max(err, e)
                        key = f"{at}, {lens_at}"
                        worst[key] = max(worst.get(key, 0.0), e)
    for key, e in worst.items():
        print(f"  refine_edges on {key}: at most {e:.3e} px from the plain "
              "version on the card over the detector's and moved corners "
              "with a zero and a NaN slot a row, 3 tiers, both borders; 1 "
              "device launch a call, 10 repeats bit-identical")

    def p2(case):
        """The kernel, its plain version and the bound on the captured
        corners of a batch's first b rows and nq slots, at n_alpha; with
        nan, the last slot of each row NaN."""
        at, lens_at, n_alpha, b, nq, *nan = case
        g, c, v, lens = refine_inputs[at]
        g = g[:b]
        c, v = c[:b, :nq].clone(), v[:b, :nq].contiguous()
        if nan:
            c[:, -1] = float("nan")
        lr = (None, None) if lens_at == "dist 0" else tuple(
            x[:b] for x in lens)
        pixels, ops = refine_work(g, c, v, n_alpha, lr[0] is not None)
        return dict(
            kernel=lambda: dec._refine_edges_cuda(g, c, v, *lr, n_alpha),
            plain=lambda: dec.refine_edges_plain(g, c, v, *lr, n_alpha),
            inputs=[c, v, *(x for x in lr if x is not None), pixels],
            ops=ops)

    # the path's tier (the longest bench edge at 1920x1080 needs 64
    # samples), then the same with a NaN slot a row, the 128-sample grid
    # and one slot alone
    refine_rows = {f"{at}, {lens_at}, 8-slot tier, {n} samples": (
        at, lens_at, n, 4, 8) for at, lens_at, n in [
            (at, lens_at, path_tier[at]) for at in refine_inputs
            for lens_at in ("dist 0", "LENS_DIST")]
        + [("1280x800 B=4", "LENS_DIST", 128)]}
    one = path_tier["1280x800 B=4"]
    refine_rows[f"1280x800 B=4, LENS_DIST, 8-slot tier with a NaN slot a "
                f"row, {one} samples"] = ("1280x800 B=4", "LENS_DIST", one,
                                          4, 8, True)
    refine_rows[f"1280x800, LENS_DIST, one slot, {one} samples"] = (
        "1280x800 B=4", "LENS_DIST", one, 1, 1)
    main_row, *other_rows = refine_rows
    record("refine_edges", "refine.cu", "ros_vision_tpu/ops/decode.py:126",
           err, at=main_row, **p2(refine_rows[main_row]),
           also=[shape_entry(at, **p2(refine_rows[at]))
                 for at in other_rows])
    row = results[-1]
    row["tolerance"] = f"{REFINE_LIMIT_PX} px"
    # the plain version enqueues 250-1,300 launches, which can fill the
    # launch queue, so its device time is the profiler's sum of its kernels
    for e in [row] + row["also"]:
        work = p2(refine_rows[e["at"]])
        _, dev_ms, n, _ = device_busy_share(work["plain"], calls=1)
        e["plain_profiled_ms"], e["plain_launches"] = dev_ms, n
        e["ops"] = work["ops"]
    print(f"  refine_edges: one slot alone (4 blocks, a thread a term) "
          f"{row['also'][-1]['ms']:.4f} ms device against the launch "
          f"floor's {floor['device_ms']:.4f}; {REFINE_TERM_OPS} f32 "
          f"operations a term of weight > 0, {REFINE_UNDISTORT_OPS} more "
          "undistorting it")
    for e in [row] + row["also"]:
        print(f"  refine_edges at {e['at']}: {e['ops']:,} f32 operations "
              "needed")
    for r in results:
        for e in [r] + r["also"]:
            print(f"  {r['name']} at {e['at']}: kernel {e['ms']:.4f} ms "
                  f"device / {e['call_ms']:.4f} call; plain "
                  f"{e['plain_ms']:.4f} ({e['plain_ms_kind']}) / "
                  f"{e['plain_call_ms']:.4f} call; library "
                  + ("none" if e["library_ms"] is None else
                     f"{e['library_ms']:.4f} ({e['library_ms_kind']}) / "
                     f"{e['library_call_ms']:.4f} call")
                  + f"; bound {e['bound_ms']:.5f} ms ({e['bound_by']})"
                  + ("" if e.get("plain_profiled_ms") is None else
                     f"; plain under the profiler {e['plain_profiled_ms']:.4f}"
                     f" ms device, {e['plain_launches']:.0f} launches"))
        print(f"  {r['name']}: max abs err {r['max_abs_err']} "
              f"({r.get('tolerance', 'bit-exact')})")
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
            max_points=k, use_pallas_sort=True), graphs=qf.GraphRunner())
    finally:
        sk.sort_tpu, qf.histogram = real_sort, real_hist
    check(len(hists) == 2, f"cluster_and_fit made {len(hists)} histograms")
    return dict(sorts=sorts, hists=hists)


def pose_slots_run(h, fx, fy, cx, cy) -> int:
    """The slots of a (B, NQ, 3, 3) estimate_poses input whose four sight
    rays are finite: P1 runs its iterations there and writes NaN at once
    elsewhere."""
    import torch
    from ros_vision_tpu_torch.ops.decode import project
    tcs = torch.tensor([[-1, 1], [1, 1], [1, -1], [-1, -1]],
                       dtype=h.dtype, device=h.device)
    px, py = project(h[..., None, :, :], tcs[:, 0], tcs[:, 1])
    vx = (px - cx[:, None, None]) / fx[:, None, None]
    vy = (py - cy[:, None, None]) / fy[:, None, None]
    return int((torch.isfinite(vx) & torch.isfinite(vy)).all(-1).sum())


def capture_pose_args(dev, frames) -> tuple:
    """The arguments (H, tag_size, fx, fy, cx, cy) of the estimate_poses
    call that one TorchDetector(estimate_pose=True) call on `frames`
    makes."""
    import torch
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.ops import pose
    _, height, width = frames.shape
    det = TorchDetector(device=dev, **detector_kw(width, height))
    calls, real = [], pose.estimate_poses

    def recording(h, tag_size, fx, fy, cx, cy, n_steps=50, syncs=None):
        calls.append((h.contiguous().clone(), tag_size,
                      *(v.contiguous().clone() for v in (fx, fy, cx, cy))))
        return real(h, tag_size, fx, fy, cx, cy, n_steps, syncs)

    pose.estimate_poses = recording
    try:
        det.detect_raw(torch.from_numpy(np.ascontiguousarray(frames)).to(
            dev))
    finally:
        pose.estimate_poses = real
    check(len(calls) == 1, f"the detector made {len(calls)} pose calls")
    return calls[0]


REFINE_LIMIT_PX = 1e-3    # P2 vs its plain version: the CPU tests' atol


def refine_err(what: str, got, want) -> float:
    """Max abs difference of P2's corners from its plain version's; raises
    unless the non-finite ones lie in the same places and the rest within
    REFINE_LIMIT_PX."""
    import torch
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin),
          f"{what}: non-finite corners in other places than the plain "
          "version's")
    err = float((got[fin] - want[fin]).abs().max())
    check(err <= REFINE_LIMIT_PX, f"{what}: {err:.3e} px from the plain "
          f"version (limit {REFINE_LIMIT_PX})")
    return err


def refine_work(g, c, v, n_alpha: int, have_dist: bool) -> tuple:
    """What refine_edges needs on gray `g`, corners `c` and quad_valid `v`
    at n_alpha: a stand-in input of one byte per distinct in-frame pixel
    that its live samples (s < ns) read, and its f32 operations."""
    import torch
    from ros_vision_tpu_torch.ops import decode as dec
    b, h, w = g.shape
    terms = dec.refine_terms_plain(g.to(torch.float32), c, n_alpha)
    pb = torch.roll(c, -1, dims=2)
    nx = pb[..., 1] - c[..., 1]
    ny = -pb[..., 0] + c[..., 0]
    ns = torch.floor(dec.mathf.sqrt(nx * nx + ny * ny) / 8.0).clamp(
        16, n_alpha)                        # NaN for a non-finite edge
    live = torch.arange(n_alpha, device=g.device) < ns[..., None]
    idx, ok = dec._int_index(terms["ux"], terms["uy"], h, w)
    flat = idx.to(torch.int64) + h * w * torch.arange(
        b, device=g.device).view(b, 1, 1, 1, 1)
    pixels = torch.empty(int(flat[ok & live[..., None]].unique().numel()),
                         dtype=torch.uint8)
    corners = 4 * int((v & torch.isfinite(c).flatten(2).all(-1)).sum())
    ops = (int(torch.isfinite(ns).sum()) * REFINE_EDGE_OPS
           + int(live.sum()) * REFINE_SAMPLE_OPS
           + int((terms["wgt"] > 0).sum())
           * (REFINE_TERM_OPS + have_dist * REFINE_UNDISTORT_OPS)
           + corners * (REFINE_CORNER_OPS + have_dist * REFINE_DISTORT_OPS))
    return pixels, ops


def capture_refine_args(dev, frames) -> tuple:
    """The gray, corners, quad_valid and reversed_border of the
    refine_edges call that one TorchDetector(estimate_pose=True) call on
    `frames` makes."""
    import torch
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.ops import decode as dec
    _, height, width = frames.shape
    det = TorchDetector(device=dev, **detector_kw(width, height))
    calls, real = [], dec.refine_edges

    def recording(gray, corners, quad_valid, intr=None, dist=None,
                  reversed_border=False, syncs=None):
        check(intr is None and dist is None, "the bench detector refined "
              "with a calibration")
        calls.append((gray.contiguous().clone(), corners.contiguous().clone(),
                      quad_valid.contiguous().clone(), reversed_border))
        return real(gray, corners, quad_valid, intr, dist, reversed_border,
                    syncs)

    dec.refine_edges = recording
    try:
        det.detect_raw(torch.from_numpy(np.ascontiguousarray(frames)).to(
            dev))
    finally:
        dec.refine_edges = real
    check(len(calls) == 1, f"the detector made {len(calls)} refine calls")
    return calls[0]


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
            dR = max(float(np.abs(x.pose_R - y.pose_R).max())
                     for x, y in zip(dets, dets_cpu))
            check(dc < 0.1, f"B={b} row {i}: {dc:.4f} px from CPU plain")
            # poses to millimetres: P1 on the card against the plain
            # version on the CPU, from homographies that differ by the
            # corners' rounding
            check(dp <= 1e-3 and dR <= 1e-3, f"B={b} row {i}: pose_t "
                  f"{dp * 1e3:.4f} mm, pose_R {dR:.2e} from CPU plain "
                  "(limits 1 mm, 1e-3)")
            dr = match_corners(dets, placed, 1.0, f"B={b} row {i}")
            print(f"  B={b} row {i}: ids {ids}; corners vs CPU plain "
                  f"{dc:.5f} px, vs rendered {dr:.4f} px; pose_t vs CPU "
                  f"{dp * 1e3:.4f} mm, pose_R {dR:.2e}")
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
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk

    _, h4, w4 = t4.shape
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
        # the hybrid's first round sweeps 448 times, every later one 64
        rounds = counts["propagate"]
        check_device_launches(name, counts, propagate=0 if not rounds else (
            ck.propagate_plan(h4, w4, 448).launches
            + (rounds - 1) * ck.propagate_plan(h4, w4, 64).launches))
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


def rectify_phase(dev, bench4, placed):
    """ops/rectify.py at 1280x800 B=4: Rectifier (remap alone, then behind
    each Bayer pattern's debayer, the bench frames taken as mosaics) on the
    card against the same Rectifier on the CPU, <= 1 grey level, none of
    the port's kernels launched; then the bench tags rendered at their
    lens-distorted corners, rectified on the card and detected by
    TorchDetector: the bench ids in every row, corners within 1 px of the
    ideal (undistorted) ones."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.ops import rectify

    g = torch.from_numpy(bench4).to(dev)
    c = torch.from_numpy(bench4)
    out, paths = {}, {}
    torch.cuda.synchronize()
    _build.reset_counts()
    for pattern in (None,) + BAYER:
        rec = rectify.Rectifier(W, H, **LENS, dist=LENS_DIST,
                                bayer_pattern=pattern, device=dev)
        cpu = rectify.Rectifier(W, H, **LENS, dist=LENS_DIST,
                                bayer_pattern=pattern, device="cpu")
        got = rec(g)
        check(got.device == g.device and got.dtype == torch.uint8
              and tuple(got.shape) == bench4.shape,
              f"rectify {pattern}: {got.device} {got.dtype} "
              f"{tuple(got.shape)}")
        d = (got.cpu().to(torch.int32) - cpu(c).to(torch.int32)).abs()
        worst, share = int(d.max()), float((d > 0).float().mean())
        check(worst <= 1, f"rectify {pattern}: {worst} grey levels from "
              "the CPU")
        ms = call_ms(lambda: rec(g))
        name = f"debayer {pattern} + remap" if pattern else "remap"
        out[name] = dict(ms_per_call=ms, max_grey_diff=worst,
                         share_differing=share)
        print(f"  {name} B=4: <= {worst} grey level from the CPU, "
              f"{share:.6%} of pixels differ; {ms:.4f} ms/call (median of "
              f"{REPS}, CUDA events)")
    torch.cuda.synchronize()
    counts = _build.counts()
    check_kernel_set("rectify", counts, set())
    paths["rectify"] = counts

    ideal = [p.corners for p in placed]
    frames, warped = lens_frames(placed)
    rec = rectify.Rectifier(W, H, **LENS, dist=LENS_DIST, device=dev)
    det = TorchDetector(device=dev, width=W, height=H, **LENS)
    gw = torch.from_numpy(frames).to(dev)
    det.detect(rec(gw))                                   # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    rows = det.detect(rec(gw))
    counts = _build.counts()
    check_kernel_set("rectified detector", counts, PATH_800)
    check_device_launches("rectified detector", counts)
    paths["rectified detector 1280x800"] = counts
    shift = max(float(np.abs(w_ - q).max()) for w_, q in zip(warped, ideal))
    worst = 0.0
    for i, dets in enumerate(rows):
        got_ids = [d.tag_id for d in dets]
        check(got_ids == BENCH_IDS, f"rectified row {i}: ids {got_ids}")
        err = match_corners(dets, placed, 1.0, f"rectified row {i}")
        worst = max(worst, err)
        print(f"  rectified bench scene row {i}: ids {got_ids}, corners "
              f"{err:.4f} px from the ideal ones (the lens moved them up "
              f"to {shift:.2f} px)")
    out["rectified_max_corner_err_px"] = worst
    return out, paths


def lens_frames(placed, width: int = W, height: int = H, b: int = 4,
                noise: float = 1.0) -> tuple:
    """The bench tags `placed` rendered at their corners moved through the
    lens (lens_for(width, height), LENS_DIST): (B, H, W) frames, noise
    seeds 0..B-1, and each tag's moved corners."""
    from ros_vision_tpu_torch.apriltag import geometry
    from ros_vision_tpu_torch.apriltag.render import render_scene
    lens = lens_for(width, height)
    warped = [geometry.distort_points(p.corners, *lens.values(),
                                      np.asarray(LENS_DIST)) for p in placed]
    ids = [p.tag_id for p in placed]
    frames = np.stack([render_scene(ids, warped, width, height,
                                    noise_sigma=noise, seed=s)[0]
                       for s in range(b)])
    return frames, warped


def calibrated_detector_phase(dev, placed):
    """The calibrated camera's path: the bench tags rendered through the
    lens (LENS, LENS_DIST) at 1280x800 B=4 and detected directly, without
    rectification, by TorchDetector(**LENS, dist=LENS_DIST,
    estimate_pose=True), whose refine_edges fits each edge in undistorted
    coordinates (P2's 25-step undistortion): on the card and on the CPU at
    B=1 and B=4, the bench ids in every row, corners within 1 px of the
    moved truth and 0.1 px of the CPU, pose within 1 mm and 1e-3 of the
    CPU, the 1280x800 kernel set; ms/frame at B=1 and B=4 (median of
    REPS, host clock around detect_raw_packed and a synchronize) beside
    the same detector without the distortion on the same frames, the two
    taken in turns."""
    import types

    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    frames, warped = lens_frames(placed)
    truth = [types.SimpleNamespace(tag_id=p.tag_id, corners=q)
             for p, q in zip(placed, warped)]
    kw = dict(width=W, height=H, **LENS, estimate_pose=True)
    det = TorchDetector(device=dev, dist=LENS_DIST, **kw)
    cpu = TorchDetector(device="cpu", dist=LENS_DIST, **kw)
    dist_free = TorchDetector(device=dev, **kw)
    det.detect(frames)                                    # warm-up
    dist_free.detect(frames)
    torch.cuda.synchronize()
    _build.reset_counts()
    out = {}
    for b in (1, 4):
        rows = det.detect(frames[:b])
        rows_cpu = cpu.detect(frames[:b])
        for i, (dets, dets_cpu) in enumerate(zip(rows, rows_cpu)):
            ids = [d.tag_id for d in dets]
            check(ids == BENCH_IDS, f"calibrated B={b} row {i}: ids {ids}")
            check([d.tag_id for d in dets_cpu] == ids,
                  f"calibrated B={b} row {i}: CPU ids differ")
            dc = max(float(np.abs(x.corners - y.corners).max())
                     for x, y in zip(dets, dets_cpu))
            dp = max(float(np.abs(x.pose_t - y.pose_t).max())
                     for x, y in zip(dets, dets_cpu))
            dR = max(float(np.abs(x.pose_R - y.pose_R).max())
                     for x, y in zip(dets, dets_cpu))
            check(dc < 0.1, f"calibrated B={b} row {i}: {dc:.4f} px from "
                  "the CPU")
            check(dp <= 1e-3 and dR <= 1e-3, f"calibrated B={b} row {i}: "
                  f"pose_t {dp * 1e3:.4f} mm, pose_R {dR:.2e} from the CPU "
                  "(limits 1 mm, 1e-3)")
            dr = match_corners(dets, truth, 1.0, f"calibrated B={b} row {i}")
            print(f"  calibrated B={b} row {i}: ids {ids}; corners vs CPU "
                  f"{dc:.5f} px, vs the lens-moved truth {dr:.4f} px; "
                  f"pose_t vs CPU {dp * 1e3:.4f} mm, pose_R {dR:.2e}")
    torch.cuda.synchronize()
    counts = _build.counts()
    check_kernel_set("calibrated detector", counts, PATH_800)
    check_device_launches("calibrated detector", counts)
    for b in (1, 4):
        g = torch.from_numpy(np.ascontiguousarray(frames[:b])).to(dev)
        times = {"calibrated": [], "dist_free": []}
        for _ in range(REPS):
            for name, d in (("calibrated", det), ("dist_free", dist_free)):
                t0 = time.perf_counter()
                d.detect_raw_packed(g)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        out[b] = {f"{name}_ms_per_frame": statistics.median(v) / b
                  for name, v in times.items()}
        print(f"  B={b}: calibrated {out[b]['calibrated_ms_per_frame']:.3f} "
              f"ms/frame, without the distortion "
              f"{out[b]['dist_free_ms_per_frame']:.3f} (medians of {REPS}, "
              "in turns, host clock incl. sync)")
    return out, {"calibrated detector 1280x800": counts}


def seeded_game_piece_weights(engine, seed: int = 1):
    """The engine's seeded init with its BatchNorm statistics and affine
    params and the head's biases drawn from a seeded generator too: the
    init's identity BatchNorm gives every anchor a score of ~0.5 and the
    same box, which no comparison could tell apart."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in engine.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                for t, lo, hi in ((mod.weight, 0.5, 1.5),
                                  (mod.bias, -0.3, 0.3),
                                  (mod.running_mean, -0.5, 0.5),
                                  (mod.running_var, 0.5, 2.0)):
                    t.copy_(torch.rand(t.shape, generator=gen)
                            * (hi - lo) + lo)
            elif isinstance(mod, torch.nn.Conv2d) and mod.bias is not None:
                mod.bias.copy_(torch.rand(mod.bias.shape, generator=gen)
                               * 2 - 1)
    path = ROOT / "build" / "chip_smoke" / "gamepiece_yolo11n_seeded.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    engine.save_params(str(path))
    engine.load_params(str(path))
    return path


def game_piece_frames(b: int) -> np.ndarray:
    """(b, 800, 1280, 3) uint8 BGR frames: the bench scene in grey with an
    orange game piece at a place of its own in each frame."""
    frames = []
    for i in range(b):
        img, _ = bench_scene(i)
        bgr = np.repeat(img[..., None], 3, -1)
        x, y = 120 + 260 * i, 480 - 90 * i
        bgr[y:y + 150, x:x + 200] = (25, 100, 230)
        frames.append(bgr)
    return np.stack(frames)


def device_busy_share(fn, calls: int = 10) -> tuple:
    """(busy share, device ms per call, device launches per call, the
    top device operations): fn()'s kernels under torch.profiler, their
    device time over the host time of the window, `calls` calls ended by a
    synchronize; (None, None, None, []) where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = []
    for e in prof.key_averages():
        # a user annotation (the optimizer's step) spans kernels listed
        # on their own too, and the gaps between them
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                not getattr(e, "is_user_annotation", False):
            us = getattr(e, "device_time_total", None)
            ops.append((e.cuda_time_total if us is None else us, e.count,
                        e.key))
    busy_us = sum(o[0] for o in ops)
    if busy_us <= 0:
        return None, None, None, []
    top = [(key[:60], us / 1e3 / calls, count / calls)
           for us, count, key in sorted(ops, reverse=True)[:6]]
    return (busy_us / wall_us, busy_us / 1e3 / calls,
            sum(o[1] for o in ops) / calls, top)


def game_piece_phase(dev):
    """models/infer.py + ops/nms.py + runtime/game_piece_node.py: YOLOv11n
    at 640x640, one class, seeded weights, bf16 on the card."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.models.infer import ModelInference
    from ros_vision_tpu_torch.ops import nms

    engine = ModelInference(num_classes=1, scale="n", img_size=GP_SIZE,
                            class_names=["ball"], device=dev)
    check(engine.dtype == torch.bfloat16 and engine.device == dev,
          f"engine {engine.dtype} on {engine.device}")
    npz = seeded_game_piece_weights(engine)
    cpu = ModelInference(num_classes=1, scale="n", img_size=GP_SIZE,
                         class_names=["ball"], params_path=str(npz),
                         dtype=torch.float32, device="cpu")
    f32 = ModelInference(num_classes=1, scale="n", img_size=GP_SIZE,
                         params_path=str(npz), dtype=torch.float32,
                         device=dev)
    frames = game_piece_frames(4)
    out, paths = {}, {}
    for b in (1, 4):
        engine.infer(engine.preprocess_device(frames[:b]))      # warm-up
        torch.cuda.synchronize()
        _build.reset_counts()
        x = engine.preprocess_device(frames[:b])
        res = engine.infer(x)
        rows = [engine.detections(res, (W, H), r) for r in range(b)]
        torch.cuda.synchronize()
        counts = _build.counts()
        check_kernel_set(f"game piece B={b}", counts, set())
        paths[f"game piece B={b}"] = counts
        check(all(v.device == dev for v in res.values())
              and tuple(res["boxes"].shape) == (b, 100, 4),
              f"game piece B={b}: outputs {[(k, v.device, v.shape) for k, v in res.items()]}")
        # the card's preprocess and forward against the CPU's f32 ones
        xc = cpu.preprocess_device(frames[:b])
        pre_err = float((x.cpu() - xc).abs().max())
        check(pre_err <= 1e-5, f"preprocess_device: {pre_err} from the CPU")
        raw = engine.forward(x)
        raw_cpu = cpu.forward(xc)
        check(tuple(raw.shape) == (b, 5, 8400) and raw.dtype == torch.float32
              and bool(torch.isfinite(raw).all()),
              f"raw {tuple(raw.shape)} {raw.dtype}")
        errs = {}
        for name, got, tol in (("bf16", raw, GP_BF16_TOL),
                               ("f32", None, GP_F32_TOL)):
            if got is None:
                # cuDNN rounds f32 convolution inputs to TF32 unless told
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=False):
                    got = f32.forward(x)
            got = got.cpu()
            box = float((got[:, :4] - raw_cpu[:, :4]).abs().max())
            score = float((got[:, 4:] - raw_cpu[:, 4:]).abs().max())
            check(box <= tol[0] and score <= tol[1],
                  f"game piece B={b} {name}: boxes {box} px, scores "
                  f"{score} from the CPU's f32 forward (limits {tol})")
            errs[name] = (box, score)
        # NMS on the card on the CPU's raw output: equal slot for slot
        want = nms.parse_and_nms(raw_cpu)
        got = nms.parse_and_nms(raw_cpu.to(dev))
        for k in ("valid", "classes", "scores", "boxes"):
            check(torch.equal(got[k].cpu(), want[k]),
                  f"game piece B={b}: card NMS {k} differs from the CPU's")
        n_valid = [int(v) for v in want["valid"].sum(1)]
        print(f"  B={b}: raw (B, 5, 8400) vs the CPU's f32 forward: card "
              f"bf16 boxes {errs['bf16'][0]:.4f} px, scores "
              f"{errs['bf16'][1]:.2e} (limits {GP_BF16_TOL}); card f32 "
              f"(TF32 off) {errs['f32'][0]:.2e} px, {errs['f32'][1]:.2e} "
              f"(limits {GP_F32_TOL}); preprocess {pre_err:.2e}; NMS on "
              f"the CPU's raw equal on the card ({n_valid} kept); "
              f"detections per row {[len(r) for r in rows]}")
        out[f"B={b}"] = dict(bf16_box_err_px=errs["bf16"][0],
                             bf16_score_err=errs["bf16"][1],
                             f32_box_err_px=errs["f32"][0],
                             f32_score_err=errs["f32"][1])

    # weights through the JAX package's .npz format and back
    again = ModelInference(num_classes=1, scale="n", img_size=GP_SIZE,
                           params_path=str(npz), device=dev)
    x = engine.preprocess_device(frames)
    a, b_ = engine.infer(x), again.infer(x)
    check(all(torch.equal(a[k], b_[k]) for k in a)
          and torch.equal(engine.forward(x), again.forward(x)),
          "save_params / load_params changed the outputs")
    print("  save_params -> load_params: outputs identical")

    try:
        import cv2  # noqa: F401
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("  GamePieceNode.process_frame not run: no cv2 here (its "
              "host preprocess needs cv2, as the JAX node's does)")
    else:
        from ros_vision_tpu_torch.runtime.game_piece_node import \
            GamePieceNode
        published = []
        node = GamePieceNode(engine=engine,
                             detection_publisher=published.append)
        try:
            dets = node.process_frame(frames[0])
        finally:
            node.stop()
        check(node.frames_processed == 1 and published
              and published[0].detections == dets,
              "GamePieceNode.process_frame published nothing")
        print(f"  GamePieceNode.process_frame ran: {len(dets)} detections")

    for b in (1, 4):
        x = engine.preprocess_device(frames[:b])
        raw = engine.forward(x)
        times = {"infer": [], "nms": []}
        for _ in range(3):
            engine.infer(x)
        for _ in range(REPS):
            for name, fn in (("infer", lambda: engine.infer(x)),
                             ("nms", lambda: nms.parse_and_nms(raw))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        ms = {k: statistics.median(v) for k, v in times.items()}
        busy, dev_ms, launches, top = device_busy_share(
            lambda: engine.infer(x))
        _, nms_dev_ms, nms_launches, _ = device_busy_share(
            lambda: nms.parse_and_nms(raw))
        out[f"B={b}"].update(infer_ms_per_frame=ms["infer"] / b,
                             infer_ms_per_call=ms["infer"],
                             nms_ms_per_call=ms["nms"],
                             nms_share=ms["nms"] / ms["infer"],
                             device_busy_share=busy,
                             device_ms_per_call=dev_ms,
                             device_launches_per_call=launches,
                             nms_device_ms_per_call=nms_dev_ms,
                             nms_device_launches_per_call=nms_launches)
        busy_text = "not measured (the profiler saw no device time)" \
            if busy is None else (f"{busy:.1%} of a profiled window "
                                  f"({dev_ms:.3f} ms device time and "
                                  f"{launches:.0f} device launches a call; "
                                  f"the NMS alone {nms_dev_ms:.3f} ms and "
                                  f"{nms_launches:.0f} launches)")
        print(f"  B={b}: infer (forward + NMS) {ms['infer'] / b:.3f} "
              f"ms/frame, {ms['infer']:.3f} ms/call; NMS alone "
              f"{ms['nms']:.3f} ms/call ({ms['nms'] / ms['infer']:.1%}); "
              f"medians of {REPS}, host clock incl. sync; device busy "
              f"{busy_text}")
        for key, op_ms, count in top:
            print(f"    {op_ms:.4f} ms, {count:.0f} launches a call: {key}")
    return out, paths


TRAIN_B = 8
# the overfit run: the class loss collapses near step 30 and knocks the
# boxes back (mean IoU 0.40 at step 20, 0.36-0.40 at step 30) before the
# box loss falls (IoU 0.45-0.58 at step 89 over five runs on an H100;
# scripts/mb_torch_train_overfit.py prints the trajectory)
TRAIN_STEPS = 90
TRAIN_LOG_EVERY = 10
TRAIN_LR = 2e-3
# one step on the card (TF32 off) against the same step on the CPU: the
# metrics' relative error, and each gradient tensor's max-abs error over
# that tensor's max-abs
TRAIN_METRIC_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# the extrinsic ring: fx = fy = 900 at 1280x800, tags of 0.1651 m
RING_FX = 900.0
TAG_SIZE = 0.1651
RING_ITERATIONS = 2500
RING_LR = 3e-2
# a free camera within 1 degree and 2 cm of the truth (the limits of
# tests/test_calib_launch.py), on the card and on the CPU. The card's solve
# within 0.01 degree and 1e-4 m of the CPU's after RIG_AGREE_ITERATIONS on
# that test's two-camera rig, where the trajectory is stable (inputs moved
# by 1e-7 move it <= 4e-7 m on the CPU). Not after 2,500: Adam at a
# constant rate ends in steps that spike once the loss has converged, and
# its last iterate then moves by up to millimetres when the inputs move by
# 1e-7, on the ring's frameset from a few hundred iterations on (the CPU's
# solve of a perturbed copy is printed beside the card's difference)
RING_TOL = (1.0, 0.02)
RING_CPU_TOL = (0.01, 1e-4)
RIG_AGREE_ITERATIONS = 1000


def tf32_flags() -> tuple:
    """(matmul.allow_tf32, cudnn.allow_tf32, float32 matmul precision)."""
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


class tf32_state:
    """Set the three TF32 settings of tf32_flags() for a block; restore
    them after."""

    def __init__(self, flags: tuple):
        self.flags = flags

    def __enter__(self):
        self.saved = tf32_flags()
        self._set(self.flags)

    def __exit__(self, *exc):
        self._set(self.saved)

    @staticmethod
    def _set(flags):
        import torch
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        torch.set_float32_matmul_precision(flags[2])


def train_batch(b: int, seed: int = 0):
    """A synthetic (imgs, boxes, labels, mask) batch at GP_SIZE: the bench
    scene in grey with an orange game piece of its own size and place in
    each frame (game_piece_frames' scenes), resized from 1280x800 to
    GP_SIZE x GP_SIZE as preprocess_device resizes, with its box in
    cx,cy,w,h model pixels; one object a row, a padded second slot."""
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    frames, boxes = [], np.zeros((b, 2, 4), np.float32)
    sx, sy = GP_SIZE / W, GP_SIZE / H
    for i in range(b):
        img, _ = bench_scene(i)
        bgr = np.repeat(img[..., None], 3, -1)
        w, h = rng.integers(120, 320), rng.integers(100, 260)
        x, y = rng.integers(0, W - w), rng.integers(0, H - h)
        bgr[y:y + h, x:x + w] = (25, 100, 230)
        frames.append(bgr[..., ::-1])
        boxes[i, 0] = ((x + w / 2) * sx, (y + h / 2) * sy, w * sx, h * sy)
    x = torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0)
    imgs = F.interpolate(x.permute(0, 3, 1, 2), size=(GP_SIZE, GP_SIZE),
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)
    labels = np.zeros((b, 2), np.int32)
    mask = np.zeros((b, 2), bool)
    mask[:, 0] = True
    return imgs.contiguous().numpy(), boxes, labels, mask


def train_phase(dev):
    """models/train.py: YOLOv11n at 640, one class, f32 training at B=8
    from seeded weights on the card."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.models import train as tr
    from ros_vision_tpu_torch.models.infer import ModelInference

    def engine(device, dtype=torch.float32, path=None):
        return ModelInference(num_classes=1, scale="n", img_size=GP_SIZE,
                              class_names=["ball"], params_path=path,
                              dtype=dtype, device=device)

    gp = engine(dev, torch.bfloat16)
    npz = str(seeded_game_piece_weights(gp))
    batch = train_batch(TRAIN_B)
    out = {}

    # one step on the card, TF32 off, against the same step on the CPU
    def one_step(device):
        eng = engine(device, path=npz)
        step = tr.make_train_step(
            eng.model, torch.optim.SGD(eng.model.parameters(), lr=0.0),
            GP_SIZE, 1)
        metrics = step(*(torch.from_numpy(a).to(device) for a in batch))
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.cpu() for k, p in eng.model.named_parameters()})

    with tf32_state((False, False, "highest")):
        card_m, card_g = one_step(dev)
    cpu_m, cpu_g = one_step(torch.device("cpu"))
    m_err = {k: abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m}
    g_err = max((float((card_g[k] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30), k)
                for k, g in cpu_g.items())
    check(all(e <= TRAIN_METRIC_TOL for e in m_err.values()),
          f"train step: card metrics {card_m} vs CPU {cpu_m} (limit "
          f"{TRAIN_METRIC_TOL} relative)")
    check(g_err[0] <= TRAIN_GRAD_TOL,
          f"train step: gradient of {g_err[1]} {g_err[0]:.3e} of its "
          f"max-abs from the CPU's (limit {TRAIN_GRAD_TOL})")
    print(f"  one step B={TRAIN_B}, TF32 off, card vs CPU: metrics "
          f"{ {k: f'{v:.2e}' for k, v in m_err.items()} } relative (limit "
          f"{TRAIN_METRIC_TOL}); worst gradient {g_err[0]:.3e} of its "
          f"max-abs ({g_err[1]}; limit {TRAIN_GRAD_TOL}); loss "
          f"{card_m['loss']:.5f}")
    out["step_vs_cpu"] = dict(metric_rel_err=m_err,
                              worst_grad_err=g_err[0],
                              worst_grad_param=g_err[1], card=card_m)

    # overfit one repeated batch through train(), on the bf16 engine
    x = torch.from_numpy(batch[0]).to(dev)
    raw0 = gp.forward(x).clone()
    stats0 = {k: v.clone() for k, v in gp.model.state_dict().items()
              if "running_" in k}

    def repeated():
        while True:
            yield batch

    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    hist = tr.train(gp, repeated(), steps=TRAIN_STEPS,
                    cfg=tr.TrainConfig(learning_rate=TRAIN_LR),
                    log_every=TRAIN_LOG_EVERY)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _build.counts()
    check_kernel_set("train", counts, set())
    first, last = hist[0], hist[-1]
    check(last["loss"] < 0.7 * first["loss"]
          and last["mean_iou"] > first["mean_iou"],
          f"train: {TRAIN_STEPS} steps on one batch went {first} -> {last}")
    stats = {k: v for k, v in gp.model.state_dict().items()
             if "running_" in k}
    check(all(torch.equal(stats[k], v) for k, v in stats0.items()),
          "train: BatchNorm running statistics changed")
    trained = ROOT / "build" / "chip_smoke" / "gamepiece_trained.npz"
    gp.save_params(str(trained))
    fresh = engine(dev, torch.bfloat16, str(trained))
    raw = gp.forward(x)
    check(torch.equal(raw, fresh.forward(x)),
          "train: the trained engine's bf16 forward differs from a fresh "
          "engine on its saved weights")
    check(not torch.equal(raw, raw0), "train: bf16 forward unchanged by "
          "training")
    a, b = gp.infer(x), fresh.infer(x)
    check(all(torch.equal(a[k], b[k]) for k in a),
          "train: infer differs from a fresh engine on the saved weights")
    ious = ", ".join(f"{h['mean_iou']:.4f}" for h in hist)
    print(f"  train() {TRAIN_STEPS} steps on one B={TRAIN_B} batch: loss "
          f"{first['loss']:.4f} -> {last['loss']:.4f}, mean IoU "
          f"{first['mean_iou']:.4f} -> {last['mean_iou']:.4f} "
          f"(every {TRAIN_LOG_EVERY} steps: {ious}; "
          f"{train_s:.2f} s); BatchNorm statistics bit-identical; bf16 "
          f"infer == a fresh engine on save_params; none of the port's "
          f"kernels launched")

    # ms per step and peak memory on a fresh f32 engine, under the
    # process defaults (no module of the port writes the TF32 flags) and,
    # in turns, with TF32 off everywhere
    eng = engine(dev, path=npz)
    step = tr.make_train_step(eng.model, tr.make_optimizer(eng.model),
                              GP_SIZE, 1)
    args = [torch.from_numpy(a).to(dev) for a in batch]
    tf32_now = tf32_flags()
    modes = {"defaults": tf32_now, "tf32_off": (False, False, "highest")}
    for mode in modes.values():
        with tf32_state(mode):
            for _ in range(3):
                step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = {m: [] for m in modes}
    for _ in range(REPS):
        for m, mode in modes.items():
            with tf32_state(mode):
                t0 = time.perf_counter()
                step(*args)
                torch.cuda.synchronize()
                times[m].append((time.perf_counter() - t0) * 1e3)
    ms = {m: statistics.median(v) for m, v in times.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    busy, dev_ms, launches, top = device_busy_share(lambda: step(*args))
    check(tf32_flags() == tf32_now, "train: TF32 flags changed")
    with tf32_state(modes["tf32_off"]):
        _, off_dev_ms, _, _ = device_busy_share(lambda: step(*args))
    busy_text = "not measured (the profiler saw no device time)" \
        if busy is None else (f"{busy:.1%} of a profiled window "
                              f"({dev_ms:.3f} ms device time and "
                              f"{launches:.0f} device launches a step; "
                              f"TF32 off: {off_dev_ms:.3f} ms)")
    print(f"  step B={TRAIN_B} f32 (medians of {REPS}, in turns, host "
          f"clock incl. sync): {ms['defaults']:.3f} ms under the process "
          f"defaults (matmul.allow_tf32, cudnn.allow_tf32, matmul "
          f"precision = {tf32_now}), {ms['tf32_off']:.3f} ms with TF32 "
          f"off; {ms['defaults'] / TRAIN_B:.3f} ms an image; peak memory "
          f"{peak / 2**20:.1f} MiB; device busy {busy_text}")
    for key, op_ms, count in top:
        print(f"    {op_ms:.4f} ms, {count:.0f} launches a step: {key}")
    out.update(first=first, last=last, ms_per_step=ms["defaults"],
               ms_per_step_tf32_off=ms["tf32_off"], tf32=tf32_now,
               peak_memory_bytes=peak, device_busy_share=busy,
               device_ms_per_step=dev_ms,
               device_ms_per_step_tf32_off=off_dev_ms,
               device_launches_per_step=launches)
    return out, {"train": counts}


def ring_cameras() -> dict:
    """Four 1280x800 cameras (fx = fy = 900) at the corners of a 0.7 x
    0.6 m robot: {cam_id: ((roll, pitch, yaw) deg, (x, y, z) m)}. A camera
    sees 70.8 degrees across, so two cameras whose axes part by 90 degrees
    share no view: the front pair turns out by 22.5 degrees and the back
    pair by 67.5 degrees, each side's pair 45 degrees apart. The three
    adjacent pairs front, left and right overlap; the back pair does not."""
    return {"front_left": ((1.0, -2.0, 22.5), (0.35, 0.30, 0.45)),
            "front_right": ((-1.5, 1.0, -22.5), (0.35, -0.30, 0.45)),
            "back_left": ((0.5, -1.0, 67.5), (-0.35, 0.30, 0.50)),
            "back_right": ((1.0, 2.0, -67.5), (-0.35, -0.30, 0.50))}


RING_PAIRS = (("front_left", "front_right"), ("front_left", "back_left"),
              ("front_right", "back_right"))


def ring_scene(per_pair: int = 12, seed: int = 0):
    """Tags 1-4 m out, each seen whole by exactly the two cameras of one
    adjacent pair and by no other camera, `per_pair` for each pair, spread
    over frames so that no two tags overlap in a camera's image. Returns
    ({frame: {cam_id: gray (800, 1280) u8}}, {frame: {tag_id: pair}}, the
    exact frameset {frame: {tag_id: [{cam_id, translation}]}} of the tags'
    true camera-frame centers)."""
    from ros_vision_tpu_torch.apriltag.render import (project_tag_corners,
                                                      render_scene)
    from ros_vision_tpu_torch.utils import rotation_utils as ru
    rng = np.random.default_rng(seed)
    mounts = ring_cameras()
    cams = {c: (ru.compose_rotations_xyz(*a) @ ru.camera_to_robot(),
                np.asarray(t)) for c, (a, t) in mounts.items()}
    up = np.array([0.0, 0.0, 1.0])

    def center(cam, p):
        r, t = cams[cam]
        return r.T @ (p - t)

    def project(cam, rot, p):
        pc = center(cam, p)
        if pc[2] < 0.3:
            return None
        return project_tag_corners(cams[cam][0].T @ rot, pc, TAG_SIZE,
                                   RING_FX, RING_FX, W / 2, H / 2)

    def inside(q, margin):
        return q is not None and bool(
            (q[:, 0] > margin).all() and (q[:, 0] < W - margin).all()
            and (q[:, 1] > margin).all() and (q[:, 1] < H - margin).all())

    def near(q, margin=100):
        """Any part of the quad's bounding box within `margin` px of the
        image."""
        return q is not None and bool(
            q[:, 0].max() > -margin and q[:, 0].min() < W + margin
            and q[:, 1].max() > -margin and q[:, 1].min() < H + margin)

    frames = []          # per frame: {tag_id: (pair, {cam: corners})}
    next_id = 1
    for pair in RING_PAIRS:
        mid = (cams[pair[0]][1] + cams[pair[1]][1]) / 2
        yaw = np.deg2rad(np.mean([mounts[c][0][2] for c in pair]))
        placed = 0
        while placed < per_pair:
            d = rng.uniform(1.0, 4.0)
            a = yaw + rng.uniform(-0.12, 0.12)
            p = mid + np.array([d * np.cos(a), d * np.sin(a),
                                rng.uniform(-0.2, 0.5)])
            z = (p - mid) / np.linalg.norm(p - mid)
            y = -(up - (up @ z) * z)
            y /= np.linalg.norm(y)
            x = np.cross(y, z)
            roll = np.deg2rad(rng.uniform(-30, 30))
            x, y = (np.cos(roll) * x + np.sin(roll) * y,
                    -np.sin(roll) * x + np.cos(roll) * y)
            rot = np.stack([x, y, z], 1)
            quads = {c: project(c, rot, p) for c in cams}
            if not all(inside(quads[c], 24) for c in pair) or any(
                    near(quads[c]) for c in cams if c not in pair):
                continue
            for frame in frames:     # the first frame with room for it
                if all(not _boxes_meet(quads[c], q[c])
                       for _, q, _ in frame.values() for c in pair
                       if c in q):
                    break
            else:
                frame = {}
                frames.append(frame)
            frame[next_id] = (pair, {c: quads[c] for c in pair},
                              {c: center(c, p) for c in pair})
            next_id += 1
            placed += 1
    images, truth, exact = {}, {}, {}
    for f, frame in enumerate(frames):
        images[f] = {}
        for cam in cams:
            tags = [(i, q[cam]) for i, (_, q, _) in frame.items() if cam in q]
            images[f][cam] = render_scene(
                [i for i, _ in tags], [q for _, q in tags], W, H,
                noise_sigma=1.0, seed=100 * f + len(images[f]))[0]
        truth[f] = {i: pair for i, (pair, _, _) in frame.items()}
        exact[f] = {i: [{"cam_id": c, "translation": pc[c]}
                        for c in cams if c in pc]
                    for i, (_, _, pc) in frame.items()}
    return images, truth, exact


def _boxes_meet(a: np.ndarray, b: np.ndarray, pad: float = 0.3) -> bool:
    """Whether two corner quads' bounding boxes, each grown by `pad` of its
    size (the tag's quiet zone and a margin), overlap."""
    def box(q):
        lo, hi = q.min(0), q.max(0)
        g = (hi - lo) * pad
        return lo - g, hi + g
    (alo, ahi), (blo, bhi) = box(a), box(b)
    return bool((alo < bhi).all() and (blo < ahi).all())


def rotation_err_deg(a, b) -> float:
    """The angle between two rotation matrices, from the Frobenius norm of
    their difference (2 arcsin(|A - B| / 2 sqrt 2)): no floor from f32
    matrices that are not quite orthonormal, as arccos of the trace has."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def pose_diff(a: dict, b: dict) -> tuple:
    """(degrees, metres) between two system_config extrinsics entries."""
    return (rotation_err_deg(a["rotation"], b["rotation"]),
            float(np.abs(np.subtract(a["offset"], b["offset"])).max()))


def perturbed(frameset: dict, eps: float, seed: int = 5) -> dict:
    """The frameset with each translation times (1 + eps * N(0, 1))."""
    rng = np.random.default_rng(seed)
    return {f: {i: [dict(r, translation=np.asarray(r["translation"])
                         * (1 + eps * rng.standard_normal(3)))
                    for r in recs] for i, recs in frame.items()}
            for f, frame in frameset.items()}


def two_camera_rig(n_tags: int = 40, seed: int = 0) -> dict:
    """tests/test_calib_launch.py's frameset: camA at (0, 0.2, 0.5) and camB
    turned (2, -3, 25) degrees at (0.1, -0.3, 0.4), both seeing 40 tags at
    random robot-frame positions, their exact camera-frame centers."""
    from ros_vision_tpu_torch.utils import rotation_utils as ru
    rng = np.random.default_rng(seed)
    cams = {"camA": (ru.camera_to_robot(), np.array([0.0, 0.2, 0.5])),
            "camB": (ru.compose_rotations_xyz(2.0, -3.0, 25.0)
                     @ ru.camera_to_robot(), np.array([0.1, -0.3, 0.4]))}
    frameset = {}
    for i in range(n_tags):
        p = rng.uniform([1.0, -2.0, 0.3], [4.0, 2.0, 1.5])
        frameset[i] = {100 + i: [{"cam_id": c, "translation": r.T @ (p - t)}
                                 for c, (r, t) in cams.items()]}
    return frameset


def extrinsic_phase(dev):
    """calib/extrinsic.py: four ring cameras' tag poses from TorchDetector
    on the card (the 1280x800 kernel set), the extrinsics solved on the
    card from perturbed guesses with front_left frozen as the anchor."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.calib import extrinsic as ex
    from ros_vision_tpu_torch.utils import rotation_utils as ru

    images, truth, exact = ring_scene()
    det = TorchDetector(device=dev, width=W, height=H, fx=RING_FX,
                        fy=RING_FX, cx=W / 2, cy=H / 2, tag_size=TAG_SIZE,
                        estimate_pose=True)
    det.detect(images[0]["front_left"])                   # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    frameset = ex.build_frameset_from_images(images, lambda cam: det,
                                             TAG_SIZE)
    detect_s = time.perf_counter() - t0
    n_images = sum(len(c) for c in images.values())
    # every detection a rendered tag seen by a camera of its pair; the
    # tags both cameras of a pair detected, at least 8 a pair
    pairs = dict.fromkeys(RING_PAIRS, 0)
    views = missed = 0
    for f, tags in truth.items():
        for i, recs in frameset[f].items():
            cams = sorted(r["cam_id"] for r in recs)
            check(i in tags and set(cams) <= set(tags[i])
                  and len(set(cams)) == len(cams),
                  f"extrinsic frame {f}: tag {i} detected by {cams}, "
                  f"rendered for {tags.get(i)}")
        for i, pair in tags.items():
            got = len(frameset[f].get(i, ()))
            views += 2
            missed += 2 - got
            pairs[pair] += got == 2
    check(min(pairs.values()) >= 8, f"extrinsic: tags detected by both "
          f"cameras of each pair {pairs}")
    pose_err = max(float(np.abs(r["translation"] - e["translation"]).max())
                   for f in exact for i, recs in frameset[f].items()
                   for r in recs for e in exact[f][i]
                   if e["cam_id"] == r["cam_id"])

    guesses = {}
    rng = np.random.default_rng(1)
    for cam, (angles, t) in ring_cameras().items():
        if cam == "front_left":
            guesses[cam] = ex.CameraGuess(angles, t, adjustable=False)
        else:
            guesses[cam] = ex.CameraGuess(
                tuple(np.add(angles, rng.uniform(-5, 5, 3))),
                tuple(np.add(t, rng.uniform(-0.1, 0.1, 3))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = ex.solve_extrinsics(frameset, guesses, RING_ITERATIONS,
                                 RING_LR, device=dev)
    solve_s = time.perf_counter() - t0
    counts = _build.counts()
    check_kernel_set("extrinsic", counts, PATH_800)
    check_device_launches("extrinsic", counts)
    check(counts["adaptive_threshold"] == n_images,
          f"extrinsic: {counts['adaptive_threshold']} detector calls for "
          f"{n_images} images")
    cpu = ex.solve_extrinsics(frameset, guesses, RING_ITERATIONS, RING_LR,
                              device="cpu")
    jitter = ex.solve_extrinsics(perturbed(frameset, 1e-7), guesses,
                                 RING_ITERATIONS, RING_LR, device="cpu")
    # the guesses' rotations as the solve computes them, batched on the card
    with torch.no_grad():
        guessed = (ex._rot_xyz(torch.tensor(
            [guesses[c].rotations_deg for c in sorted(guesses)],
            dtype=torch.float32, device=dev))
            @ torch.as_tensor(ex._CAM2ROBOT, device=dev)).cpu().numpy()

    errs = {}
    for cam, (angles, t) in ring_cameras().items():
        want_r = ru.compose_rotations_xyz(*angles) @ ru.camera_to_robot()
        got = result[cam]
        rot_err, off_err = pose_diff(got, {"rotation": want_r, "offset": t})
        vs_cpu = pose_diff(got, cpu[cam])
        cpu_jitter = pose_diff(cpu[cam], jitter[cam])
        if guesses[cam].adjustable:
            cpu_err = pose_diff(cpu[cam], {"rotation": want_r, "offset": t})
            check(rot_err < RING_TOL[0] and off_err < RING_TOL[1]
                  and cpu_err[0] < RING_TOL[0] and cpu_err[1] < RING_TOL[1],
                  f"extrinsic {cam}: card {rot_err:.4f} deg, {off_err:.4f} "
                  f"m, CPU {cpu_err} from the truth (limits {RING_TOL})")
        else:
            row = sorted(guesses).index(cam)
            check(got["rotation"] == guessed[row].tolist()
                  and got["offset"] == np.float32(
                      guesses[cam].translation).tolist(),
                  f"extrinsic {cam}: the frozen anchor moved")
        errs[cam] = dict(rot_err_deg=rot_err, offset_err_m=off_err,
                         vs_cpu_deg=vs_cpu[0], vs_cpu_m=vs_cpu[1],
                         cpu_jitter_deg=cpu_jitter[0],
                         cpu_jitter_m=cpu_jitter[1])
        print(f"  {cam}{' (anchor, frozen)' if cam == 'front_left' else ''}"
              f": {rot_err:.4f} deg, {off_err * 1e3:.2f} mm from the truth;"
              f" card vs CPU {vs_cpu[0]:.2e} deg, {vs_cpu[1]:.2e} m; the "
              f"CPU's solve of the inputs x (1 + 1e-7 noise) moved "
              f"{cpu_jitter[0]:.2e} deg, {cpu_jitter[1]:.2e} m")
    # the two-camera rig of tests/test_calib_launch.py: card vs CPU
    rig = two_camera_rig()
    rig_guesses = {"camA": ex.CameraGuess((0.0, 0.0, 0.0), (0.0, 0.2, 0.5),
                                          adjustable=False),
                   "camB": ex.CameraGuess((0.0, 0.0, 15.0), (0.0, 0.0, 0.3))}
    rig_card, rig_cpu = (ex.solve_extrinsics(rig, rig_guesses,
                                             RIG_AGREE_ITERATIONS, RING_LR,
                                             device=d) for d in (dev, "cpu"))
    rig_diff = pose_diff(rig_card["camB"], rig_cpu["camB"])
    rig_card = ex.solve_extrinsics(rig, rig_guesses, RING_ITERATIONS,
                                   RING_LR, device=dev)
    rig_err = pose_diff(rig_card["camB"], {
        "rotation": ru.compose_rotations_xyz(2.0, -3.0, 25.0)
        @ ru.camera_to_robot(), "offset": (0.1, -0.3, 0.4)})
    check(rig_diff[0] <= RING_CPU_TOL[0] and rig_diff[1] <= RING_CPU_TOL[1]
          and rig_err[0] < RING_TOL[0] and rig_err[1] < RING_TOL[1],
          f"extrinsic two-camera rig: card vs CPU {rig_diff} (limits "
          f"{RING_CPU_TOL}), vs the truth {rig_err} (limits {RING_TOL})")
    print(f"  two-camera rig of tests/test_calib_launch.py: camB "
          f"{rig_err[0]:.2e} deg, {rig_err[1]:.2e} m from the truth after "
          f"{RING_ITERATIONS} iterations on the card; card vs CPU after "
          f"{RIG_AGREE_ITERATIONS} {rig_diff[0]:.2e} deg, {rig_diff[1]:.2e}"
          f" m (limits {RING_CPU_TOL})")
    ms_image = detect_s * 1e3 / n_images
    ms_iter = solve_s * 1e3 / RING_ITERATIONS
    busy, dev_ms, launches, _ = device_busy_share(
        lambda: ex.solve_extrinsics(frameset, guesses, 50, RING_LR,
                                    device=dev), calls=1)
    busy_text = "not measured (the profiler saw no device time)" \
        if busy is None else (f"{busy:.1%} of a profiled 50-iteration "
                              f"solve, {launches / 50:.0f} device launches "
                              f"and {dev_ms / 50 * 1e3:.1f} us of device "
                              f"time an iteration")
    print(f"  {n_images} images ({len(images)} frames x 4 cameras); "
          f"{missed} of {views} rendered views not detected; tags detected "
          f"by both cameras of a pair {list(pairs.values())}; pose_t at "
          f"most {pose_err * 1e3:.2f} mm from the rendered centers; "
          f"{ms_image:.3f} ms per detected "
          f"image; solve {RING_ITERATIONS} iterations {solve_s:.3f} s, "
          f"{ms_iter:.4f} ms an iteration (host clock incl. sync), device "
          f"busy {busy_text}; launches {counts}")
    return (dict(cameras=errs, images=n_images, views_missed=missed,
                 views=views, pair_tags=list(pairs.values()),
                 pose_t_max_err_m=pose_err, rig_vs_cpu=rig_diff,
                 ms_per_image=ms_image,
                 ms_per_iteration=ms_iter, solve_s=solve_s,
                 solve_device_busy_share=busy,
                 solve_device_launches_per_iteration=None if busy is None
                 else launches / 50),
            {"extrinsic": counts})


def same_bits(got, want) -> bool:
    """Same shapes, dtypes and bits (float NaNs in unused slots too)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.is_floating_point:
        got, want = got.contiguous().view(torch.int32), \
            want.contiguous().view(torch.int32)
    return torch.equal(got, want)


def check_same_bits(what: str, got, want) -> None:
    check(same_bits(got, want),
          f"{what}: not bit-identical ({tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype})")


def unpack_torch(packed) -> dict:
    """unpack_outputs of a packed tensor, as CPU tensors."""
    import torch
    from ros_vision_tpu_torch.apriltag.detector import unpack_outputs
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in unpack_outputs(packed.cpu().numpy()).items()}


def detector_kw(width: int, height: int) -> dict:
    return dict(width=width, height=height, fx=900.0, fy=900.0,
                cx=width / 2, cy=height / 2, estimate_pose=True)


def tf32_phase(dev, batches: dict) -> tuple:
    """TorchDetector writes none of the TF32 settings, and its packed
    output at B=4 is bit-identical with TF32 allowed everywhere
    (matmul.allow_tf32, cudnn.allow_tf32, float32 matmul precision
    "high") and with TF32 off."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    before = tf32_flags()
    paths = {}
    for (width, height), (frames, must) in batches.items():
        det = TorchDetector(device=dev, **detector_kw(width, height))
        check(tf32_flags() == before,
              f"TorchDetector {width}x{height} changed the TF32 settings "
              f"{before} to {tf32_flags()}")
        g = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        det.detect_raw_packed(g)                          # warm-up
        torch.cuda.synchronize()
        _build.reset_counts()
        out = {}
        for name, flags in (("on", (True, True, "high")),
                            ("off", (False, False, "highest"))):
            with tf32_state(flags):
                out[name] = det.detect_raw_packed(g)
                torch.cuda.synchronize()
        counts = _build.counts()
        check_kernel_set(f"tf32 {width}x{height}", counts, must)
        check_device_launches(f"tf32 {width}x{height}", counts)
        check(tf32_flags() == before, "the TF32 settings were not restored")
        check_same_bits(f"{width}x{height} B=4 packed output, TF32 on vs "
                        "off", out["on"], out["off"])
        for i, dets in enumerate(det.unpack(out["on"])):
            ids = [d.tag_id for d in dets]
            check(ids == BENCH_IDS, f"tf32 {width}x{height} row {i}: {ids}")
        paths[f"tf32 {width}x{height}"] = counts
        print(f"  {width}x{height} B=4: packed output bit-identical with "
              f"TF32 on (True, True, 'high') and off; TorchDetector left "
              f"the settings at {before}")
    return {"settings": list(before), "bit_identical": True}, paths


def tap_detections(taps: dict) -> list:
    """Per row {tag_id: (hamming, corners (4, 2))} of the accepted quads
    of stage_taps, the corners projected from the decode's homography as
    the detector projects them."""
    tcs = np.array([[-1, 1], [1, 1], [1, -1], [-1, -1]], np.float64)
    rows = []
    for b in range(taps["ok"].shape[0]):
        row = {}
        for q in np.nonzero(taps["ok"][b])[0]:
            Hq = taps["H"][b, q].astype(np.float64)
            p = np.c_[tcs, np.ones(4)] @ Hq.T
            row[int(taps["tag_id"][b, q])] = (int(taps["hamming"][b, q]),
                                             p[:, :2] / p[:, 2:])
        rows.append(row)
    return rows


def sync_count(det, g, intr) -> tuple:
    """One detect_raw_packed call's synchronising operations three ways:
    host_syncs' count, the call record's `syncs`, and the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch
    from ros_vision_tpu_torch.utils.tracing import RECORDER
    torch.cuda.synchronize()
    before = det.host_syncs.count
    since = time.time_ns()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            det.detect_raw_packed(g, intr)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    return (det.host_syncs.count - before,
            RECORDER.calls(since)[-1]["syncs"], warned)


def tracing_phase(dev, batches: dict) -> tuple:
    """utils/tracing on the card: stage_taps(check=True) through the
    path's kernels, held against detect_raw on the same frames (ids and
    hamming equal, corners within 0.1 px); the recorder's spans, host ms
    a detect_raw_packed call at B=1 and B=4; one B=4 call's synchronising
    operations, host_syncs' count equal to the call record's and to
    set_sync_debug_mode("warn")'s."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.utils.tracing import (RECORDER, span_ms,
                                                    stage_taps)

    out, paths = {}, {}
    for (width, height), (frames, must) in batches.items():
        det = TorchDetector(device=dev, **detector_kw(width, height))
        stage_taps(det, frames, check=True)               # warm-up
        torch.cuda.synchronize()
        _build.reset_counts()
        taps = stage_taps(det, frames, check=True)
        torch.cuda.synchronize()
        counts = _build.counts()
        what = f"stage taps {width}x{height}"
        check_kernel_set(what, counts, must)
        check_device_launches(what, counts)
        paths[what] = counts
        worst = 0.0
        for i, (tap, dets) in enumerate(zip(tap_detections(taps),
                                            det.detect(frames))):
            check(sorted(tap) == [d.tag_id for d in dets] == BENCH_IDS,
                  f"{what} row {i}: taps {sorted(tap)}, detect "
                  f"{[d.tag_id for d in dets]}")
            for d in dets:
                ham, corners = tap[d.tag_id]
                check(ham == d.hamming, f"{what} row {i} id {d.tag_id}: "
                      f"hamming {ham} vs {d.hamming}")
                worst = max(worst, float(np.abs(corners - d.corners).max()))
        check(worst < 0.1, f"{what}: corners {worst:.4f} px from detect")
        ms = {}
        for b in (1, 4):
            g = torch.as_tensor(frames[:b], device=dev)
            intr = torch.as_tensor(det.default_intrinsics(b), device=dev)
            det.detect_raw_packed(g, intr)
            since = time.time_ns()
            for _ in range(5):
                det.detect_raw_packed(g, intr)
            torch.cuda.synchronize()
            ms[str(b)] = span_ms(RECORDER.calls(since))
        syncs = sync_count(det, g, intr)
        check(syncs[0] == syncs[1] == syncs[2],
              f"{width}x{height} B=4 syncs: host_syncs {syncs[0]}, call "
              f"record {syncs[1]}, sync debug mode {syncs[2]}")
        print(f"  {width}x{height} B=4: taps checked, ids and hamming == "
              f"detect_raw, corners within {worst:.5f} px; launches "
              f"{ {k: v for k, v in counts.items() if v} }; synchronising "
              f"operations a call: {syncs[0]} (host_syncs == call record "
              f"== sync debug mode)")
        for b, times in ms.items():
            print(f"  spans {width}x{height} B={b} (host ms a call, 5 "
                  f"detect_raw_packed calls, {CARD}): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        out[f"{width}x{height}"] = dict(corner_err_px=worst, stage_ms=ms,
                                        syncs=syncs[0])
    return out, paths


def big_tag_frames(width: int, height: int, side: float,
                   noise: float) -> np.ndarray:
    """Four frames whose first holds one tag `side` px wide: a blob-pair
    segment of over ERRS_STABLE_MIN_SZ points, so cluster_and_fit takes
    its stable windowed-error branch; the others are bench frames at noise
    sigma `noise`."""
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)
    big, _ = render_scene([7], [simple_square_corners(
        width / 2, height / 2, side, angle_deg=5)], width, height,
        noise_sigma=0.75, seed=5)
    return np.stack([big] + [bench_scene(seed, width, height, noise)[0]
                             for seed in (1, 2, 3)])


def quadfit_graph_phase(dev, batches: dict) -> dict:
    """ops/quadfit.GraphRunner on the card: cluster_and_fit's eager,
    capturing and replaying calls (a fresh runner each: the first call at
    a key runs eagerly, the second captures, the third replays) against
    the eager stages (_cluster_and_fit), every returned tensor bit for
    bit, on the detector's inputs (K1, then K2 or the flood front end, K3)
    at 1280x800 (32,768 slots) and 1920x1080 (the narrow 32,768 and the
    full 131,072), on the bench batch and on a batch with one segment
    over ERRS_STABLE_MIN_SZ points (the stable branch), with
    use_pallas_sort off and on; a replay's _build launch counts equal to
    the eager call's; one synchronising operation (the branch read) in a
    replaying call under torch.cuda.set_sync_debug_mode("warn"); a
    returned result unchanged after a later call replays the graphs on
    the batch's rows reversed, which give the eager call's rows reversed;
    eager, capture and replay under torch.profiler; host ms a call, eager
    against replayed."""
    import dataclasses
    import warnings

    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import (
        TorchDetector, adaptive_threshold_fused, frontend)
    from ros_vision_tpu_torch.device import HostSyncs
    from ros_vision_tpu_torch.ops import graphs
    from ros_vision_tpu_torch.ops import quadfit as qf

    def inputs(det, frames):
        g = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        decim, th = adaptive_threshold_fused(g)
        pts, counts = frontend(th, det.config.max_points,
                               det._qcfg.max_boundary_pixels)
        return pts, decim, int(counts.max())

    # (batch, frames, the branch it must take or None): the bench batches
    # (sigma 1 at 1280x800, 0.75 at 1920x1080) fill more than the narrow
    # width; the 1280x800 layout's tags at sigma 0.3 or 0.5 make no
    # segment of over ERRS_STABLE_MIN_SZ points, and fit the narrow width
    cases = []
    for (width, height), (bench4, _) in batches.items():
        det = TorchDetector(device=dev, **detector_kw(width, height))
        noise = 0.3 if width == W else 0.5
        small = np.stack([bench_scene(seed, width, height, noise, 1.0)[0]
                          for seed in range(4)])
        sets = [("bench", bench4, None),
                (f"small tags sigma {noise}", small, False),
                ("big tag", big_tag_frames(width, height,
                                           600 if width == W else 900,
                                           noise), True)]
        for batch, frames, stable in sets:
            pts, decim, most = inputs(det, frames)
            ka = det._active_points
            if ka < pts["key"].shape[1] and most <= ka:
                # the detector's narrow width, where every frame fits
                cases.append((f"{width}x{height} {batch} narrow {ka}",
                              {k: v[:, :ka] for k, v in pts.items()},
                              decim, det._qcfg_narrow, stable))
            cases.append((f"{width}x{height} {batch} "
                          f"{pts['key'].shape[1]}", pts, decim, det._qcfg,
                          stable))
    names = [c[0] for c in cases]
    for need in (f"{W}x{H} small tags sigma 0.3 32768",
                 f"{W}x{H} big tag 32768", f"{W2}x{H2} bench 131072",
                 f"{W2}x{H2} small tags sigma 0.5 narrow 32768",
                 f"{W2}x{H2} small tags sigma 0.5 131072",
                 f"{W2}x{H2} big tag narrow 32768",
                 f"{W2}x{H2} big tag 131072"):
        check(need in names, f"no case {need} among {names}")

    def eager(pts, decim, cfg):
        return qf._cluster_and_fit(pts, decim, cfg, HostSyncs())

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, _build.counts(), _build.kernel_counts()

    def same(what, got, want):
        check(set(got) == set(want), f"{what}: keys {sorted(got)}")
        for k in want:
            check_same_bits(f"{what} {k}", got[k], want[k])

    out = {}
    for name, pts, decim, base, branch in cases:
        for pallas in (False, True):
            cfg = dataclasses.replace(base, use_pallas_sort=pallas)
            what = f"{name} use_pallas_sort={pallas}"
            stable = bool(qf.fit_sort(cfg, tuple(decim.shape), pts["key"],
                                      pts["pack2"])["stable"])
            check(branch in (None, stable), f"{what}: stable {stable}")
            want, w_counts, w_kernels = counted(
                lambda: eager(pts, decim, cfg))
            runner = qf.GraphRunner()
            got = []
            for how in qf.GraphRunner.RUNS:
                before = dict(runner.runs)
                res, counts, kernels = counted(lambda: qf.cluster_and_fit(
                    pts, decim, cfg, graphs=runner))
                check(runner.runs[how] == before[how] + 1,
                      f"{what}: call ran {runner.runs}, not {how}")
                same(f"{what} {how}", res, want)
                check(counts == w_counts and kernels == w_kernels,
                      f"{what} {how}: launches {counts} / {kernels}, eager "
                      f"{w_counts} / {w_kernels}")
                got.append(res)
            torch.cuda.synchronize()
            syncs = HostSyncs()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    flipped = qf.cluster_and_fit(
                        {k: v.flip(0) for k, v in pts.items()},
                        decim.flip(0), cfg, syncs, runner)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            warned = sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in caught)
            check(runner.runs["replayed"] == 2 and syncs.count == 1
                  and warned == 1, f"{what}: reversed rows ran "
                  f"{runner.runs}, {syncs.count} syncs counted, {warned} "
                  "warned")
            for res in got:
                same(f"{what} after a later replay", res, want)
            same(f"{what} reversed rows", flipped,
                 {k: v.flip(0) for k, v in want.items()})
            out[what] = dict(stable=stable)
        ms = {}
        for how, runner in (("eager", None), ("replayed", qf.GraphRunner())):
            fn = (lambda: eager(pts, decim, base)) if runner is None else \
                (lambda r=runner: qf.cluster_and_fit(pts, decim, base,
                                                     graphs=r))
            fn()
            fn()
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            ms[how] = statistics.median(times)
        out[name] = dict(host_ms=ms)
        print(f"  {name}: eager, capture, replay and a replay on reversed "
              f"rows bit-identical to the eager stages (use_pallas_sort "
              f"off and on), launches equal, 1 sync a replayed call; host "
              f"ms a call (median of {REPS}, no synchronize inside, "
              f"{CARD}): eager {ms['eager']:.3f}, replayed "
              f"{ms['replayed']:.3f}")
    name, pts, decim, cfg, _ = cases[0]
    runner = qf.GraphRunner()
    want = eager(pts, decim, cfg)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in qf.GraphRunner.RUNS:
            res = qf.cluster_and_fit(pts, decim, cfg, graphs=runner)
        torch.cuda.synchronize()
    same(f"{name} under torch.profiler", res, want)
    check(runner.runs == {"eager": 1, "captured": 1, "replayed": 1},
          f"under torch.profiler: {runner.runs}")
    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type().name == "CUDA")
    held = graphs._graph_launch() is not None and hasattr(
        torch.cuda.CUDAGraph, "raw_cuda_graph_exec")
    check(held, "graphs are not launched with the GIL held")
    print(f"  {name}: eager, capture and replay under torch.profiler "
          f"bit-identical; {kernels} device events profiled; graphs "
          f"launched by cudaGraphLaunch with the GIL held")
    return out


def decode_graph_phase(dev, batches: dict) -> dict:
    """ops/decode.GraphRunner on the card: decode_quads' eager, capturing
    and replaying calls (a fresh runner each: the first call at a key runs
    eagerly, the second captures, the third replays) against the eager
    body (decode._decode_quads), every returned tensor bit for bit, on the
    detector's unrefined corners (its cluster_and_fit slots, largest area
    first) at 1280x800 B=1 and B=4 and 1920x1080 B=4, in the first 8, 32
    and 128 slots; no synchronising operation in a replaying call under
    torch.cuda.set_sync_debug_mode("warn"); a returned result unchanged
    after a later call replays the graph on the batch's rows reversed,
    which give the eager body's rows reversed; a warm detect_raw_packed
    call's synchronising operations, 4, as host_syncs counts them and as
    the sync debug mode warns of them; host ms a call, eager against
    replayed."""
    import warnings

    import torch
    from ros_vision_tpu_torch.apriltag.detector import (
        TorchDetector, adaptive_threshold_fused, frontend)
    from ros_vision_tpu_torch.device import HostSyncs
    from ros_vision_tpu_torch.ops import decode as dec
    from ros_vision_tpu_torch.ops import quadfit as qf

    def same(what, got, want):
        check(set(got) == set(want), f"{what}: keys {sorted(got)}")
        for k in want:
            check_same_bits(f"{what} {k}", got[k], want[k])

    out = {}
    for (width, height), (bench4, _) in batches.items():
        det = TorchDetector(device=dev, **detector_kw(width, height))
        fam, cm = det.family, det._code_matrix
        tabs = dec.decode_tables(fam, dev, HostSyncs())
        for b in ((1, 4) if width == W else (4,)):
            g = torch.from_numpy(np.ascontiguousarray(bench4[:b])).to(dev)
            decim, th = adaptive_threshold_fused(g)
            pts, _ = frontend(th, det.config.max_points,
                              det._qcfg.max_boundary_pixels)
            quads = qf.cluster_and_fit(pts, decim, det._qcfg)
            corners = dec.adjust_pixel_centers(quads["corners"])
            for nq in (8, 32, 128):
                what = f"{width}x{height} B={b} NQ={nq}"
                c = corners[:, :nq].contiguous()
                v = quads["quad_valid"][:, :nq].contiguous()

                def eager(g=g, c=c, v=v):
                    return dec._decode_quads(fam, tabs, cm, g, c, v)
                want = eager()
                check(bool(want["ok"].any()), f"{what}: no tag decoded")
                runner = dec.GraphRunner()

                def graphed(g=g, c=c, v=v, runner=runner):
                    return dec.decode_quads(g, c, v, fam, cm,
                                            graphs=runner)
                got = []
                for how in dec.GraphRunner.RUNS:
                    before = dict(runner.runs)
                    res = graphed()
                    check(runner.runs[how] == before[how] + 1,
                          f"{what}: call ran {runner.runs}, not {how}")
                    same(f"{what} {how}", res, want)
                    got.append(res)
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        flipped = dec.decode_quads(
                            g.flip(0), c.flip(0), v.flip(0), fam, cm,
                            graphs=runner)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                warned = sum("called a synchronizing CUDA operation"
                             in str(w.message) for w in caught)
                check(runner.runs["replayed"] == 2 and warned == 0,
                      f"{what}: reversed rows ran {runner.runs}, "
                      f"{warned} syncs warned")
                for res in got:
                    same(f"{what} after a later replay", res, want)
                same(f"{what} reversed rows", flipped,
                     {k: t.flip(0) for k, t in want.items()})
                ms = {}
                for how, fn in (("eager", eager), ("replayed", graphed)):
                    fn()
                    times = []
                    for _ in range(REPS):
                        t0 = time.perf_counter()
                        fn()
                        times.append((time.perf_counter() - t0) * 1e3)
                        torch.cuda.synchronize()
                    ms[how] = statistics.median(times)
                out[what] = dict(host_ms=ms)
                print(f"  {what}: eager, capture, replay and a replay on "
                      f"reversed rows bit-identical to the eager body, 0 "
                      f"syncs a replayed call; host ms a call (median of "
                      f"{REPS}, no synchronize inside, {CARD}): eager "
                      f"{ms['eager']:.3f}, replayed {ms['replayed']:.3f}")
        g4 = torch.as_tensor(bench4, device=dev)
        intr = torch.as_tensor(det.default_intrinsics(4), device=dev)
        for _ in range(3):
            det.detect_raw_packed(g4, intr)
        syncs = sync_count(det, g4, intr)
        check(syncs[0] == syncs[1] == syncs[2] == 4,
              f"{width}x{height} B=4 warm call syncs: host_syncs "
              f"{syncs[0]}, call record {syncs[1]}, sync debug mode "
              f"{syncs[2]}, not 4")
        check(det._decode_graphs.runs["replayed"] >= 2,
              f"{width}x{height}: detector decodes ran "
              f"{det._decode_graphs.runs}")
        print(f"  {width}x{height} B=4 warm detect_raw_packed: "
              f"{syncs[0]} synchronising operations (host_syncs == call "
              f"record == sync debug mode); decode runs "
              f"{det._decode_graphs.runs}")
        out[f"{width}x{height} warm syncs"] = syncs[0]
    return out


def mesh_phase(dev, bench4) -> tuple:
    """parallel/mesh.py: a two-way mesh [dev, dev], installed by
    TorchDetector.use_mesh as VisionSystem installs it, over the bench B=4
    batch: detect_raw and detect_raw_packed bit-identical to the unsharded
    B=4 call and to per-row B=1 calls."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import (TorchDetector,
                                                        pack_outputs)
    from ros_vision_tpu_torch.parallel import mesh as pm

    det = TorchDetector(device=dev, **detector_kw(W, H))
    g = torch.from_numpy(np.ascontiguousarray(bench4)).to(dev)
    intr = torch.as_tensor(det.default_intrinsics(4), device=dev)
    mdet = TorchDetector(device=dev, **detector_kw(W, H))
    mdet.use_mesh(pm.make_camera_mesh(devices=[dev, dev]))
    mdet.detect_raw(g, intr)                              # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    got = mdet.detect_raw(g, intr)
    got_packed = mdet.detect_raw_packed(g, intr)
    torch.cuda.synchronize()
    counts = _build.counts()
    check_kernel_set("mesh", counts, PATH_800)
    check_device_launches("mesh", counts)
    whole = det._detect_device(g, intr)
    rows = [det._detect_device(g[i:i + 1], intr[i:i + 1]) for i in range(4)]
    per_row = {k: torch.cat([r[k] for r in rows]) for k in whole}
    check(set(got) == set(whole), f"mesh keys {sorted(got)}")
    # Each call picks its tail tier from its batch's worst row, and a
    # rejected slot holds what that tier left there (decode junk or
    # padding), as in the JAX package; so the detections are compared: the
    # ok mask in every slot, every output in the accepted ones.
    full = {}
    for ref_name, ref in (("unsharded B=4", whole), ("per-row B=1", per_row),
                          ("unsharded B=4 packed",
                           unpack_torch(pack_outputs(whole))),
                          ("per-row B=1 packed",
                           unpack_torch(pack_outputs(per_row)))):
        mine = unpack_torch(got_packed) if "packed" in ref_name else got
        ok = ref["ok"]
        check_same_bits(f"mesh ok vs {ref_name}", mine["ok"], ok)
        for k in ref:
            check_same_bits(f"mesh {k} vs {ref_name} (accepted slots)",
                            mine[k][ok.to(mine[k].device)],
                            ref[k][ok.to(ref[k].device)])
        full[ref_name] = all(same_bits(mine[k], ref[k]) for k in ref)
    for i, dets in enumerate(det.unpack(got_packed)):
        check([d.tag_id for d in dets] == BENCH_IDS, f"mesh row {i}")
    times = {"mesh": [], "unsharded": []}
    for _ in range(5):
        for name, fn in (("mesh", lambda: mdet.detect_raw_packed(g, intr)),
                         ("unsharded", lambda: det.detect_raw_packed(g))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"  [{dev}, {dev}] over 1280x800 B=4: dict and packed "
          f"detections bit-identical to the unsharded B=4 call and to "
          f"per-row B=1 calls (ok mask in every slot, every output in the "
          f"accepted ones); whole tensors identical too: {full}")
    print(f"  ms a call (medians of 5, in turns, host clock incl. "
          f"sync, {CARD}): mesh {ms['mesh']:.3f}, unsharded "
          f"{ms['unsharded']:.3f}")
    return dict(ms_per_call=ms, whole_tensors_identical=full), \
        {"mesh": counts}


SOAK_SEEDS = {"parity": 100, "hard": 50, "gate": 4}


def soak_phase(dev) -> tuple:
    """tools/soak.py's three profiles on the card against the f64 oracle:
    parity on 100 seeds, hard on 50 with --audit-misses, gate on 4; no
    mismatch, no miss the oracle does not share."""
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.tools import soak

    torch.cuda.synchronize()
    _build.reset_counts()
    res = {"parity": soak.run_parity(range(SOAK_SEEDS["parity"]), dev),
           "hard": soak.run_hard(range(SOAK_SEEDS["hard"]), dev,
                                 audit_misses=True),
           "gate": soak.run_gate(range(SOAK_SEEDS["gate"]), dev)}
    torch.cuda.synchronize()
    counts = _build.counts()
    # 320x160 and 640x400 frames take the flood front end
    check_kernel_set("soak", counts, PATH_1080)
    check_device_launches("soak", counts)
    for name, r in res.items():
        check(r["ok"], f"soak {name}: {r}")
    p, h, gt = res["parity"], res["hard"], res["gate"]
    print(f"  parity: {p['seeds']} seeds, {len(p['failures'])} failures, "
          f"{p['junk_extras']} junk-margin extras, {p['tie_divergences']} "
          f"peak-tie divergences, {p['seconds']:.1f} s")
    print(f"  hard (--audit-misses): {h['seeds']} seeds, {h['scored']} in "
          f"frame, {len(h['failures'])} failures, {h['missed']} "
          f"non-detections, all {h['oracle_missed']} missed by the oracle "
          f"too, {h['seconds']:.1f} s")
    print(f"  gate: {gt['seeds']} seeds, {gt['cases']} decode pairs, "
          f"losses {gt['losses']}, {gt['seconds']:.1f} s")
    summary = {k: {kk: vv for kk, vv in r.items() if kk != "failures"}
               for k, r in res.items()}
    return summary, {"soak": counts}


BENCH_ENV = {"BENCH_ITERS": "5", "BENCH_STREAM_S": "4",
             "BENCH_STREAM_TIMEOUT_S": "180", "BENCH_TOTAL_TIMEOUT_S": "400"}


def bench_phase() -> dict:
    """python -m ros_vision_tpu_torch.bench in a subprocess with
    BENCH_ENV's cuts: its last line parsed, tags_ok true, every key of
    bench.py's record present and filled (the golden photo's null, and
    marked skipped, when the photo is absent)."""
    import os
    from ros_vision_tpu_torch import bench

    r = subprocess.run([sys.executable, "-m", "ros_vision_tpu_torch.bench"],
                       cwd=ROOT, env={**os.environ, **BENCH_ENV},
                       capture_output=True, text=True, timeout=450)
    check(r.returncode == 0, f"bench exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    missing = [k for k in bench.KEYS if k not in rec]
    check(not missing, f"bench record lacks {missing}")
    golden = ("golden_1080p_ms_per_frame", "golden_1080p_tags_ok")
    empty = [k for k in bench.KEYS if rec[k] is None
             and not (k in golden and rec["golden_1080p_skipped"])]
    check(not empty, f"bench record has no value for {empty}")
    check(rec["tags_ok"] is True, "bench: tags_ok is not true")
    check(rec["backend"] == "torch-cuda" and "bench_error" not in rec,
          f"bench: {rec.get('backend')}, {rec.get('bench_error')}")
    print(f"  {rec['value']} fps at B={rec['best_batch']} "
          f"({rec['best_batch_call_ms']} ms a call), vs_baseline "
          f"{rec['vs_baseline']}, p50_latency_ms {rec['p50_latency_ms']}, "
          f"b1_sync_roundtrip_ms {rec['b1_sync_roundtrip_ms']}, tags_ok "
          f"{rec['tags_ok']}; card {rec['device']}")
    print(f"  sweep: {rec['sweep']}")
    print(f"  streaming: {rec['streaming_fps_per_camera']} fps a camera, "
          f"e2e p50 {rec['e2e_p50_ms']} ms, p95 {rec['e2e_p95_ms']} ms; "
          f"phases {rec['streaming_phases']}")
    print(f"  stage_ms: {rec['stage_ms']}")
    print(f"  golden 1080p: {rec['golden_1080p_skipped'] or 'run'}; "
          f"BENCH_* = {BENCH_ENV}")
    return rec


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
    global CARD
    CARD = smi

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
    print(f"[rectify {W}x{H} B=4]")
    rectified, rect_paths = rectify_phase(dev, bench4, bench[0][1])
    paths.update(rect_paths)
    print(f"[calibrated detector {W}x{H}]")
    calibrated, cal_paths = calibrated_detector_phase(dev, bench[0][1])
    paths.update(cal_paths)
    print(f"[game piece YOLOv11n {GP_SIZE} bf16]")
    game_piece, gp_paths = game_piece_phase(dev)
    paths.update(gp_paths)
    print(f"[train YOLOv11n {GP_SIZE} f32 B={TRAIN_B}]")
    trained, train_paths = train_phase(dev)
    paths.update(train_paths)
    print(f"[extrinsic calibration: 4 cameras {W}x{H}]")
    extrinsic, ex_paths = extrinsic_phase(dev)
    paths.update(ex_paths)
    sizes = {(W, H): (bench4, PATH_800), (W2, H2): (bench4_1080, PATH_1080)}
    added = {}
    for name, run in (
            ("tf32", lambda: tf32_phase(dev, sizes)),
            ("tracing", lambda: tracing_phase(dev, sizes)),
            ("quadfit_graph", lambda: (quadfit_graph_phase(dev, sizes), {})),
            ("decode_graph", lambda: (decode_graph_phase(dev, sizes), {})),
            ("mesh", lambda: mesh_phase(dev, bench4)),
            ("soak", lambda: soak_phase(dev)),
            ("bench", lambda: (bench_phase(), {}))):
        print(f"[{name}]")
        t0 = time.monotonic()
        added[name], new_paths = run()
        paths.update(new_paths)
        print(f"  [{name}] {time.monotonic() - t0:.1f} s on {CARD}")
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths.values())
    print(json.dumps({"detector": {str(b): v for b, v in det.items()},
                      "detector_1080": {str(b): v
                                        for b, v in det_1080.items()},
                      "use_pallas_sort_b4_ms_per_call": sorted_ms,
                      "system": system, "rectify": rectified,
                      "calibrated_detector": {
                          str(b): v for b, v in calibrated.items()},
                      "game_piece": game_piece, "train": trained,
                      "extrinsic": extrinsic, **added}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
