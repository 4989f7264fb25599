"""Judge "tags": how `correct` is decided for an AprilTag configuration,
what the timed window produced against the plain reference
(benchmark/reference: the frozen f64 NumPy oracle and its geometry), run
once the window has closed.

The reference detects each distinct frame of the run's pool once, in
worker processes. Every answer the window produced is then compared with
it, and its poses with the reference's pose solve run on the answer's own
corners (the reference reads the program's output only to judge it, as it
would re-score a served model's tokens), so that a pose is judged apart
from the corners it came from. The numbers, each against the cell's limit
in benchmark/workloads/<cell>.json (a number without a limit there is
reported and not compared):

    extra_ids           tags an answer reports that the reference does
                        not find in that frame (exact: limit 0)
    empty_answers       answers with no tag for a frame where the
                        reference finds one (exact: limit 0)
    hamming_mismatch    tags, matched by id, whose hamming differs (exact)
    corner_px           the widest gap of a matched tag's corners, px
    pose_t_m            the widest gap of an answer's translation from
                        the reference's pose of the answer's corners, m
    pose_R              the same for an entry of its rotation
    pose_px             the widest gap, in px, between the tag's corners
                        projected through the answer's pose and through
                        that reference pose: the depth of a far tag is
                        ill-conditioned in float32, its image is not
    robot_m             (served answers) the widest gap of a tag's
                        robot-frame position as the consumer received it
                        from the reference's pose of the published corners
                        through the configuration's extrinsics, m
    missed_tags         tags the reference finds that an answer lacks

A tag that the reference finds and that the scene never placed (a noise
quad that decodes at the edge of the code's reach, as a seed now and then
draws) is not due from the program: it counts in neither missed_tags nor
empty_answers. An answer that reports such a tag is still judged against
the reference, as any other.

The control (benchmark/reference/control.py) is the same reference with
its stage outputs rounded to bfloat16, the precision below the float32
the configurations state.
"""
from __future__ import annotations

import dataclasses
import gc
import multiprocessing
import os
from multiprocessing import resource_tracker

import numpy as np

NUMBERS = ("extra_ids", "empty_answers", "hamming_mismatch", "corner_px",
           "pose_t_m", "pose_R", "pose_px", "robot_m", "missed_tags")


@dataclasses.dataclass
class Answer:
    frame: int                  # index in the pool
    dets: list                  # (id, hamming, corners (4,2), R, t)
    robot: list | None = None   # (id, x, y, z) as the consumer got them
    camera: int | None = None   # the configuration's camera (extrinsics)


def as_tuples(dets) -> list:
    """The port's Detection objects as (id, hamming, corners, R, t)."""
    return [(d.tag_id, d.hamming, np.asarray(d.corners, float),
             None if d.pose_R is None else np.asarray(d.pose_R, float),
             None if d.pose_t is None else np.asarray(d.pose_t, float))
            for d in dets]


def detect_frame(job):
    """One frame through the reference (run in a worker process)."""
    frame, cfg, control = job
    from benchmark.reference.oracle import OracleDetector
    det = OracleDetector(cfg["family"], tag_size=cfg["tag_size"],
                         fx=cfg["fx"], fy=cfg["fy"], cx=cfg["cx"],
                         cy=cfg["cy"], dist=np.asarray(cfg["dist"], float),
                         estimate_pose=True, keep_taps=False)
    if control:
        from benchmark.reference.control import bf16_stages
        with bf16_stages():
            res = det.detect(frame)
    else:
        res = det.detect(frame)
    return [(d.tag_id, d.hamming, np.asarray(d.corners, float),
             np.asarray(d.pose_R, float), np.asarray(d.pose_t, float))
            for d in res.detections]


def reference(pool, cfg: dict, control: bool = False,
              workers: int | None = None) -> list:
    """The reference's detections of each frame of the pool, one worker
    process a frame (at most the cores there are), single-threaded each.
    control: the reference with its stages held in bfloat16."""
    frames = pool.frames
    workers = min(len(frames), workers or os.cpu_count() or 1)
    jobs = [(f, cfg, control) for f in frames]
    if workers <= 1:
        return [detect_frame(j) for j in jobs]
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                           "OPENBLAS_NUM_THREADS",
                                           "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            out = pool.map(detect_frame, jobs)
            pool.close()
            pool.join()
        del pool
        gc.collect()        # the pool's semaphores, while the tracker runs
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the pool started a resource-tracker process as well: stop it and wait
    # for it, so that the run leaves no process behind
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if hasattr(tracker, "_stop"):
        tracker._stop()
    return out


class PoseOfCorners:
    """The reference's pose solve (geometry.estimate_tag_pose, f64) of a
    set of corners, undistorted first where the configuration has a lens,
    as the oracle does; memoised on the corners' bytes."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.intr = (cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"])
        self.dist = np.asarray(cfg["dist"], float)
        self.memo = {}

    def project(self, R, t) -> np.ndarray:
        """The tag's four corners through pose (R, t), in px."""
        from benchmark.reference import geometry
        cam = geometry.pose_object_points(self.cfg["tag_size"]) \
            @ np.asarray(R, float).T + np.asarray(t, float)
        xy = cam[:, :2] / cam[:, 2:3]
        fx, fy, cx, cy = self.intr
        px = np.stack([xy[:, 0] * fx + cx, xy[:, 1] * fy + cy], -1)
        if np.any(self.dist):
            px = geometry.distort_points(px, *self.intr, self.dist)
        return px

    def __call__(self, corners):
        from benchmark.reference import geometry
        c = np.ascontiguousarray(corners, float)
        key = c.tobytes()
        if key not in self.memo:
            if np.any(self.dist):
                c = geometry.undistort_points(c, *self.intr, self.dist)
            R, t, _ = geometry.estimate_tag_pose(c, self.cfg["tag_size"],
                                                 *self.intr)
            self.memo[key] = (R, t)
        return self.memo[key]


def _robot(cfg: dict, camera: int, t: np.ndarray) -> np.ndarray:
    cam = cfg["cameras"][camera]
    return np.asarray(cam["rotation"], float) @ t + \
        np.asarray(cam["offset"], float)


def read_answer(a: Answer, ref: list, cfg: dict, pose_of,
                placed=None) -> dict:
    """Every number for one answer against the reference's detections of
    its frame. placed: the ids the scene put in the frame (None: every tag
    the reference finds is due)."""
    ref = {r[0]: r for r in ref}
    due = set(ref) if placed is None else set(ref) & set(placed)
    got = {}
    read = dict.fromkeys(NUMBERS, 0.0)
    for d in a.dets:
        if d[0] in got or d[0] not in ref:
            read["extra_ids"] += 1      # a duplicate or an unknown id
        got[d[0]] = d
    read["missed_tags"] = float(len(due - set(got)))
    if due and not a.dets:
        read["empty_answers"] = 1.0
    by_corners = {}
    for tid, g in got.items():
        if g[4] is not None:
            R, t = pose_of(g[2])
            by_corners[tid] = t
            read["pose_t_m"] = max(read["pose_t_m"], float(
                np.linalg.norm(np.asarray(g[4]) - t)))
            read["pose_R"] = max(read["pose_R"], float(np.max(np.abs(
                np.asarray(g[3]) - R))))
            read["pose_px"] = max(read["pose_px"], float(np.max(
                np.linalg.norm(pose_of.project(g[3], g[4])
                               - pose_of.project(R, t), axis=-1))))
        if tid not in ref:
            continue
        if g[1] != ref[tid][1]:
            read["hamming_mismatch"] += 1
        read["corner_px"] = max(read["corner_px"], float(np.max(
            np.linalg.norm(np.asarray(g[2]) - ref[tid][2], axis=-1))))
    if a.robot is not None:
        sent = [x[0] for x in a.robot]
        if sorted(sent) != sorted(got):
            read["extra_ids"] += len(set(sent) ^ set(got)) or 1
        for tid, *xyz in a.robot:
            if tid in by_corners:
                read["robot_m"] = max(read["robot_m"], float(
                    np.linalg.norm(np.asarray(xyz) - _robot(
                        cfg, a.camera, by_corners[tid]))))
    return read


def compare(answers, refs: list, cfg: dict, limits: dict,
            placed=None) -> tuple:
    """(the widest reading of each number over all answers, the answers
    with a number over its limit). placed: for each frame of the pool the
    ids its scene placed, or None."""
    pose_of = PoseOfCorners(cfg)
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = 0
    for a in answers:
        read = read_answer(a, refs[a.frame], cfg, pose_of,
                           None if placed is None else placed[a.frame])
        if any(read[k] > v for k, v in limits.items()):
            failed += 1
        for k in NUMBERS:
            worst[k] = max(worst[k], read[k])
    return worst, failed


def _placed(pool):
    """For each frame of the pool the ids its scene placed, or None where
    the pool carries no truth."""
    if getattr(pool, "truth", None) is None:
        return None
    return [{t.tag_id for t in f} for f in pool.truth]


def judge(answers, refs: list, pool, cfg: dict, limits: dict) -> tuple:
    """(the widest reading of each number, the answers with a number over
    its limit, notes for the run: the tags the reference finds that the
    scene never placed, [frame, id, hamming] each)."""
    placed = _placed(pool)
    notes = {}
    if placed is not None:
        notes["reference_unplaced"] = [
            [i, r[0], r[1]] for i, found in enumerate(refs) for r in found
            if r[0] not in placed[i]]
    worst, failed = compare(answers, refs, cfg, limits, placed)
    return worst, failed, notes


def control_readings(pool, cfg: dict, limits: dict) -> tuple:
    """The control in the program's place, judged as the program is: one
    answer a distinct frame, its robot-frame positions through camera
    i % cameras where the limits hold robot_m. Returns (the widest
    reading of each number, the answers over a limit, the answers)."""
    refs = reference(pool, cfg)
    ctrl = reference(pool, cfg, control=True)
    robot = "robot_m" in limits
    answers = []
    for i, dets in enumerate(ctrl):
        cam = i % len(cfg.get("cameras", [0])) if robot else None
        answers.append(Answer(
            i, dets, [(d[0], *_robot(cfg, cam, d[4]))
                      for d in dets] if robot else None, cam))
    worst, failed = compare(answers, refs, cfg, limits, _placed(pool))
    return worst, failed, len(answers)
