"""Judge "gamepiece": how `correct` is decided for a YOLO11 game-piece
configuration, what the timed window produced against the plain float32
reference (benchmark/reference/yolo11.py: the Ultralytics module tree,
its preprocessing and a plain greedy NMS), run once the window has closed
on each distinct frame of the pool, with the pool's own weights.

An answer is one camera's detections of one call, in slot order
(confidence descending), each (x, y, w, h, conf, cls) with the box in the
frame's pixels; the driver also hands over, for some calls, that row of
the raw head output the program's NMS read. Detections differ from the
reference's by the program's precision (bfloat16 convolutions): a
detection whose score lies near the 0.25 threshold, or whose overlap with
a rival of its class lies near 0.45, or whose place in the order lies near
the 100-candidate cut, may be kept on one side and not on the other.
Those are not due. A reference detection is clear when none of that can
happen within the limits on `raw_score_abs` (s) and `raw_box_px` (b),
which bound how far the program's precision moves any anchor's score and
box: its score is over 0.25 + s; fewer than 100 other anchors score within 2 s of it or
above; and every anchor of its class scoring within 2 s of it or above
overlaps it by IoU <= 0.45 whatever moves of up to b px each box's
centre and size make. The numbers, each against the cell's limit in
benchmark/workloads/<cell>.json (a number without a limit there is
reported and not compared):

    box_px          the widest gap, px of the frame, of a clear reference
                    detection's box (centre, size) from the answer's
                    detection matched to it: its class, IoU >= 0.5, the
                    nearest box
    score_abs       the widest gap of the matched pair's scores
    missed_clear    clear reference detections with no match in the
                    answer (exact: limit 0)
    extra_clear     answer detections the reference clearly does not
                    keep: no anchor of its class lies within b px and s
                    of it, or each that does ranks clearly past the 100th
                    or is clearly suppressed by a clear reference
                    detection (IoU > 0.45 under any such moves; exact)
    empty_answers   answers with no detection where the reference's best
                    score is over 0.25 + s (exact)
    raw_box_px      (calls with the raw output) the widest gap of any
                    anchor's box from the reference's, px of the frame
    raw_score_abs   the same for any anchor's class score
    nms_mismatch    (calls with the raw output) answers that differ, slot
                    for slot and bit for bit, from the plain NMS run on
                    the program's own raw output and scaled as the
                    program scales (exact)

A kept detection's box and score are its anchor's, so where it matches
the right anchor box_px and score_abs read at most raw_box_px and
raw_score_abs. The seeded weights give few clear detections and the
control none, so the game-piece cell sets no limit on box_px and
score_abs: every answer is checked by extra_clear (and missed_clear,
empty_answers), the calls with the raw output besides by the raw numbers
and nms_mismatch.

The control (reference(control=True)) is the reference with each
convolution's input and weights rounded through float8_e4m3fn, one
precision below the bfloat16 the configuration's convolutions use.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

NUMBERS = ("box_px", "score_abs", "missed_clear", "extra_clear",
           "empty_answers", "raw_box_px", "raw_score_abs", "nms_mismatch")
MATCH_IOU = 0.5


@dataclasses.dataclass
class Answer:
    frame: int                          # index in the pool
    dets: list                          # (x, y, w, h, conf, cls) each
    raw: np.ndarray | None = None       # (4 + nc, A) f32: the call's row


def as_tuples(dets) -> list:
    """The port's GamePieceDetection objects as (x, y, w, h, conf, cls)."""
    return [(d.x, d.y, d.w, d.h, d.conf, d.cls) for d in dets]


def _scales(cfg: dict):
    return (np.float32(cfg["width"] / cfg["img_size"]),
            np.float32(cfg["height"] / cfg["img_size"]))


def frame_boxes(raw: np.ndarray, cfg: dict) -> np.ndarray:
    """(A, 4) cx, cy, w, h in the frame's pixels, each column scaled in
    float32 by the frame over the model input, as the program scales."""
    sx, sy = _scales(cfg)
    b = np.array(raw[:4].T, np.float32)
    return b * np.array([sx, sy, sx, sy], np.float32)


def plain_nms(raw: np.ndarray, cfg: dict) -> list:
    """The reference's NMS on one row of raw output (4 + nc, A): the kept
    detections in slot order, (x, y, w, h, conf, cls) in the frame's
    pixels."""
    import torch
    from benchmark.reference import yolo11
    row = yolo11.nms(torch.from_numpy(np.array(raw, np.float32)[None]),
                     cfg["max_detections"], cfg["conf_threshold"],
                     cfg["iou_threshold"])[0]
    sx, sy = _scales(cfg)
    b = row["boxes"].numpy()[row["kept"].numpy()]
    b = b * np.array([sx, sy, sx, sy], np.float32)
    return [(float(x), float(y), float(w), float(h), float(s), int(c))
            for (x, y, w, h), s, c in zip(
                b.tolist(), row["scores"][row["kept"]].tolist(),
                row["classes"][row["kept"]].tolist())]


def _iou_bounds(a: np.ndarray, b: np.ndarray, d: float):
    """Lower and upper IoU of box a (4,) with boxes b (n, 4) (cx, cy, w, h)
    when each centre and size may move by up to d: each edge moves by up
    to 1.5 d, an intersection's side by up to 3 d."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    iw = np.minimum(a[0] + a[2] / 2, b[:, 0] + b[:, 2] / 2) - \
        np.maximum(a[0] - a[2] / 2, b[:, 0] - b[:, 2] / 2)
    ih = np.minimum(a[1] + a[3] / 2, b[:, 1] + b[:, 3] / 2) - \
        np.maximum(a[1] - a[3] / 2, b[:, 1] - b[:, 3] / 2)
    inter_lo = np.clip(iw - 3 * d, 0, None) * np.clip(ih - 3 * d, 0, None)
    inter_hi = np.clip(iw + 3 * d, 0, None) * np.clip(ih + 3 * d, 0, None)
    a_lo = max(a[2] - d, 0) * max(a[3] - d, 0)
    b_lo = np.clip(b[:, 2] - d, 0, None) * np.clip(b[:, 3] - d, 0, None)
    area_hi = (a[2] + d) * (a[3] + d) + (b[:, 2] + d) * (b[:, 3] + d)
    # a union is no smaller than either box
    union_lo = np.maximum(a_lo + b_lo - inter_hi, np.maximum(a_lo, b_lo))
    union_hi = area_hi - inter_lo
    lo = np.where(union_hi > 0, inter_lo / np.where(union_hi > 0, union_hi,
                                                   1), 0.0)
    hi = np.where(union_lo > 0, np.minimum(
        1.0, inter_hi / np.where(union_lo > 0, union_lo, 1)), 1.0)
    return lo, hi


def _iou(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(_iou_bounds(a, b[None], 0.0)[0][0])


class FrameRef:
    """The reference on one frame: its raw output, every anchor's box in
    the frame's pixels, score (0 under the threshold) and class, the kept
    detections and which of them are clear (see the module's docstring)."""

    def __init__(self, raw: np.ndarray, cfg: dict, limits: dict):
        self.raw = np.array(raw, np.float32)
        self.cfg = cfg
        self.tau_s = float(limits.get("raw_score_abs", 0.0))
        self.tau_b = float(limits.get("raw_box_px", 0.0))
        self.boxes = frame_boxes(self.raw, cfg)
        scores = self.raw[4:]
        self.classes = scores.argmax(0)
        s = scores.max(0)
        self.scores = np.where(s >= np.float32(cfg["conf_threshold"]), s,
                               np.float32(0.0))
        self.kept = plain_nms(self.raw, cfg)
        self.kept_anchor = [self._anchor(d) for d in self.kept]
        self.clear = [self._is_clear(a) for a in self.kept_anchor]

    def _anchor(self, det) -> int:
        hit = np.nonzero((self.boxes == np.float32(det[:4])).all(1)
                         & (self.scores == np.float32(det[4])))[0]
        return int(hit[0])

    def _is_clear(self, a: int) -> bool:
        conf, iou_thr = self.cfg["conf_threshold"], self.cfg["iou_threshold"]
        s, t = float(self.scores[a]), self.tau_s
        if s - conf <= t:
            return False
        near = self.scores >= s - 2 * t
        near[a] = False
        if int(near.sum()) >= self.cfg["max_detections"]:
            return False
        rivals = np.nonzero(near & (self.classes == self.classes[a]))[0]
        if not len(rivals):
            return True
        _, hi = _iou_bounds(self.boxes[a], self.boxes[rivals], self.tau_b)
        return bool((hi <= iou_thr).all())

    def _plausible(self, det) -> bool:
        """Whether the reference could keep a detection within the limits
        of `det` (see extra_clear)."""
        t, b = self.tau_s, self.tau_b
        box = np.asarray(det[:4], np.float64)
        near = (self.classes == det[5]) \
            & (np.abs(self.boxes - box).max(1) <= b) \
            & (np.abs(self.scores - det[4]) <= t) & (self.scores > 0)
        clear = [(a, d) for a, d, c in zip(self.kept_anchor, self.kept,
                                           self.clear) if c]
        for r in np.nonzero(near)[0]:
            s = float(self.scores[r])
            if int((self.scores > s + 2 * t).sum()) >= \
                    self.cfg["max_detections"]:
                continue
            suppressed = False
            for a, d in clear:
                if a != r and d[5] == det[5] and d[4] > s + 2 * t:
                    lo, _ = _iou_bounds(self.boxes[a], self.boxes[r][None],
                                        b)
                    if lo[0] > self.cfg["iou_threshold"]:
                        suppressed = True
                        break
            if not suppressed:
                return True
        return False

    def read(self, a: Answer) -> dict:
        read = dict.fromkeys(NUMBERS, 0.0)
        dets = a.dets
        for d, clear in zip(self.kept, self.clear):
            if not clear:
                continue
            pairs = [p for p in dets if p[5] == d[5]
                     and _iou(p[:4], d[:4]) >= MATCH_IOU]
            if not pairs:
                read["missed_clear"] += 1
                continue
            p = min(pairs, key=lambda p: np.abs(np.subtract(p[:4], d[:4]))
                    .max())
            read["box_px"] = max(read["box_px"], float(np.abs(
                np.subtract(p[:4], d[:4])).max()))
            read["score_abs"] = max(read["score_abs"], abs(p[4] - d[4]))
        read["extra_clear"] = float(sum(not self._plausible(p)
                                        for p in dets))
        if not dets and float(self.scores.max()) > \
                self.cfg["conf_threshold"] + self.tau_s:
            read["empty_answers"] = 1.0
        if a.raw is not None:
            raw = np.asarray(a.raw, np.float32)
            read["raw_box_px"] = float(np.abs(frame_boxes(raw, self.cfg)
                                              - self.boxes).max())
            read["raw_score_abs"] = float(np.abs(raw[4:]
                                                 - self.raw[4:]).max())
            read["nms_mismatch"] = float(plain_nms(raw, self.cfg)
                                         != list(map(tuple, dets)))
        return read


def reference(pool, cfg: dict, control: bool = False,
              workers: int | None = None) -> list:
    """The reference's raw output (4 + nc, A) of each frame of the pool, in
    float32 (control: with the float8 convolutions). `workers` is not used:
    one process runs every frame on torch's threads."""
    from benchmark.reference import yolo11
    model = yolo11.model_from(pool.state_dict, cfg["num_classes"],
                              cfg["scale"])
    with yolo11.control(model) if control else contextlib.nullcontext():
        return [yolo11.detect_raw(model, f, cfg["img_size"])[0].numpy()
                for f in pool.frames]


def compare(answers, frame_refs: list) -> tuple:
    """(the widest reading of each number over all answers, the readings
    of each answer), memoised on what an answer holds."""
    memo, reads = {}, []
    for a in answers:
        key = (a.frame, tuple(map(tuple, a.dets)),
               None if a.raw is None else id(a.raw))
        if key not in memo:
            memo[key] = frame_refs[a.frame].read(a)
        reads.append(memo[key])
    worst = {k: max([r[k] for r in reads], default=0.0) for k in NUMBERS}
    return worst, reads


def judge(answers, refs: list, pool, cfg: dict, limits: dict) -> tuple:
    """(the widest reading of each number, the answers with a number over
    its limit, notes for the run: each frame's kept and clear reference
    detections, and the answers that carried the raw output)."""
    frame_refs = [FrameRef(r, cfg, limits) for r in refs]
    worst, reads = compare(answers, frame_refs)
    failed = sum(any(r[k] > v for k, v in limits.items()) for r in reads)
    notes = {"reference_kept": [len(f.kept) for f in frame_refs],
             "reference_clear": [sum(f.clear) for f in frame_refs],
             "raw_answers": sum(a.raw is not None for a in answers)}
    return worst, failed, notes


def control_readings(pool, cfg: dict, limits: dict) -> tuple:
    """The control in the program's place, judged as the program is: one
    answer a distinct frame, with its raw output. Returns (the widest
    reading of each number, the answers over a limit, the answers)."""
    refs = reference(pool, cfg)
    ctrl = reference(pool, cfg, control=True)
    answers = [Answer(i, plain_nms(r, cfg), r) for i, r in enumerate(ctrl)]
    worst, failed, _ = judge(answers, refs, pool, cfg, limits)
    return worst, failed, len(answers)
