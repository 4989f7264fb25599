"""Traffic driver "detector": TorchDetector.detect_raw_packed, then unpack.

Parameters (the mix's file): `batch`, the frames of one call (camera r of
the call shows pool frames r, r + batch, ...), and `in_flight`:

- 0: each result is read on the host before the next frame is handed
  over: every launch and every synchronising read is on the path;
- n > 0: each packed result is copied to pinned memory without blocking,
  behind an event, and read and unpacked once n newer calls are queued,
  in the order VisionSystem.spin keeps at depth n.

Frames are staged as VisionNode.upload stages them: pinned host memory,
a non-blocking copy to the card. A frame's latency runs from its hand-off
(before its upload) to its detections unpacked on the host. The loop is
closed: the next call goes in as soon as the last one is queued.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

from benchmark.judges.tags import Answer, as_tuples


def detector_for(cfg: dict, device):
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    return TorchDetector(device=device, width=cfg["width"],
                         height=cfg["height"], family=cfg["family"],
                         tag_size=cfg["tag_size"], fx=cfg["fx"],
                         fy=cfg["fy"], cx=cfg["cx"], cy=cfg["cy"],
                         dist=tuple(cfg["dist"]), estimate_pose=True)


def run(ctx):
    import torch
    from ros_vision_tpu_torch.apriltag.detector import PendingOutput
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    cuda = dev.type == "cuda"
    det = detector_for(cfg, dev)
    ctx.mark("detector")
    b, depth = int(tr["batch"]), int(tr["in_flight"])
    n = len(ctx.pool.frames)
    rows = [[(j * b + r) % n for r in range(b)]
            for j in range(max(1, n // b))]
    host = [torch.from_numpy(np.stack([ctx.pool.frames[i] for i in ix]))
            for ix in rows]
    if cuda:
        host = [h.pin_memory() for h in host]
    intr = torch.as_tensor(det.default_intrinsics(b), device=dev)
    tracer = ctx.tracer
    span = tracer.call if tracer is not None else contextlib.nullcontext

    def submit(j):
        t_hand = time.time()
        g = host[j].to(dev, non_blocking=True)
        with span():
            out = det.detect_raw_packed(g, intr)
        if cuda:
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            buf.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            out = PendingOutput(buf, ev)
        return j, t_hand, out

    def consume(item):
        j, t_hand, out = item
        dets = det.unpack(out)
        return j, t_hand, time.time(), dets

    def drive(until=None, calls=None):
        """Calls in turn over the batches until the clock passes `until`
        (or `calls` are made); returns the consumed calls, the last ones
        drained after."""
        q, done, k = collections.deque(), [], 0
        while (until is None or time.time() < until) and \
                (calls is None or k < calls):
            q.append(submit(k % len(rows)))
            k += 1
            while len(q) > depth:
                done.append(consume(q.popleft()))
        while q:
            done.append(consume(q.popleft()))
        return done

    drive(calls=int(tr.get("warmup_calls", 6)) * len(rows))
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("warm")
    t0 = time.time()
    ctx.window_started(t0)
    done = drive(until=t0 + ctx.seconds)
    t1 = t0 + ctx.seconds
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    delivered, answers = [], []
    for j, t_hand, t_res, dets in done:
        for r, frame in enumerate(rows[j]):
            delivered.append((t_hand, t_res))
            answers.append(Answer(frame, as_tuples(dets[r])))
    del det, host, intr, done
    per_s = [0] * max(1, int(ctx.seconds + 0.999))
    for s, r in delivered:
        if t0 <= r < t1:
            per_s[min(int(r - t0), len(per_s) - 1)] += 1
    return dict(t0=t0, t1=t1, delivered=delivered, answers=answers,
                memory_peak_bytes=peak, layers={}, notes={
                    "calls": sum(1 for s, r in delivered if t0 <= r <= t1)
                    // b, "frames_a_second": per_s})
