"""Traffic driver "gamepiece": GamePieceNode.process_frames, then unpack.

The pool's weights (Ultralytics layout) are written as a .pt checkpoint
and converted with ros_vision_tpu_torch.tools.convert_yolo_weights, the
path a team's trained checkpoint takes, into the .npz that
ModelInference(params_path=...) loads. The node runs the configuration's
scale, classes, input size and detections a call, in the engine's
default precision.

Parameters (the mix's file), as the "detector" driver reads them:
`batch`, the cameras' frames of one call (camera r of the call shows pool
frames r, r + batch, ...), and `in_flight`:

- 0: each result is read on the host before the next frames are handed
  over;
- n > 0: each packed result's copy to pinned memory is started behind an
  event (GamePieceNode.fetch), and read and unpacked once n newer calls
  are queued, in the order VisionSystem.spin keeps at depth n.

Frames are staged as the "detector" driver stages them: each batch in
pinned host memory once, before the window, which the node copies to the
card without blocking (a deployment's host arrays are first copied into
pinned memory by the node itself). A frame's latency runs from its
hand-off to its detections unpacked on the host. The loop is closed.

Every answer is judged; for the newest call of each distinct batch the
answers also carry that call's raw head output, read after the window.
The layers hand the readers the forward's operations a call
(`gamepiece_flops`, benchmark/reference/yolo11_flops.py).
"""
from __future__ import annotations

import collections
import contextlib
import io
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark.judges.gamepiece import Answer, as_tuples
from benchmark.reference.yolo11_flops import flops


def node_for(cfg: dict, state_dict: dict, device):
    """A GamePieceNode on `device` whose engine loads `state_dict` through
    the converter."""
    import torch
    from ros_vision_tpu_torch.models.infer import ModelInference
    from ros_vision_tpu_torch.runtime.game_piece_node import GamePieceNode
    from ros_vision_tpu_torch.tools import convert_yolo_weights
    with tempfile.TemporaryDirectory() as tmp:
        pt, npz = Path(tmp) / "gamepiece.pt", Path(tmp) / "gamepiece.npz"
        torch.save(state_dict, pt)
        with contextlib.redirect_stdout(io.StringIO()):
            convert_yolo_weights.convert(str(pt), str(npz),
                                         cfg["num_classes"], cfg["scale"])
        engine = ModelInference(
            num_classes=cfg["num_classes"], scale=cfg["scale"],
            img_size=cfg["img_size"], class_names=cfg["class_names"],
            params_path=str(npz), max_detections=cfg["max_detections"],
            device=device)
    return GamePieceNode(engine=engine)


def run(ctx):
    import torch
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    cuda = dev.type == "cuda"
    node = node_for(cfg, ctx.pool.state_dict, dev)
    ctx.mark("detector")
    b, depth = int(tr["batch"]), int(tr["in_flight"])
    n = len(ctx.pool.frames)
    rows = [[(j * b + r) % n for r in range(b)]
            for j in range(max(1, n // b))]
    host = [torch.from_numpy(np.stack([ctx.pool.frames[i] for i in ix]))
            for ix in rows]
    if cuda:
        host = [h.pin_memory() for h in host]
    tracer = ctx.tracer
    span = tracer.call if tracer is not None else contextlib.nullcontext
    newest = {}                 # batch -> (call number, its raw output)

    def submit(k):
        j = k % len(rows)
        t_hand = time.time()
        with span():
            packed, raw = node.process_frames(host[j], with_raw=True)
        newest[j] = (k, raw)
        return k, j, t_hand, node.fetch(packed) if depth else packed

    def consume(item):
        k, j, t_hand, out = item
        dets = node.unpack(out)
        t_res = time.time()
        # kept as tuples: fewer objects for the collector to walk
        return k, j, t_hand, t_res, [as_tuples(d) for d in dets]

    def drive(until=None, calls=None, start=0):
        """Calls in turn over the batches until the clock passes `until`
        (or `calls` are made); returns the consumed calls, the last ones
        drained after."""
        q, done, k = collections.deque(), [], start
        while (until is None or time.time() < until) and \
                (calls is None or k - start < calls):
            q.append(submit(k))
            k += 1
            while len(q) > depth:
                done.append(consume(q.popleft()))
        while q:
            done.append(consume(q.popleft()))
        return done

    warm = int(tr.get("warmup_calls", 6)) * len(rows)
    drive(calls=warm)
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("warm")
    t0 = time.time()
    ctx.window_started(t0)
    done = drive(until=t0 + ctx.seconds, start=warm)
    t1 = t0 + ctx.seconds
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    raws = {k: raw.float().cpu().numpy() for k, raw in newest.values()}
    delivered, answers = [], []
    for k, j, t_hand, t_res, dets in done:
        raw = raws.get(k)
        for r, frame in enumerate(rows[j]):
            delivered.append((t_hand, t_res))
            answers.append(Answer(frame, dets[r],
                                  None if raw is None else raw[r]))
    del node, host, done, newest
    per_s = [0] * max(1, int(ctx.seconds + 0.999))
    for s, r in delivered:
        if t0 <= r < t1:
            per_s[min(int(r - t0), len(per_s) - 1)] += 1
    return dict(t0=t0, t1=t1, delivered=delivered, answers=answers,
                memory_peak_bytes=peak,
                layers={"gamepiece_flops": flops(
                    cfg["scale"], cfg["num_classes"], cfg["img_size"], b)},
                notes={"calls": sum(1 for s, r in delivered
                                    if t0 <= r <= t1) // b,
                       "frames_a_second": per_s})
