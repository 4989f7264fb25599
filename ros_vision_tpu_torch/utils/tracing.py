"""Stage-level tracing and debug taps for the PyTorch detector.

Counterpart of ros_vision_tpu/utils/tracing.py. The reference has three
observability tiers (SURVEY section 5): per-stage CUDA events with running
averages (apriltag_gpu.cu:1113-1165), ~20 Copy*To debug taps
(apriltag_gpu.h:98-183), and a --sync flag forcing synchronize+check after
every kernel (cuda_frc971.cu:5-26). Here:

  - RECORDER: host-clock spans of every detector call and its count of
    synchronising operations, always on (the reference keeps its stage
    averages on too). A `detector` span (Call) around
    TorchDetector._detect_device (and pack_outputs, through
    detect_raw_packed) opens the calling thread's call record; inside it
    the stages open Spans: `quadfit` (cluster_and_fit) with its three
    parts `quadfit.sort`, `quadfit.lines`, `quadfit.quads`, and
    `decode.screen`, `decode.refine`, `decode.tail`. The record's `syncs`
    and `sync_ns` are what the call's device.HostSyncs counted and timed
    over it: each `.item()` read and constant-table upload, and the host
    ns spent inside them; its `quadfit_eager`, `quadfit_captured` and
    `quadfit_replayed` count how its cluster_and_fit calls on a CUDA
    device ran (ops/quadfit.GraphRunner), and `decode_eager`,
    `decode_captured` and `decode_replayed` its decode_quads calls
    (ops/decode.GraphRunner). Spans are stamped
    with time.time_ns(), the clock of torch.profiler's events, so device
    operations and idle gaps in a profile can be put down to the span open
    at their runtime call. No span synchronises, records an event or reads
    the device. A game-piece call (ModelInference.detect_packed) opens a
    call record of its own the same way, under a `gamepiece` span, with
    `gamepiece.preprocess`, `gamepiece.forward` and `gamepiece.nms`
    inside (GAMEPIECE_SPANS); it makes no host read and no upload, so it
    counts none (Call with no HostSyncs: `syncs` and `sync_ns` 0).
  - stage_taps(): runs the pipeline stage by stage and returns every
    intermediate (threshold image, labels, boundary points, segment stats,
    quads, decode fields) as numpy, under the JAX package's key names — the
    Copy*To tier.
  - check mode: stage_taps(check=True) validates invariants after every
    stage (value sets, id ranges, finite corners and poses) and raises
    RuntimeError with the failing stage's name — the --sync tier.

The taps run the detector's own kernels on a CUDA tensor: K1 threshold,
then K2 ranks at 1280x800 or the flood CCL (K6, K7) at 1920x1080, as
ops/frontend_kernel.frontend_route picks, K3 boundary compaction and
cluster_and_fit's K4 histograms. On a CPU tensor they run the plain
versions, and the CCL stage is ops/ccl.label_components, as the JAX
package's taps use on the CPU. They run the untiered full-width pipeline,
so they are no split of a detect_raw call: the recorder's spans are.
"""
from __future__ import annotations

import array
import itertools
import threading
import time

import numpy as np
import torch

# the spans a detector call records, in pipeline order
SPANS = ("detector", "quadfit", "quadfit.sort", "quadfit.lines",
         "quadfit.quads", "decode.screen", "decode.refine", "decode.tail")
# the spans a game-piece call records (models/infer.ModelInference)
GAMEPIECE_SPANS = ("gamepiece", "gamepiece.preprocess", "gamepiece.forward",
                   "gamepiece.nms")
# the layers that replay CUDA graphs (ops/graphs.Runner), and how a call
# of one on a CUDA device ran
GRAPH_LAYERS = ("quadfit", "decode")
GRAPH_RUNS = ("eager", "captured", "replayed")
SPAN_SLOTS = 1 << 18
CALL_SLOTS = 1 << 16


class _Open:
    """The calling thread's open call: the name of its outer span, its
    sequence number, start (epoch ns), its HostSyncs' count and ns at the
    start, the sequence number of its first span, and its calls of each
    of GRAPH_LAYERS on a CUDA device by how they ran (GRAPH_RUNS), layer
    by layer."""
    __slots__ = ("name", "seq", "t0", "syncs", "sync_ns", "span_lo",
                 "runs")

    def __init__(self, name: str, seq: int, t0: int, syncs):
        self.name = name
        self.seq = seq
        self.t0 = t0
        self.syncs = syncs.count
        self.sync_ns = syncs.ns
        self.span_lo = -1
        self.runs = [0] * (len(GRAPH_LAYERS) * len(GRAPH_RUNS))


def _ring(columns: int, slots: int) -> list:
    """`columns` int64 columns of `slots` entries, each -1."""
    return [array.array("q", [-1]) * slots for _ in range(columns)]


class Recorder:
    """Spans and call records in two rings allocated up front (int64
    columns; a record overwrites the oldest once a ring is full). A span
    row: its sequence number, name id, call and start and end (epoch ns);
    a call row: its sequence number, start, end, thread, syncs, sync_ns,
    first span and its graph layers' runs (GRAPH_LAYERS by GRAPH_RUNS).
    The open call is per thread, so worker threads (as parallel/mesh.py
    runs them, each with a detector of its own) record calls of their
    own. `enabled = False` turns every span and counter into one
    attribute test."""

    def __init__(self, span_slots: int = SPAN_SLOTS,
                 call_slots: int = CALL_SLOTS):
        for n in (span_slots, call_slots):
            if n < 1 or n & (n - 1):
                raise ValueError(f"ring size {n} is not a power of two")
        self.enabled = True
        self._spans = _ring(5, span_slots)
        self._calls = _ring(7 + len(GRAPH_LAYERS) * len(GRAPH_RUNS),
                            call_slots)
        self._span_seq = itertools.count()
        self._call_seq = itertools.count()
        self._ids: dict = {}
        self._names: list = []
        self._ids_lock = threading.Lock()
        self._local = threading.local()

    def _new_name(self, name: str) -> int:
        with self._ids_lock:
            i = self._ids.setdefault(name, len(self._names))
            if i == len(self._names):
                self._names.append(name)
        return i

    def _span(self, name: str, t0: int, t1: int) -> None:
        i = next(self._span_seq)
        o = getattr(self._local, "open", None)
        if o is not None and o.span_lo < 0:
            o.span_lo = i
        name_id = self._ids.get(name)
        if name_id is None:
            name_id = self._new_name(name)
        seq, nid, call, s0, s1 = self._spans
        j = i & (len(seq) - 1)
        seq[j] = -1                     # a torn row reads as empty
        nid[j] = name_id
        call[j] = o.seq if o is not None else -1
        s0[j] = t0
        s1[j] = t1
        seq[j] = i

    def graph_run(self, layer: str, how: int) -> None:
        """Count a call of `layer` (of GRAPH_LAYERS) on a CUDA device in
        the calling thread's open call, as GRAPH_RUNS[how]."""
        o = getattr(self._local, "open", None)
        if o is not None:
            o.runs[GRAPH_LAYERS.index(layer) * len(GRAPH_RUNS) + how] += 1

    def _begin(self, syncs, name: str = "detector") -> _Open:
        o = _Open(name, next(self._call_seq), time.time_ns(), syncs)
        self._local.open = o
        return o

    def _end(self, o: _Open, syncs) -> None:
        t1 = time.time_ns()
        self._span(o.name, o.t0, t1)
        self._local.open = None
        self._local.last_ns = t1 - o.t0
        seq, c0, c1, thread, n_syncs, sync_ns, lo, *runs = self._calls
        j = o.seq & (len(seq) - 1)
        seq[j] = -1
        c0[j] = o.t0
        c1[j] = t1
        thread[j] = threading.get_ident()
        n_syncs[j] = syncs.count - o.syncs
        sync_ns[j] = syncs.ns - o.sync_ns
        lo[j] = o.span_lo
        for col, n in zip(runs, o.runs):
            col[j] = n
        seq[j] = o.seq

    def take_last_ns(self) -> int | None:
        """The host ns of the calling thread's last closed call, once
        (None if it closed none since the last take)."""
        return self._local.__dict__.pop("last_ns", None)

    def calls(self, since_ns: int = 0) -> list:
        """The call records the ring still holds that started at or after
        `since_ns`, oldest first, each a dict: t0_ns, t1_ns, thread, syncs,
        sync_ns, `<layer>_<run>` for each of GRAPH_LAYERS and GRAPH_RUNS
        (quadfit_eager, ..., decode_replayed: its calls of the layer on a
        CUDA device by how they ran) and spans,
        {name: [(t0_ns, t1_ns), ...]} of the spans recorded inside the
        call (its outer span, `detector` or `gamepiece`, among them), or
        None where the span ring no longer holds them all."""
        c = np.stack([np.frombuffer(a, np.int64) for a in self._calls])
        s = np.stack([np.frombuffer(a, np.int64) for a in self._spans])
        names = list(self._names)
        c = c[:, (c[0] >= 0) & (c[1] >= since_ns)]
        c = c[:, np.argsort(c[0], kind="stable")]
        held = s[0] >= 0
        s = s[:, held]
        oldest = int(s[0].min()) if s.shape[1] else 0
        by_call: dict = {}
        for name, call, t0, t1 in zip(s[1].tolist(), s[2].tolist(),
                                      s[3].tolist(), s[4].tolist()):
            if call >= 0:
                by_call.setdefault(call, {}).setdefault(
                    names[name], []).append((t0, t1))
        out = []
        for seq, t0, t1, thread, syncs, sync_ns, lo, *runs in c.T.tolist():
            spans = by_call.get(seq) if 0 <= lo and oldest <= lo else None
            out.append({"t0_ns": t0, "t1_ns": t1, "thread": thread,
                        "syncs": syncs, "sync_ns": sync_ns,
                        **{f"{layer}_{k}": n for (layer, k), n in zip(
                            itertools.product(GRAPH_LAYERS, GRAPH_RUNS),
                            runs)},
                        "spans": spans})
        return out


RECORDER = Recorder()


class Span:
    """A named host-clock span of the open call: `with Span("quadfit"):`."""
    __slots__ = ("_name", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._t0 = 0

    def __enter__(self):
        if RECORDER.enabled:
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._t0:
            RECORDER._span(self._name, self._t0, time.time_ns())


class _NoSyncs:
    """The syncs of a call that routes none through a device.HostSyncs."""
    count = 0
    ns = 0


class Call:
    """The `detector` span (or the span `name`): opens the calling
    thread's call record and closes it with the span, with the syncs
    `syncs` (device.HostSyncs, or None for a call that makes none)
    counted and timed in between."""
    __slots__ = ("_syncs", "_name", "_open")

    def __init__(self, syncs, name: str = "detector"):
        self._syncs = _NoSyncs if syncs is None else syncs
        self._name = name

    def __enter__(self):
        self._open = RECORDER._begin(self._syncs, self._name) \
            if RECORDER.enabled else None
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            RECORDER._end(self._open, self._syncs)


def span_ms(calls: list) -> dict:
    """Mean host ms a call of each span of SPANS over `calls` (records of
    Recorder.calls with their spans held), in SPANS order."""
    calls = [c for c in calls if c["spans"] is not None]
    n = max(1, len(calls))
    return {k: sum(t1 - t0 for c in calls for t0, t1 in
                   c["spans"].get(k, ())) / n / 1e6 for k in SPANS}


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
                                       syncs, det._quadfit_graphs)

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
                                fam, cm, syncs, det._decode_graphs)

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
