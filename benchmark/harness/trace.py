"""The traced run's instruments, all on the harness's side of the port.

A traced window runs in three stretches, each with its own instrument on,
so that none of them weighs on what another reads:

- "spans" (from the window's start): stage spans. The port's stage
  functions, the ones scripts/mb_torch_detector_profile.py wraps (at
  commit 5b978635277ede7c3d2dd15eeb95ccc7be8ca268), are wrapped for the
  whole window and their spans kept on the host clock (epoch ns). Unlike
  that script no synchronize follows a stage. The host-clock metrics are
  read from the calls of this stretch.
- "syncs": synchronising operations counted under
  torch.cuda.set_sync_debug_mode("warn") with a warnings hook, both on in
  this stretch alone (a warning a synchronising operation costs host time).
- "profile": the profiler (device activity and the CUDA runtime calls
  only: recording every CPU op slowed a call several times), started from
  a thread of the tracer's own; each device operation is attributed to the
  stage span open when its runtime call (matched by correlation id) was
  made. The calls wholly inside it are the profiled ones.

A call span goes around each detector call (detect_raw_packed, or
VisionNode.submit in the served loop), with what the call did: the
front-end route, the cluster_and_fit width and the tail's slot count (every
call of the window), its stages' host ms, its synchronising operations,
and the host time the spans' own bookkeeping took. A call that straddles
two stretches counts in neither. The notes compare the calls' host time
stretch by stretch: the instruments' cost.

A stage whose function the port no longer has is left out: its metrics are
absent, never 0.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import threading
import time
import warnings

# stage -> (module, attribute), as mb_torch_detector_profile.py wraps them
STAGES = {
    "threshold": ("ros_vision_tpu_torch.apriltag.detector",
                  "adaptive_threshold_fused"),
    "frontend": ("ros_vision_tpu_torch.apriltag.detector", "frontend"),
    "quadfit": ("ros_vision_tpu_torch.ops.quadfit", "cluster_and_fit"),
    "refine": ("ros_vision_tpu_torch.ops.decode", "refine_edges"),
    "decode": ("ros_vision_tpu_torch.ops.decode", "decode_quads"),
    "pose": ("ros_vision_tpu_torch.ops.pose", "estimate_poses"),
}
SYNC_MESSAGE = "called a synchronizing CUDA operation"


def nbytes(obj) -> int:
    """Bytes of a tensor, or of the tensors in a tuple, list or dict."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(nbytes(v) for v in obj)
    return 0


class Tracer:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.calls = []               # one record a finished call
        self._local = threading.local()
        self._originals = {}
        self._lock = threading.Lock()
        self._prof = None
        self.profile = None           # the parsed profile, after it stops
        self._profile_ns = None
        self._showwarning = None
        self._seen = set()
        self._route = None
        self._timer = None
        self._results = None
        self._filters = None
        self.stretch = "spans"
        self.bounds = {}              # stretch -> (t0, t1) epoch s

    # -- installation --------------------------------------------------
    def install(self) -> None:
        for stage, (modname, attr) in STAGES.items():
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            self._originals[stage] = (mod, attr, fn)
            setattr(mod, attr, self._wrap(stage, fn))
        try:
            fk = importlib.import_module(
                "ros_vision_tpu_torch.ops.frontend_kernel")
            self._route = getattr(fk, "frontend_route", None)
        except ImportError:
            self._route = None
        self.warm()

    def uninstall(self) -> None:
        for mod, attr, fn in self._originals.values():
            setattr(mod, attr, fn)
        self._count_syncs(False)

    def _count_syncs(self, on: bool) -> None:
        """Sync debug mode "warn" and the warnings hook, on or off."""
        if not self.cuda:
            return
        import torch
        if on and self._showwarning is None:
            self._showwarning = warnings.showwarning
            self._filters = list(warnings.filters)
            warnings.showwarning = self._on_warning
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        elif not on and self._showwarning is not None:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = self._showwarning
            warnings.filters[:] = self._filters
            getattr(warnings, "_filters_mutated", lambda: None)()
            self._showwarning = None

    @property
    def stages(self) -> list:
        return list(self._originals)

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if SYNC_MESSAGE in str(message):
            rec = getattr(self._local, "rec", None)
            if rec is not None:
                rec["syncs"] += 1
            return
        key = (str(message), category)
        if key not in self._seen:
            self._seen.add(key)
            self._showwarning(message, category, filename, lineno, file,
                              line)

    # -- spans ---------------------------------------------------------
    def schedule(self, t0: float, seconds: float) -> float:
        """Lay the stretches over the window [t0, t0 + seconds] (epoch s)
        and switch between them from a thread of the tracer's own; returns
        the end of the "spans" stretch. The profile takes the last
        min(3, seconds / 3) s but 0.5, the sync count min(3, seconds / 6)
        s before it, the spans the rest."""
        p = min(3.0, seconds / 3)
        p1 = t0 + seconds - 0.5
        p0 = p1 - p
        q0 = p0 - min(3.0, seconds / 6)
        self.bounds = {"spans": (t0, q0), "syncs": (q0, p0),
                       "profile": (p0, p1)}

        def at(t):
            time.sleep(max(0.0, t - time.time()))

        def run():
            at(q0)
            self.stretch = None
            self._count_syncs(True)
            self.stretch = "syncs"
            at(p0)
            self.stretch = None
            self._count_syncs(False)
            self._start_profile()
            self.stretch = "profile"
            at(p1)
            self.stretch = None
            self._stop_profile()
        self._timer = threading.Thread(target=run, name="profile")
        self._timer.start()
        return q0

    @contextlib.contextmanager
    def call(self):
        now = time.time()
        rec = {"t0": now, "t1": None, "route": None, "width": None,
               "slots": None, "syncs": 0, "profiled": False,
               "stretch": self.stretch, "own_ms": 0.0,
               "while_profiling": self._prof is not None,
               "host_ms": collections.defaultdict(float), "bytes": {},
               "keep": {}, "spans": [], "ns": [time.time_ns(), None]}
        self._local.rec = rec
        t = time.perf_counter()
        try:
            yield rec
        finally:
            rec["ms"] = (time.perf_counter() - t) * 1e3
            rec["ns"][1] = time.time_ns()
            if self.stretch != rec["stretch"]:
                rec["stretch"] = None
            rec["t1"] = time.time()
            self._local.rec = None
            with self._lock:
                self.calls.append(rec)

    def _wrap(self, stage, fn):
        def run(*a, **kw):
            rec = getattr(self._local, "rec", None)
            if rec is None:
                return fn(*a, **kw)
            t_ns = time.time_ns()
            t = time.perf_counter()
            out = fn(*a, **kw)
            t1 = time.perf_counter()
            rec["spans"].append((t_ns, time.time_ns(), stage))
            rec["host_ms"][stage] += (t1 - t) * 1e3
            self._observe(stage, rec, a, out)
            rec["own_ms"] += (time.perf_counter() - t1) * 1e3
            return out
        run.__wrapped__ = fn
        return run

    def _observe(self, stage, rec, a, out) -> None:
        """What the call did, read from shapes (no device read)."""
        b = rec["bytes"]
        if stage == "threshold":
            b[stage] = b.get(stage, 0) + nbytes(a[0]) + nbytes(out)
        elif stage == "frontend":
            if self._route is not None:
                rec["route"] = self._route(*a[0].shape[1:])
            b[stage] = b.get(stage, 0) + nbytes(a[0]) + nbytes(out)
        elif stage == "quadfit":
            rec["width"] = int(a[0]["key"].shape[1])
        elif stage == "refine":
            rec["slots"] = int(a[1].shape[1])
            b[stage] = b.get(stage, 0) + nbytes(a[1]) + nbytes(a[2]) \
                + nbytes(out)
            if rec["while_profiling"]:
                rec["keep"]["refine"] = (a[1], a[2])
        elif stage == "pose":
            b[stage] = b.get(stage, 0) + nbytes(a[0]) + nbytes(out)
            if rec["while_profiling"]:
                rec["keep"]["pose"] = a[0]

    # -- the profiler --------------------------------------------------
    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start (which
        initialises CUPTI, seconds on the card) falls in set-up."""
        with self._profiler():
            pass

    def _start_profile(self) -> None:
        self._prof = self._profiler()
        self._prof.__enter__()
        self._profile_ns = [time.time_ns(), None]

    def _stop_profile(self) -> None:
        prof, self._prof = self._prof, None
        self._profile_ns[1] = time.time_ns()
        prof.__exit__(None, None, None)
        self._results = prof.profiler.kineto_results

    def finish(self) -> None:
        """After the window: wait for the profile to end and read it. The
        calls that ran wholly inside it are the profiled ones."""
        if self._timer is None:
            return
        self._timer.join()
        w0, w1 = self._profile_ns
        with self._lock:
            calls = list(self.calls)
        for c in calls:
            c["profiled"] = w0 <= c["ns"][0] and c["ns"][1] <= w1
        self.profile = parse_profile(
            self._results.events(), [c for c in calls if c["profiled"]],
            w0, w1)
        self._results = None

    def cost(self, calls: list) -> dict:
        """The instruments' cost: the calls' mean host ms in each stretch,
        and the spans' own bookkeeping ms a call."""
        out = {}
        for name in self.bounds:
            ms = [c["ms"] for c in calls if c["stretch"] == name]
            out[f"call_ms.{name}"] = sum(ms) / len(ms) if ms else None
            out[f"calls.{name}"] = len(ms)
        own = [c["own_ms"] for c in calls]
        out["span_bookkeeping_ms"] = sum(own) / len(own) if own else None
        return out


def _innermost(starts, items, t, walk: int = 2):
    """The item (start, end, name) with the latest start <= t whose end >=
    t, looking back at most `walk` items (spans of one kind do not nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - walk, -1), -1):
        if items[j][1] >= t:
            return items[j]
    return None


def _index(items):
    items = sorted(items)
    return [x[0] for x in items], items


def parse_profile(events, calls: list, w0: int, w1: int) -> dict:
    """The traced window [w0, w1] (epoch ns) from kineto events and the
    profiled calls' host spans: device operations (kernels, copies,
    memsets), each with the stage span open when its runtime call was
    made; their busy union; the idle gaps, each named by the stage open on
    the host at its middle and the runtime call in progress there (or
    "python"); and counts."""
    from torch.autograd import DeviceType
    dev, runtime, api = [], {}, []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, end, e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = s
            api.append((s, end, e.name()))
    stage_ix = _index([sp for c in calls for sp in c["spans"]])
    call_ix = _index([(c["ns"][0], c["ns"][1], "call") for c in calls])
    api_ix = _index(api)

    def where(t):
        st = _innermost(*stage_ix, t)
        if st is not None:
            return st[2]
        return "other" if _innermost(*call_ix, t) else "outside calls"

    stages = collections.defaultdict(lambda: [0, 0])  # launches, ns
    by_name = collections.defaultdict(float)
    attributed = 0
    for s, end, name, corr in dev:
        by_name[name[:120]] += (end - s) / 1e9
        t = runtime.get(corr)
        if t is None:
            label = "unattributed"
        else:
            attributed += 1
            label = where(t)
        stages[label][0] += 1
        stages[label][1] += end - s

    # the busy union inside the window, and the idle gaps between
    union = []
    for s, end in sorted((max(s, w0), min(end, w1)) for s, end, _, _ in dev
                         if end > w0 and s < w1):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], end)
        else:
            union.append([s, end])
    busy = sum(end - s for s, end in union)
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for s, end in union for x in (s, end)] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            m = (g0 + g1) // 2
            call = _innermost(*api_ix, m, walk=8)
            gaps[f"{where(m)}|{call[2] if call else 'python'}"] += \
                (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
        "calls": len(calls), "device_ops": len(dev),
        "attributed_share": attributed / len(dev) if dev else None,
        "stages": {k: {"launches": v[0], "device_ms": v[1] / 1e6}
                   for k, v in stages.items()},
        "top_ops": sorted(by_name.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:10],
    }
