"""Replay of a stage of eager PyTorch ops as a CUDA graph, shared by the
layers that replay theirs: cluster_and_fit's three stages
(ops/quadfit.GraphRunner) and decode_quads (ops/decode.GraphRunner).

A Runner keys each stage by what the code observes (a subclass builds
the key). The first run at a key is eager, and is the warm-up a capture
needs (kernels loaded, launchers' one-time device checks made); the
second captures the stage on a side stream and replays it; later runs
replay. So a shape seen once never pays for a capture; a key whose
capture fails runs eagerly from then on, with a warning. A graph reads
its inputs where an earlier graph of the runner wrote them, else from
buffers of its own that each replay first copies the inputs into; it
writes into a memory pool of its own, and the caller gets copies
(Runner._copy), so a later replay changes nothing a caller holds. A
replay adds to _build's launch counters what the kernel wrappers added
while it was captured. A runner serves one thread at a time: a
TorchDetector holds one for each layer, other callers get one per thread
(thread_runner).
"""
from __future__ import annotations

import ctypes
import gc
import threading
import warnings

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.utils import tracing


class _Graph:
    """One captured stage: its CUDA graph, the tensors it reads (bound at
    capture), the tensors it writes, the launches its kernel wrappers made
    while it was captured, and the tables it reads."""
    __slots__ = ("graph", "inputs", "outputs", "launches", "tabs")

    def __init__(self, graph, inputs, outputs, launches, tabs):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.tabs = tabs


class Runner:
    """A layer's stages on a CUDA device, each replayed as a CUDA graph
    once its key recurs (the module's docstring). `runs` counts the
    layer's calls by how they ran (RUNS): eager when any stage ran
    eagerly, captured when any was captured, replayed when all replayed;
    so does the calling thread's open call record, under LAYER
    (utils/tracing.GRAPH_LAYERS)."""

    RUNS = tracing.GRAPH_RUNS
    LAYER = ""

    def __init__(self):
        self._graphs: dict = {}
        self._seen: set = set()
        self._eager: set = set()     # keys whose capture failed
        self._static: dict = {}      # id -> tensor, every graph's outputs
        self._side: dict = {}        # device -> capture stream
        self.runs = dict.fromkeys(self.RUNS, 0)

    def _count(self, how: list) -> None:
        """Count a call whose stages ran as `how` (indices into RUNS)."""
        i = min(how)
        self.runs[self.RUNS[i]] += 1
        tracing.RECORDER.graph_run(self.LAYER, i)

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        """`t`, or a copy where a graph of this runner writes it."""
        return t.clone() if self._static.get(id(t)) is t else t

    def _stage(self, key, on: tuple, how: list, tabs, fn, inputs: dict,
               what: str) -> dict:
        """fn(**inputs) run as the stage keyed `key` on `on`, (device,
        stream): eagerly, captured or replayed, appended to `how`. `tabs`
        are kept alive with the graph; `what` names the stage in the
        warning of a failed capture."""
        g = self._graphs.get(key)
        if g is None:
            if key not in self._seen or key in self._eager:
                self._seen.add(key)
                how.append(0)
                return fn(**inputs)
            try:
                g = self._graphs[key] = self._capture(fn, inputs, tabs)
            except RuntimeError as e:
                self._eager.add(key)
                warnings.warn(f"{what} capture failed ({e}); it runs "
                              "eagerly")
                how.append(0)
                return fn(**inputs)
            how.append(1)
        else:
            for name, t in g.inputs.items():
                if inputs[name] is not t:
                    t.copy_(inputs[name])
            how.append(2)
        _replay(g.graph, *on)
        _build.replayed(g.launches)
        return g.outputs

    def _capture(self, fn, inputs: dict, tabs) -> _Graph:
        """The stage bound to its inputs (an earlier graph's outputs as
        they are, other inputs copied to buffers of its own) and
        captured."""
        bound = {n: t if self._static.get(id(t)) is t else t.clone()
                 for n, t in inputs.items()}
        with _build.recording() as launches:
            graph, out = self._record(fn, bound)
        for t in out.values():
            self._static[id(t)] = t
        return _Graph(graph, bound, out, launches, tabs)

    def _record(self, fn, bound: dict) -> tuple:
        """(graph, outputs): fn(**bound) captured on the device's side
        stream, with no device synchronisation; only the calling thread
        may make no unsafe CUDA call meanwhile, so other threads' work on
        the device goes on. One capture at a time in the process, and no
        garbage collection during one (it would destroy the graphs of
        detectors that died in reference cycles)."""
        dev = next(iter(bound.values())).device
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE, torch.cuda.stream(side):
            side.wait_stream(cur)
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn(**bound)
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        cur.wait_stream(side)
        return graph, out


_LAUNCH: list = []


def _graph_launch():
    """cudaGraphLaunch of the CUDA runtime that torch loaded, called
    through ctypes.PyDLL, so the call holds the GIL; None where no shared
    runtime is mapped into the process."""
    if not _LAUNCH:
        with open("/proc/self/maps") as maps:
            paths = [line.split()[-1] for line in maps
                     if "/libcudart" in line]
        fn = None
        if paths:
            fn = ctypes.PyDLL(paths[0]).cudaGraphLaunch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def _replay(graph, dev: torch.device, stream: int) -> None:
    """graph.replay() on `stream`, with the GIL held through the launch.
    CUDAGraph.replay releases the GIL around cudaGraphLaunch, so a
    torch.profiler started or stopped on another thread (both hold the
    GIL) overlapped the launch of a whole graph: on an H100 that hung the
    process, or aborted it at exit, in about one traced benchmark run in
    four. The graphs hold no random-number state, so the launch is all
    that replay() does for them."""
    launch = _graph_launch() if dev.type == "cuda" else None
    if launch is None or not hasattr(graph, "raw_cuda_graph_exec"):
        graph.replay()
        return
    if torch.cuda.current_device() == dev.index:
        rc = launch(graph.raw_cuda_graph_exec(), stream)
    else:
        with torch.cuda.device(dev):
            rc = launch(graph.raw_cuda_graph_exec(), stream)
    if rc != 0:
        raise RuntimeError(f"cudaGraphLaunch failed with error {rc}")


def stream_id(dev: torch.device) -> int:
    """The device's current stream (0 off CUDA, where only tests run a
    runner)."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.current_stream(dev).cuda_stream


_LOCAL = threading.local()
_CAPTURE = threading.Lock()


def thread_runner(cls: type) -> Runner:
    """The calling thread's own runner of class `cls`."""
    runners = _LOCAL.__dict__.setdefault("runners", {})
    runner = runners.get(cls)
    if runner is None:
        runner = runners[cls] = cls()
    return runner
