"""First-use build of the CUDA kernels and their ctypes binding.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds, not minutes)
under ``build/ros_vision_tpu_torch/`` beside the package, named by a hash
of the sources and flags so an edited source is never served a stale
binary. Nothing is compiled at import: the first kernel launch builds and
loads the library. Each C launcher enqueues on the stream it is given,
allocates nothing, and returns ``cudaGetLastError()`` (or -1 where the
device cannot place a kernel's thread-block cluster); :func:`launch`
raises on anything but 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ros_vision_tpu_torch"
# no --use_fast_math: the thinning selection in boundary.cu needs IEEE
# division and round-to-nearest products (nvcc's defaults)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every launcher: (..., int device, void* stream) -> int cudaError_t
_SIGNATURES = {
    # gray, decim, threshim, launches, b, h, w, min_white_black_diff,
    # band, bands, threads, smem
    "rvt_adaptive_threshold": [_P] * 4 + [_I] * 8,
    # threshim, labels, size_root, rank_root, block_counts, ranks, sizes,
    # launches, b, h, w, min_blob, max_blobs, tile_h, tile_w, tiles_x,
    # tiles_y, threads, border_threads, smem
    "rvt_rank_image": [_P] * 8 + [_I] * 12,
    # threshim, ranks, key, pack2, counts, launches, b, h, w, pc, k_cap,
    # cluster, threads, span, slice, smem
    "rvt_boundary_compact": [_P] * 6 + [_I] * 10,
    # values, out, launches, b, k, num_values, cluster, threads, per_rank,
    # smem
    "rvt_value_histogram": [_P] * 3 + [_I] * 7,
    # threshim, values, labels, rootmin, out, launches, b, h, w, tile_h,
    # tile_w, tiles_x, tiles_y, threads, border_threads, smem
    "rvt_propagate_fixpoint": [_P] * 6 + [_I] * 10,
    # labels, counts, launches, b, n
    "rvt_label_histogram": [_P] * 3 + [_I] * 2,
    # threshim, labels, scratch, out, launches, b, h, w, n_sweeps, tile_h,
    # tile_w, halo, tiles_x, tiles_y, threads, smem
    "rvt_propagate": [_P] * 5 + [_I] * 11,
    # labels, rank_v, out, b, n
    "rvt_rank_gather": [_P] * 3 + [_I] * 2,
    # in0..2, work0..2, out0..2, launches, b, k, n, nops, nkeys, tile,
    # cluster, threads, smem
    "rvt_sort": [_P] * 10 + [_I] * 9,
    # table, idx, out, launches, b, s, c, k
    "rvt_table_take_cm": [_P] * 4 + [_I] * 4,
    # seg, val, mn, mx, launches, b, k, s, cluster, threads, chunk, slices,
    # per_slice, per_rank, smem
    "rvt_segment_min_max": [_P] * 5 + [_I] * 10,
    # h, fx, fy, cx, cy, r, t, err, launches, b, nq, tag_size, n_steps
    "rvt_estimate_poses": [_P] * 9 + [_I, _I, _F, _I],
    # gray, corners, quad_valid, intr, dist, out, lines, launches,
    # intr_stride, dist_stride, b, nq, h, w, n_alpha, have_dist,
    # reversed_border
    "rvt_refine_edges": [_P] * 8 + [_I] * 9,
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path(flags: tuple = NVCC_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librvt_kernels_{h.hexdigest()[:16]}.so"


class KernelLibrary:
    """The built, loaded kernel library (one per process), compiled with
    `flags` (a measuring script may build a variant with extra defines)."""

    def __init__(self, flags: tuple = NVCC_FLAGS):
        self.flags = tuple(flags)
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds: float | None = None   # None until built here
        self.build_log = ""

    def build(self) -> Path:
        out = library_path(self.flags)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
        t0 = time.monotonic()
        procs = [subprocess.Popen([_nvcc(), *self.flags, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cus, objs)]
        logs = []
        for p, proc in zip(cus, procs):
            text, _ = proc.communicate()
            logs.append((p.name, text, proc.returncode))
        tmp = out.with_name(f"{tag}.tmp")
        link = None
        if all(rc == 0 for _, _, rc in logs):
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(("link", link.stdout + link.stderr,
                         link.returncode))
        self.build_seconds = time.monotonic() - t0
        self.build_log = "".join(f"== {name} (exit {rc})\n{text}"
                                 for name, text, rc in logs)
        (BUILD_DIR / "build.log").write_text(self.build_log)
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, args in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args + [_I, _P]
                    fn.restype = _I
                self._lib = lib
            return self._lib


LIBRARY = KernelLibrary()


class LaunchCounter:
    """Launches of one kernel; its wrapper adds one per launch and nowhere
    else, so a run can show that the main path went through the kernel.
    `kernels` sums the device kernel launches that C launchers which
    report them (K1-K4, K6-K11, P1, P2) made for those calls. Wrappers may run
    on several threads at once (parallel/mesh.py), so add() takes a
    lock."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.kernels = 0
        self._lock = threading.Lock()

    def add(self, kernels: int = 0) -> None:
        """One more launch of the wrapper, which made `kernels` device
        kernel launches; recorded instead where the calling thread is
        inside recording()."""
        held = getattr(_RECORDING, "launches", None)
        if held is not None:
            held.append((self, kernels))
            return
        with self._lock:
            self.count += 1
            self.kernels += kernels


COUNTERS: dict[str, LaunchCounter] = {}
_RECORDING = threading.local()


@contextlib.contextmanager
def recording():
    """Inside it the calling thread's wrapper launches are recorded, not
    counted, in the list it yields: a CUDA graph's capture enqueues no
    work, and each replay of the graph counts them with replayed()."""
    _RECORDING.launches = held = []
    try:
        yield held
    finally:
        _RECORDING.launches = None


def replayed(launches: list) -> None:
    """Count the launches recording() recorded, once more."""
    for c, kernels in launches:
        c.add(kernels)


def counter(name: str) -> LaunchCounter:
    COUNTERS[name] = c = LaunchCounter(name)
    return c


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0
        c.kernels = 0


def counts() -> dict[str, int]:
    return {n: c.count for n, c in COUNTERS.items()}


def kernel_counts() -> dict[str, int]:
    return {n: c.kernels for n, c in COUNTERS.items()}


_FUNCS: dict = {}          # launcher name -> its ctypes function
# the current stream's handle without building a torch.cuda.Stream (every
# CUDA build of torch has it; a CPU build never launches)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
CLUSTER_UNPLACEABLE = -1


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher `name` with tensors passed as device pointers (None ->
    NULL), floats as floats and ints as ints, on `device`'s current
    stream; raise if the launch reported an error. The ctypes function is
    looked up once per name."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = _FUNCS[name] = getattr(LIBRARY.get(), name)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor)
              else None if a is None
              else float(a) if isinstance(a, float) else int(a)
              for a in args],
            index, _RAW_STREAM(index))
    if rc == CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"{name}: the device cannot place the kernel's "
                           "thread-block cluster "
                           "(cudaOccupancyMaxActiveClusters is 0)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — the contract every kernel wrapper enforces before passing
    a raw pointer to C."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements overflow the "
                         "kernels' int32 indexing")
