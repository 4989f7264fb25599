"""P1 (csrc/pose.cu): estimate_poses' dispatch, its plain version against
the JAX function, and the kernel's slot arithmetic built for the host.

The card runs the kernel; here a CPU tensor takes estimate_poses_plain, so
the kernel's own arithmetic (csrc/pose.cuh, which also compiles as plain
C++) is built with the host's C++ compiler and held against the plain
version and the JAX function, and its lane form, run lane by lane, against
its serial form bit for bit. Inputs: chip_smoke.seeded_homographies,
tags 0.5-6 m out at tilts up to 70 degrees, the planar ambiguity, an
all-zero and a NaN slot a row. Limits: chip_smoke.pose_limits, which add
to t 1e-4 m, R 1e-3 and err 1e-3 relative the f32 rounding of the depth
solve (it grows as |t|^3 for a tag |t| out), and allow a candidate tie to
go either way (chip_smoke.pose_agreement).
"""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_helpers  # noqa: F401  (one torch thread)
from ros_vision_tpu.ops import pose as jpose
from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.ops import pose as tpose

TAG = 0.1651
INTR = ("fx", "fy", "cx", "cy")


def _batch(seed: int, b: int = 3, nq: int = 16) -> dict:
    return chip_smoke.seeded_homographies(b, nq, seed)


def _torch_args(d: dict):
    return (torch.from_numpy(d["H"]), TAG,
            *(torch.from_numpy(d[k]) for k in INTR))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_cpu_tensor_runs_plain_bit_for_bit():
    args = _torch_args(_batch(0))
    _build.reset_counts()
    got = tpose.estimate_poses(*args)
    want = tpose.estimate_poses_plain(*args)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    assert _build.counts()["estimate_poses"] == 0
    assert _build.kernel_counts()["estimate_poses"] == 0


def test_plain_choice_of_candidates():
    """estimate_poses_plain is pose_candidates_plain and the choice
    (e2 < e1) & (sin_a > 1e-8), bit for bit."""
    args = _torch_args(_batch(1))
    (r1, t1, e1), (r2, t2, e2), sin_a = tpose.pose_candidates_plain(*args)
    r, t, e = tpose.estimate_poses_plain(*args)
    use2 = (e2 < e1) & (sin_a > 1e-8)
    assert torch.equal(_bits(r), _bits(torch.where(use2[..., None, None],
                                                   r2, r1)))
    assert torch.equal(_bits(t), _bits(torch.where(use2[..., None], t2, t1)))
    assert torch.equal(_bits(e), _bits(torch.where(use2, e2, e1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_vs_jax(seed):
    d = _batch(seed)
    args = _torch_args(d)
    want = jpose.estimate_poses(jnp.asarray(d["H"]), TAG,
                                *(jnp.asarray(d[k]) for k in INTR))
    cands = tpose.pose_candidates_plain(*args)
    # the batch holds what its docstring says: 6 degenerate slots, and
    # the planar ambiguity (sin_a ~ 0) on every fourth slot
    fin = torch.isfinite(tpose.estimate_poses_plain(*args)[2])
    assert int((~fin).sum()) == 6
    near = torch.arange(3 * 16).view(3, 16) % 4 == 0
    assert float(cands[2][near & fin].max()) < 0.02
    # the JAX function (lax.fori_loops) against the plain version's choice
    a = chip_smoke.pose_agreement(f"JAX vs plain, seed {seed}",
                                  [np.asarray(x) for x in want], cands, TAG)
    print(f"seed {seed}: share of pose_limits used {a['limit_used']}")
    assert a["finite"] == 42


def test_pose_agreement_catches_faults():
    args = _torch_args(_batch(0))
    cands = tpose.pose_candidates_plain(*args)
    r, t, e = (x.clone() for x in tpose.estimate_poses_plain(*args))
    chip_smoke.pose_agreement("same", (r, t, e), cands, TAG)
    # the nearest tag, bumped past twice its limit in R and in t
    dist = torch.linalg.norm(t, dim=-1).nan_to_num(float("inf"))
    slot = np.unravel_index(int(dist.argmin()), tuple(dist.shape))
    lim = chip_smoke.pose_limits(t[slot].numpy()[None],
                                 e[slot].numpy()[None], TAG)
    for i, key in ((0, "R"), (1, "t")):
        bad = [r.clone(), t.clone(), e.clone()]
        bad[i][slot] += 2 * float(lim[key][0])
        with pytest.raises(RuntimeError, match="outside pose_limits"):
            chip_smoke.pose_agreement("bumped", bad, cands, TAG)
    moved = e.clone()
    moved[slot] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        chip_smoke.pose_agreement("nan", (r, t, moved), cands, TAG)


def test_intrinsics_broadcast():
    """One camera's (1,) intrinsics serve every row, as (B,) copies do."""
    d = _batch(3)
    h = torch.from_numpy(d["H"])
    one = [torch.from_numpy(d[k][:1]) for k in INTR]
    rows = [v.expand(3).contiguous() for v in one]
    got = tpose.estimate_poses(h, TAG, *one)
    want = tpose.estimate_poses(h, TAG, *rows)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def test_launcher_declared():
    """_build binds rvt_estimate_poses with the signature csrc/pose.cu
    defines extern "C": 9 pointers, b, nq, tag_size (float), n_steps,
    then device and stream."""
    args = _build._SIGNATURES["rvt_estimate_poses"]
    assert args == [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int]
    src = (_build.CSRC / "pose.cu").read_text()
    m = re.search(r'extern "C" int rvt_estimate_poses\(([^)]*)\)', src)
    assert m is not None
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(args) + 2
    assert params[11].startswith("float tag_size")
    assert params[-2:] == ["int device", "cudaStream_t stream"]


def _host_compiler():
    return shutil.which("c++") or shutil.which("g++")


HOST_GLUE = r'''
#include "pose.cuh"
using namespace rvt_pose;

// pose.cuh's exchange run serially: a lane quantity is an array of the
// slot's lanes, filled by running each lane's role in turn
struct HostQ {
  float v[kSlotLanes];
};
struct HostLanes {
  using Q = HostQ;
  float at(const HostQ& q, int k) const { return q.v[k]; }
  float own(const HostQ& q, int k) const { return q.v[k]; }
  void mark(int) const {}
  template <class F>
  HostQ each(int n, F f) const {
    HostQ q;
    for (int k = 0; k < kSlotLanes; ++k) q.v[k] = f(k < n ? k : n - 1);
    return q;
  }
};

extern "C" void host_estimate_poses(const float* h, const float* fx,
    const float* fy, const float* cx, const float* cy, float* r, float* t,
    float* err, int b, int nq, float tag_size, int n_steps, int lanes) {
  for (int i = 0; i < b * nq; ++i) {
    const int bi = i / nq;
    if (!lanes) {
      estimate_slot(h + 9 * i, fx[bi], fy[bi], cx[bi], cy[bi], tag_size,
                    n_steps, r + 9 * i, t + 3 * i, err + i);
      continue;
    }
    if (!estimate_slot_lanes(HostLanes(), h + 9 * i, fx[bi], fy[bi],
                             cx[bi], cy[bi], tag_size, n_steps, r + 9 * i,
                             t + 3 * i, err + i)) {  // pose.cu's NaN slot
      for (int k = 0; k < 9; ++k) r[9 * i + k] = NAN;
      for (int k = 0; k < 3; ++k) t[3 * i + k] = NAN;
      err[i] = NAN;
    }
  }
}
'''


@pytest.fixture(scope="module")
def host_pose(tmp_path_factory):
    """csrc/pose.cuh built for the host (IEEE f32, no contraction into
    FMAs, as the kernel's __f*_rn operations round): estimate_slot, the
    serial reference, or with lanes=True estimate_slot_lanes, the kernel's
    lane form, its lanes run one after another."""
    cxx = _host_compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_pose")
    src = out / "host_pose.cpp"
    src.write_text(HOST_GLUE)
    lib = out / "libhost_pose.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).host_estimate_poses
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int]

    def run(d: dict, n_steps: int = 50, lanes: bool = False):
        ins = [np.ascontiguousarray(d[k], np.float32)
               for k in ("H",) + INTR]
        b, nq = ins[0].shape[:2]
        outs = [np.empty((b, nq, 3, 3), np.float32),
                np.empty((b, nq, 3), np.float32),
                np.empty((b, nq), np.float32)]
        fn(*[a.ctypes.data for a in ins + outs], b, nq, TAG, n_steps,
           int(lanes))
        return outs
    return run


@pytest.mark.parametrize("seed,b,nq,n_steps", [(0, 3, 16, 50),
                                               (4, 4, 128, 50),
                                               (5, 2, 8, 0), (5, 2, 8, 1)])
def test_lane_form_on_host_gives_the_serial_bits(host_pose, seed, b, nq,
                                                 n_steps):
    """The kernel's lane form (a Newton step on 9 lanes, an orthogonal
    step on 12, every sum in the serial order) run lane by lane gives
    estimate_slot's bits in every slot, NaN in the same places; the batches
    hold an all-zero and a NaN slot a row."""
    d = _batch(seed, b, nq)
    got = host_pose(d, n_steps, lanes=True)
    want = host_pose(d, n_steps)
    for g, w in zip(got, want):
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        np.testing.assert_array_equal(g.view(np.int32)[~nan],
                                      w.view(np.int32)[~nan])
    assert np.isnan(want[2][:, -2:]).all()
    if n_steps:
        assert np.isfinite(want[2][:, :-2]).all()


@pytest.mark.parametrize("seed,b,nq", [(0, 3, 16), (4, 4, 128)])
def test_kernel_arithmetic_on_host(host_pose, seed, b, nq):
    """The kernel's slot arithmetic against the plain version and the JAX
    function, non-finite outputs in the same places."""
    d = _batch(seed, b, nq)
    got = host_pose(d)
    cands = tpose.pose_candidates_plain(*_torch_args(d))
    a = chip_smoke.pose_agreement("host kernel vs plain", got, cands, TAG)
    want = jpose.estimate_poses(jnp.asarray(d["H"]), TAG,
                                *(jnp.asarray(d[k]) for k in INTR))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g),
                                      np.isfinite(np.asarray(w)))
    print(f"seed {seed}: share of pose_limits used {a['limit_used']}")
    assert a["finite"] == b * (nq - 2)


def test_kernel_arithmetic_degenerate(host_pose):
    """n_steps = 0 keeps the homography start, as the plain version does,
    and an all-zero or NaN homography gives NaN everywhere."""
    d = _batch(5, 2, 8)
    args = _torch_args(d)
    for n_steps in (0, 1):
        got = host_pose(d, n_steps)
        want = tpose.estimate_poses_plain(*args, n_steps=n_steps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isfinite(g),
                                          torch.isfinite(w).numpy())
    r, t, e = host_pose(d, 50)
    assert np.isnan(r[:, -2:]).all() and np.isnan(t[:, -2:]).all()
    assert np.isnan(e[:, -2:]).all() and np.isfinite(e[:, :-2]).all()
