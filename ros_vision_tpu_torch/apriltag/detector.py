"""TorchDetector — the batched AprilTag detection pipeline in PyTorch.

Counterpart of ros_vision_tpu/apriltag/detector.py (TPUDetector): a
(B, H, W) uint8 batch of grayscale frames (one row per camera) becomes
fixed-shape per-quad detection tensors — ids, corners, homographies,
poses — packed into one (B, NQ, 36) f32 tensor for a single device->host
copy. Stages: K1 threshold, CCL ranks, K3 boundary compaction,
cluster_and_fit (K4 histograms), a loose decode screen, refine_edges,
decode, duplicate reconcile and pose. The CCL ranks come from the front
end the JAX detector's TPU path takes for the frame size
(ops/frontend_kernel.py frontend_route): K2 at 1280x800, the flood CCL
(K6 + K7) at 1920x1080. With use_pallas_sort, cluster_and_fit's four
sorts run on K9 (ops/sort_kernel.py) instead of torch.sort, with
bit-identical outputs.

On a CUDA tensor the hand-written kernels run; on a CPU tensor their
plain versions do. There is no other switch. PyTorch runs eagerly, so the
JAX package's device-side lax.cond/lax.switch choices become host reads
(counted in `host_syncs`); each branch computes exactly what the JAX
branch computes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ros_vision_tpu_torch.apriltag.families import TagFamily, get_family
from ros_vision_tpu_torch.device import HostSyncs
from ros_vision_tpu_torch.ops import decode as dec, pose as poseops
from ros_vision_tpu_torch.ops import quadfit
from ros_vision_tpu_torch.ops import threshold as thr
from ros_vision_tpu_torch.ops.frontend_kernel import frontend
from ros_vision_tpu_torch.ops.threshold_kernel import adaptive_threshold_fused

# The JAX DetectorConfig fields that only choose between bit-identical TPU
# implementations of the same stage; config_from_jax drops them.
# use_pallas_sort is kept: it routes cluster_and_fit's sorts through K9.
TPU_BACKEND_SWITCHES = ("use_pallas_threshold", "use_pallas_ccl",
                        "use_fused_frontend", "route_compaction")


@dataclasses.dataclass
class Detection:
    tag_id: int
    hamming: int
    decision_margin: float
    center: np.ndarray
    corners: np.ndarray
    H: np.ndarray
    pose_R: np.ndarray | None = None
    pose_t: np.ndarray | None = None
    pose_err: float | None = None


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Same fields and auto rules as the JAX DetectorConfig, minus the TPU
    backend switches of TPU_BACKEND_SWITCHES."""
    width: int = 1280
    height: int = 800
    family: str = "tag36h11"
    max_points: int | None = None    # K (None = auto, see TorchDetector)
    max_segments: int = 1024
    max_quads: int = 128
    refine_edges: bool = True
    estimate_pose: bool = True
    active_points: int | None = None  # narrow cluster_and_fit width (auto)
    screen_hamming: int | None = 4   # loose pre-decode gate (None: off)
    max_active_quads: int = 32       # refine/decode/pose slot budget
    tag_size: float = 0.1651         # meters
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # cluster_and_fit's four sorts through K9 (ops/sort_kernel.py) instead
    # of torch.sort; None or False = off, as the JAX detector resolves it
    use_pallas_sort: bool | None = None

    def __post_init__(self):
        if self.width % 8 or self.height % 8:
            raise ValueError("width/height must be multiples of 8")


def config_from_jax(d: dict) -> DetectorConfig:
    """DetectorConfig from dataclasses.asdict() of a JAX DetectorConfig.
    The four TPU backend switches are dropped: each only chose between
    TPU implementations of one stage that give bit-identical outputs, so
    they carry no state the port needs. use_pallas_sort is carried."""
    kw = {k: v for k, v in d.items() if k not in TPU_BACKEND_SWITCHES}
    kw["dist"] = tuple(kw.get("dist", (0.0,) * 5))
    return DetectorConfig(**kw)


def pack_outputs(out: dict) -> torch.Tensor:
    """Per-quad output dict -> ONE (B, NQ, C) f32 tensor. Layout: [ok,
    tag_id, hamming, margin, H(9), corners(8), centers(2) (+ pose_R(9),
    pose_t(3), pose_err)]."""
    b, nq = out["ok"].shape
    f32 = torch.float32
    parts = [out["ok"].to(f32)[..., None],
             out["tag_id"].to(f32)[..., None],
             out["hamming"].to(f32)[..., None],
             out["margin"][..., None],
             out["H"].reshape(b, nq, 9),
             out["corners"].reshape(b, nq, 8),
             out["centers"].reshape(b, nq, 2)]
    if "pose_t" in out:
        parts += [out["pose_R"].reshape(b, nq, 9),
                  out["pose_t"].reshape(b, nq, 3),
                  out["pose_err"][..., None]]
    return torch.cat(parts, dim=-1)


def unpack_outputs(packed) -> dict:
    """Host-side inverse of pack_outputs (numpy views of `packed`)."""
    p = np.asarray(packed)
    out = {
        "ok": p[..., 0] > 0.5,
        "tag_id": p[..., 1].astype(np.int32),
        "hamming": p[..., 2].astype(np.int32),
        "margin": p[..., 3],
        "H": p[..., 4:13].reshape(p.shape[:2] + (3, 3)),
        "corners": p[..., 13:21].reshape(p.shape[:2] + (4, 2)),
        "centers": p[..., 21:23],
    }
    if p.shape[-1] > 23:
        out["pose_R"] = p[..., 23:32].reshape(p.shape[:2] + (3, 3))
        out["pose_t"] = p[..., 32:35]
        out["pose_err"] = p[..., 35]
    return out


class PendingOutput:
    """A packed result on its way to the host: the pinned host tensor a
    non-blocking D2H copy writes, and the event recorded after the copy.
    TorchDetector.unpack waits on the event before it reads."""

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class TorchDetector:
    """Batched detector on one explicit device."""

    def __init__(self, config: DetectorConfig | None = None, *,
                 device, **kw):
        if config is None:
            config = DetectorConfig(**kw)
        if config.max_points is None:
            # dp//8 at production-class frames (32768 at 1280x800), dp//4
            # past 2^18 decimated px, power of two in [16384, 131072]
            dp = (config.height // 2) * (config.width // 2)
            div = 4 if dp > (1 << 18) else 8
            mp = 16384
            while mp < min(max(dp // div, 16384), 131072):
                mp *= 2
            config = dataclasses.replace(config, max_points=mp)
        self.config = config
        self.device = torch.device(device)
        self.family: TagFamily = get_family(config.family)
        self._code_matrix = torch.as_tensor(dec.make_code_matrix(self.family),
                                            device=self.device)
        self._qcfg = quadfit.QuadFitConfig(
            max_points=config.max_points,
            max_segments=config.max_segments,
            max_quads=config.max_quads,
            tag_width=max(3, self.family.border_size // dec.QUAD_DECIMATE),
            normal_border=not self.family.reversed_border,
            reversed_border=self.family.reversed_border,
            use_pallas_sort=bool(config.use_pallas_sort))
        ka = config.active_points
        if ka is None:
            ka = config.max_points // 4 if config.max_points >= 32768 \
                else config.max_points
        self._active_points = min(ka, config.max_points)
        self._qcfg_narrow = dataclasses.replace(
            self._qcfg, max_points=self._active_points)
        self.host_syncs = HostSyncs()
        self.use_mesh(None)

    def use_mesh(self, mesh: list | None) -> None:
        """Serve detect_raw / detect_raw_packed sharded over `mesh` (a list
        of devices, parallel/mesh.py: a detector and a worker thread per
        device, gathered on mesh[0]); None serves them unsharded here."""
        self.mesh = mesh
        if mesh is None:
            self._fn = self._detect_device
            self._fn_packed = self._detect_packed
            return
        from ros_vision_tpu_torch.parallel.mesh import (shard_detector,
                                                        shard_detector_packed)
        self._fn = shard_detector(self, mesh)
        self._fn_packed = shard_detector_packed(self, mesh)

    def default_intrinsics(self, batch: int) -> np.ndarray:
        """(B, 9) [fx, fy, cx, cy, k1, k2, p1, p2, k3] from the config."""
        cfg = self.config
        row = np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy, *cfg.dist],
                       np.float32)
        return np.tile(row, (batch, 1))

    # ---- the device pipeline ---------------------------------------------
    @torch.inference_mode()
    def _detect_device(self, gray: torch.Tensor, intr: torch.Tensor) -> dict:
        """gray (B, H, W) uint8; intr (B, 9) per-camera rows."""
        cfg = self.config
        decim, threshim = adaptive_threshold_fused(gray)
        pts, counts = frontend(threshim, cfg.max_points,
                               self._qcfg.max_boundary_pixels)
        return self._cluster_and_tail(gray, decim, pts, counts, intr)

    def _detect_packed(self, gray: torch.Tensor,
                       intr: torch.Tensor) -> torch.Tensor:
        return pack_outputs(self._detect_device(gray, intr))

    def _cluster_and_tail(self, gray, decim, pts, counts, intr):
        cfg = self.config
        syncs = self.host_syncs
        ka = self._active_points
        if ka < pts["key"].shape[1] and \
                syncs.item(counts.max()) <= ka:
            # valid points sit first, so the narrow width is exact when
            # every frame fits
            qf = quadfit.cluster_and_fit(
                {kk: v[:, :ka] for kk, v in pts.items()}, decim,
                self._qcfg_narrow, syncs)
        else:
            qf = quadfit.cluster_and_fit(pts, decim, self._qcfg, syncs)
        corners = dec.adjust_pixel_centers(qf["corners"])
        qvalid = qf["quad_valid"]

        fxs, fys, cxs, cys = (intr[:, i] for i in range(4))
        dist = intr[:, 4:9]
        use_dist = any(cfg.dist)

        def tail(corners, qvalid):
            c = corners
            if cfg.refine_edges:
                c = dec.refine_edges(
                    gray, c, qvalid, intr[:, :4] if use_dist else None,
                    dist if use_dist else None,
                    reversed_border=self.family.reversed_border,
                    syncs=syncs)
            d = dec.decode_quads(gray, c, qvalid, self.family,
                                 self._code_matrix)
            ok = d["ok"]
            H = d["H"]
            tcs = torch.tensor([[-1, 1], [1, 1], [1, -1], [-1, -1]],
                               dtype=torch.float32, device=gray.device)
            px, py = dec.project(H[..., None, :, :], tcs[:, 0], tcs[:, 1])
            det_corners = torch.stack([px, py], -1)         # (B, nq, 4, 2)
            cx0, cy0 = dec.project(H, 0.0, 0.0)
            centers = torch.stack([cx0, cy0], -1)

            # reconcile duplicates: same id + overlapping centers -> keep
            # the lowest hamming, then the highest margin
            score = d["hamming"].to(torch.float32) * 1e6 - d["margin"]
            score = torch.where(ok, score, torch.inf)
            diag = torch.linalg.norm(
                det_corners[:, :, 0] - det_corners[:, :, 2], dim=-1)
            cdist = torch.linalg.norm(centers[:, :, None, :]
                                      - centers[:, None, :, :], dim=-1)
            same = (d["tag_id"][:, :, None] == d["tag_id"][:, None, :]) & \
                (cdist < 0.5 * diag[:, :, None]) & \
                ok[:, :, None] & ok[:, None, :]
            nq = score.shape[1]
            ii = torch.arange(nq, device=gray.device)
            better = (score[:, None, :] < score[:, :, None]) | \
                ((score[:, None, :] == score[:, :, None])
                 & (ii[None, None, :] < ii[None, :, None]))
            loses = (same & better
                     & (ii[None, None, :] != ii[None, :, None])).any(-1)
            out = {"ok": ok & ~loses, "tag_id": d["tag_id"],
                   "hamming": d["hamming"], "margin": d["margin"], "H": H,
                   "corners": det_corners, "centers": centers}
            if cfg.estimate_pose and cfg.fx:
                R, t, err = poseops.estimate_poses(
                    H, cfg.tag_size, fxs, fys, cxs, cys)
                out.update({"pose_R": R, "pose_t": t, "pose_err": err})
            return out

        nq = cfg.max_quads
        na = cfg.max_active_quads
        if na >= nq:
            return tail(corners, qvalid)

        def padded(out, w):
            return {kk: torch.nn.functional.pad(
                v, [0, 0] * (v.ndim - 2) + [0, nq - w]) for kk, v in
                out.items()}

        # tail-width ladder: the narrowest tier whose slots hold every
        # candidate runs (exact either way)
        tiers = sorted({min(8, na), na})
        if cfg.refine_edges and cfg.screen_hamming is not None:
            # decode-gated refine: a loose decode of the unrefined corners
            # screens out quads that cannot become detections
            pre = dec.decode_quads(gray, corners, qvalid, self.family,
                                   self._code_matrix)
            screen = qvalid & (pre["hamming"] <= cfg.screen_hamming)
            prio = torch.where(screen, pre["margin"], -torch.inf)
            # lax.top_k order: descending, ties to the lower index
            top_idx = torch.sort(prio, dim=1, descending=True,
                                 stable=True)[1][:, :na]
            nscreen = syncs.item(screen.sum(dim=1).max())
            for w in tiers:
                if nscreen <= w:
                    idx = top_idx[:, :w]
                    c_n = torch.gather(corners, 1, idx[..., None, None]
                                       .expand(-1, -1, 4, 2))
                    v_n = torch.gather(screen, 1, idx)
                    return padded(tail(c_n, v_n), w)
            return tail(corners, qvalid)
        # no-refine path: quads are area-ordered, so the first w slots hold
        # every valid quad when each frame has at most w
        nvalid = syncs.item(qvalid.sum(dim=1).max())
        for w in tiers:
            if nvalid <= w:
                return padded(tail(corners[:, :w], qvalid[:, :w]), w)
        return tail(corners, qvalid)

    # ---- host API ----------------------------------------------------------
    def _inputs(self, gray_batch, intrinsics):
        g = torch.as_tensor(gray_batch, device=self.device)
        if g.ndim == 2:
            g = g[None]
        if intrinsics is None:
            intrinsics = self.default_intrinsics(g.shape[0])
        intr = torch.as_tensor(intrinsics, dtype=torch.float32,
                               device=self.device)
        return g.contiguous(), intr

    def detect_raw(self, gray_batch, intrinsics=None) -> dict:
        """Fixed-shape output dict on the device. intrinsics: (B, 9)
        per-camera rows; defaults from the config."""
        return self._fn(*self._inputs(gray_batch, intrinsics))

    def detect_raw_packed(self, gray_batch, intrinsics=None) -> torch.Tensor:
        """The single packed (B, NQ, C) f32 tensor (pack_outputs layout)."""
        return self._fn_packed(*self._inputs(gray_batch, intrinsics))

    def detect_yuyv(self, yuyv_batch, intrinsics=None) -> list:
        """Detect on raw YUYV422 frames (B, H, 2*W) uint8."""
        y = torch.as_tensor(yuyv_batch, device=self.device)
        single = y.ndim == 2
        if single:
            y = y[None]
        results = self.unpack(self.detect_raw(thr.yuyv_to_gray(y),
                                              intrinsics))
        return results[0] if single else results

    def detect(self, gray_batch, intrinsics=None) -> list:
        """Per batch row, a list of Detection sorted by tag id."""
        single = np.ndim(gray_batch) == 2
        results = self.unpack(self.detect_raw(gray_batch, intrinsics))
        return results[0] if single else results

    def unpack(self, raw_out) -> list:
        """Device output (dict, packed tensor or PendingOutput) -> per-row
        Detection lists (waits for the device->host copy)."""
        if isinstance(raw_out, PendingOutput):
            out = unpack_outputs(raw_out.wait().numpy())
        elif isinstance(raw_out, dict):
            out = {k: v.cpu().numpy() for k, v in raw_out.items()}
        else:
            out = unpack_outputs(raw_out.cpu().numpy())
        results = []
        for b in range(out["ok"].shape[0]):
            dets = []
            for q in np.nonzero(out["ok"][b])[0]:
                det = Detection(
                    tag_id=int(out["tag_id"][b, q]),
                    hamming=int(out["hamming"][b, q]),
                    decision_margin=float(out["margin"][b, q]),
                    center=out["centers"][b, q],
                    corners=out["corners"][b, q],
                    H=out["H"][b, q])
                if "pose_t" in out:
                    det.pose_R = out["pose_R"][b, q]
                    det.pose_t = out["pose_t"][b, q]
                    det.pose_err = float(out["pose_err"][b, q])
                dets.append(det)
            dets.sort(key=lambda d: d.tag_id)
            results.append(dets)
        return results
