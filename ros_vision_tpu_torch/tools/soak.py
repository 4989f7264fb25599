#!/usr/bin/env python
"""Randomized oracle soak of the port's detector: the port of
scripts/soak.py, with TorchDetector on --device (cuda, the first card, by
default) scored against the port's f64 OracleDetector on the host.

Profiles (scripts/soak.py's three):
  parity  each seed renders a randomized scene (1-3 tags, noise sigma 0-4,
          varied background/angles/sizes); the detector must decode the
          oracle's ids with the same hamming, corners within 1 px and poses
          within 2 cm (junk-margin extras and peak-tie divergences are
          reported, and fail only above the knife-edge budget);
  hard    lens distortion and tilts up to 65 degrees against ground truth:
          a decoded tag must have the right id and pose; with
          --audit-misses the oracle runs on every non-detection, and a miss
          the oracle does not share fails;
  gate    the decode gate's corner-perturbation sweep: any perturbation of
          <= 1.5 px whose unrefined decode is screened out (hamming > 4)
          while the refined decode is accepted (<= 2) fails.

Usage:
  python -m ros_vision_tpu_torch.tools.soak                  # 126 seeds
  python -m ros_vision_tpu_torch.tools.soak -n 500 -s 200 --profile hard \\
      --audit-misses
  SOAK_DET_KW='{"use_pallas_sort": true}' python -m ...soak  # config A/B

Exit code 0 = clean; 1 = any mismatch (each mismatch is printed).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

W, H = 320, 160
FX = FY = 300.0
CX, CY = 160.0, 80.0
JUNK_MARGIN = 10.0


def _det_kw_env() -> dict:
    """SOAK_DET_KW: JSON dict of DetectorConfig overrides, so configuration
    A/Bs run the same seed ranges without editing the harness."""
    raw = os.environ.get("SOAK_DET_KW", "")
    return json.loads(raw) if raw else {}


def _device(name: str):
    import torch

    from ros_vision_tpu_torch.device import require_cuda
    return require_cuda() if name == "cuda" else torch.device(name)


def run_parity(seeds: range, device) -> dict:
    """The parity profile; a summary dict ("failures" lists (seed, errors))."""
    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.apriltag.oracle import OracleDetector
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)

    det = TorchDetector(DetectorConfig(
        width=W, height=H, max_points=16384, max_segments=128, max_quads=16,
        fx=FX, fy=FY, cx=CX, cy=CY, estimate_pose=True, **_det_kw_env()),
        device=device)
    oracle = OracleDetector(fx=FX, fy=FY, cx=CX, cy=CY, estimate_pose=True)

    failures, junk_extras, tie_divergences = [], [], []
    t0 = time.time()
    for done, seed in enumerate(seeds, 1):
        rng = np.random.default_rng(seed)
        n_tags = int(rng.integers(1, 4))
        ids = rng.choice(587, n_tags, replace=False).tolist()
        corners = []
        xs = np.linspace(60, W - 60, n_tags)
        for i in range(n_tags):
            corners.append(simple_square_corners(
                xs[i] + rng.uniform(-10, 10), rng.uniform(55, H - 55),
                rng.uniform(22, 34), angle_deg=rng.uniform(-45, 45)))
        img, _ = render_scene(ids, corners, W, H,
                              noise_sigma=rng.uniform(0, 4),
                              background=int(rng.uniform(120, 220)),
                              seed=int(rng.integers(1 << 30)))
        o = oracle.detect(img).detections
        t = det.detect(img)
        errs = []
        # Detections of RENDERED ids need strict parity. Extras with a
        # junk-level decision margin (< 10; real tags measure 150-300) are
        # knife-edge junk quads, where f32 and f64 refine the same noise
        # to different places: reported, not failures.
        rendered = set(ids)
        t_real = {d.tag_id: d for d in t if d.tag_id in rendered}
        o_real = {d.tag_id: d for d in o if d.tag_id in rendered}
        extras = [("device", d) for d in t if d.tag_id not in rendered] + \
                 [("oracle", d) for d in o if d.tag_id not in rendered]
        if sorted(t_real) != sorted(o_real):
            errs.append(f"rendered-id sets device={sorted(t_real)} "
                        f"oracle={sorted(o_real)}")
        for side, d in extras:
            if d.decision_margin >= JUNK_MARGIN:
                errs.append(f"{side} extra id {d.tag_id} margin "
                            f"{d.decision_margin:.1f}")
            else:
                junk_extras.append((seed, side, d.tag_id,
                                    d.decision_margin))
                print(f"seed {seed}: junk-margin extra ({side} id "
                      f"{d.tag_id} margin {d.decision_margin:.1f}) — "
                      "reported, not a failure", flush=True)
        for tag_id in sorted(set(t_real) & set(o_real)):
            td, od = t_real[tag_id], o_real[tag_id]
            if td.hamming != od.hamming:
                errs.append(f"id {td.tag_id} hamming "
                            f"{td.hamming}!={od.hamming}")
            dc = float(np.abs(td.corners - od.corners).max())
            dp = None
            if td.pose_t is not None and od.pose_t is not None:
                dp = float(np.abs(np.asarray(td.pose_t)
                                  - np.asarray(od.pose_t)).max())
                if dp >= 0.02:
                    errs.append(f"id {td.tag_id} pose delta {dp:.4f}")
            if dc >= 1.0:
                # peak-tie divergence: under heavy noise the top-10 peak
                # threshold sits at a near-tie and f32 moment rounding can
                # pick another valid corner combination than the f64 oracle
                # (scripts/soak.py, seed 10298). Accepted only when the
                # operational outputs agree: equal hamming, pose within 1 cm.
                if td.hamming == od.hamming and dp is not None \
                        and dp < 0.01:
                    tie_divergences.append((seed, tag_id, dc, dp))
                    print(f"seed {seed}: peak-tie divergence (id {tag_id}"
                          f" corners {dc:.2f} px, pose {dp * 1e3:.1f} mm)"
                          " — reported, not a failure", flush=True)
                else:
                    errs.append(f"id {td.tag_id} corner delta {dc:.3f}")
        if errs:
            failures.append((seed, errs))
            print(f"seed {seed}: MISMATCH {errs}", flush=True)
        if done % 10 == 0:
            print(f"[{done}/{len(seeds)}] {len(failures)} failures "
                  f"({time.time() - t0:.0f}s)", flush=True)

    n = len(seeds)
    # knife-edge events are expected at ~1e-4 a seed; a rate above the
    # budget is a systematic regression, not knife-edge noise
    junk_cap = max(2, n // 200)
    print(f"\n{n} seeds, {len(failures)} failures, "
          f"{len(junk_extras)} junk-margin extras, "
          f"{len(tie_divergences)} peak-tie divergences, "
          f"{time.time() - t0:.0f}s")
    over = []
    if len(junk_extras) > junk_cap:
        over.append("junk-extra")
    if len(tie_divergences) > junk_cap:
        over.append("peak-tie")
    for what in over:
        print(f"{what} rate exceeds the knife-edge budget ({junk_cap}) — "
              "treating as failure")
    return dict(profile="parity", seeds=n, failures=failures,
                junk_extras=len(junk_extras),
                tie_divergences=len(tie_divergences),
                seconds=time.time() - t0,
                ok=not failures and not over)


def run_gate(seeds: range, device) -> dict:
    """The gate profile (scripts/soak.py run_gate): per seed, one tag
    (half-width 22-80 px, any angle, noise 0-2.5) at 640x400; its detected
    corners perturbed by 64 random offsets at each magnitude; a loss is an
    unrefined best-code hamming > 4 (screened out by screen_hamming=4)
    whose refined decode is accepted."""
    import torch

    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.apriltag.families import get_family
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)
    from ros_vision_tpu_torch.ops import decode as dec

    gw, gh = 640, 400
    det = TorchDetector(DetectorConfig(
        width=gw, height=gh, fx=600.0, fy=600.0, cx=320.0, cy=200.0,
        max_points=65536, max_segments=512, max_quads=32,
        estimate_pose=False), device=device)
    fam = get_family()
    cm = torch.as_tensor(dec.make_code_matrix(fam), device=device)
    mags = tuple(float(x) for x in os.environ.get(
        "SOAK_GATE_MAGS", "0.5,1.0,1.5,2.0,2.5,3.0").split(","))
    n_pert = 64

    @torch.inference_mode()
    def gate_fn(gray, quads):
        valid = torch.ones(quads.shape[:2], dtype=torch.bool, device=device)
        pre = dec.decode_quads(gray, quads, valid, fam, cm)
        refined = dec.refine_edges(gray, quads, valid, None, None)
        post = dec.decode_quads(gray, refined, valid, fam, cm)
        return pre["hamming"], post["hamming"], post["ok"]

    losses_at = {m: 0 for m in mags}
    cases = 0
    t0 = time.time()
    for done, seed in enumerate(seeds, 1):
        rng = np.random.default_rng(10_000 + seed)
        half = rng.uniform(22, 80)
        img, _ = render_scene(
            [int(rng.integers(0, 587))],
            [simple_square_corners(rng.uniform(150, gw - 150),
                                   rng.uniform(120, gh - 120), half,
                                   angle_deg=rng.uniform(-45, 45))],
            gw, gh, noise_sigma=rng.uniform(0, 2.5),
            seed=int(rng.integers(1 << 30)))
        dets = det.detect(img)
        if len(dets) != 1:
            continue
        base = np.asarray(dets[0].corners, np.float64)
        gray = torch.as_tensor(img, device=device)[None]
        for mag in mags:
            theta = rng.uniform(0, 2 * np.pi, (n_pert, 4))
            offs = mag * np.stack([np.cos(theta), np.sin(theta)], -1)
            quads = torch.as_tensor((base[None] + offs)[None],
                                    dtype=torch.float32, device=device)
            pre_h, post_h, post_ok = (x[0].cpu().numpy()
                                      for x in gate_fn(gray, quads))
            losses_at[mag] += int(((pre_h > 4) & (post_h <= 2)
                                   & post_ok).sum())
            cases += n_pert
        if done % 10 == 0:
            print(f"[{done}/{len(seeds)}] losses={losses_at} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print(f"\ngate profile: {len(seeds)} seeds x {n_pert} perturbations x "
          f"{len(mags)} magnitudes ({cases} decode pairs), "
          f"{time.time() - t0:.0f}s")
    print(f"gate losses by perturbation magnitude: {losses_at}")
    thr = min((m for m, n in losses_at.items() if n), default=None)
    if thr is None:
        print(f"no gate loss at any magnitude <= {max(mags)} px")
    else:
        print(f"smallest magnitude with a gate loss: {thr} px "
              f"(quadfit worst observed corner error is sub-0.5 px)")
    # a failure only where losses appear at quadfit-plausible magnitudes
    return dict(profile="gate", seeds=len(seeds), cases=cases,
                losses=losses_at, seconds=time.time() - t0,
                ok=not any(n for m, n in losses_at.items() if m <= 1.5))


def run_hard(seeds: range, device, audit_misses: bool = False) -> dict:
    """The hard profile (scripts/soak.py run_hard): distortion and shallow
    tilts against ground truth. A case fails when the tag decodes with the
    wrong id, a pose off by 2 cm (6 cm with distortion) or, below 55
    degrees of tilt, a flipped normal; with audit_misses, also when the
    oracle detects a tag the device missed."""
    from scipy.spatial.transform import Rotation

    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.apriltag.oracle import OracleDetector
    from ros_vision_tpu_torch.apriltag.render import (project_tag_corners,
                                                      render_scene)

    tag = 0.1651
    # the distortion palette of scripts/soak.py (its detector specialises
    # on the static distortion)
    dist_palette = [np.zeros(5),
                    np.array([-0.25, 0.08, 0.0, 0.0, 0.0]),
                    np.array([-0.12, 0.03, 0.0, 0.0, 0.0]),
                    np.array([0.08, -0.02, 0.0, 0.0, 0.0])]
    failures, missed, scored, oracle_missed = [], 0, 0, 0
    t0 = time.time()
    det_cache = {}
    for done, seed in enumerate(seeds, 1):
        rng = np.random.default_rng(10_000 + seed)
        dist = dist_palette[int(rng.integers(0, len(dist_palette)))]
        use_dist = bool(np.any(dist))
        tilt = rng.uniform(0, 65)
        yaw = rng.uniform(-30, 30)
        roll = rng.uniform(-180, 180)
        rot = Rotation.from_euler(
            "xyz", [tilt, yaw, roll], degrees=True).as_matrix()
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05),
                      rng.uniform(0.6, 1.4)])
        corners = project_tag_corners(rot, t, tag, FX, FY, CX, CY,
                                      dist=dist if use_dist else None)
        if (corners < 8).any() or (corners[:, 0] > W - 8).any() \
                or (corners[:, 1] > H - 8).any():
            continue                      # partially out of frame: skip
        scored += 1
        tag_id = int(rng.integers(0, 587))
        img, _ = render_scene([tag_id], [corners], W, H,
                              noise_sigma=rng.uniform(0, 2),
                              seed=int(rng.integers(1 << 30)))
        key = tuple(np.round(dist, 6))
        if key not in det_cache:
            det_cache[key] = TorchDetector(DetectorConfig(
                width=W, height=H, max_points=16384, max_segments=128,
                max_quads=16, fx=FX, fy=FY, cx=CX, cy=CY,
                dist=tuple(dist) if use_dist else (0.0,) * 5,
                estimate_pose=True), device=device)
        res = det_cache[key].detect(img)
        if not res:
            missed += 1
            if audit_misses:
                # recall parity: a miss is acceptable only if the f64
                # oracle misses the same scene
                ok = OracleDetector(
                    fx=FX, fy=FY, cx=CX, cy=CY,
                    dist=tuple(dist) if use_dist else None).detect(
                        img).detections
                if any(d.tag_id == tag_id for d in ok):
                    failures.append((seed, ["device-specific miss: oracle "
                                            f"detects id {tag_id}"]))
                    print(f"seed {seed}: DEVICE-SPECIFIC MISS (oracle "
                          f"detects {tag_id}, tilt {tilt:.0f})",
                          flush=True)
                else:
                    oracle_missed += 1
            continue
        errs = []
        d = res[0]
        if d.tag_id != tag_id:
            errs.append(f"id {d.tag_id} != {tag_id}")
        elif d.pose_t is not None:
            dp = float(np.linalg.norm(np.asarray(d.pose_t) - t))
            tol = 0.06 if use_dist else 0.02
            if dp >= tol:
                errs.append(f"pose err {dp:.4f} (tilt {tilt:.0f}, "
                            f"dist={use_dist})")
            dotz = float(np.asarray(d.pose_R)[:, 2] @ rot[:, 2])
            if tilt < 55 and dotz < 0.9:
                errs.append(f"normal flipped (dot {dotz:.2f}, "
                            f"tilt {tilt:.0f})")
        if errs:
            failures.append((seed, errs))
            print(f"seed {seed}: MISMATCH {errs}", flush=True)
        if done % 20 == 0:
            print(f"[{done}/{len(seeds)}] {len(failures)} failures, "
                  f"{missed} missed ({time.time() - t0:.0f}s)", flush=True)
    print(f"\nhard profile: {len(seeds)} seeds, {len(failures)} failures, "
          f"{missed} non-detections, {time.time() - t0:.0f}s")
    return dict(profile="hard", seeds=len(seeds), scored=scored,
                failures=failures, missed=missed,
                oracle_missed=oracle_missed if audit_misses else None,
                seconds=time.time() - t0, ok=not failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Randomized oracle soak of the port's detector")
    ap.add_argument("-n", "--seeds", type=int, default=126)
    ap.add_argument("-s", "--start", type=int, default=0)
    ap.add_argument("--audit-misses", action="store_true",
                    help="hard profile: run the f64 oracle on every "
                         "non-detection and fail on device-specific misses")
    ap.add_argument("--profile", choices=["parity", "hard", "gate"],
                    default="parity",
                    help="parity: randomized scenes vs the f64 oracle; "
                         "hard: lens distortion + shallow tilts vs ground "
                         "truth; gate: decode-gate corner-perturbation "
                         "sweep")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the detector under test (the oracle "
                         "runs on the host either way); cuda is the first "
                         "card, and raises without one")
    args = ap.parse_args(argv)
    device = _device(args.device)
    seeds = range(args.start, args.start + args.seeds)
    if args.profile == "hard":
        res = run_hard(seeds, device, args.audit_misses)
    elif args.profile == "gate":
        res = run_gate(seeds, device)
    else:
        res = run_parity(seeds, device)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
