#!/usr/bin/env python3
"""K1 adaptive_threshold, K2 rank_image, K3 boundary_compact, K4
value_histogram, K6 propagate_fixpoint, K7 label_histogram, K8 propagate,
K9 sort_tpu, K10 table_take_cm and K11 segment_min_max of several
checkouts of the port, timed on one CUDA card on the same inputs, the
device time apart from the host's enqueue.

    python3 scripts/mb_torch_kernel_versions.py ROOT [ROOT ...]

Each ROOT is the top of a checkout that holds ros_vision_tpu_torch/ (`.`
for this one), for instance an older commit unpacked with `git archive`
under build/. First, with this checkout's package, one process captures
the inputs one use_pallas_sort cluster_and_fit call gives K4 and K9 on
chip_smoke.py's bench batches at B = 4: the segment ids and peak
segments at (4, 32768) (1280x800) and (4, 131072) (1920x1080), and the
four sorts' operands at both widths; and the threshold planes of those
batches and of the clutter frames, K2's at 640x400 and K6's at 960x540
(with the flat pixel indices as values, as label_components_flood passes
them); K1's gray frames (those batches and clutter frames) and K3's
threshold planes, plain ranks and detector caps (K and the stage-A cap
3K/4); K7's (4, 518400) labels at 960x540 (the converged flood labels
of the 1920x1080 bench batch and of four clutter frames, and random
labels with some outside [0, N)) and K8's 640x400 planes (the 1280x800
bench batch and four spiral planes, flat indices, 448 sweeps), which
scripts/mb_torch_flood_phases.py takes too (flood_inputs); K10's and
K11's inputs at chip_smoke.py's shapes (K11 also random, and K4 on K11's
sorted ids), which scripts/mb_torch_gather_phases.py takes too
(gather_inputs); P1's and P2's inputs (pose_inputs, refine_inputs):
chip_smoke.py's pose cases (the homographies one TorchDetector call hands
estimate_poses on each bench batch, the 8-slot tier, the same padded to
128 slots, seeded_homographies(4, 128) and one slot) and the corners one
call hands refine_edges on each bench batch at the path's tier, with and
without LENS_DIST, with a NaN slot a row, at 128 samples and one slot.
Then each
ROOT, in the order given
(so "OLD . . OLD" takes them in turns), runs in a process of its own that
imports that root's package, builds its kernels, checks every call
bit-exact against the root's plain version (P1 within chip_smoke.
pose_limits, P2 within chip_smoke.REFINE_LIMIT_PX) and times it with
chip_smoke.both_ms: device_ms (calls queued behind a torch.cuda._sleep)
and call_ms (one call between CUDA events, the enqueue included), and
saves P1's and P2's outputs. Prints one JSON line per root and input, then
whether P1's outputs are bit-identical across the roots and P2's largest
corner difference across them, then the card's name and power limit;
exits nonzero without a card or if a root's kernel disagrees.

    python3 scripts/mb_torch_kernel_versions.py --only pose,refine ROOT ...

takes only the named groups of inputs (hist, sort, ccl, threshold,
boundary, flood, gather, pose, refine).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INPUTS = ROOT / "build" / "mb_torch_kernel_versions" / "inputs.pt"
GROUPS = ("hist", "sort", "ccl", "threshold", "boundary", "flood", "gather",
          "pose", "refine")
SIZES = {"1280x800": 32768, "1920x1080": 131072}   # cluster_and_fit width


def timing_helpers():
    """This checkout's chip_smoke.py (its timing and scene functions),
    loaded from its file so that ros_vision_tpu_torch still resolves to
    the root under test."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(only: tuple = GROUPS) -> None:
    """Save the inputs of the groups `only` names."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    cs = timing_helpers()
    dev = require_cuda()
    saved = {"hist": {}, "sort": {}, "ccl": {}, "threshold": {},
             "boundary": {}, "flood": {}}
    for label, k in (SIZES if set(only) & {
            "hist", "sort", "ccl", "threshold", "boundary"} else {}).items():
        w, h, noise = ((cs.W, cs.H, 1.0) if k == 32768
                       else (cs.W2, cs.H2, cs.NOISE_1080))
        g = torch.from_numpy(np.stack([cs.bench_scene(seed, w, h, noise)[0]
                                       for seed in range(4)])).to(dev)
        decim, th = tk.adaptive_threshold_plain(g)
        kernel = "rank_image" if k == 32768 else "propagate_fixpoint"
        clutter = torch.from_numpy(cs.clutter_frame(width=w, height=h)[None])
        saved["ccl"][f"{w // 2}x{h // 2} B=4 bench"] = (kernel, th.cpu())
        saved["ccl"][f"{w // 2}x{h // 2} B=1 clutter"] = (
            kernel, tk.adaptive_threshold_plain(clutter.to(dev))[1].cpu())
        ranks = fk.label_components_plain(th)[2].view(th.shape)
        p_cap = qf.QuadFitConfig(max_points=k).max_boundary_pixels
        th_c = tk.adaptive_threshold_plain(clutter.to(dev))[1]
        saved["threshold"][f"{label} B=4 bench"] = g.cpu()
        saved["threshold"][f"{label} B=1 clutter"] = clutter
        saved["boundary"][f"{label} B=4 bench"] = (th.cpu(), ranks.cpu(),
                                                   p_cap, k)
        saved["boundary"][f"{label} B=1 clutter"] = (
            th_c.cpu(), fk.label_components_plain(th_c)[2].view(
                th_c.shape).cpu(), p_cap, k)
        key, pack2, _ = fk.boundary_compact(th, ranks, p_cap, k)
        calls = cs.capture_calls({"key": key, "pack2": pack2}, decim, k)
        at = f"{label} B=4 K={k}"
        saved["hist"][f"{at} (segment ids)"] = calls["hists"][0].cpu()
        saved["hist"][f"{at} (peak segments)"] = calls["hists"][1].cpu()
        saved["sort"][at] = [([o.cpu() for o in ops], nk)
                             for ops, nk in calls["sorts"]]
    if "flood" in only:
        saved["flood"] = {f"{kernel} {at}": (kernel, x)
                          for kernel, xs in flood_inputs(cs, dev).items()
                          for at, x in xs.items()}
    if "gather" in only:
        saved["gather"] = gather_inputs(cs, dev)
    if "pose" in only:
        saved["pose"] = pose_inputs(cs, dev)
    if "refine" in only:
        saved["refine"] = refine_inputs(cs, dev)
    saved = {g: saved.get(g, {}) if g in only else {} for g in GROUPS}
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


def bench_batches(cs) -> dict:
    """chip_smoke.py's bench batches at B = 4, both sizes (numpy)."""
    import numpy as np
    return {"1280x800 B=4": np.stack([cs.bench_scene(s)[0]
                                      for s in range(4)]),
            "1920x1080 B=4": np.stack([cs.bench_scene(
                s, cs.W2, cs.H2, cs.NOISE_1080)[0] for s in range(4)])}


def pose_inputs(cs, dev) -> dict:
    """P1's inputs as chip_smoke.py's kernel phase takes them: {at: (H,
    tag_size, [fx, fy, cx, cy])} on the CPU."""
    import torch
    out = {}
    for at, frames in bench_batches(cs).items():
        h, tag_size, *intr = cs.capture_pose_args(dev, frames)
        intr = [v.cpu() for v in intr]
        out[f"{at}, 8-slot tier"] = (h.cpu(), tag_size, intr)
        out[f"{at}, padded to 128 slots"] = (torch.nn.functional.pad(
            h, (0, 0, 0, 0, 0, 128 - h.shape[1])).cpu(), tag_size, intr)
    seeded = cs.seeded_homographies(4, 128)
    out["seeded 4x128"] = (torch.from_numpy(seeded["H"]), tag_size,
                           [torch.from_numpy(seeded[k])
                            for k in ("fx", "fy", "cx", "cy")])
    h, tag_size, intr = out["1280x800 B=4, 8-slot tier"]
    out["one slot"] = (h[:1, :1].contiguous(), tag_size,
                       [v[:1] for v in intr])
    return out


def refine_inputs(cs, dev) -> dict:
    """P2's inputs as chip_smoke.py's kernel phase times them: {at: (gray,
    corners, quad_valid, (B, 9) intrinsics row or None, n_alpha)} on the
    CPU: the corners one TorchDetector call hands refine_edges on each
    bench batch at its tier, without and with LENS_DIST (the lens centred
    on the frame), the same with the last slot of each row NaN, 128
    samples, and one slot."""
    import torch
    from ros_vision_tpu_torch.ops import decode as dec
    out = {}
    for at, frames in bench_batches(cs).items():
        g, c, v, _ = cs.capture_refine_args(dev, frames)
        b = c.shape[0]
        row = torch.tensor([[*cs.lens_for(g.shape[2], g.shape[1]).values(),
                             *cs.LENS_DIST]] * b, dtype=torch.float32)
        tier = dec.REFINE_ALPHA_TIERS[dec.refine_tier(c, v)]
        nan = c.clone()
        nan[:, -1] = float("nan")
        g, c, v, nan = g.cpu(), c.cpu(), v.cpu(), nan.cpu()
        for lens_at, lens in (("dist 0", None), ("LENS_DIST", row)):
            out[f"{at}, {lens_at}, 8-slot tier, {tier} samples"] = (
                g, c, v, lens, tier)
            out[f"{at}, {lens_at}, 8-slot tier with a NaN slot a row, "
                f"{tier} samples"] = (g, nan, v, lens, tier)
        if at.startswith("1280x800"):
            out[f"{at}, LENS_DIST, 8-slot tier, 128 samples"] = (
                g, c, v, row, 128)
            out[f"1280x800, LENS_DIST, one slot, {tier} samples"] = (
                g[:1], c[:1, :1].contiguous(), v[:1, :1].contiguous(),
                row[:1], tier)
    return out


def pose_call(xs):
    """(P1 call, its outputs, the plain version's candidates) on saved
    inputs on the card."""
    from ros_vision_tpu_torch.ops import pose
    h, tag_size, intr = xs
    return (lambda: pose.estimate_poses(h, tag_size, *intr),
            pose.estimate_poses(h, tag_size, *intr),
            pose.pose_candidates_plain(h, tag_size, *intr))


def refine_call(xs):
    """(P2 call, its corners, the plain version's) on saved inputs on the
    card."""
    from ros_vision_tpu_torch.ops import decode as dec
    g, c, v, row, n_alpha = xs
    lens = (None, None) if row is None else (row[:, :4], row[:, 4:9])
    return (lambda: dec._refine_edges_cuda(g, c, v, *lens, n_alpha),
            dec._refine_edges_cuda(g, c, v, *lens, n_alpha),
            dec.refine_edges_plain(g, c, v, *lens, n_alpha))


def flood_inputs(cs, dev) -> dict:
    """K7's (4, 518400) labels at 960x540 (the decimated 1920x1080 frame):
    the converged flood labels of chip_smoke.py's bench batch and of four
    of its clutter frames (seeds 7-10), and random labels in [-1000,
    N + 5000) with -1, N and INT32_MAX among them; K8's 640x400 planes
    (the decimated 1280x800 frame, B=4): the bench batch and four spiral
    planes. {kernel: {input: CPU tensor}}; cs is chip_smoke.py."""
    import numpy as np
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import threshold_kernel as tk

    def thresh(gray):
        return tk.adaptive_threshold_plain(torch.from_numpy(
            np.ascontiguousarray(gray)).to(dev))[1]

    def converged(th):
        b, h, w = th.shape
        flat = torch.arange(h * w, dtype=torch.int32, device=dev)
        flat = flat.view(1, h, w).expand(b, h, w).contiguous()
        return ccl.propagate_fixpoint(th, flat).view(b, -1).cpu()

    bench = thresh(np.stack([cs.bench_scene(s, cs.W2, cs.H2,
                                            cs.NOISE_1080)[0]
                             for s in range(4)]))
    clutter = thresh(np.stack([cs.clutter_frame(s, cs.W2, cs.H2)
                               for s in range(7, 11)]))
    n = bench.shape[1] * bench.shape[2]
    rnd = np.random.default_rng(5).integers(-1000, n + 5000, (4, n))
    rnd[:, :3] = [-1, n, 2 ** 31 - 1]
    return {
        "label_histogram": {
            "960x540 B=4 bench labels": converged(bench),
            "960x540 B=4 clutter labels": converged(clutter),
            "960x540 B=4 random labels": torch.from_numpy(
                rnd.astype(np.int32))},
        "propagate": {
            "640x400 B=4 bench, 448 sweeps": thresh(np.stack(
                [cs.bench_scene(s)[0] for s in range(4)])).cpu(),
            "640x400 B=4 spiral, 448 sweeps": torch.from_numpy(np.repeat(
                cs.spiral_plane(cs.H // 2, cs.W // 2), 4, 0))}}


def gather_inputs(cs, dev) -> dict:
    """K10's and K11's inputs at chip_smoke.py's shapes: K10 gathers a
    (4, 1025, 4) f32 table (normal, sigma 100) at the (4, 32768) segment
    ids of one use_pallas_sort cluster_and_fit call on the 1280x800 bench
    batch; K11 takes the (4, 131072) segment ids of the 1920x1080 bench
    batch's points sorted by key with their y coordinates (sorted ids in
    [0, 1024]), and random ids in [-20, 1045) with values over the whole
    int32 range. {input: (kernel, CPU tensors)}; cs is chip_smoke.py."""
    import numpy as np
    import torch
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import segments as segs
    from ros_vision_tpu_torch.ops import threshold_kernel as tk

    def points(w, h, noise, k):
        g = torch.from_numpy(np.stack([cs.bench_scene(seed, w, h, noise)[0]
                                       for seed in range(4)])).to(dev)
        decim, th = tk.adaptive_threshold_plain(g)
        ranks = fk.label_components_plain(th)[2].view(th.shape)
        p_cap = qf.QuadFitConfig(max_points=k).max_boundary_pixels
        key, pack2, _ = fk.boundary_compact(th, ranks, p_cap, k)
        return key, pack2, decim

    rng = np.random.default_rng(3)
    key, pack2, decim = points(cs.W, cs.H, 1.0, 32768)
    ids = cs.capture_calls({"key": key, "pack2": pack2}, decim,
                           32768)["hists"][0]
    table = torch.from_numpy(rng.normal(0, 100, (4, 1025, 4)).astype(
        np.float32))
    key_s, pack2_s = qf._sort2(*points(cs.W2, cs.H2, cs.NOISE_1080,
                                       131072)[:2])
    seg = segs.segment_ids_from_sorted_keys(
        key_s, valid=key_s < qf.KEY_INVALID, max_segments=1024)
    y = qf.unpack_payload(pack2_s)[1].contiguous()
    rnd_seg = rng.integers(-20, 1045, (4, 131072)).astype(np.int32)
    rnd_val = rng.integers(-2 ** 31, 2 ** 31 - 1, (4, 131072),
                           dtype=np.int64).astype(np.int32)
    return {
        "1280x800 B=4 S=1025 C=4 K=32768": (
            "table_take_cm", (table, ids.cpu())),
        "1920x1080 B=4 S=1025 K=131072 (sorted ids)": (
            "segment_min_max", (seg.cpu(), y.cpu())),
        "1920x1080 B=4 S=1025 K=131072 (random ids)": (
            "segment_min_max", (torch.from_numpy(rnd_seg),
                                torch.from_numpy(rnd_val))),
        "1920x1080 B=4 K=131072 (K11's sorted ids)": (
            "value_histogram", (seg.cpu(),))}


def gather_calls(kernel: str, xs):
    """(kernel call, its outputs, the plain version's outputs) of K10, K11
    or K4 (1025 bins) on the saved inputs xs."""
    from ros_vision_tpu_torch.ops import gather_kernel as gk
    if kernel == "table_take_cm":
        return (lambda: gk.take_cm(*xs), (gk.take_cm(*xs),),
                (gk.table_take_cm_plain(*xs),))
    if kernel == "segment_min_max":
        return (lambda: gk.segment_min_max(*xs, 1025),
                gk.segment_min_max(*xs, 1025),
                gk.segment_min_max_plain(*xs, 1025))
    return (lambda: gk.histogram(*xs, 1025), (gk.histogram(*xs, 1025),),
            (gk.value_histogram_plain(*xs, 1025),))


def ccl_calls(kernel: str, th):
    """(kernel call, its outputs, the plain version's outputs) of K2 or K6
    on the threshold plane th (K6 on the flat pixel indices)."""
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    if kernel == "rank_image":
        return (lambda: fk.rank_image(th), fk.label_components(th),
                fk.label_components_plain(th))
    b, h, w = th.shape
    flat = torch.arange(h * w, dtype=torch.int32, device=th.device)
    flat = flat.view(1, h, w).expand(b, h, w).contiguous()
    return (lambda: ck.propagate_fixpoint(th, flat),
            (ck.propagate_fixpoint(th, flat),),
            (ccl.propagate_fixpoint(th, flat),))


def flood_calls(kernel: str, x):
    """(kernel call, its outputs, the plain version's outputs) of K7 on
    labels x or of K8 on the plane x (flat indices, 448 sweeps)."""
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    if kernel == "label_histogram":
        return (lambda: ck.label_histogram(x), (ck.label_histogram(x),),
                (ccl.label_histogram(x),))
    b, h, w = x.shape
    flat = torch.arange(h * w, dtype=torch.int32, device=x.device)
    flat = flat.view(1, h, w).expand(b, h, w).contiguous()
    return (lambda: ck.propagate(x, flat, 448),
            (ck.propagate(x, flat, 448),), (ccl.propagate(x, flat, 448),))


def time_root(root: Path, out_path: Path) -> None:
    """Check and time root's kernels on the saved inputs; save P1's and
    P2's outputs to out_path."""
    sys.path.insert(0, str(root))
    import torch
    import ros_vision_tpu_torch
    cs = timing_helpers()
    cs.check(Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), f"ros_vision_tpu_torch imported from "
        f"{ros_vision_tpu_torch.__file__}, not from {root}")
    from ros_vision_tpu_torch.ops import gather_kernel as gk
    from ros_vision_tpu_torch.ops import sort_kernel as sk
    dev = torch.device("cuda", 0)
    saved = torch.load(INPUTS)
    rows = []
    for at, v in saved["hist"].items():
        v = v.to(dev)
        cs.check(torch.equal(gk.histogram(v, 1025),
                             gk.value_histogram_plain(v, 1025)),
                 f"{root}: value_histogram differs at {at}")
        rows.append(("value_histogram", at,
                     cs.both_ms(lambda: gk.histogram(v, 1025))))
    for at, sorts in saved["sort"].items():
        for ops, nk in sorts:
            ops = [o.to(dev) for o in ops]
            got, want = sk.sort_tpu(ops, nk), sk.sort_plain(ops, nk)
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"{root}: sort_tpu differs at {at}, {len(ops)} planes")
            rows.append(("sort_tpu", f"{at}, {len(ops)} plane(s)",
                         cs.both_ms(lambda: sk.sort_tpu(ops, nk))))
    for at, (kernel, th) in saved["ccl"].items():
        run, got, want = ccl_calls(kernel, th.to(dev))
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{root}: {kernel} differs at {at}")
        rows.append((kernel, at, cs.both_ms(run)))
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    for at, g in saved["threshold"].items():
        g = g.to(dev)
        cs.max_abs_err(f"{root}: adaptive_threshold at {at}",
                       tk.adaptive_threshold_fused(g),
                       tk.adaptive_threshold_plain(g))
        rows.append(("adaptive_threshold", at,
                     cs.both_ms(lambda: tk.adaptive_threshold_fused(g))))
    for at, (th, ranks, p_cap, k) in saved["boundary"].items():
        th, ranks = th.to(dev), ranks.to(dev)
        pts, counts = qf.boundary_points_capped(
            th, ranks.reshape(th.shape[0], -1), p_cap, k)
        cs.max_abs_err(f"{root}: boundary_compact at {at}",
                       fk.boundary_compact(th, ranks, p_cap, k),
                       (pts["key"], pts["pack2"], counts))
        rows.append(("boundary_compact", at, cs.both_ms(
            lambda: fk.boundary_compact(th, ranks, p_cap, k))))
    for at, (kernel, x) in saved["flood"].items():
        run, got, want = flood_calls(kernel, x.to(dev))
        cs.max_abs_err(f"{root}: {at}", got, want)
        rows.append((kernel, at, cs.both_ms(run)))
    for at, (kernel, xs) in saved["gather"].items():
        run, got, want = gather_calls(kernel, [x.to(dev) for x in xs])
        cs.max_abs_err(f"{root}: {kernel} at {at}", got, want)
        rows.append((kernel, at, cs.both_ms(run)))
    outputs = {"pose": {}, "refine": {}}
    for at, xs in saved["pose"].items():
        h, tag_size, intr = xs
        run, got, cands = pose_call((h.to(dev), tag_size,
                                     [v.to(dev) for v in intr]))
        cs.pose_agreement(f"{root}: estimate_poses at {at}", got, cands,
                          tag_size)
        outputs["pose"][at] = [x.cpu() for x in got]
        rows.append(("estimate_poses", at, cs.both_ms(run)))
    for at, xs in saved["refine"].items():
        run, got, want = refine_call([None if x is None else x.to(dev)
                                      if isinstance(x, torch.Tensor) else x
                                      for x in xs])
        cs.refine_err(f"{root}: refine_edges at {at}", got, want)
        outputs["refine"][at] = got.cpu()
        rows.append(("refine_edges", at, cs.both_ms(run)))
    for kernel, at, t in rows:
        print(json.dumps(dict(root=str(root), kernel=kernel, at=at, **t)))
    torch.save(outputs, out_path)


def compare_outputs(paths: list) -> None:
    """Print whether P1's outputs are bit-identical across the roots and
    P2's largest corner difference across them, input by input."""
    import torch
    runs = [torch.load(p) for p in paths]
    for at in runs[0]["pose"]:
        bits = [[x.contiguous().view(torch.int32) for x in r["pose"][at]]
                for r in runs]
        same = all(torch.equal(a, b) for other in bits[1:]
                   for a, b in zip(bits[0], other))
        print(json.dumps(dict(kernel="estimate_poses", at=at,
                              bit_identical_across_roots=same)))
    for at in runs[0]["refine"]:
        first = runs[0]["refine"][at]
        fin = torch.isfinite(first)
        worst, same_places = 0.0, True
        for r in runs[1:]:
            other = r["refine"][at]
            same_places &= torch.equal(torch.isfinite(other), fin)
            if fin.any():
                worst = max(worst, float((other[fin] - first[fin]).abs()
                                         .max()))
        print(json.dumps(dict(kernel="refine_edges", at=at,
                              max_corner_diff_across_roots_px=worst,
                              non_finite_in_the_same_places=same_places)))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture(tuple(argv[1].split(",")))
        return 0
    if argv[:1] == ["--time"]:
        time_root(Path(argv[1]), Path(argv[2]))
        return 0
    only = GROUPS
    if argv[:1] == ["--only"]:
        only, argv = tuple(argv[1].split(",")), argv[2:]
        if not set(only) <= set(GROUPS):
            print(f"--only takes groups of {GROUPS}", file=sys.stderr)
            return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture", ",".join(only)], check=True)
    outs = [INPUTS.parent / f"outputs_{i}.pt" for i in range(len(argv))]
    for root, out in zip(argv, outs):
        run = subprocess.run(me + ["--time", root, str(out)],
                             capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return run.returncode
    compare_outputs(outs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
