#!/usr/bin/env python3
"""K2 rank_image, K4 value_histogram, K6 propagate_fixpoint and K9
sort_tpu of several checkouts of the port, timed on one CUDA card on the
same inputs, the device time apart from the host's enqueue.

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
them). Then each ROOT, in the order given
(so "OLD . . OLD" takes them in turns), runs in a process of its own that
imports that root's package, builds its kernels, checks every call
bit-exact against the root's plain version and times it with
chip_smoke.both_ms: device_ms (calls queued behind a torch.cuda._sleep)
and call_ms (one call between CUDA events, the enqueue included). Prints
one JSON line per root and input, then the card's name and power limit;
exits nonzero without a card or if a root's kernel disagrees.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INPUTS = ROOT / "build" / "mb_torch_kernel_versions" / "inputs.pt"
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


def capture() -> None:
    """Save the K4 and K9 inputs of one cluster_and_fit call per size."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    cs = timing_helpers()
    dev = require_cuda()
    saved = {"hist": {}, "sort": {}, "ccl": {}}
    for label, k in SIZES.items():
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
        key, pack2, _ = fk.boundary_compact(th, ranks, p_cap, k)
        calls = cs.capture_calls({"key": key, "pack2": pack2}, decim, k)
        at = f"{label} B=4 K={k}"
        saved["hist"][f"{at} (segment ids)"] = calls["hists"][0].cpu()
        saved["hist"][f"{at} (peak segments)"] = calls["hists"][1].cpu()
        saved["sort"][at] = [([o.cpu() for o in ops], nk)
                             for ops, nk in calls["sorts"]]
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


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


def time_root(root: Path) -> None:
    """Check and time root's K2, K4, K6 and K9 on the saved inputs."""
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
    for kernel, at, t in rows:
        print(json.dumps(dict(root=str(root), kernel=kernel, at=at, **t)))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture()
        return 0
    if argv[:1] == ["--time"]:
        time_root(Path(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv:
        run = subprocess.run(me + ["--time", root], capture_output=True,
                             text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return run.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
