#!/usr/bin/env python
"""Extract images from a ROS2 bag to PNGs.

CLI parity with the reference's `extract_images` console script
(bag_utils/extract_images.py:262-344): same positional bag path and
-o/--output, -t/--topic-filter, -m/--max-images, -s/--skip-frames knobs,
same per-topic output layout. Also accepts this framework's bespoke .rec
bag directories (runtime/bags.py) for completeness. The port's own copy of
ros_vision_tpu/tools/extract_images.py.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag_path", help="ROS2 bag directory (or .db3 file, "
                                     "or a framework .rec bag directory)")
    ap.add_argument("-o", "--output", default="./extracted_images")
    ap.add_argument("-t", "--topic-filter",
                    help="only topics containing this string")
    ap.add_argument("-m", "--max-images", type=int,
                    help="max images per topic")
    ap.add_argument("-s", "--skip-frames", type=int, default=1,
                    help="extract every Nth frame")
    args = ap.parse_args(argv)

    if not os.path.exists(args.bag_path):
        print(f"Error: bag path does not exist: {args.bag_path}",
              file=sys.stderr)
        return 1

    is_ros2 = args.bag_path.endswith(".db3") or (
        os.path.isdir(args.bag_path)
        and glob.glob(os.path.join(args.bag_path, "*.db3")))
    if is_ros2:
        from ros_vision_tpu_torch.runtime.rosbag2 import extract_images
        stats = extract_images(args.bag_path, args.output,
                               topic_filter=args.topic_filter,
                               max_images=args.max_images,
                               skip_frames=args.skip_frames)
    else:
        stats = _extract_rec(args)

    total = 0
    for topic, s in stats.items():
        print(f"{topic}: extracted {s['extracted']}, "
              f"skipped {s['skipped']}, errors {s['errors']}")
        total += s["extracted"]
    print(f"total images extracted: {total} -> {args.output}")
    return 0


def _extract_rec(args):
    """Framework .rec bag extraction with the same knobs/layout."""
    import cv2
    from ros_vision_tpu_torch.runtime.bags import BagReader
    reader = BagReader(args.bag_path)
    topics = [t for t in reader.topics()
              if not args.topic_filter or args.topic_filter in t]
    stats = {t: {"extracted": 0, "skipped": 0, "errors": 0} for t in topics}
    os.makedirs(args.output, exist_ok=True)
    for topic in topics:
        n = 0
        for header, img in reader.read_images(topic):
            n += 1
            if n % args.skip_frames != 0:
                stats[topic]["skipped"] += 1
                continue
            if args.max_images and \
                    stats[topic]["extracted"] >= args.max_images:
                continue
            if img is None:
                stats[topic]["errors"] += 1
                continue
            safe = topic.replace("/", "_").strip("_")
            tdir = os.path.join(args.output, safe)
            os.makedirs(tdir, exist_ok=True)
            ts = header.get("t", 0.0)
            cv2.imwrite(os.path.join(tdir, f"{safe}_{ts:.6f}.png"), img)
            stats[topic]["extracted"] += 1
    return stats


if __name__ == "__main__":
    sys.exit(main())
