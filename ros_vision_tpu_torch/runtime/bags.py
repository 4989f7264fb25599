"""Frame/detection recording + replay ("bags").

Role parity with the reference's bag recording (launch_vision.py:86-153
spawns `ros2 bag record` with topics from system_config bag_recording) and
bag_utils/extract_images.py (P4). Format: a self-describing directory with a
metadata.json + one length-prefixed record file per topic; image records are
JPEG-compressed (matching the reference's use of /compressed topics).

Record layout per entry: [u32 header_len][json header][u32 payload_len]
[payload]. Header: {"t": epoch seconds, "seq": n, ...}. Replay is an
iterator; extract_images writes PNGs like the reference tool.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Iterator, Optional

import numpy as np


class BagWriter:
    def __init__(self, directory: str, max_bytes: int | None = None,
                 max_duration_s: float | None = None):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_bytes = max_bytes
        self.max_duration_s = max_duration_s
        self._files = {}
        self._lock = threading.Lock()
        self._seq = {}
        self._bytes = 0
        self._t0 = time.time()
        self._meta = {"created": self._t0, "topics": {}, "format": 1}
        self._closed = False

    def _file(self, topic: str):
        if topic not in self._files:
            safe = topic.strip("/").replace("/", "__")
            path = os.path.join(self.directory, f"{safe}.rec")
            self._files[topic] = open(path, "ab")
            self._seq[topic] = 0
            self._meta["topics"][topic] = {"file": os.path.basename(path)}
        return self._files[topic]

    def write(self, topic: str, payload: bytes, header: dict | None = None,
              t: float | None = None) -> bool:
        """Returns False when recording limits are reached."""
        with self._lock:
            if self._closed:
                return False
            if self.max_duration_s and \
                    time.time() - self._t0 > self.max_duration_s:
                return False
            if self.max_bytes and self._bytes > self.max_bytes:
                return False
            h = dict(header or {})
            h["t"] = t if t is not None else time.time()
            h["seq"] = self._seq[topic] if topic in self._seq else 0
            f = self._file(topic)
            hb = json.dumps(h).encode()
            f.write(struct.pack("<I", len(hb)) + hb +
                    struct.pack("<I", len(payload)) + payload)
            self._seq[topic] += 1
            self._bytes += len(payload) + len(hb) + 8
            return True

    def write_image(self, topic: str, image: np.ndarray,
                    t: float | None = None, jpeg_quality: int = 90) -> bool:
        import cv2
        ok, enc = cv2.imencode(".jpg", image,
                               [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        if not ok:
            return False
        return self.write(topic, enc.tobytes(),
                          {"encoding": "jpeg",
                           "shape": list(image.shape)}, t)

    def close(self):
        with self._lock:
            self._closed = True
            self._meta["duration"] = time.time() - self._t0
            for topic, f in self._files.items():
                self._meta["topics"][topic]["messages"] = self._seq[topic]
                f.close()
            with open(os.path.join(self.directory, "metadata.json"),
                      "w") as f:
                json.dump(self._meta, f, indent=2)


class BagReader:
    def __init__(self, directory: str):
        self.directory = directory
        meta_path = os.path.join(directory, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.metadata = json.load(f)
        else:
            # synthesize metadata like extract_images.py does for bags
            # missing metadata.yaml (extract_images.py:20-118)
            self.metadata = {"topics": {}}
            for fn in os.listdir(directory):
                if fn.endswith(".rec"):
                    topic = "/" + fn[:-4].replace("__", "/")
                    self.metadata["topics"][topic] = {"file": fn}

    def topics(self) -> list:
        return list(self.metadata["topics"].keys())

    def read(self, topic: str) -> Iterator[tuple]:
        """Yields (header dict, payload bytes)."""
        fn = self.metadata["topics"][topic]["file"]
        with open(os.path.join(self.directory, fn), "rb") as f:
            while True:
                lb = f.read(4)
                if len(lb) < 4:
                    return
                hlen = struct.unpack("<I", lb)[0]
                header = json.loads(f.read(hlen))
                plen = struct.unpack("<I", f.read(4))[0]
                yield header, f.read(plen)

    def read_images(self, topic: str) -> Iterator[tuple]:
        import cv2
        for header, payload in self.read(topic):
            img = cv2.imdecode(np.frombuffer(payload, np.uint8),
                               cv2.IMREAD_UNCHANGED)
            yield header, img


def extract_images(bag_dir: str, out_dir: str,
                   topic: Optional[str] = None) -> int:
    """Write PNGs from a bag (bag_utils/extract_images.py equivalent)."""
    import cv2
    reader = BagReader(bag_dir)
    topics = [topic] if topic else [
        t for t in reader.topics() if "image" in t]
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for tp in topics:
        safe = tp.strip("/").replace("/", "_")
        for header, img in reader.read_images(tp):
            if img is None:
                continue
            cv2.imwrite(os.path.join(out_dir,
                                     f"{safe}_{header['seq']:06d}.png"), img)
            n += 1
    return n
