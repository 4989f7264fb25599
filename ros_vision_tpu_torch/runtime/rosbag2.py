"""ROS2 bag (rosbag2/sqlite3) reading and writing — no external deps.

Role parity with the reference's `bag_utils/extract_images.py:20-118`, which
reprocesses the team's real ROS2 recordings via `rosbags.AnyReader`. That
library isn't available here, so this module implements the subset the
vision workflows need from scratch on stdlib sqlite3:

  * the rosbag2 sqlite3 storage schema (`topics` + `messages` tables, one or
    more .db3 files merged in timestamp order),
  * metadata.yaml synthesis when missing (extract_images.py:68-117 behavior),
  * CDR (XCDR1 little-endian) serialization/deserialization for
    sensor_msgs/msg/Image and sensor_msgs/msg/CompressedImage,
  * the reference's image-encoding matrix: bgr8, rgb8, mono8/8UC1, bgra8,
    rgba8, 16UC1 (scaled to 8-bit) + compressed via cv2.imdecode
    (extract_images.py:41-60, 214-228).

The Writer produces bags that round-trip through this Reader and follow the
same schema real rosbag2 sqlite3 bags use, so recordings made here are
readable by standard ROS2 tooling as well.
"""
from __future__ import annotations

import glob
import heapq
import os
import sqlite3
import struct
from typing import Iterable, Iterator, Optional

import numpy as np

IMAGE_TYPE = "sensor_msgs/msg/Image"
COMPRESSED_TYPE = "sensor_msgs/msg/CompressedImage"

# XCDR1 little-endian encapsulation identifier
_CDR_LE = b"\x00\x01\x00\x00"


# ---------------------------------------------------------------------------
# CDR primitives. Alignment is relative to the start of the payload (the
# byte AFTER the 4-byte encapsulation header), per the DDS XCDR1 rules.
# ---------------------------------------------------------------------------
class CdrReader:
    def __init__(self, raw: bytes):
        if len(raw) < 4 or raw[1] not in (0, 1):
            raise ValueError("not a CDR message")
        if raw[1] != 1:
            raise ValueError("big-endian CDR not supported")
        self._buf = memoryview(raw)[4:]
        self._pos = 0

    def _align(self, n: int) -> None:
        rem = self._pos % n
        if rem:
            self._pos += n - rem

    def u8(self) -> int:
        v = self._buf[self._pos]
        self._pos += 1
        return v

    def u32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<I", self._buf, self._pos)
        self._pos += 4
        return v

    def i32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<i", self._buf, self._pos)
        self._pos += 4
        return v

    def string(self) -> str:
        n = self.u32()                      # includes the NUL terminator
        raw = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n
        return raw.rstrip(b"\x00").decode("utf-8", "replace")

    def u8_seq(self) -> bytes:
        n = self.u32()
        raw = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n
        return raw


class CdrWriter:
    def __init__(self):
        self._parts = [bytearray(_CDR_LE)]
        self._pos = 0

    def _align(self, n: int) -> None:
        rem = self._pos % n
        if rem:
            self._parts.append(bytearray(n - rem))
            self._pos += n - rem

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack("<B", v))
        self._pos += 1

    def u32(self, v: int) -> None:
        self._align(4)
        self._parts.append(struct.pack("<I", v))
        self._pos += 4

    def i32(self, v: int) -> None:
        self._align(4)
        self._parts.append(struct.pack("<i", v))
        self._pos += 4

    def string(self, s: str) -> None:
        raw = s.encode("utf-8") + b"\x00"
        self.u32(len(raw))
        self._parts.append(raw)
        self._pos += len(raw)

    def u8_seq(self, raw: bytes) -> None:
        self.u32(len(raw))
        self._parts.append(raw)
        self._pos += len(raw)

    def tobytes(self) -> bytes:
        return b"".join(bytes(p) for p in self._parts)


# ---------------------------------------------------------------------------
# sensor_msgs (de)serialization
# ---------------------------------------------------------------------------
def _read_header(r: CdrReader) -> dict:
    sec = r.i32()
    nsec = r.u32()
    frame_id = r.string()
    return {"stamp_sec": sec, "stamp_nsec": nsec, "frame_id": frame_id}


def _write_header(w: CdrWriter, stamp_ns: int, frame_id: str) -> None:
    w.i32(int(stamp_ns // 1_000_000_000))
    w.u32(int(stamp_ns % 1_000_000_000))
    w.string(frame_id)


def parse_image(raw: bytes) -> dict:
    """sensor_msgs/msg/Image -> dict(stamp_sec, stamp_nsec, frame_id,
    height, width, encoding, is_bigendian, step, data)."""
    r = CdrReader(raw)
    msg = _read_header(r)
    msg["height"] = r.u32()
    msg["width"] = r.u32()
    msg["encoding"] = r.string()
    msg["is_bigendian"] = r.u8()
    msg["step"] = r.u32()
    msg["data"] = r.u8_seq()
    return msg


def parse_compressed_image(raw: bytes) -> dict:
    r = CdrReader(raw)
    msg = _read_header(r)
    msg["format"] = r.string()
    msg["data"] = r.u8_seq()
    return msg


def serialize_image(arr: np.ndarray, encoding: str, stamp_ns: int = 0,
                    frame_id: str = "camera") -> bytes:
    arr = np.ascontiguousarray(arr)
    w = CdrWriter()
    _write_header(w, stamp_ns, frame_id)
    h, wd = arr.shape[:2]
    w.u32(h)
    w.u32(wd)
    w.string(encoding)
    w.u8(0)
    w.u32(arr.strides[0])
    w.u8_seq(arr.tobytes())
    return w.tobytes()


def serialize_compressed_image(data: bytes, fmt: str = "jpeg",
                               stamp_ns: int = 0,
                               frame_id: str = "camera") -> bytes:
    w = CdrWriter()
    _write_header(w, stamp_ns, frame_id)
    w.string(fmt)
    w.u8_seq(data)
    return w.tobytes()


def image_to_array(msg: dict) -> Optional[np.ndarray]:
    """Decode a parsed Image message to a BGR/gray numpy array using the
    reference's encoding matrix (extract_images.py:41-60). Returns None for
    unsupported encodings."""
    import cv2
    h, w = msg["height"], msg["width"]
    enc = msg["encoding"]
    data = np.frombuffer(msg["data"], np.uint8)
    if enc == "bgr8":
        return data.reshape(h, w, 3)
    if enc == "rgb8":
        return cv2.cvtColor(data.reshape(h, w, 3), cv2.COLOR_RGB2BGR)
    if enc in ("mono8", "8UC1"):
        return data.reshape(h, w)
    if enc == "bgra8":
        return cv2.cvtColor(data.reshape(h, w, 4), cv2.COLOR_BGRA2BGR)
    if enc == "rgba8":
        return cv2.cvtColor(data.reshape(h, w, 4), cv2.COLOR_RGBA2BGR)
    if enc == "16UC1":
        img16 = np.frombuffer(msg["data"], np.uint16).reshape(h, w)
        return (img16 // 256).astype(np.uint8)
    return None


def decode_message(msgtype: str, raw: bytes) -> Optional[np.ndarray]:
    """Any supported image message -> numpy image. Returns None for
    unsupported types AND for malformed/truncated messages (the reference
    extractor counts per-message errors and keeps going,
    extract_images.py:243-245 — one bad record must not kill a replay)."""
    import cv2
    try:
        if "CompressedImage" in msgtype:
            msg = parse_compressed_image(raw)
            return cv2.imdecode(np.frombuffer(msg["data"], np.uint8),
                                cv2.IMREAD_COLOR)
        if "Image" in msgtype:
            return image_to_array(parse_image(raw))
    except (ValueError, struct.error, IndexError):
        return None
    return None


# ---------------------------------------------------------------------------
# rosbag2 sqlite3 storage
# ---------------------------------------------------------------------------
def _synthesize_metadata(bag_dir: str, db_files: list[str],
                         topics: Optional[list] = None,
                         message_count: int = 0) -> None:
    """Write a minimal metadata.yaml (extract_images.py:68-117 behavior:
    bags that lost their metadata must still open)."""
    import yaml
    meta = {
        "rosbag2_bagfile_information": {
            "version": 5,
            "storage_identifier": "sqlite3",
            "relative_file_paths": [os.path.basename(f) for f in db_files],
            "duration": {"nanoseconds": 0},
            "starting_time": {"nanoseconds_since_epoch": 0},
            "message_count": message_count,
            "topics_with_message_count": topics or [],
            "compression_format": "",
            "compression_mode": "",
        }
    }
    with open(os.path.join(bag_dir, "metadata.yaml"), "w") as f:
        yaml.safe_dump(meta, f, default_flow_style=False)


class Rosbag2Reader:
    """Read a rosbag2 sqlite3 bag: a directory containing metadata.yaml +
    one or more .db3 files (or a bare .db3 path). Multiple storage files
    are merged in timestamp order."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self._db_files = sorted(glob.glob(os.path.join(path, "*.db3")))
            if not self._db_files:
                raise FileNotFoundError(f"no .db3 files in {path}")
            if not os.path.exists(os.path.join(path, "metadata.yaml")):
                _synthesize_metadata(path, self._db_files)
        elif path.endswith(".db3"):
            self._db_files = [path]
        else:
            raise FileNotFoundError(path)
        # topic map from the first file that has each topic
        self.topics: dict[str, dict] = {}
        for db in self._db_files:
            con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
            try:
                rows = con.execute(
                    "SELECT id, name, type, serialization_format "
                    "FROM topics").fetchall()
            finally:
                con.close()
            for _tid, name, typ, fmt in rows:
                self.topics.setdefault(
                    name, {"type": typ, "serialization_format": fmt})

    def image_topics(self) -> list[str]:
        return [t for t, info in self.topics.items()
                if "sensor_msgs/msg/Image" in info["type"]
                or "sensor_msgs/msg/CompressedImage" in info["type"]]

    def messages(self, topics: Optional[Iterable[str]] = None
                 ) -> Iterator[tuple[str, str, int, bytes]]:
        """Yield (topic, msgtype, timestamp_ns, rawdata) in timestamp order
        across all storage files: per-file ORDER BY cursors heap-merged on
        (timestamp, file index), so split bags with overlapping timestamp
        ranges still come out globally ordered."""
        want = set(topics) if topics is not None else None

        def file_stream(fidx, db):
            con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
            try:
                tmap = {tid: (name, typ) for tid, name, typ, _ in con.execute(
                    "SELECT id, name, type, serialization_format "
                    "FROM topics")}
                for tid, ts, data in con.execute(
                        "SELECT topic_id, timestamp, data FROM messages "
                        "ORDER BY timestamp ASC"):
                    name, typ = tmap[tid]
                    if want is not None and name not in want:
                        continue
                    yield ts, fidx, name, typ, bytes(data)
            finally:
                con.close()

        streams = [file_stream(i, db) for i, db in enumerate(self._db_files)]
        for ts, _fidx, name, typ, data in heapq.merge(*streams):
            yield name, typ, ts, data

    def read_images(self, topic: str
                    ) -> Iterator[tuple[int, Optional[np.ndarray]]]:
        """Yield (timestamp_ns, image) for one topic (None = undecodable)."""
        typ = self.topics[topic]["type"]
        for _name, _typ, ts, raw in self.messages([topic]):
            yield ts, decode_message(typ, raw)


class Rosbag2Writer:
    """Write a rosbag2 sqlite3 bag directory (metadata.yaml + <name>_N.db3)
    using the same schema `ros2 bag record` produces. `segment` numbers the
    storage file, mirroring `ros2 bag record`'s split naming; callers that
    rotate on size/duration open segment N+1 in the same directory (the
    launch-side _Ros2BagRecorder does). bytes_written tracks serialized
    payload bytes for such split policies."""

    def __init__(self, bag_dir: str, segment: int = 0):
        os.makedirs(bag_dir, exist_ok=True)
        self._dir = bag_dir
        name = os.path.basename(os.path.normpath(bag_dir)) or "bag"
        self.bytes_written = 0
        self._db_path = os.path.join(bag_dir, f"{name}_{segment}.db3")
        self._con = sqlite3.connect(self._db_path)
        cur = self._con.cursor()
        cur.execute("CREATE TABLE IF NOT EXISTS schema("
                    "schema_version INTEGER PRIMARY KEY, "
                    "ros_distro TEXT NOT NULL)")
        cur.execute("INSERT OR IGNORE INTO schema VALUES (3, 'rosvision')")
        cur.execute("CREATE TABLE IF NOT EXISTS topics("
                    "id INTEGER PRIMARY KEY, name TEXT NOT NULL, "
                    "type TEXT NOT NULL, serialization_format TEXT NOT NULL, "
                    "offered_qos_profiles TEXT NOT NULL)")
        cur.execute("CREATE TABLE IF NOT EXISTS messages("
                    "id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL, "
                    "timestamp INTEGER NOT NULL, data BLOB NOT NULL)")
        cur.execute("CREATE INDEX IF NOT EXISTS timestamp_idx "
                    "ON messages (timestamp ASC)")
        self._con.commit()
        self._topic_ids: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self._closed = False

    def add_topic(self, name: str, msgtype: str,
                  serialization: str = "cdr") -> int:
        if name in self._topic_ids:
            return self._topic_ids[name]
        tid = len(self._topic_ids) + 1
        self._con.execute(
            "INSERT INTO topics VALUES (?, ?, ?, ?, ?)",
            (tid, name, msgtype, serialization, "[]"))
        self._topic_ids[name] = tid
        self._counts[name] = 0
        return tid

    def write(self, topic: str, timestamp_ns: int, raw: bytes) -> None:
        tid = self._topic_ids[topic]
        self._con.execute(
            "INSERT INTO messages (topic_id, timestamp, data) "
            "VALUES (?, ?, ?)", (tid, int(timestamp_ns), raw))
        self._counts[topic] += 1
        self.bytes_written += len(raw)

    def write_image(self, topic: str, img: np.ndarray, timestamp_ns: int,
                    encoding: Optional[str] = None,
                    frame_id: str = "camera") -> None:
        if encoding is None:
            encoding = "mono8" if img.ndim == 2 else "bgr8"
        self.add_topic(topic, IMAGE_TYPE)
        self.write(topic, timestamp_ns,
                   serialize_image(img, encoding, timestamp_ns, frame_id))

    def write_compressed(self, topic: str, img: np.ndarray,
                         timestamp_ns: int, frame_id: str = "camera",
                         quality: int = 90) -> None:
        import cv2
        ok, buf = cv2.imencode(".jpg", img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("jpeg encode failed")
        self.add_topic(topic, COMPRESSED_TYPE)
        self.write(topic, timestamp_ns, serialize_compressed_image(
            buf.tobytes(), "jpeg", timestamp_ns, frame_id))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._con.commit()
        self._con.close()
        meta_topics = [{
            "topic_metadata": {
                "name": n,
                "type": "",
                "serialization_format": "cdr",
                "offered_qos_profiles": "",
            },
            "message_count": c,
        } for n, c in self._counts.items()]
        # list every segment in the directory so a split recording's final
        # metadata.yaml covers all storage files (counts reflect the last
        # segment only; Rosbag2Reader merges all files regardless)
        all_dbs = sorted(glob.glob(os.path.join(self._dir, "*.db3"))) \
            or [self._db_path]
        _synthesize_metadata(self._dir, all_dbs, meta_topics,
                             sum(self._counts.values()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def extract_images(bag_path: str, output_dir: str,
                   topic_filter: Optional[str] = None,
                   max_images: Optional[int] = None,
                   skip_frames: int = 1) -> dict:
    """PNG extraction with the reference tool's layout and knobs
    (extract_images.py:120-259): per-topic subdirectories named by the
    sanitized topic, files `<topic>_<t_sec>.png`, every-Nth-frame skip and
    per-topic max. Returns {topic: {extracted, skipped, errors}}."""
    import cv2
    reader = Rosbag2Reader(bag_path)
    topics = reader.image_topics()
    if topic_filter:
        topics = [t for t in topics if topic_filter in t]
    os.makedirs(output_dir, exist_ok=True)
    stats = {t: {"extracted": 0, "skipped": 0, "errors": 0} for t in topics}
    counters = {t: 0 for t in topics}
    for topic, typ, ts, raw in reader.messages(topics):
        counters[topic] += 1
        if counters[topic] % skip_frames != 0:
            stats[topic]["skipped"] += 1
            continue
        if max_images and stats[topic]["extracted"] >= max_images:
            continue
        img = decode_message(typ, raw)
        if img is None:
            stats[topic]["errors"] += 1
            continue
        safe = topic.replace("/", "_").strip("_")
        tdir = os.path.join(output_dir, safe)
        os.makedirs(tdir, exist_ok=True)
        cv2.imwrite(os.path.join(tdir, f"{safe}_{ts / 1e9:.6f}.png"), img)
        stats[topic]["extracted"] += 1
    return stats
