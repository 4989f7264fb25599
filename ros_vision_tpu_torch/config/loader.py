"""System configuration loader.

Same single-JSON-source-of-truth model and schema as the reference's
vision_utils::ConfigLoader (config_loader.hpp:30-135, config_loader.cpp):
`system_config.json` holds camera mounted positions (serial -> camera
params), per-location extrinsics, bag recording, NetworkTables,
performance-optimization and game-piece-detection sections. Defaults, the
static cache, the test path override (setConfigFilePath/reloadConfig test
hooks) and required-field validation semantics are preserved.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

DEFAULT_CONFIG_PATHS = (
    os.path.join(os.path.dirname(__file__), "data", "system_config.json"),
)


@dataclasses.dataclass
class CameraConfig:
    location: str = "center_front"
    format: str = "MJPG"
    height: int = 800
    width: int = 1280
    frame_rate: int = 100
    api_preference: str = "V4L2"
    usb_port: Optional[str] = None


@dataclasses.dataclass
class ExtrinsicConfig:
    # default = the reference's camera->robot base transform
    # (rotation_utils camera_to_robot() = Rx(-90) Ry(90))
    rotation: list = dataclasses.field(default_factory=lambda: [
        [0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    offset: list = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclasses.dataclass
class NetworkTablesConfig:
    table_address: str = "10.7.66.2"
    table_name: str = "/SmartDashboard"
    port: int = 5810             # NT4 websocket port (test servers override)


@dataclasses.dataclass
class BagRecordingConfig:
    output_directory: str = "/tmp/ros_vision_bags"
    max_bag_size: str = "1000000000"
    topics: list = dataclasses.field(default_factory=list)
    auto_split: bool = True
    max_duration: int = 300
    format: str = "rec"          # "rec" (framework) | "ros2" (rosbag2)


@dataclasses.dataclass
class PerformanceConfig:
    enable_optimizations: bool = False
    available_cpu_cores: list = dataclasses.field(default_factory=list)
    default_priority: int = 80


@dataclasses.dataclass
class GamePieceConfig:
    engine_file: str = ""
    input_channels: int = 3
    class_names: list = dataclasses.field(default_factory=list)


class ConfigError(RuntimeError):
    pass


class ConfigLoader:
    """Static-cached JSON config accessor (mirrors the reference's
    static-instance ConfigLoader with test hooks)."""

    _lock = threading.Lock()
    _data: Optional[dict] = None
    _path: Optional[str] = None

    # -- test hooks (config_loader.hpp:126-135) ---------------------------
    @classmethod
    def set_config_file_path(cls, path: str) -> None:
        with cls._lock:
            cls._path = path
            cls._data = None

    @classmethod
    def reload_config(cls) -> None:
        with cls._lock:
            cls._data = None

    # -- internals ---------------------------------------------------------
    @classmethod
    def _load(cls) -> dict:
        with cls._lock:
            if cls._data is not None:
                return cls._data
            path = cls._path or os.environ.get("ROS_VISION_TPU_CONFIG")
            if path is None:
                for p in DEFAULT_CONFIG_PATHS:
                    if os.path.exists(p):
                        path = p
                        break
            if path is None or not os.path.exists(path):
                raise ConfigError(
                    f"system config not found (path={path!r}); set "
                    "ROS_VISION_TPU_CONFIG or ConfigLoader.set_config_file_path")
            with open(path) as f:
                try:
                    cls._data = json.load(f)
                except json.JSONDecodeError as e:
                    raise ConfigError(f"invalid JSON in {path}: {e}") from e
            return cls._data

    @staticmethod
    def _require(d: dict, keys: list, ctx: str) -> None:
        missing = [k for k in keys if k not in d]
        if missing:
            raise ConfigError(f"{ctx}: missing required fields {missing}")

    # -- accessors (config_loader.hpp public API) --------------------------
    @classmethod
    def get_camera_config(cls, serial: str) -> Optional[CameraConfig]:
        data = cls._load()
        cams = data.get("camera_mounted_positions", {})
        if serial not in cams:
            return None
        c = cams[serial]
        cls._require(c, ["location", "format", "height", "width",
                         "frame_rate", "api_preference"],
                     f"camera_mounted_positions[{serial}]")
        return CameraConfig(
            location=c["location"], format=c["format"], height=c["height"],
            width=c["width"], frame_rate=c["frame_rate"],
            api_preference=c["api_preference"], usb_port=c.get("usb_port"))

    @classmethod
    def get_all_camera_serials(cls) -> list:
        return list(cls._load().get("camera_mounted_positions", {}).keys())

    @classmethod
    def get_extrinsic_config(cls, location: str) -> Optional[ExtrinsicConfig]:
        data = cls._load()
        ext = data.get("extrinsics", {})
        if location not in ext:
            return None
        e = ext[location]
        cls._require(e, ["rotation", "offset"], f"extrinsics[{location}]")
        return ExtrinsicConfig(rotation=e["rotation"], offset=e["offset"])

    @classmethod
    def get_network_tables_config(cls) -> NetworkTablesConfig:
        nt = cls._load().get("network_tables_config", {})
        return NetworkTablesConfig(
            table_address=nt.get("table_address", "10.7.66.2"),
            table_name=nt.get("table_name", "/SmartDashboard"),
            port=int(nt.get("port", 5810)))

    @classmethod
    def get_bag_recording_config(cls) -> BagRecordingConfig:
        b = cls._load().get("bag_recording", {})
        return BagRecordingConfig(
            output_directory=b.get("output_directory", "/tmp/ros_vision_bags"),
            max_bag_size=b.get("max_bag_size", "1000000000"),
            topics=b.get("topics", []),
            auto_split=b.get("auto_split", True),
            max_duration=b.get("max_duration", 300),
            format=b.get("format", "rec"))

    @classmethod
    def get_performance_config(cls) -> PerformanceConfig:
        p = cls._load().get("performance_optimization", {})
        return PerformanceConfig(
            enable_optimizations=p.get("enable_optimizations", False),
            available_cpu_cores=p.get("available_cpu_cores", []),
            default_priority=p.get("default_priority", 80))

    @classmethod
    def get_game_piece_config(cls) -> GamePieceConfig:
        g = cls._load().get("game_piece_detection", {})
        return GamePieceConfig(
            engine_file=g.get("engine_file", ""),
            input_channels=g.get("input_channels", 3),
            class_names=g.get("class_names", []))


def fourcc_from_string(format_str: str) -> int:
    """'MJPG' -> OpenCV fourcc int (config_loader utilities)."""
    if len(format_str) != 4:
        raise ConfigError(f"fourcc must be 4 chars, got {format_str!r}")
    v = 0
    for i, ch in enumerate(format_str):
        v |= ord(ch) << (8 * i)
    return v


_API_MAP = {"ANY": 0, "V4L2": 200, "GSTREAMER": 1800, "FFMPEG": 1900}


def api_preference_from_string(api: str) -> int:
    """'V4L2' -> OpenCV VideoCapture API id (config_loader utilities)."""
    if api not in _API_MAP:
        raise ConfigError(f"unknown api_preference {api!r}")
    return _API_MAP[api]
