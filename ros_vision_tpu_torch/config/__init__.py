from ros_vision_tpu_torch.config.loader import (
    BagRecordingConfig,
    CameraConfig,
    ConfigLoader,
    ExtrinsicConfig,
    GamePieceConfig,
    NetworkTablesConfig,
    PerformanceConfig,
)

__all__ = [
    "BagRecordingConfig", "CameraConfig", "ConfigLoader", "ExtrinsicConfig",
    "GamePieceConfig", "NetworkTablesConfig", "PerformanceConfig",
]
