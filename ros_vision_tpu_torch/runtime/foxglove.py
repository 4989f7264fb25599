"""Foxglove WebSocket bridge (ws-protocol v1).

Role parity with the reference's Foxglove visualization bridge
(`launch_vision.py:313` starts `foxglove_bridge` so Foxglove Studio can
inspect the camera topics live). This implements the subset of the public
`foxglove.websocket.v1` subprotocol that Studio needs to plot our data:

  server -> client:  serverInfo, advertise (JSON text frames),
                     MESSAGE_DATA (binary: opcode 0x01, u32 subscription id,
                     u64 receive timestamp ns, payload)
  client -> server:  subscribe / unsubscribe (JSON text frames)

Channels are JSON-encoded with well-known Foxglove schemas
(`foxglove.CompressedImage`, `foxglove.PosesInFrame`), so a stock Foxglove
Studio connects with no custom plugins: camera frames render in the Image
panel and tag poses in the 3D panel.
"""
from __future__ import annotations

import base64
import json
import logging
import struct
import threading
import time
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SUBPROTOCOL = "foxglove.websocket.v1"
_OP_MESSAGE_DATA = 0x01


class FoxgloveBridge:
    """Foxglove ws-protocol server. `publish_image` / `publish_poses` fan
    out to every subscribed client; channels are advertised on connect."""

    def __init__(self, port: int = 8765, name: str = "ros_vision_tpu",
                 jpeg_quality: int = 80):
        self.port = port
        self.name = name
        self.jpeg_quality = jpeg_quality
        self._channels: dict[int, dict] = {}
        self._topic_to_channel: dict[str, int] = {}
        self._next_channel = 1
        # ws -> {channel_id: subscription_id}
        self._clients: dict = {}
        self._lock = threading.Lock()
        self.messages_sent = 0

        from websockets.sync.server import serve

        self._server = serve(self._handler, "0.0.0.0", port,
                             subprotocols=[SUBPROTOCOL])
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    # ---- channel management ------------------------------------------------
    def add_channel(self, topic: str, schema_name: str,
                    schema: Optional[dict] = None) -> int:
        """Advertise a JSON channel; returns the channel id. Safe to call
        before or after clients connect (late channels are re-advertised)."""
        with self._lock:
            if topic in self._topic_to_channel:
                return self._topic_to_channel[topic]
            cid = self._next_channel
            self._next_channel += 1
            chan = {
                "id": cid,
                "topic": topic,
                "encoding": "json",
                "schemaName": schema_name,
                "schema": json.dumps(schema or {}),
                "schemaEncoding": "jsonschema",
            }
            self._channels[cid] = chan
            self._topic_to_channel[topic] = cid
            clients = list(self._clients)
        ad = json.dumps({"op": "advertise", "channels": [chan]})
        for ws in clients:
            try:
                ws.send(ad)
            except Exception:
                pass
        return cid

    # ---- client handling ---------------------------------------------------
    def _handler(self, ws):
        with self._lock:
            self._clients[ws] = {}
            channels = list(self._channels.values())
        try:
            ws.send(json.dumps({
                "op": "serverInfo", "name": self.name,
                "capabilities": [], "supportedEncodings": ["json"],
                "metadata": {}, "sessionId": str(int(time.time()))}))
            if channels:
                ws.send(json.dumps({"op": "advertise",
                                    "channels": channels}))
            while True:
                raw = ws.recv()
                if isinstance(raw, bytes):
                    continue
                try:
                    msg = json.loads(raw)
                except ValueError:
                    continue
                op = msg.get("op")
                if op == "subscribe":
                    with self._lock:
                        subs = self._clients.get(ws, {})
                        for s in msg.get("subscriptions", []):
                            subs[int(s["channelId"])] = int(s["id"])
                elif op == "unsubscribe":
                    with self._lock:
                        subs = self._clients.get(ws, {})
                        drop = set(int(i) for i in
                                   msg.get("subscriptionIds", []))
                        for cid, sid in list(subs.items()):
                            if sid in drop:
                                del subs[cid]
        except Exception:
            pass
        finally:
            with self._lock:
                self._clients.pop(ws, None)

    # ---- publishing --------------------------------------------------------
    def _broadcast(self, channel_id: int, payload: bytes,
                   timestamp_ns: Optional[int] = None) -> None:
        ts = timestamp_ns if timestamp_ns is not None else time.time_ns()
        with self._lock:
            targets = [(ws, subs[channel_id])
                       for ws, subs in self._clients.items()
                       if channel_id in subs]
        for ws, sid in targets:
            try:
                ws.send(struct.pack("<BIQ", _OP_MESSAGE_DATA, sid, ts)
                        + payload)
                self.messages_sent += 1
            except Exception:
                with self._lock:
                    self._clients.pop(ws, None)

    def _has_subscribers(self, cid: int) -> bool:
        with self._lock:
            return any(cid in subs for subs in self._clients.values())

    def publish_image(self, topic: str, image: np.ndarray,
                      frame_id: str = "camera",
                      timestamp_ns: Optional[int] = None) -> None:
        """JPEG-encode and publish as foxglove.CompressedImage."""
        cid = self.add_channel(topic, "foxglove.CompressedImage")
        if not self._has_subscribers(cid):
            return                      # don't pay the JPEG encode for nobody
        import cv2
        ok, jpg = cv2.imencode(".jpg", image,
                               [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality])
        if not ok:
            return
        ts = timestamp_ns if timestamp_ns is not None else time.time_ns()
        msg = {
            "timestamp": {"sec": ts // 10 ** 9, "nsec": ts % 10 ** 9},
            "frame_id": frame_id,
            "data": base64.b64encode(jpg.tobytes()).decode("ascii"),
            "format": "jpeg",
        }
        self._broadcast(cid, json.dumps(msg).encode(), ts)

    def publish_poses(self, topic: str, detections,
                      frame_id: str = "robot",
                      timestamp_ns: Optional[int] = None) -> None:
        """Publish tag detections as foxglove.PosesInFrame (position +
        quaternion per detection; detections need .pose_t/.pose_R)."""
        cid = self.add_channel(topic, "foxglove.PosesInFrame")
        ts = timestamp_ns if timestamp_ns is not None else time.time_ns()
        poses = []
        for d in detections:
            t = getattr(d, "pose_t", None)
            R = getattr(d, "pose_R", None)
            if t is None or R is None:
                continue
            qw, qx, qy, qz = _quat_from_matrix(np.asarray(R, np.float64))
            t = np.asarray(t, np.float64).ravel()
            poses.append({
                "position": {"x": float(t[0]), "y": float(t[1]),
                             "z": float(t[2])},
                "orientation": {"x": qx, "y": qy, "z": qz, "w": qw},
            })
        msg = {
            "timestamp": {"sec": ts // 10 ** 9, "nsec": ts % 10 ** 9},
            "frame_id": frame_id,
            "poses": poses,
        }
        self._broadcast(cid, json.dumps(msg).encode(), ts)

    def close(self):
        self._server.shutdown()


def _quat_from_matrix(R: np.ndarray) -> tuple:
    """(w, x, y, z) from a 3x3 rotation matrix (Shepperd's method)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return (0.25 * s, (R[2, 1] - R[1, 2]) / s,
                (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s)
    i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[0] = (R[k, j] - R[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (R[j, i] + R[i, j]) / s
    q[k + 1] = (R[k, i] + R[i, k]) / s
    return tuple(q)
