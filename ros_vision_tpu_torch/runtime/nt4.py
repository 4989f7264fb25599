"""NetworkTables 4 client + AprilTag data sender.

Robot-bus output parity with the reference's ntcore-based sender
(AprilTagDataSender.cpp:9-44): connects to the roboRIO's NT4 server
(table_address from system_config network_tables_config), publishes a
double-array topic with the flattened [collect_time, id, x, y, z]* layout
(apriltags_cuda_detector.cu:465-502) plus a raw protobuf topic
(apriltag.proto schema), flushing after each send.

Implemented directly against the NT4 WebSocket wire protocol (JSON text
frames for pub/sub control, msgpack binary frames for values) so no ntcore
native dependency is required. An in-process NT4 *server* is provided for
tests — the same isolated-instance technique as apriltag_sender_test.cu.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional

from ros_vision_tpu_torch.runtime import msgpack_mini as mp

log = logging.getLogger(__name__)

NT4_PORT = 5810
TYPE_IDS = {"boolean": 0, "double": 1, "int": 2, "float": 3, "string": 4,
            "raw": 5, "boolean[]": 16, "double[]": 17, "int[]": 18,
            "float[]": 19, "string[]": 20}


class NT4Client:
    """NT4 websocket client with ntcore-style reconnection.

    The reference's ntcore client reconnects to the roboRIO forever — robot
    networks drop constantly (AprilTagDataSender.cpp relies on this). With
    reconnect=True (default) this client never raises on network failure:
    sends while disconnected are dropped (NT data is perishable — drop-oldest
    is the PublisherQueue semantic too), a background thread re-dials with
    backoff, and on reconnect every published topic is re-announced and the
    RTT time sync re-run. Periodic RTT re-syncs keep timestamps honest across
    clock drift; they run on a background thread (like ntcore's) so the
    publish hot path never blocks on a ws.recv exchange."""

    RECONNECT_INTERVAL = 1.0
    RESYNC_INTERVAL = 3.0

    def __init__(self, server: str, client_name: str = "ros_vision_tpu",
                 port: int = NT4_PORT, connect_timeout: float = 5.0,
                 reconnect: bool = True):
        # accept "host" or "host:port" (an explicit port in the address
        # wins over the default NT4 port)
        if ":" in server:
            server, port_s = server.rsplit(":", 1)
            port = int(port_s)
        self._uri = f"ws://{server}:{port}/nt/{client_name}"
        self._connect_timeout = connect_timeout
        self._reconnect = reconnect
        self._ws = None
        self._closed = False
        self._reconnect_thread = None
        self._next_pubuid = 1
        self._pubs: dict = {}        # name -> (uid, type_str, properties)
        self._lock = threading.RLock()
        self._t0 = time.monotonic_ns()
        self._server_offset_us = 0
        self._sync_lock = threading.Lock()   # serializes _sync_time's recv
        try:
            self._connect()
        except Exception as e:
            if not reconnect:
                raise
            log.warning("NT4 connect failed (%s); retrying in background", e)
            self._start_reconnect()
        # periodic RTT re-sync off the hot path (ntcore runs RTT on a
        # background thread too; an inline recv in set_value can stall the
        # vision loop up to the 2 s response timeout on a slow server)
        self._resync_thread = threading.Thread(
            target=self._resync_loop, daemon=True, name="nt4-resync")
        self._resync_thread.start()

    @property
    def connected(self) -> bool:
        return self._ws is not None

    def _connect(self) -> None:
        """Dial, re-announce all published topics, re-sync time. Called
        under no lock at ctor, under the reconnect thread otherwise."""
        from websockets.sync.client import connect
        ws = connect(
            self._uri, subprotocols=["v4.1.networktables.first.wpi.edu",
                                     "networktables.first.wpi.edu"],
            open_timeout=self._connect_timeout)
        with self._lock:
            self._ws = ws
            for name, (uid, type_str, props) in self._pubs.items():
                ws.send(json.dumps([{
                    "method": "publish",
                    "params": {"name": name, "pubuid": uid,
                               "type": type_str, "properties": props},
                }]))
        self._sync_time()

    def _on_disconnect(self) -> None:
        with self._lock:
            if self._ws is not None:
                try:
                    self._ws.close()
                except Exception:
                    pass
                self._ws = None
            if self._reconnect and not self._closed:
                self._start_reconnect()

    def _start_reconnect(self) -> None:
        with self._lock:
            if self._reconnect_thread is not None and \
                    self._reconnect_thread.is_alive():
                return
            self._reconnect_thread = threading.Thread(
                target=self._reconnect_loop, daemon=True,
                name="nt4-reconnect")
            self._reconnect_thread.start()

    def _reconnect_loop(self) -> None:
        while not self._closed:
            time.sleep(self.RECONNECT_INTERVAL)
            if self._closed:
                return
            try:
                self._connect()
                log.info("NT4 reconnected to %s", self._uri)
                return
            except Exception:
                continue

    def _send(self, data) -> bool:
        """Send one frame; on failure drop it and kick off reconnection.
        Returns True if the frame went out."""
        with self._lock:
            ws = self._ws
            if ws is None:
                return False
            try:
                ws.send(data)
                return True
            except Exception as e:
                log.warning("NT4 send failed (%s); reconnecting", e)
                self._on_disconnect()
                return False

    def _now_us(self) -> int:
        return (time.monotonic_ns() - self._t0) // 1000 + \
            self._server_offset_us

    def _resync_loop(self) -> None:
        while not self._closed:
            time.sleep(self.RESYNC_INTERVAL)
            if self._closed:
                return
            if self._ws is not None:
                try:
                    self._sync_time()
                except Exception:
                    pass

    def _sync_time(self) -> None:
        """RTT exchange: binary msg to topic -1 carrying our clock. Runs
        only on the resync/reconnect background threads (never the publish
        path); _sync_lock keeps the two from recv'ing concurrently."""
        with self._sync_lock:
            t1 = (time.monotonic_ns() - self._t0) // 1000
            if not self._send(mp.pack([-1, 0, TYPE_IDS["int"], int(t1)])):
                return
            ws = self._ws
            if ws is None:
                return
            try:
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    msg = ws.recv(timeout=deadline - time.monotonic())
                    if not isinstance(msg, (bytes, bytearray)):
                        continue    # topic announcements etc.
                    arr, _ = mp.unpack(bytes(msg))
                    if arr and arr[0] == -1:
                        server_time = arr[1]
                        t2 = (time.monotonic_ns() - self._t0) // 1000
                        rtt = (t2 - t1) // 2
                        self._server_offset_us = \
                            int(server_time) - int(t1) - rtt
                        return
            except Exception:
                log.debug("NT4 time sync response missed; using local time")

    def publish(self, name: str, type_str: str,
                properties: Optional[dict] = None) -> int:
        with self._lock:
            uid = self._next_pubuid
            self._next_pubuid += 1
            self._pubs[name] = (uid, type_str, properties or {})
        self._send(json.dumps([{
            "method": "publish",
            "params": {"name": name, "pubuid": uid, "type": type_str,
                       "properties": properties or {}},
        }]))
        return uid

    def set_value(self, name: str, value, timestamp_us: int = 0) -> None:
        uid, type_str, _ = self._pubs[name]
        tid = TYPE_IDS[type_str if not type_str.startswith("proto:")
                       else "raw"]
        if isinstance(value, (list, tuple)) and type_str == "double[]":
            value = [float(v) for v in value]
        ts = timestamp_us or self._now_us()
        self._send(mp.pack([uid, int(ts), tid, value]))

    def flush(self) -> None:
        pass  # the sync websocket sends eagerly; kept for API parity

    def close(self) -> None:
        self._closed = True
        with self._lock:
            if self._ws is not None:
                try:
                    self._ws.close()
                except Exception:
                    pass
                self._ws = None


class AprilTagDataSender:
    """Publishes `<table>/<key>` double[] + `<table>/<key>_protobuf` raw
    (AprilTagDataSender.cpp behavior)."""

    def __init__(self, key: str, table_address: str,
                 table_name: str = "/SmartDashboard",
                 client: NT4Client | None = None, port: int = NT4_PORT):
        self._client = client or NT4Client(table_address, port=port)
        base = table_name.rstrip("/")
        self._da_name = f"{base}/{key}"
        self._pb_name = f"{base}/{key}_protobuf"
        self._client.publish(self._da_name, "double[]")
        self._client.publish(
            self._pb_name, "proto:com.team766.vision.ApriltagListProto")

    def send_value(self, values: list) -> None:
        self._client.set_value(self._da_name, list(values))
        self._client.flush()

    def send_protobuf(self, payload: bytes) -> None:
        self._client.set_value(self._pb_name, bytes(payload))

    def set_default_value(self, values: list) -> None:
        self.send_value(values)

    def close(self):
        self._client.close()


def flatten_detections(detections, collect_time: float) -> list:
    """[t, id, x, y, z] per detection (apriltags_cuda_detector.cu:465-502)."""
    out = []
    for d in detections:
        t = d.pose_t if d.pose_t is not None else (0.0, 0.0, 0.0)
        out += [float(collect_time), float(d.tag_id),
                float(t[0]), float(t[1]), float(t[2])]
    return out


class NT4TestServer:
    """Minimal in-process NT4 server for round-trip tests (the role of the
    isolated NetworkTableInstance in apriltag_sender_test.cu:14-50)."""

    def __init__(self, port: int = 0):
        from websockets.sync.server import serve
        self.received = []        # (name, timestamp_us, value)
        self._topics = {}         # pubuid -> name
        self._announced = []
        self._cv = threading.Condition()

        self._conns = set()

        def handler(ws):
            # pubuids are scoped per client connection (NT4 spec) — a
            # multi-camera system runs one client per sender and their uids
            # collide if tracked globally
            conn_topics = {}
            self._conns.add(ws)
            try:
                self._run_conn(ws, conn_topics)
            finally:
                self._conns.discard(ws)

        self._handler = handler
        self._server = serve(handler, "127.0.0.1", port)
        self.port = self._server.socket.getsockname()[1] \
            if hasattr(self._server, "socket") else port
        if self.port == 0:
            self.port = list(self._server.server.sockets)[0].getsockname()[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _run_conn(self, ws, conn_topics):
        while True:
            try:
                msg = ws.recv()
            except Exception:
                return
            if isinstance(msg, str):
                for op in json.loads(msg):
                    if op.get("method") == "publish":
                        p = op["params"]
                        conn_topics[p["pubuid"]] = p["name"]
                        self._topics[p["pubuid"]] = p["name"]
                        with self._cv:
                            self._announced.append(p)
                            self._cv.notify_all()
            else:
                arr, _ = mp.unpack(bytes(msg))
                uid, ts, tid, val = arr
                if uid == -1:   # RTT: echo with server time
                    ws.send(mp.pack([-1, int(time.monotonic_ns() // 1000),
                                     2, val]))
                    continue
                with self._cv:
                    self.received.append(
                        (conn_topics.get(uid, f"#{uid}"), ts, val))
                    self._cv.notify_all()

    def wait_for(self, n_values: int, timeout: float = 5.0) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: len(self.received) >= n_values,
                                     timeout)

    def close(self):
        """Shut the listener AND active connections (a restartable server:
        clients must see the drop, as they would a real roboRIO reboot)."""
        self._server.shutdown()
        for ws in list(self._conns):
            try:
                ws.close()
            except Exception:
                pass
