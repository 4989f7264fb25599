"""WebSocket JPEG image streamer + embedded web page.

Parity with the reference's seasocks viewer (seasocks_viewer_node.cpp:14-94:
subscribes an image topic, JPEG-encodes, broadcasts to /image websocket
clients, serves a static page). Here: an HTTP server for the page + a
websocket broadcast endpoint fed by publish(); thread-safe client set
guarded like the reference's mutex-guarded handler list.
"""
from __future__ import annotations

import http.server
import logging
import socketserver
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

INDEX_HTML = b"""<!DOCTYPE html>
<html><head><title>ros_vision_tpu viewer</title></head>
<body style="background:#111;color:#eee;font-family:sans-serif">
<h3>ros_vision_tpu camera stream</h3>
<img id="view" style="max-width:100%"/>
<script>
const ws = new WebSocket(`ws://${location.hostname}:${parseInt(location.port)+1}/image`);
ws.binaryType = 'arraybuffer';
ws.onmessage = (ev) => {
  const blob = new Blob([ev.data], {type: 'image/jpeg'});
  document.getElementById('view').src = URL.createObjectURL(blob);
};
</script></body></html>
"""


class ImageStreamServer:
    """HTTP page on `port`, websocket broadcast on `port + 1`."""

    def __init__(self, port: int = 8080, quality: int = 80):
        self.port = port
        self.quality = quality
        self._clients = set()
        self._lock = threading.Lock()
        self.frames_sent = 0

        from websockets.sync.server import serve

        def handler(ws):
            with self._lock:
                self._clients.add(ws)
            try:
                while True:
                    ws.recv()          # keep alive; clients don't send
            except Exception:
                pass
            finally:
                with self._lock:
                    self._clients.discard(ws)

        self._ws_server = serve(handler, "0.0.0.0", port + 1)
        self._ws_thread = threading.Thread(
            target=self._ws_server.serve_forever, daemon=True)
        self._ws_thread.start()

        class Page(http.server.BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(INDEX_HTML)

            def log_message(self, *a):
                pass

        self._http = socketserver.ThreadingTCPServer(("0.0.0.0", port), Page)
        self._http.daemon_threads = True
        threading.Thread(target=self._http.serve_forever,
                         daemon=True).start()

    def publish(self, image: np.ndarray) -> None:
        """JPEG-encode and broadcast to all connected clients."""
        with self._lock:
            clients = list(self._clients)
        if not clients:
            return
        import cv2
        ok, jpg = cv2.imencode(".jpg", image,
                               [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            return
        payload = jpg.tobytes()
        for ws in clients:
            try:
                ws.send(payload)
                self.frames_sent += 1
            except Exception:
                with self._lock:
                    self._clients.discard(ws)

    def close(self):
        self._ws_server.shutdown()
        self._http.shutdown()
