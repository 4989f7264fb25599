# Frozen copy of NT4TestServer from ros_vision_tpu_torch/runtime/nt4.py
# at commit 5b978635277ede7c3d2dd15eeb95ccc7be8ca268,
# kept for the benchmark alone, so that the yardstick does not move
# when the port does. Changed: the imports, and each received value
# carries its arrival time (time.time()), read under the server's lock.
"""The robot's stand-in: an NT4 server that records every value published
to it and when it arrived.

The robot's NT4 server runs on another machine, so the stream driver runs
this one in a process of its own (`ServerProcess`): its connection
threads then take no turns at the interpreter lock of the process under
test. `python3 -m benchmark.harness.nt4_server` serves on a free local
port, prints it, and on a line "stop" on its standard input prints every
double-array value received, with its arrival time, as JSON lines, then
exits.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from benchmark.harness import msgpack_mini as mp


class NT4TestServer:
    """Minimal in-process NT4 server for round-trip tests (the role of the
    isolated NetworkTableInstance in apriltag_sender_test.cu:14-50)."""

    def __init__(self, port: int = 0):
        from websockets.sync.server import serve
        self.received = []        # (name, timestamp_us, value, arrival s)
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
                        (conn_topics.get(uid, f"#{uid}"), ts, val,
                         time.time()))
                    self._cv.notify_all()

    def close(self):
        """Shut the listener AND active connections (a restartable server:
        clients must see the drop, as they would a real roboRIO reboot)."""
        self._server.shutdown()
        for ws in list(self._conns):
            try:
                ws.close()
            except Exception:
                pass


class ServerProcess:
    """NT4TestServer in a child process of this one; `received` is filled
    by stop(): (topic name, NT timestamp us, value, arrival epoch s) of
    every double-array value."""

    def __init__(self):
        root = Path(__file__).resolve().parents[2]
        env = dict(os.environ, PYTHONPATH=str(root))
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.harness.nt4_server"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=root, env=env)
        self.port = int(self._proc.stdout.readline())
        self.received = []

    def stop(self) -> None:
        try:
            out, _ = self._proc.communicate("stop\n", timeout=60)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
        self.received = [tuple(json.loads(line))
                         for line in out.splitlines() if line]


def main() -> int:
    server = NT4TestServer()
    print(server.port, flush=True)
    sys.stdin.readline()
    server.close()
    server._thread.join(timeout=10)
    with server._cv:
        rows = list(server.received)
    for name, ts, val, arrival in rows:
        if isinstance(val, list):
            print(json.dumps([name, ts, val, arrival]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
