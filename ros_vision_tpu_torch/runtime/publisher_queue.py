"""Bounded drop-oldest publisher queue with a dedicated publisher thread.

Same semantics as the reference's PublisherQueue (publisher_queue.hpp:10-65):
enqueue() drops the OLDEST entry when full (bounded latency over
completeness — a frame late is a frame wasted on a robot), a single worker
thread drains the queue into the publisher callable, stop() joins cleanly.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable


class PublisherQueue:
    def __init__(self, publish: Callable, max_queue_size: int = 2,
                 name: str = "publisher_queue"):
        self._publish = publish
        self._max = max_queue_size
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._running = True
        self._dropped = 0
        self._published = 0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def enqueue(self, msg) -> None:
        with self._cv:
            if len(self._q) >= self._max:
                self._q.popleft()          # drop oldest
                self._dropped += 1
            self._q.append(msg)
            self._cv.notify()

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def published(self) -> int:
        return self._published

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._q or not self._running)
                if not self._running and not self._q:
                    return
                msg = self._q.popleft() if self._q else None
            if msg is not None:
                try:
                    self._publish(msg)
                    self._published += 1
                except Exception:  # publisher errors must not kill the drain
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
