"""Double-buffered host→device prefetch (BASELINE.json north star: 'host-side
image decode/augment pipeline that feeds HBM via device prefetch').

A background thread runs the (native) augment pipeline and issues
jax.device_put ahead of consumption, so H2D transfer and host augment overlap
with the device step.  Queue depth 2 = classic double buffering."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import jax


class DevicePrefetcher:
    def __init__(self, loader, sharding=None, depth: int = 2):
        self.loader = loader
        self.sharding = sharding
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                images, labels = self.loader.next_batch()
                if self.sharding is not None:
                    images = jax.device_put(images, self.sharding)
                    labels = jax.device_put(labels, self.sharding)
                else:
                    images = jax.device_put(images)
                    labels = jax.device_put(labels)
                while not self._stop.is_set():
                    try:
                        self._q.put((images, labels), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on next __next__
            self._exc = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise StopIteration

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
