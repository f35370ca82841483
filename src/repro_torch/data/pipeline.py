"""Host-side input pipeline: shard-aware batching with background prefetch
(the port's copy of ``repro/data/pipeline.py``; host numpy)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class DataPipeline:
    """Wraps a batch-producing callable with a prefetch thread.

    Args:
      make_batch: ``(step) -> dict of numpy arrays`` (global batch).
      shard_fn: optional ``(batch) -> batch`` slicing to this host's shard
        (multi-host data parallelism); identity by default.
      prefetch: queue depth.
    """

    def __init__(
        self,
        make_batch: Callable[[int], Dict[str, np.ndarray]],
        shard_fn: Optional[Callable] = None,
        prefetch: int = 2,
    ):
        self._make = make_batch
        self._shard = shard_fn or (lambda b: b)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            batch = self._shard(self._make(step))
            step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        # drain so the worker can exit a blocked put
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def host_shard_fn(host_id: int, num_hosts: int) -> Callable:
    """Slice the leading batch dim to this host's contiguous shard."""

    def fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            assert b % num_hosts == 0, (k, b, num_hosts)
            per = b // num_hosts
            out[k] = v[host_id * per : (host_id + 1) * per]
        return out

    return fn
