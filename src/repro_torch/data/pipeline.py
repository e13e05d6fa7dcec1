"""Prefetching, restart-deterministic input pipeline (the port's copy of
``repro.data.pipeline``).

A background thread keeps a small queue of ready host batches (numpy) so
data generation overlaps the device step.  ``start_step`` makes restarts
exact: the pipeline replays from the step recorded in the checkpoint.
``to_device`` moves a batch to the device the step runs on.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import DataConfig, sample_batch


class Pipeline:
    def __init__(self, dc: DataConfig, *, start_step: int = 0,
                 prefetch: int = 2):
        self.dc = dc
        self.step = start_step
        #: host seconds the worker spent making batches, and their count
        self.make_s = 0.0
        self.made = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            t0 = time.perf_counter()
            batch = sample_batch(self.dc, step)
            self.make_s += time.perf_counter() - t0
            self.made += 1
            batch["_step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def seconds_per_batch(self) -> float:
        """Mean host seconds the worker took to make one batch."""
        return self.make_s / max(self.made, 1)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._q.get()
        self.step = batch.pop("_step") + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``; on the card each copy goes
    through pinned memory and does not block the host."""
    dev = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out
