"""Fault-tolerant checkpointing: atomic, keep-N, async, device-free (the
port's counterpart of ``repro.checkpoint.manager``).

Layout:  <dir>/step_<N>/
             meta.json      (step, extra, each leaf's dtype)
             arrays.npz     (flat path-keyed leaves, as the reference's)

Guarantees:
  * **atomic**: written to ``step_<N>.tmp`` then ``os.replace``d -- a crash
    mid-write never corrupts the latest checkpoint (restore scans only
    completed dirs);
  * **keep-N**: older checkpoints garbage-collected after a successful save;
  * **async**: ``save(..., blocking=False)`` copies the tree to host memory
    and hands it to one writer thread, so the train loop never waits on
    the disk;
  * **any device**: arrays are stored on the host; ``restore`` places each
    leaf on ``device`` (or the device of the matching leaf of ``like``), so
    a checkpoint saved on the card restores on the CPU, and back;
  * **any mesh**: under a mesh the caller gathers the ranks' blocks and
    one rank saves the whole arrays (``training/loop.py``); ``restore``
    with ``shardings`` cuts each rank's block again.

numpy has no bfloat16 of its own, so a bf16 leaf is stored as its raw 16
bits (int16) and ``meta.json`` names its dtype.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, leaves, unflatten

_DTYPES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """-> (a numpy copy, the dtype name to restore)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), type(leaf).__name__
    raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last_future: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # save
    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[Dict] = None) -> None:
        # snapshot to host memory first (the train step updates the
        # params and moments in place)
        flat, dtypes = {}, {}
        for key, leaf in flatten_with_paths(tree):
            flat[key], dtypes[key] = _to_host(leaf)
        meta = {"step": step, "extra": extra or {}, "dtypes": dtypes}

        # one write at a time: a blocking save of the step an async one is
        # still writing would race it for the same .tmp dir
        self.wait()
        if blocking:
            self._write(step, flat, meta)
        else:
            self._last_future = self._pool.submit(self._write, step, flat,
                                                  meta)

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               meta: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with self._lock:
            self._gc()

    def wait(self) -> None:
        if self._last_future is not None:
            self._last_future.result()
            self._last_future = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    # restore
    # ------------------------------------------------------------------ #
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` -> (tree, meta).  Tensor
        leaves take the dtype of ``like``'s leaf and land on ``device``, or
        on the device of ``like``'s leaf (which may be a ``meta`` tensor
        when ``device`` is given).

        ``shardings``: a matching tree of ``sharding.Sharding`` on a bound
        mesh -- each leaf becomes the rank's block of the stored whole
        array (elastic restore: the checkpoint holds whole arrays, so
        it resumes on any mesh shape, or none).  ``like`` holds the whole
        shapes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}

        flat = flatten_with_paths(like)
        shs = (leaves(shardings) if shardings is not None
               else [None] * len(flat))
        if len(shs) != len(flat):
            raise ValueError(f"{len(shs)} shardings for {len(flat)} leaves")
        out = []
        for (key, leaf), sh in zip(flat, shs):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr, name = arrays[key], meta["dtypes"][key]
            if not isinstance(leaf, torch.Tensor):
                out.append(type(leaf)(arr.item()))
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if name == "bfloat16":
                t = t.view(torch.bfloat16)
            elif t.dtype != _DTYPES[name]:
                raise ValueError(f"{key}: stored {t.dtype}, meta says {name}")
            if sh is not None and sh.sharded:
                t = sh.local(t).clone()
            out.append(t.to(device if device is not None else leaf.device,
                            leaf.dtype))
        return unflatten(like, out), meta
