"""CUDA graph capture and replay that keep the wrappers' launch counts and
the collective counts true.

A wrapper counts a launch in Python when it launches its kernel; a graph
replay runs the captured kernels without calling any wrapper.  So
``capture`` reads what each wrapper added to its count while the call was
captured -- nothing ran then, so it takes those counts back -- and every
``Graph.replay`` adds them again: ``launch_counts()`` counts the launches
the card ran, graphed or not.  The collectives of ``sharding/comm.py``
report to ``analysis.collectives`` the same way: the notes a capture makes
are held back (``collectives.held``) and each replay notes them again, so
a ``record()`` block counts a graphed step's collectives as an eager
step's.

The callers (``serving/runner.py``, ``launch/forward.py``,
``training/step.py``, ``training/loop.py::eval_perplexity``,
``core/sensitivity.py``) run a call once on the capture stream before they
capture it (``on_stream``): the kernel library's build and load, the split
decode kernels' per-stream counter buffer (``flash_decode._counters``: the
capture stream gets one of its own, and every graph captured on that
stream shares it; graphs replay one after another on one stream, and each
kernel leaves its counters at zero), the weight tensor-map cache of
``wgmma_tiles.cuh`` and cuBLAS's workspace all happen outside the capture,
and so does the creation of each NCCL communicator a step on a mesh uses
(at its group's first collective).  The activation tensor maps that
``moe_gmm``, ``moe_gmm_quant`` and ``moe_ffn`` encode on the host at every
call are frozen into the graph by value: right only because the graph's
memory pool keeps every intermediate at the address it was captured at, so
a pool is never captured into again while a graph that uses it is alive,
except by graphs that replay one after another with it (the shared pool of
one runner, or of one ``profile_sensitivity`` call).

The cyclic garbage collector is off while a call is captured: a dead
runner or forward held in a reference cycle would otherwise be freed in
the middle of a capture, and destroying its graphs and their memory there
invalidates the capture (a card test saw exactly that).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.analysis import collectives
from repro_torch.kernels import WRAPPERS, launch_counts


class Graph:
    """A captured call: ``replay()`` reruns it on the current stream and
    returns the tensors the capture produced (the same ones every time)."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", output,
                 launches: Dict[str, int], notes: List[Tuple[str, int, int]]):
        self.graph = graph
        self.output = output
        #: launches of each wrapper in one run of the graph
        self.launches = launches
        #: the collectives of one run, as ``collectives.note``'s arguments
        self.notes = notes

    def replay(self):
        self.graph.replay()
        for name, n in self.launches.items():
            WRAPPERS[name].launches += n
        for args in self.notes:
            collectives.note(*args)
        return self.output


#: each device's shared capture stream (``side_stream``)
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The device's capture stream for the owners that capture a graph or
    two a call (the train step, held-out eval, Alg. 1): one stream a
    device, so the buffers kept per stream (cuBLAS's workspace, the split
    decode kernels' counters) are made once, not once an owner, and stay
    out of the memory a later call measures."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def on_stream(fn: Callable, stream: "torch.cuda.Stream"):
    """Run ``fn()`` eagerly on ``stream``, ordered after the current
    stream's work and before its later work."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


def capture(fn: Callable, *, stream: "torch.cuda.Stream", pool) -> Graph:
    """Capture ``fn()`` on ``stream`` into the memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``).  ``fn`` must have run on
    ``stream`` before (``on_stream``).  A capture that fails raises;
    nothing falls back to running eagerly.  The collectives ``fn`` notes
    are held back and noted again at each replay."""
    before = launch_counts()
    g = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream), collectives.held() as notes:
            g.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                g.capture_end()
        after = launch_counts()
    finally:
        if collecting:
            gc.enable()
        for name, n in before.items():          # the capture ran nothing
            WRAPPERS[name].launches = n
    return Graph(g, out, {name: after[name] - n for name, n in before.items()
                          if after[name] != n}, notes)
