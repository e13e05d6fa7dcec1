"""Gradient compression with error feedback (the port's counterpart of
``repro.optim.compression``).

int8 per-tensor symmetric quantization of gradients, with an error-feedback
accumulator: the quantization residual is carried into the next step, so
compression bias vanishes and convergence tracks the uncompressed run.  The
quantize / dequantize pair runs inside the step, so the numerics are what a
compressed data-parallel all-reduce would produce.

The scales follow the reference's tree, which stacks each run of identical
layers (``models/blocks.py::group_pattern`` over ``cfg.pattern()``) into one
leaf: given ``cfg``, a layer tensor shares its scale with the same tensor of
every other layer of its group.  A LExI plan splits the runs, so a planned
stack has more scales.  Without ``cfg`` every leaf is scaled alone.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import group_pattern
from repro_torch.tree import flatten_with_paths, leaves, map_tree, unflatten


def init_error_state(params) -> Any:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def scale_groups(tree, cfg: Optional[ModelConfig] = None) -> List[List[int]]:
    """The leaves (indices into ``leaves(tree)``) that share one scale: a
    path ``layers/<i>/<rest>`` joins the same ``rest`` of the other layers
    of layer i's group under ``cfg``; any other leaf is alone."""
    group_of: Dict[int, int] = {}
    if cfg is not None:
        for gi, g in enumerate(group_pattern(cfg.pattern())):
            for i in range(g.start, g.start + g.count):
                group_of[i] = gi
    keys: Dict[Tuple, List[int]] = {}
    for n, (path, _) in enumerate(flatten_with_paths(tree)):
        parts = path.split("/", 2)
        key: Tuple = (path,)
        if parts[0] == "layers" and len(parts) == 3 and group_of:
            key = ("layers", group_of[int(parts[1])], parts[2])
        keys.setdefault(key, []).append(n)
    return list(keys.values())


@torch.no_grad()
def compress_grads(grads, err_state, cfg: Optional[ModelConfig] = None, *,
                   amax_reduce: Optional[Callable] = None
                   ) -> Tuple[Any, Any]:
    """Returns (dequantized grads as seen after the all-reduce, the error
    state); one scale per leaf of the reference's stacked tree for ``cfg``
    (``scale_groups``).  ``amax_reduce`` maps the groups' amaxes [G] to
    the global ones (under a mesh, a max over the ranks whose slices of a
    leaf differ).  The residuals are written into ``err_state``'s tensors
    in place (a CUDA graph of the train step reads and writes them at the
    addresses it captured), and ``err_state`` is returned."""
    gs, es = leaves(grads), leaves(err_state)
    deq: List[Any] = [None] * len(gs)
    groups = scale_groups(grads, cfg)
    # each group's scale first, then each leaf again: one leaf's f32 copy
    # at a time, not the whole group's
    amax = torch.stack([torch.stack([(gs[i].float() + es[i]).abs().max()
                                     for i in idx]).max() for idx in groups])
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    for gi, idx in enumerate(groups):
        scale = amax[gi].clamp(min=1e-12) / 127.0
        for i in idx:
            g = gs[i].float() + es[i]            # apply error feedback
            q = (g / scale).round().clamp(-127, 127).to(torch.int8)
            d = q.float() * scale                # what the collective carries
            deq[i] = d.to(gs[i].dtype)
            torch.sub(g, d, out=es[i])           # residual -> next step
    return unflatten(grads, deq), err_state


def compression_bytes_saved(params, cfg: Optional[ModelConfig] = None) -> int:
    """All-reduce byte reduction per step (f32 -> i8 + a scale per leaf of
    the reference's stacked tree)."""
    total = sum(p.numel() for p in leaves(params))
    return total * 4 - (total + 4 * len(scale_groups(params, cfg)))
