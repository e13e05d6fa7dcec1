"""Gradient compression with error feedback (the port's counterpart of
``repro.optim.compression``).

int8 per-tensor symmetric quantization of gradients, with an error-feedback
accumulator: the quantization residual is carried into the next step, so
compression bias vanishes and convergence tracks the uncompressed run.  The
quantize / dequantize pair runs inside the step, so the numerics are what a
compressed data-parallel all-reduce would produce.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, map_tree, unflatten


def init_error_state(params) -> Any:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(g: torch.Tensor):
    scale = g.abs().max().clamp(min=1e-12) / 127.0
    q = (g / scale).round().clamp(-127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, err_state) -> Tuple[Any, Any]:
    """Returns (dequantized grads as seen after the all-reduce, new error
    state)."""
    deq, err = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        g32 = g.float() + e                      # apply error feedback
        q, scale = _quantize(g32)
        d = q.float() * scale                    # what the collective carries
        deq.append(d.to(g.dtype))
        err.append(g32 - d)                      # residual -> next step
    return unflatten(grads, deq), unflatten(err_state, err)


def compression_bytes_saved(params) -> int:
    """All-reduce byte reduction per step (f32 -> i8 + per-tensor scale)."""
    ls = leaves(params)
    total = sum(p.numel() for p in ls)
    return total * 4 - (total + 4 * len(ls))
