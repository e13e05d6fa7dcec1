"""Compute stage: expert SwiGLU over the sorted and the routed layouts.

Each has a plain path (``use_kernel=False``, the reference's jnp path)
and a kernel path through ``repro_torch.kernels`` (whose wrappers run the
kernel's plain version on CPU tensors).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F_

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mlp import mlp
from repro_torch.models.moe.dispatch import SortPlan


def grouped_ffn(w1, w2, xs, plan: SortPlan, use_kernel: bool = False):
    """xs [M, D] sorted-by-expert -> [M, D] (padding rows stay zero)."""
    if use_kernel:
        from repro_torch.kernels import moe_gmm
        return moe_gmm(xs, w1, w2, plan.tile_expert, plan.tile_valid,
                       block_m=plan.block_m)
    m, d = xs.shape
    f = w2.shape[1]
    te = plan.tile_expert.long()
    xt = xs.reshape(-1, plan.block_m, d)
    h = torch.bmm(xt, w1[te])
    h = F_.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(h, w2[te]).reshape(m, d)


def routed_ffn(w1, w2, x2d, idx, weights, use_kernel: bool = False):
    """x2d [T, D] + routing (idx, weights) [T, k] -> combined [T, D]."""
    if use_kernel:
        from repro_torch.kernels import moe_decode
        return moe_decode(x2d, w1, w2, idx, weights)
    from repro_torch.kernels.moe_decode import moe_decode_plain
    return moe_decode_plain(x2d, w1, w2, idx, weights)


def add_shared(params: Dict, cfg: ModelConfig, x2d, y):
    """Always-on shared experts on top of the routed output."""
    if cfg.num_shared_experts:
        y = y + mlp(params["shared"], x2d)
    return y
