"""Compute stage: expert SwiGLU over the capacity, the sorted and the
routed layouts.

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


def expert_ffn(w1, w2, xe, use_kernel: bool = False):
    """xe [E, C, D] -> [E, C, D] (SwiGLU per expert, capacity layout)."""
    if use_kernel:
        from repro_torch.kernels import moe_ffn
        return moe_ffn(xe, w1, w2)
    f = w2.shape[1]
    h = torch.bmm(xe, w1)
    h = F_.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(h, w2)


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


def quant_leaves(params: Dict, expert_dtype: str):
    """(w1q, w2q, s1, s2) from a quantized MoE layer dict, with a clear
    error when the params were never quantized (the opts/engine contract
    is quantize-at-load; raw weights here are a wiring bug)."""
    if "w1_scale" not in params:
        raise ValueError(
            f"expert_dtype={expert_dtype!r} needs quantized params: run "
            "models.moe.quantize_expert_params (Engine(expert_dtype=...) "
            "does this at load)")
    return (params["w1"], params["w2"], params["w1_scale"],
            params["w2_scale"])


def routed_ffn_quant(params: Dict, x2d, idx, weights,
                     use_kernel: bool = False, *, expert_dtype: str):
    """``routed_ffn`` over int8-stored expert tiles (in-kernel dequant on
    the kernel path, dequant-after-gather on the plain path)."""
    w1q, w2q, s1, s2 = quant_leaves(params, expert_dtype)
    if use_kernel:
        from repro_torch.kernels import moe_decode_quant
        return moe_decode_quant(x2d, w1q, w2q, s1, s2, idx, weights,
                                dtype=expert_dtype)
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    return moe_decode_quant_plain(x2d, w1q, w2q, s1, s2, idx, weights,
                                  dtype=expert_dtype)


def grouped_ffn_quant(params: Dict, xs, plan: SortPlan,
                      use_kernel: bool = False, *, expert_dtype: str):
    """``grouped_ffn`` over int8-stored expert tiles: the per-tile gather
    moves int8 (int4: packed) weights, s1 multiplies after the w1 product
    and s2 folds into h before the w2 product."""
    w1q, w2q, s1, s2 = quant_leaves(params, expert_dtype)
    if use_kernel:
        from repro_torch.kernels import moe_gmm_quant
        return moe_gmm_quant(xs, w1q, w2q, s1, s2, plan.tile_expert,
                             plan.tile_valid, dtype=expert_dtype,
                             block_m=plan.block_m)
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    return moe_gmm_quant_plain(xs, w1q, w2q, s1, s2, plan.tile_expert,
                               plan.tile_valid, plan.block_m,
                               dtype=expert_dtype)


def add_shared(params: Dict, cfg: ModelConfig, x2d, y):
    """Always-on shared experts on top of the routed output."""
    if cfg.num_shared_experts:
        y = y + mlp(params["shared"], x2d)
    return y
