"""Compute stage: expert SwiGLU over the capacity, the sorted and the
routed layouts.

Each has a plain path (``use_kernel=False``, the reference's jnp path)
and a kernel path through ``repro_torch.kernels`` (whose wrappers run the
kernel's plain version on CPU tensors).

Under a bound mesh whose ``model`` axis does not split the experts but
splits their F (``sharding.rules._moe_w1`` / ``_moe_w2``), ``dense``,
``gmm`` and ``decode`` run each expert on the rank's F block
(``FSlice``): the same routing on every rank, the expert input and the
combine weights through ``f``, the combined output summed over ``model``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F_

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.dispatch import SortPlan
from repro_torch.models.tp import TP, mlp_tp


class FSlice:
    """Tensor parallelism of a MoE layer whose experts hold the rank's F
    block (module doc); a no-op without a mesh or where F stays whole."""

    def __init__(self, params: Dict, cfg: ModelConfig, mesh):
        tp = TP(mesh)
        if tp.on and cfg.num_experts % tp.m == 0:
            raise ValueError(
                f"the experts split over model={tp.m} (expert parallelism): "
                f"the rank holds {params['w1'].shape[0]} of "
                f"{cfg.num_experts}; run ep_a2a / ep_psum "
                "(models.moe.mesh_impl)")
        self.tp = tp if tp.splits(cfg.moe_d_ff) else TP(None)

    def inputs(self, x2d, weights):
        """The expert input and the combine weights, through ``f``."""
        return self.tp.f(x2d), self.tp.f(weights)

    def output(self, y):
        """The rank's partial combined output summed over ``model``."""
        return self.tp.g(y)


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


def routed_ffn(w1, w2, x2d, idx, weights, use_kernel: bool = False,
               pred_idx=None):
    """x2d [T, D] + routing (idx, weights) [T, k] -> combined [T, D].

    ``pred_idx`` [T, k] (router lookahead) stages the plain path's weight
    gathers on the predicted ids, hit-selected against the true ids; the
    CUDA kernel ignores it.  The output never depends on it."""
    if use_kernel:
        from repro_torch.kernels import moe_decode
        return moe_decode(x2d, w1, w2, idx, weights, pred_idx)
    from repro_torch.kernels.moe_decode import moe_decode_plain
    return moe_decode_plain(x2d, w1, w2, idx, weights, pred_idx)


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
                     use_kernel: bool = False, *, expert_dtype: str,
                     pred_idx=None):
    """``routed_ffn`` over int8-stored expert tiles (in-kernel dequant on
    the kernel path, dequant-after-gather on the plain path, whose gathers
    stage on ``pred_idx`` when given)."""
    w1q, w2q, s1, s2 = quant_leaves(params, expert_dtype)
    if use_kernel:
        from repro_torch.kernels import moe_decode_quant
        return moe_decode_quant(x2d, w1q, w2q, s1, s2, idx, weights,
                                pred_idx, dtype=expert_dtype)
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    return moe_decode_quant_plain(x2d, w1q, w2q, s1, s2, idx, weights,
                                  dtype=expert_dtype, pred_idx=pred_idx)


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


def add_shared(params: Dict, cfg: ModelConfig, x2d, y, mesh=None):
    """Always-on shared experts on top of the routed output; under a mesh
    a tensor-parallel MLP (``models/tp.py``)."""
    if cfg.num_shared_experts:
        sf = cfg.shared_expert_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
        y = y + mlp_tp(params["shared"], x2d, mesh, sf)
    return y
