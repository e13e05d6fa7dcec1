"""``gmm`` impl: sort-based dropless dispatch + ragged grouped SwiGLU.

The production path at prefill scale: argsort token copies by expert id,
run the grouped SwiGLU over the tile-aligned groups (the ``moe_gmm``
kernel on the card), unsort and combine.  Work scales with the occupied
tiles, so a LExI plan's smaller per-layer k runs fewer of them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.compute import FSlice, add_shared, \
    grouped_ffn, grouped_ffn_quant
from repro_torch.models.moe.dispatch import default_block_m, \
    make_sort_plan, sort_combine, sort_dispatch
from repro_torch.models.moe.router import route


def moe_gmm(params: Dict, cfg: ModelConfig, x2d: torch.Tensor, top_k: int,
            use_kernel: bool = False, block_m: Optional[int] = None, *,
            expert_dtype: str = "bf16", k_budget=None, mesh=None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, D] -> (y2d [T, D], aux_loss).  Dropless for any T, k.

    ``expert_dtype`` != "bf16" runs the grouped FFN over int8-stored
    expert tiles (``grouped_ffn_quant``); routing and the sort plan are
    the same either way.  Under a mesh each expert's F block
    (``compute.FSlice``)."""
    t, _ = x2d.shape
    fs = FSlice(params, cfg, mesh)
    weights, idx, aux = route(params, cfg, x2d, top_k, k_budget=k_budget)
    # the kernel takes row tiles of 8 rows or more
    bm = block_m or default_block_m(t * top_k, floor=8 if use_kernel else 1)
    plan = make_sort_plan(idx, cfg.num_experts, bm)
    xf, wf = fs.inputs(x2d, weights)
    xs = sort_dispatch(xf, plan, top_k)                           # [M, D]
    if expert_dtype == "bf16":
        ys = grouped_ffn(params["w1"], params["w2"], xs, plan, use_kernel)
    else:
        ys = grouped_ffn_quant(params, xs, plan, use_kernel,
                               expert_dtype=expert_dtype)
    y = fs.output(sort_combine(ys, wf, plan)).to(x2d.dtype)
    return add_shared(params, cfg, x2d, y, mesh), aux
