"""``decode`` impl: fused routed-expert path for decode-shaped batches.

No sort plan and no packed buffer: the router's top-k ids go straight to
the compute stage (the ``moe_decode`` kernel on the card), which reads
only the k routed experts per token.  Per-layer k sets the issued work
directly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.compute import FSlice, add_shared, \
    routed_ffn, routed_ffn_quant
from repro_torch.models.moe.router import route


def moe_decode(params: Dict, cfg: ModelConfig, x2d: torch.Tensor, top_k: int,
               use_kernel: bool = False, *, expert_dtype: str = "bf16",
               pred_idx=None, k_budget=None, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, D] -> (y2d [T, D], aux_loss).  Dropless; decode-shaped T.

    ``expert_dtype`` != "bf16" reads int8-stored expert tiles and their
    scale rows (``quantize_expert_params``); the router runs full
    precision either way.  ``pred_idx`` [T, k] is the router-lookahead
    hint: the plain path's weight gathers stage on it and hit-select
    against the true ids; outputs never depend on it.  Under a mesh each
    expert's F block (``compute.FSlice``)."""
    fs = FSlice(params, cfg, mesh)
    weights, idx, aux = route(params, cfg, x2d, top_k, k_budget=k_budget)
    xf, wf = fs.inputs(x2d, weights)
    if expert_dtype == "bf16":
        y = routed_ffn(params["w1"], params["w2"], xf, idx, wf,
                       use_kernel, pred_idx=pred_idx)
    else:
        y = routed_ffn_quant(params, xf, idx, wf, use_kernel,
                             expert_dtype=expert_dtype, pred_idx=pred_idx)
    return add_shared(params, cfg, x2d, fs.output(y).to(x2d.dtype), mesh), aux
