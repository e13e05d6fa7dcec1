"""``dense`` impl: GShard-style capacity-buffer dispatch (single device).

Every config's default impl.  Token copies are scattered into ``[E, C, D]``
buffers (C from ``capacity``, at the config's ``moe_capacity_factor``);
copies past an expert's capacity are dropped.  The compute walks every
expert, empty or not (the ``moe_ffn`` kernel on the card), so its cost
follows C, not the routed copies.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.compute import FSlice, add_shared, expert_ffn
from repro_torch.models.moe.dispatch import _gather_combine, _scatter, \
    _slot_positions
from repro_torch.models.moe.router import capacity, route


def moe_dense(params: Dict, cfg: ModelConfig, x2d: torch.Tensor, top_k: int,
              use_kernel: bool = False, *, k_budget=None, mesh=None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, D] -> (y2d [T, D], aux_loss).  bf16 (unquantized) experts;
    under a mesh the rank's F block of each (``compute.FSlice``)."""
    t, _ = x2d.shape
    e = cfg.num_experts
    fs = FSlice(params, cfg, mesh)
    weights, idx, aux = route(params, cfg, x2d, top_k, k_budget=k_budget)
    cap = capacity(t, top_k, e, cfg.moe_capacity_factor)
    pos, keep = _slot_positions(idx, e, cap)
    xf, wf = fs.inputs(x2d, weights)
    xe = _scatter(xf, idx, pos, keep, e, cap)                     # [E, C, D]
    ye = expert_ffn(params["w1"], params["w2"], xe, use_kernel)
    y = fs.output(_gather_combine(ye, wf, idx, pos, keep, cap)).to(x2d.dtype)
    return add_shared(params, cfg, x2d, y, mesh), aux
