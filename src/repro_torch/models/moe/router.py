"""Router stage: expert scoring, top-k selection, the aux loss, capacity
sizing.

``route`` is the single source of truth for scores, the NAEE
dynamic-skipping baseline and the load-balancing loss, so the dispatch
impls stay numerically interchangeable (as in ``repro.models.moe.router``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


def route(params: Dict, cfg: ModelConfig, x2d: torch.Tensor, top_k: int,
          k_budget: Optional[torch.Tensor] = None):
    """x2d [T, D] -> (weights [T,k] f32, idx [T,k] int32, aux_loss scalar).

    ``k_budget`` (optional, [T] int) caps the number of *active* experts per
    token below the static ``top_k``: routed slots at positions >= the
    token's budget get weight exactly 0.0 *before* the top-k
    renormalization, so they add exactly nothing in every combine.
    """
    logits = x2d.float() @ params["router"].float()              # [T, E]
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(scores, top_k, dim=-1)             # [T, k]
    if k_budget is not None:
        slot = torch.arange(top_k, device=x2d.device)[None, :]
        weights = torch.where(slot < k_budget[:, None], weights, 0.0)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    if cfg.dynamic_skip_tau > 0.0 and top_k >= 2:
        # NAEE dynamic skipping baseline: drop low-confidence extra experts
        thresh = cfg.dynamic_skip_tau * weights[:, :1]
        keep = torch.cat([torch.ones_like(weights[:, :1], dtype=torch.bool),
                          weights[:, 1:] >= thresh], dim=1)
        weights = weights * keep

    # Switch-transformer load-balancing auxiliary loss
    e = cfg.num_experts
    # expert frequencies by scatter-add (one_hot would sync to validate ids)
    me = torch.zeros(e, device=x2d.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x2d.device))
    me = me / idx.numel()
    ce = torch.softmax(logits, dim=-1).mean(0)
    aux = e * (me * ce).sum()
    return weights, idx.to(torch.int32), aux


def route_lookahead(params: Dict, cfg: ModelConfig, x2d: torch.Tensor,
                    top_k: int) -> torch.Tensor:
    """Predict this layer's top-k expert ids from the *previous* layer's
    pre-FFN hidden state -> pred_idx [T, k] int32.

    The hint scores the previous layer's pre-FFN hidden through *this*
    layer's router: residual streams change slowly across adjacent layers,
    so the top-k sets usually agree.  Only the id selection of ``route`` is
    replicated (the same scoring function, the same ``torch.topk``
    tie-breaking); weights, NAEE skipping and the aux loss stay with
    ``route`` on the true input.  Consumers hit-select staged loads against
    the true ids, so a miss costs a fallback load, never an output change.
    """
    logits = x2d.float() @ params["router"].float()              # [T, E]
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    return torch.topk(scores, top_k, dim=-1)[1].to(torch.int32)


def capacity(t: int, top_k: int, num_experts: int, factor: float) -> int:
    """Per-expert buffer rows for the capacity-buffer dispatch: at least 4,
    padded to a multiple of 4."""
    c = int(math.ceil(t * top_k / num_experts * factor))
    return max(4, ((c + 3) // 4) * 4)
