"""NAEE-style dynamic expert skipping baseline (Lu et al. 2024).

Token-aware: during inference, an expert past the first is skipped for a
token when its routing weight falls below ``tau * weight_of_top1``
(``route`` applies ``cfg.dynamic_skip_tau``).  The paper notes this is (a)
limited to top-k >= 2 regimes and (b) data-dependent -- the skip decision
varies per token, so it cannot shrink static dispatch shapes: only the
*quality* effect is real, plus an *expected* FLOP saving reported
analytically (``expected_skip_rate``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation_dtype


def with_dynamic_skipping(cfg: ModelConfig, tau: float) -> ModelConfig:
    """Enable skipping (routing-level; see ``models/moe/router.route``)."""
    if cfg.moe_top_k < 2:
        raise ValueError("dynamic skipping needs top-k >= 2 (paper §1)")
    return cfg.with_(dynamic_skip_tau=float(tau))


def skip_share(params_moe: Dict, cfg: ModelConfig, tau: float,
               x: torch.Tensor) -> float:
    """The fraction of non-top1 routed slots of hidden states x [T, D]
    whose weight falls below ``tau`` times the top-1 weight."""
    from repro_torch.models.moe import route
    w, _, _ = route(params_moe, cfg.with_(dynamic_skip_tau=0.0), x,
                    cfg.moe_top_k)
    skipped = (w[:, 1:] < tau * w[:, :1]).sum()
    return float(skipped) / float(w[:, 1:].numel())


def expected_skip_rate(params_moe: Dict, cfg: ModelConfig, tau: float,
                       n_samples: int = 4096, seed: int = 0) -> float:
    """Monte-Carlo estimate of the fraction of non-top1 slots skipped
    (``skip_share``), on ``n_samples`` standard-normal hidden states drawn
    from a generator seeded by ``seed`` on the router's device."""
    dev = params_moe["router"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n_samples, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float32).to(activation_dtype(cfg))
    return skip_share(params_moe, cfg, tau, x)
