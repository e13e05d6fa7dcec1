"""Parameter init for one MoE layer (bf16 expert storage only)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param_dtype
from repro_torch.models.mlp import init_mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = param_dtype(cfg)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p: Dict = {
        "router": dense_init(gen, (d, e), torch.float32, device),  # kept f32
        "w1": dense_init(gen, (e, d, 2 * f), dt, device),
        "w2": dense_init(gen, (e, f, d), dt, device, in_axis_size=f),
    }
    if cfg.num_shared_experts:
        sf = cfg.shared_expert_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = init_mlp(gen, cfg, device, d_ff=sf)
    return p
