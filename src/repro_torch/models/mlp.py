"""Dense SwiGLU MLP."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F_

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param_dtype


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: int = 0) -> Dict:
    dt = param_dtype(cfg)
    f = d_ff or cfg.d_ff
    return {
        # gate and up fused into one matmul: [D, 2F]
        "w1": dense_init(gen, (cfg.d_model, 2 * f), dt, device),
        "w2": dense_init(gen, (f, cfg.d_model), dt, device, in_axis_size=f),
    }


def mlp(params: Dict, x):
    h = x @ params["w1"]
    f = params["w2"].shape[0]
    return (F_.silu(h[..., :f]) * h[..., f:]) @ params["w2"]
