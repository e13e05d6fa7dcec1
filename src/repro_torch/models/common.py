"""Shared model primitives: device and dtype policy, norms, RoPE."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# --------------------------------------------------------------------------- #
# device + dtype policy
# --------------------------------------------------------------------------- #


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  With no GPU present and the CPU not asked for, raise --
    never carry on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def count_params(params) -> int:
    """Elements over every tensor of a param tree."""
    from repro_torch.tree import leaves
    return sum(int(x.numel()) for x in leaves(params))


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# --------------------------------------------------------------------------- #
# Initializers (drawn on the target device from an explicit generator)
# --------------------------------------------------------------------------- #


def dense_init(gen: torch.Generator, shape, dtype, device,
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """Fan-in normal init, clamped at two standard deviations."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / max(fan_in, 1) ** 0.5
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return w.clamp_(-2.0, 2.0).mul_(std)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(0.02)


# --------------------------------------------------------------------------- #
# Normalization
# --------------------------------------------------------------------------- #


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None):
    """The params dict for one norm: ``{}`` for OLMo's non-parametric
    LayerNorm, ``scale`` and ``bias`` for LayerNorm, ``scale`` for
    RMSNorm."""
    d = d or cfg.d_model
    dt = param_dtype(cfg)
    if cfg.norm_type == "nonparam_ln":
        return {}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=dt, device=device),
                "bias": torch.zeros(d, dtype=dt, device=device)}
    return {"scale": torch.ones(d, dtype=dt, device=device)}


def apply_norm(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm / OLMo's non-parametric LayerNorm: statistics in
    f32 (LayerNorm's variance the biased one), output cast back to the
    input dtype."""
    xdt = x.dtype
    x = x.float()
    if cfg.norm_type == "rmsnorm":
        var = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.norm_eps) * params["scale"].float()
    else:
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(xdt)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm for qk-norm (scale shaped [head_dim])."""
    xdt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(xdt)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by per-token ``positions [..., S]``
    (split-halves convention, as the reference)."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)                     # [D/2]
    angles = positions[..., None].float() * freqs                # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
