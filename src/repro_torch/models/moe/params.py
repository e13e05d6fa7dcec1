"""Parameter init + quantized storage for one MoE layer.

``init_moe`` draws the bf16 (or f32) expert weights.  ``quantize_experts``
/ ``dequantize_experts`` define the quantized expert-weight format the
inference paths consume, the same as ``repro.models.moe.params``:
symmetric per-(expert, f-channel) f32 scales.

  w1 [.., E, D, 2F]  one scale per (gate|up, f-column), over the
                     contraction dim D: ``w1_scale [.., E, 2, F]``, applied
                     *after* the x @ w1 product.
  w2 [.., E, F, D]   one scale per f-*row*: ``w2_scale [.., E, F]``, folded
                     into the hidden activation *before* the h @ w2 product
                     (it varies along the F contraction, so it cannot move
                     past it).

``int4`` packs two nibbles per int8 byte along D in blocked halves: byte
``i`` holds element ``i`` (low nibble) and element ``i + D//2`` (high
nibble) -- not the interleaved (2i, 2i+1) pairs of most GPU int4 formats.
D is the contraction dim of w1 and the output dim of w2.

Quantization is bit-exact against the reference: round half to even
(``torch.round``) of an f32 quotient, the same f32 max and divide.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param_dtype
from repro_torch.models.mlp import init_mlp

#: quantized expert-weight dtypes ("bf16" everywhere else means "native":
#: whatever param_dtype(cfg) stored -- no quantization)
QUANT_DTYPES: Tuple[str, ...] = ("int8", "int4")

#: symmetric quantization maxima: int8 uses the full signed range; int4
#: values live in [-8, 7] but a symmetric round trip needs |q| <= 7
_QMAX = {"int8": 127, "int4": 7}

_EPS = 1e-12   # zero-channel guard: scale 0 would divide 0/0


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


# --------------------------------------------------------------------------- #
# Quantized expert-weight format
# --------------------------------------------------------------------------- #


def _pack_int4(q: torch.Tensor, dim: int) -> torch.Tensor:
    """Pack int values in [-8, 7] two per byte along ``dim`` (blocked
    halves: byte i = elem i | elem i + n//2 << 4)."""
    n = q.shape[dim]
    assert n % 2 == 0, f"int4 packing needs an even dim, got {n}"
    lo, hi = q.to(torch.int32).split(n // 2, dim=dim)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of ``_pack_int4`` -> int32 values in [-8, 7]: the low nibble
    sign-extends as ``(x ^ 8) - 8``, the high one by an arithmetic shift,
    both on the int8 bytes (the temporaries stay at the packed size)."""
    return torch.cat([((packed & 0xF) ^ 8) - 8, packed >> 4],
                     dim=axis).to(torch.int32)


def quantize_experts(w1: torch.Tensor, w2: torch.Tensor, dtype: str):
    """(w1 [.., E, D, 2F], w2 [.., E, F, D]) -> (w1q, w2q, s1, s2).

    ``w1q`` int8 [.., E, D, 2F] (int4: [.., E, D//2, 2F] packed along D),
    ``w2q`` int8 [.., E, F, D] (int4: [.., E, F, D//2] packed along D),
    ``s1`` f32 [.., E, 2, F], ``s2`` f32 [.., E, F]; on w1's device.
    """
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"expert dtype {dtype!r} not in {QUANT_DTYPES}")
    qmax = _QMAX[dtype]
    *lead, d, twof = w1.shape
    f = twof // 2
    assert tuple(w2.shape[-2:]) == (f, d), (w1.shape, w2.shape)
    nl = len(lead)

    w1v = w1.reshape(*lead, d, 2, f).float()
    s1 = w1v.abs().amax(dim=-3).clamp(min=_EPS) / qmax
    q1 = torch.round(w1v / s1.unsqueeze(-3)).clamp(-qmax, qmax)
    del w1v
    w2f = w2.float()
    s2 = w2f.abs().amax(dim=-1).clamp(min=_EPS) / qmax
    q2 = torch.round(w2f / s2.unsqueeze(-1)).clamp(-qmax, qmax)
    del w2f

    if dtype == "int4":
        w1q = _pack_int4(q1, nl).reshape(*lead, d // 2, twof)
        w2q = _pack_int4(q2, nl + 1)
    else:
        w1q = q1.to(torch.int8).reshape(*lead, d, twof)
        w2q = q2.to(torch.int8)
    return w1q, w2q, s1, s2


def dequantize_experts(w1q, w2q, s1, s2, dtype: str,
                       out_dtype: torch.dtype = torch.float32):
    """Inverse of ``quantize_experts`` (up to rounding): full-precision
    (w1 [.., E, D, 2F], w2 [.., E, F, D])."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"expert dtype {dtype!r} not in {QUANT_DTYPES}")
    *lead, dp, twof = w1q.shape
    f = twof // 2
    nl = len(lead)
    q1 = w1q.reshape(*lead, dp, 2, f)
    w2v = w2q
    if dtype == "int4":
        q1 = unpack_int4(q1, nl)
        w2v = unpack_int4(w2q, nl + 1)
    d = q1.shape[nl]
    w1 = (q1.float() * s1.unsqueeze(-3)).reshape(*lead, d, twof)
    w2 = w2v.float() * s2.unsqueeze(-1)
    return w1.to(out_dtype), w2.to(out_dtype)


def quantize_moe_layer(p: Dict, dtype: str) -> Dict:
    """One MoE layer dict -> the same dict with int8-stored experts.

    ``w1``/``w2`` keep their keys, beside new ``w1_scale``/``w2_scale``;
    the router and any shared expert stay full precision (every routing
    decision flows from the router; the shared expert is dense).
    """
    if "w1_scale" in p:
        raise ValueError("moe layer is already quantized")
    w1q, w2q, s1, s2 = quantize_experts(p["w1"], p["w2"], dtype)
    out = dict(p)
    out["w1"], out["w2"] = w1q, w2q
    out["w1_scale"], out["w2_scale"] = s1, s2
    return out


def quantize_expert_params(params: Dict, cfg: ModelConfig,
                           dtype: str) -> Dict:
    """Whole-model quantize-at-load: every MoE layer's experts -> ``dtype``.

    Walks the port's one dict per layer (``params["layers"]``), one layer
    at a time on the params' device, so the f32 temporaries stay at one
    layer's size.  Returns a new params dict that shares every non-expert
    tensor with the input: the caller can drop the full-precision params,
    and serving never holds both expert copies.
    """
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"expert dtype {dtype!r} not in {QUANT_DTYPES}")
    layers = []
    for spec, lp in zip(cfg.pattern(), params["layers"]):
        if spec.kind == "attn_moe":
            lp = dict(lp, moe=quantize_moe_layer(lp["moe"], dtype))
        layers.append(lp)
    return dict(params, layers=layers)
