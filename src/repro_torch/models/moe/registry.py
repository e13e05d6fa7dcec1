"""Dispatch-strategy registry and the public ``moe()`` entry point.

The port serves the reference's single-device impls:

  ``dense``   capacity-buffer dispatch + per-expert SwiGLU over every
              expert (``moe_ffn`` kernel); every config's default.
  ``gmm``     sort-based dropless dispatch + ragged grouped SwiGLU
              (``moe_gmm`` kernel); the prefill-scale path.
  ``decode``  fused routed-expert path (``moe_decode`` kernel); the
              decode-shaped path, reached from ``gmm`` through
              ``resolve_impl``.

The expert-parallel impls ``ep_a2a`` / ``ep_psum`` are not ported yet and
raise.  Quantized expert tiles (``expert_dtype`` in
``params.QUANT_DTYPES``) are served by ``gmm`` and ``decode`` only: any
other impl raises rather than read int8 tiles as weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.decode import moe_decode
from repro_torch.models.moe.dense import moe_dense
from repro_torch.models.moe.gmm import moe_gmm

#: decode-regime auto-switch bound: ``gmm`` calls with at most this many
#: tokens reroute to the fused ``decode`` impl when the caller opts in
DECODE_TOKEN_THRESHOLD = 16

_NOT_PORTED = {
    "ep_a2a": "ROADMAP.md A14 (expert parallelism)",
    "ep_psum": "ROADMAP.md A14 (expert parallelism)",
}


def _require_bf16(impl: str, expert_dtype: str):
    if expert_dtype != "bf16":
        raise ValueError(
            f"moe impl {impl!r} serves bf16 expert weights only; "
            f"expert_dtype={expert_dtype!r} requires 'gmm' or 'decode'")


def resolve_impl(impl: str, n_tokens: int, decode_kernel: bool = False) -> str:
    """Apply the decode-regime auto-switch: only ``gmm`` reroutes (both
    paths are exactly dropless; ``dense`` can drop copies past capacity,
    so it stays as selected)."""
    if (decode_kernel and impl == "gmm"
            and n_tokens <= DECODE_TOKEN_THRESHOLD):
        return "decode"
    return impl


def _dense(params, cfg, x2d, top_k, use_kernel=False, *,
           expert_dtype="bf16", pred_idx=None, k_budget=None):
    del pred_idx
    _require_bf16("dense", expert_dtype)
    return moe_dense(params, cfg, x2d, top_k, use_kernel, k_budget=k_budget)


def _gmm(params, cfg, x2d, top_k, use_kernel=False, *,
         expert_dtype="bf16", pred_idx=None, k_budget=None):
    del pred_idx
    return moe_gmm(params, cfg, x2d, top_k, use_kernel,
                   expert_dtype=expert_dtype, k_budget=k_budget)


#: every impl takes the router-lookahead hint ``pred_idx``; only the fused
#: ``decode`` path reads it (the others drop it, as in the reference)
_IMPLS: Dict[str, Callable] = {"dense": _dense, "gmm": _gmm,
                               "decode": moe_decode}


def moe(params: Dict, cfg: ModelConfig, x, top_k: int, *,
        impl: Optional[str] = None, use_kernel: bool = False,
        decode_kernel: bool = False, expert_dtype: str = "bf16",
        pred_idx=None, k_budget=None):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).

    ``impl`` overrides ``cfg.moe_impl``; ``decode_kernel=True`` opts
    decode-shaped gmm calls into the fused routed-expert path.
    ``expert_dtype`` != "bf16" expects params quantized at load
    (``quantize_expert_params``) and is served by gmm/decode only.
    ``k_budget`` [B*S] int32 caps active experts per token below ``top_k``
    (``route`` zero-weights the surplus routed slots).  ``pred_idx``
    [B*S, k] is the router-lookahead hint for the fused decode path; the
    other impls drop it.
    """
    b, s, d = x.shape
    impl = resolve_impl(impl or cfg.moe_impl, b * s, decode_kernel)
    if impl in _NOT_PORTED:
        _require_bf16(impl, expert_dtype)
        raise NotImplementedError(
            f"moe impl {impl!r} is not ported yet: {_NOT_PORTED[impl]}; "
            "serve with moe_impl='dense' or 'gmm'")
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; have {sorted(_IMPLS)}")
    y2d, aux = _IMPLS[impl](params, cfg, x.reshape(b * s, d), top_k,
                            use_kernel, expert_dtype=expert_dtype,
                            pred_idx=pred_idx, k_budget=k_budget)
    return y2d.reshape(b, s, d), aux
