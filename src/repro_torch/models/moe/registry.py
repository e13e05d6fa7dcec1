"""Dispatch-strategy registry and the public ``moe()`` entry point.

Every implementation is a ``Router -> Dispatch -> Compute -> Combine``
pipeline registered under the name ``cfg.moe_impl`` selects, as in
``repro.models.moe.registry``:

  ``dense``    capacity-buffer dispatch + per-expert SwiGLU over every
               expert (``moe_ffn`` kernel); every config's default.
  ``gmm``      sort-based dropless dispatch + ragged grouped SwiGLU
               (``moe_gmm`` kernel); the prefill-scale path.
  ``decode``   fused routed-expert path (``moe_decode`` kernel); the
               decode-shaped path, reached from ``gmm`` through
               ``resolve_impl``.
  ``ep_a2a``   expert parallelism via all_to_all (train / prefill;
               ``moe_ffn`` on each rank's experts).
  ``ep_psum``  expert parallelism via psum (decode-shaped batches).

Impls registered here take ``(params, cfg, x2d, top_k, use_kernel, *,
mesh, a2a_chunks, expert_dtype, pred_idx, k_budget)`` and return ``(y2d,
aux)``.  Under a bound mesh ``mesh_impl`` picks what a block runs: the EP
impls where the experts split over ``model``, ``dense`` / ``gmm`` /
``decode`` on each expert's F block where they do not.  Quantized expert tiles (``expert_dtype`` in
``params.QUANT_DTYPES``) are served by ``gmm`` and ``decode`` only: any
other impl raises rather than read int8 tiles as weights.  The expert-
parallel impls serve no per-token k budget either.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.decode import moe_decode
from repro_torch.models.moe.dense import moe_dense
from repro_torch.models.moe.ep import moe_ep_a2a, moe_ep_psum
from repro_torch.models.moe.gmm import moe_gmm

#: impl name -> (pipeline fn, needs_mesh)
_IMPLS: Dict[str, Tuple[Callable, bool]] = {}

#: decode-regime auto-switch bound: ``gmm`` calls with at most this many
#: tokens reroute to the fused ``decode`` impl when the caller opts in
DECODE_TOKEN_THRESHOLD = 16


def resolve_impl(impl: str, n_tokens: int, decode_kernel: bool = False) -> str:
    """Apply the decode-regime auto-switch: only ``gmm`` reroutes (both
    paths are exactly dropless; ``dense`` can drop copies past capacity,
    so it stays as selected; the EP impls own their collectives)."""
    if (decode_kernel and impl == "gmm"
            and n_tokens <= DECODE_TOKEN_THRESHOLD):
        return "decode"
    return impl


def mesh_impl(impl: str, cfg: ModelConfig, mode: str, n_tokens: int,
              mesh) -> str:
    """The impl a block runs for ``impl`` (``opts.moe_impl`` or the
    config's).  ``ep_a2a`` in decode, or on a token count that does not
    split over ``model``, runs ``ep_psum`` (a2a dispatch is the wrong
    regime for decode).  Under a bound mesh whose ``model`` axis splits
    the experts (the rank holds its expert slice) every impl runs
    expert-parallel: ``ep_a2a`` in train / prefill / chunk steps,
    ``ep_psum`` in decode, as the reference's dry run picks them; where
    the experts do not split, the impl runs as asked (the EP impls refuse
    it, ``dense`` / ``gmm`` / ``decode`` run each expert's F block)."""
    if mesh is not None and cfg.num_experts % mesh.shape["model"] == 0:
        impl = "ep_a2a"
    if impl == "ep_a2a" and (mode == "decode" or mesh is not None
                             and n_tokens % mesh.shape["model"]):
        return "ep_psum"
    return impl


def register_impl(name: str, *, needs_mesh: bool = False):
    """Register a dispatch pipeline under ``cfg.moe_impl`` name ``name``
    (a decorator).  A ``needs_mesh`` impl runs ``dense`` when ``moe`` is
    given no mesh."""
    def deco(fn: Callable):
        _IMPLS[name] = (fn, needs_mesh)
        return fn
    return deco


def available_impls() -> Tuple[str, ...]:
    return tuple(sorted(_IMPLS))


def _require_bf16(impl: str, expert_dtype: str):
    if expert_dtype != "bf16":
        raise ValueError(
            f"moe impl {impl!r} serves bf16 expert weights only; "
            f"expert_dtype={expert_dtype!r} requires 'gmm' or 'decode'")


def _no_budget(impl: str, k_budget):
    if k_budget is not None:
        raise ValueError(
            f"moe impl {impl!r} does not serve per-token k budgets; "
            f"mixed-plan serving requires 'dense', 'gmm' or 'decode'")


@register_impl("dense")
def _dense(params, cfg, x2d, top_k, use_kernel=False, *, mesh=None,
           a2a_chunks=1, expert_dtype="bf16", pred_idx=None, k_budget=None):
    del a2a_chunks, pred_idx
    _require_bf16("dense", expert_dtype)
    return moe_dense(params, cfg, x2d, top_k, use_kernel, k_budget=k_budget,
                     mesh=mesh)


@register_impl("gmm")
def _gmm(params, cfg, x2d, top_k, use_kernel=False, *, mesh=None,
         a2a_chunks=1, expert_dtype="bf16", pred_idx=None, k_budget=None):
    del a2a_chunks, pred_idx
    return moe_gmm(params, cfg, x2d, top_k, use_kernel,
                   expert_dtype=expert_dtype, k_budget=k_budget, mesh=mesh)


@register_impl("decode")
def _decode(params, cfg, x2d, top_k, use_kernel=False, *, mesh=None,
            a2a_chunks=1, expert_dtype="bf16", pred_idx=None, k_budget=None):
    del a2a_chunks
    return moe_decode(params, cfg, x2d, top_k, use_kernel,
                      expert_dtype=expert_dtype, pred_idx=pred_idx,
                      k_budget=k_budget, mesh=mesh)


@register_impl("ep_a2a", needs_mesh=True)
def _ep_a2a(params, cfg, x2d, top_k, use_kernel=False, *, mesh=None,
            a2a_chunks=1, expert_dtype="bf16", pred_idx=None, k_budget=None):
    del pred_idx
    _require_bf16("ep_a2a", expert_dtype)
    _no_budget("ep_a2a", k_budget)
    return moe_ep_a2a(params, cfg, x2d, top_k, mesh=mesh,
                      use_kernel=use_kernel, a2a_chunks=a2a_chunks)


@register_impl("ep_psum", needs_mesh=True)
def _ep_psum(params, cfg, x2d, top_k, use_kernel=False, *, mesh=None,
             a2a_chunks=1, expert_dtype="bf16", pred_idx=None, k_budget=None):
    del a2a_chunks, pred_idx
    _require_bf16("ep_psum", expert_dtype)
    _no_budget("ep_psum", k_budget)
    return moe_ep_psum(params, cfg, x2d, top_k, mesh=mesh,
                       use_kernel=use_kernel)


def moe(params: Dict, cfg: ModelConfig, x, top_k: int, *,
        impl: Optional[str] = None, mesh=None, use_kernel: bool = False,
        a2a_chunks: int = 1, decode_kernel: bool = False,
        expert_dtype: str = "bf16", pred_idx=None, k_budget=None):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).

    ``impl`` overrides ``cfg.moe_impl``; mesh-requiring impls fall back to
    ``dense`` when no mesh is given (single-device runs of EP configs).
    Under a mesh, x is the rank's data block of the tokens, the same on
    every rank of ``model`` (``models/moe/ep.py``).
    ``decode_kernel=True`` opts decode-shaped gmm calls into the fused
    routed-expert path.  ``expert_dtype`` != "bf16" expects params
    quantized at load (``quantize_expert_params``) and is served by
    gmm/decode only.  ``k_budget`` [B*S] int32 caps active experts per
    token below ``top_k`` (``route`` zero-weights the surplus routed
    slots).  ``pred_idx`` [B*S, k] is the router-lookahead hint for the
    fused decode path; the other impls drop it.
    """
    b, s, d = x.shape
    impl = resolve_impl(impl or cfg.moe_impl, b * s, decode_kernel)
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; have {available_impls()}")
    fn, needs_mesh = _IMPLS[impl]
    if needs_mesh and mesh is None:
        fn, _ = _IMPLS["dense"]
    y2d, aux = fn(params, cfg, x.reshape(b * s, d), top_k, use_kernel,
                  mesh=mesh, a2a_chunks=a2a_chunks, expert_dtype=expert_dtype,
                  pred_idx=pred_idx, k_budget=k_budget)
    return y2d.reshape(b, s, d), aux
