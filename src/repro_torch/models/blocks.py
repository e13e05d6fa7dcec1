"""Layer blocks and the layer stack.

The reference scans groups of identical layers over stacked parameters
(``lax.scan``); the port keeps one parameter dict per layer and runs the
stack as a Python loop.  ``group_pattern`` stays: ``convert.py`` needs it
to split the reference's stacked groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts

_PORTED_KINDS = ("attn_moe", "attn_mlp")


@dataclass(frozen=True)
class Group:
    spec: BlockSpec
    count: int
    start: int   # first layer index


def group_pattern(pattern: Tuple[BlockSpec, ...]) -> List[Group]:
    """Runs of consecutive identical specs (the reference's scan groups)."""
    groups: List[Group] = []
    i = 0
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
        groups.append(Group(pattern[i], j - i, i))
        i = j
    return groups


def _check_kind(spec: BlockSpec) -> None:
    if spec.kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"{spec.kind!r} blocks are not ported yet (ROADMAP.md A13)")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device) -> Dict:
    _check_kind(spec)
    p = {
        "norm1": init_norm(cfg, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
    }
    if spec.kind == "attn_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg, device)
    return p


def apply_block(
    params: Dict,
    cfg: ModelConfig,
    spec: BlockSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str,
    cache: Optional[Dict],
    opts: ModelOpts = DEFAULT_OPTS,
    block_tables=None,
    kernel_blocks: Optional[int] = None,
    k_budget: Optional[torch.Tensor] = None,
    lookahead_h2: Optional[torch.Tensor] = None,
):
    """Returns (x, cache, aux_loss, h2), ``h2`` the block's pre-FFN hidden.
    ``k_budget`` [B] int32 caps each batch row's active experts below
    ``spec.moe_top_k`` (every token of the row takes the row's cap).

    ``lookahead_h2`` (router lookahead) is the previous layer's pre-FFN
    hidden, from which this block predicts its top-k expert ids before its
    own attention runs; the MoE's plain decode path stages its weight
    gathers on the prediction, and no output depends on it."""
    _check_kind(spec)
    pred_idx = None
    if lookahead_h2 is not None and spec.kind == "attn_moe":
        d = lookahead_h2.shape[-1]
        pred_idx = moe_mod.route_lookahead(
            params["moe"], cfg, lookahead_h2.reshape(-1, d), spec.moe_top_k)
    attn_kw = {"block_tables": block_tables,
               "use_paged_kernel": opts.use_paged_kernel,
               "kernel_blocks": kernel_blocks}
    if cfg.attention == "mla":
        attn_kw["absorb"] = opts.mla_absorb
    else:
        attn_kw.update(use_flash=opts.use_flash,
                       compute_dtype=opts.attn_compute_dtype,
                       use_flash_decode=opts.use_flash_decode)
    h, cache = attn_mod.attention(
        params["attn"], cfg, apply_norm(params["norm1"], cfg, x), positions,
        mode=mode, cache=cache, **attn_kw)
    x = x + h
    h2 = apply_norm(params["norm2"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "attn_moe":
        kb_tok = None
        if k_budget is not None:
            b, s, _ = h2.shape
            kb_tok = k_budget.to(torch.int32)[:, None].expand(b, s).reshape(-1)
        y, aux = moe_mod.moe(
            params["moe"], cfg, h2, spec.moe_top_k,
            impl=opts.moe_impl or cfg.moe_impl,
            use_kernel=opts.use_moe_kernel,
            decode_kernel=opts.use_moe_decode_kernel and mode == "decode",
            expert_dtype=opts.expert_dtype, pred_idx=pred_idx,
            k_budget=kb_tok)
        x = x + y
    else:
        x = x + mlp(params["mlp"], h2)
    return x, cache, aux, h2


def init_stack(gen: torch.Generator, cfg: ModelConfig, device) -> List[Dict]:
    """One parameter dict per layer."""
    return [init_block(gen, cfg, spec, device) for spec in cfg.pattern()]


def init_stack_cache(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                     layout: str = "paged", page_size: int = 16,
                     num_pages: int = 0, device) -> List[Dict]:
    """One cache per layer: a paged pool of ``num_pages`` x ``page_size``
    positions, or ``batch`` contiguous rows for ``max_len`` positions."""
    if layout == "paged":
        return [attn_mod.init_paged_cache(cfg, num_pages, page_size, device)
                for _ in cfg.pattern()]
    if layout == "contiguous":
        return [attn_mod.init_cache(cfg, batch, max_len, device)
                for _ in cfg.pattern()]
    raise ValueError(f"unknown cache layout {layout!r}")


def apply_stack(layers: List[Dict], cfg: ModelConfig, x, positions, *,
                mode: str, caches=None, opts: ModelOpts = DEFAULT_OPTS,
                block_tables=None, kernel_blocks: Optional[int] = None,
                k_budgets=None):
    """Run every layer.  Returns (x, caches, total_aux).

    ``k_budgets`` [B, n_moe] int32 gives each batch row a per-MoE-layer
    active-expert cap below the pattern's per-layer top-k (per-request
    LExI plans): MoE layer i takes column i, counted over the MoE layers
    only, as the reference's running index does.

    With ``opts.router_lookahead`` a decode step carries each layer's
    pre-FFN hidden to the next (``h2_prev``), from which that layer
    predicts its expert ids; zeros feed the first layer, whose staged loads
    then just miss."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lookahead = opts.router_lookahead and mode == "decode"
    h2_prev = torch.zeros_like(x) if lookahead else None
    moe_i = 0
    for li, spec in enumerate(cfg.pattern()):
        kb = None
        if spec.kind == "attn_moe":
            if k_budgets is not None:
                kb = k_budgets[:, moe_i]
            moe_i += 1
        x, _, aux, h2 = apply_block(
            layers[li], cfg, spec, x, positions, mode=mode,
            cache=caches[li] if caches is not None else None, opts=opts,
            block_tables=block_tables, kernel_blocks=kernel_blocks,
            k_budget=kb, lookahead_h2=h2_prev)
        if lookahead:
            h2_prev = h2
        total_aux = total_aux + aux
    return x, caches, total_aux
