"""Decoder-only LM: embeddings, layer stack, head, and the serving steps."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.common import apply_norm, dense_init, embed_init, \
    init_norm, param_dtype
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    if cfg.prefix_embed_len or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: VLM / encoder-decoder stacks are not ported yet "
            "(ROADMAP.md A15)")
    dt = param_dtype(cfg)
    p: Dict = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt, device),
        "layers": blocks_mod.init_stack(gen, cfg, device),
        "final_norm": init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt,
                                  device)
    return p


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    return params["embed"][tokens.long()]


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], cfg, x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def forward(params: Dict, cfg: ModelConfig, tokens, positions, *,
            mode: str = "train", caches=None, opts: ModelOpts = DEFAULT_OPTS,
            block_tables=None, kernel_blocks=None):
    """tokens [B,S]; positions [B,S] (train/chunk) or [B] (decode).
    Returns (hidden [B,S,D], caches, aux_loss)."""
    x = embed_tokens(params, cfg, tokens)
    return blocks_mod.apply_stack(
        params["layers"], cfg, x, positions, mode=mode, caches=caches,
        opts=opts, block_tables=block_tables, kernel_blocks=kernel_blocks)


def init_caches(cfg: ModelConfig, *, page_size: int, num_pages: int, device):
    return blocks_mod.init_stack_cache(cfg, page_size=page_size,
                                       num_pages=num_pages, device=device)


@torch.no_grad()
def chunk_prefill(params: Dict, cfg: ModelConfig, tokens, caches, *,
                  positions, last_index=None, block_tables=None,
                  opts: ModelOpts = DEFAULT_OPTS):
    """One chunked-prefill step over all slots -> (logits [B,V], caches).

    tokens / positions [B, C] (position -1 = pad or idle row); the
    returned logits are taken at ``last_index`` per row (clipped)."""
    hidden, caches, _ = forward(params, cfg, tokens, positions, mode="chunk",
                                caches=caches, opts=opts,
                                block_tables=block_tables)
    if last_index is None:
        sel = hidden[:, -1]
    else:
        idx = last_index.long().clamp(0, hidden.shape[1] - 1)
        sel = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return lm_logits(params, cfg, sel[:, None])[:, 0], caches


@torch.no_grad()
def decode_step(params: Dict, cfg: ModelConfig, tokens, pos, caches, *,
                opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
                kernel_blocks: Optional[int] = None):
    """One decode step -> (logits [B,V] f32, caches).  ``kernel_blocks``
    bounds the paged kernel's table walk to the live-page bucket."""
    hidden, caches, _ = forward(params, cfg, tokens[:, None], pos,
                                mode="decode", caches=caches, opts=opts,
                                block_tables=block_tables,
                                kernel_blocks=kernel_blocks)
    return lm_logits(params, cfg, hidden)[:, 0], caches
