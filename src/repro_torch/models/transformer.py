"""Decoder-only LM: embeddings, layer stack, head, the loss and the
serving steps."""

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
            "(ROADMAP.md A13)")
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
            block_tables=None, kernel_blocks=None, k_budgets=None):
    """tokens [B,S]; positions [B,S] (train/chunk) or [B] (decode).
    ``k_budgets`` [B, n_moe] int32: each row's active-expert cap per MoE
    layer (per-request plans).  Returns (hidden [B,S,D], caches,
    aux_loss)."""
    x = embed_tokens(params, cfg, tokens)
    return blocks_mod.apply_stack(
        params["layers"], cfg, x, positions, mode=mode, caches=caches,
        opts=opts, block_tables=block_tables, kernel_blocks=kernel_blocks,
        k_budgets=k_budgets)


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #


def softmax_xent(logits, targets, mask):
    """logits [B,S,V] f32, targets [B,S] int, mask [B,S] {0,1} f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def lm_loss(params: Dict, cfg: ModelConfig, batch: Dict, *,
            opts: ModelOpts = DEFAULT_OPTS, aux_coef: float = 0.01):
    """batch: tokens [B,S], targets [B,S], mask [B,S] -> (loss, {"xent",
    "aux"})."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    hidden, _, aux = forward(params, cfg, tokens, positions, mode="train",
                             opts=opts)
    logits = lm_logits(params, cfg, hidden)
    xent = softmax_xent(logits, batch["targets"], batch["mask"].float())
    return xent + aux_coef * aux, {"xent": xent, "aux": aux}


# --------------------------------------------------------------------------- #
# Inference steps
# --------------------------------------------------------------------------- #


def init_caches(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                layout: str = "paged", page_size: int = 16,
                num_pages: int = 0, device):
    return blocks_mod.init_stack_cache(cfg, batch, max_len, layout=layout,
                                       page_size=page_size,
                                       num_pages=num_pages, device=device)


@torch.no_grad()
def prefill(params: Dict, cfg: ModelConfig, tokens, caches, *,
            positions=None, opts: ModelOpts = DEFAULT_OPTS):
    """Write a whole prompt into contiguous caches -> (last_logits [B,V],
    caches).  Under ``opts.use_flash`` positions must be 0..S-1 (the
    kernel masks by index)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    hidden, caches, _ = forward(params, cfg, tokens, positions,
                                mode="prefill", caches=caches, opts=opts)
    return lm_logits(params, cfg, hidden[:, -1:])[:, 0], caches


@torch.no_grad()
def chunk_prefill(params: Dict, cfg: ModelConfig, tokens, caches, *,
                  positions, last_index=None, block_tables=None,
                  opts: ModelOpts = DEFAULT_OPTS, k_budgets=None):
    """One chunked-prefill step over all slots -> (logits [B,V], caches).

    tokens / positions [B, C] (position -1 = pad or idle row); the
    returned logits are taken at ``last_index`` per row (clipped)."""
    hidden, caches, _ = forward(params, cfg, tokens, positions, mode="chunk",
                                caches=caches, opts=opts,
                                block_tables=block_tables,
                                k_budgets=k_budgets)
    if last_index is None:
        sel = hidden[:, -1]
    else:
        idx = last_index.long().clamp(0, hidden.shape[1] - 1)
        sel = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return lm_logits(params, cfg, sel[:, None])[:, 0], caches


@torch.no_grad()
def decode_step(params: Dict, cfg: ModelConfig, tokens, pos, caches, *,
                opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
                kernel_blocks: Optional[int] = None, k_budgets=None):
    """One decode step -> (logits [B,V] f32, caches).  ``kernel_blocks``
    bounds the paged kernel's table walk to the live-page bucket."""
    hidden, caches, _ = forward(params, cfg, tokens[:, None], pos,
                                mode="decode", caches=caches, opts=opts,
                                block_tables=block_tables,
                                kernel_blocks=kernel_blocks,
                                k_budgets=k_budgets)
    return lm_logits(params, cfg, hidden)[:, 0], caches
