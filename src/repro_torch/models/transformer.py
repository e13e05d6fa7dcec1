"""Decoder-only LM: embeddings, layer stack, head, the loss and the
serving steps.

The VLM variant (pixtral) takes precomputed patch embeddings (the vision
frontend is a stub, as in the reference): ``prefix_embeds @ prefix_proj``
goes ahead of the token embeddings in ``forward``, ``prefill`` and
``lm_loss``, and the loss counts the token part only.  A decode step after
such a prefill sits at position ``S + prefix_embed_len``.

Under a bound ``mesh`` (``models/tp.py``) the embedding is vocab-parallel
and the head (``lm_head``, or the tied ``embed.T``) column-parallel over
the vocab; the logits come out whole on every rank (the ranks' vocab
blocks all-gathered), as the reference's replicated out-sharding, and the
loss takes the cross-entropy of those whole logits.  Under
``opts.fsdp_params`` each entry point gathers the top-level leaves over
the data axes once, the layer stack each layer's where it runs."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.common import apply_norm, dense_init, embed_init, \
    init_norm, param_dtype
from repro_torch.models import tp as tp_mod
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.models.tp import TP


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """Decoder-only params: ``embed``, ``layers`` (one dict per layer),
    ``final_norm``, ``lm_head`` unless tied, ``shared_attn`` for a stack
    with shared attention blocks and ``prefix_proj`` for a VLM."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder; "
                         "models.init_params builds it (models/encdec.py)")
    dt = param_dtype(cfg)
    p: Dict = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt, device),
        "layers": blocks_mod.init_stack(gen, cfg, device),
        "final_norm": init_norm(cfg, device),
    }
    shared = blocks_mod.init_shared(gen, cfg, device)
    if shared is not None:
        p["shared_attn"] = shared
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt,
                                  device)
    if cfg.prefix_embed_len:
        p["prefix_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), dt,
                                      device)
    return p


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, mesh=None):
    return tp_mod.embed(TP(mesh), params["embed"], tokens, cfg.padded_vocab)


def _head(params, cfg: ModelConfig, x: torch.Tensor):
    """-> (the final norm of ``x``, the head: ``embed.T`` when tied)."""
    x = apply_norm(params["final_norm"], cfg, x)
    return x, (params["embed"].T if cfg.tie_embeddings
               else params["lm_head"])


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    return tp_mod.logits(TP(mesh), *_head(params, cfg, x), cfg.padded_vocab)


def _fsdp_top(params, cfg: ModelConfig, mesh, opts: ModelOpts):
    """-> (params with the top-level leaves gathered over the data axes,
    the FSDP layout for the layer stack) under ``opts.fsdp_params`` on a
    mesh; (params, None) otherwise."""
    if mesh is None or not opts.fsdp_params:
        return params, None
    from repro_torch.sharding.rules import fsdp_layout
    layout = fsdp_layout(cfg, mesh, opts.fsdp_min_size)
    top = {k: v for k, v in params.items()
           if k not in ("layers", "shared_attn")}
    top = tp_mod.gather_fsdp(top, {k: layout[k] for k in top}, mesh, opts)
    return {**params, **top}, layout


def forward(params: Dict, cfg: ModelConfig, tokens, positions, *,
            mode: str = "train", caches=None, prefix_embeds=None,
            opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
            kernel_blocks=None, k_budgets=None, mesh=None, layout=None):
    """tokens [B,S]; positions [B,S] (train/chunk; [B, P+S] with
    ``prefix_embeds`` [B,P,D]) or [B] (decode).  ``k_budgets`` [B, n_moe]
    int32: each row's active-expert cap per MoE layer (per-request
    plans).  Under a bound ``mesh`` the rows are the rank's data block,
    the same on every rank of ``model``, and the params its blocks
    (``sharding.local_params``); ``layout`` is the stack's FSDP layout
    (``_fsdp_top``).  Returns (hidden [B,S,D] or [B,P+S,D], caches,
    aux_loss)."""
    x = embed_tokens(params, cfg, tokens, mesh)
    if prefix_embeds is not None:
        pre = prefix_embeds.to(x.dtype) @ params["prefix_proj"]
        x = torch.cat([pre, x], dim=1)
    return blocks_mod.apply_stack(
        params["layers"], cfg, x, positions, mode=mode, caches=caches,
        opts=opts, block_tables=block_tables, kernel_blocks=kernel_blocks,
        k_budgets=k_budgets, shared=params.get("shared_attn"), mesh=mesh,
        layout=layout)


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #


def softmax_xent(logits, targets, mask):
    """logits [B,S,V] f32, targets [B,S] int, mask [B,S] {0,1} f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def lm_xent(params, cfg: ModelConfig, x: torch.Tensor, targets, mask,
            mesh=None) -> torch.Tensor:
    """``softmax_xent(lm_logits(params, cfg, x, mesh), targets, mask)``,
    vocab-parallel under a mesh (``tp.xent``: no rank holds the whole
    vocabulary's logits)."""
    return tp_mod.xent(TP(mesh), *_head(params, cfg, x), cfg.padded_vocab,
                       targets, mask)


def lm_loss(params: Dict, cfg: ModelConfig, batch: Dict, *, mesh=None,
            opts: ModelOpts = DEFAULT_OPTS, aux_coef: float = 0.01):
    """batch: tokens [B,S], targets [B,S], mask [B,S], optional
    prefix_embeds [B,P,D] -> (loss, {"xent", "aux"}); the loss counts the
    token part only.  Under a mesh the batch and the loss are the rank's
    data block's, the same on every rank of ``model``
    (``training/step.py`` weighs the data blocks' losses into the global
    one)."""
    params, layout = _fsdp_top(params, cfg, mesh, opts)
    tokens = batch["tokens"]
    b, s = tokens.shape
    pre = batch.get("prefix_embeds")
    plen = pre.shape[1] if pre is not None else 0
    positions = torch.arange(s + plen, dtype=torch.int32,
                             device=tokens.device).expand(b, s + plen)
    hidden, _, aux = forward(params, cfg, tokens, positions, mode="train",
                             prefix_embeds=pre, opts=opts, mesh=mesh,
                             layout=layout)
    xent = lm_xent(params, cfg, hidden[:, plen:], batch["targets"],
                   batch["mask"].float(), mesh)
    return xent + aux_coef * aux, {"xent": xent, "aux": aux}


# --------------------------------------------------------------------------- #
# Inference steps
# --------------------------------------------------------------------------- #


def init_caches(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                layout: str = "contiguous", page_size: int = 16,
                num_pages: int = 0, device):
    return blocks_mod.init_stack_cache(cfg, batch, max_len, layout=layout,
                                       page_size=page_size,
                                       num_pages=num_pages, device=device)


@torch.no_grad()
def prefill(params: Dict, cfg: ModelConfig, tokens, caches, *,
            positions=None, prefix_embeds=None,
            opts: ModelOpts = DEFAULT_OPTS, mesh=None):
    """Write a whole prompt (after ``prefix_embeds`` [B,P,D], if given)
    into contiguous caches -> (last_logits [B,V], caches).  Under
    ``opts.use_flash`` positions must be 0..P+S-1 (the kernel masks by
    index)."""
    params, layout = _fsdp_top(params, cfg, mesh, opts)
    b, s = tokens.shape
    plen = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    if positions is None:
        positions = torch.arange(s + plen, dtype=torch.int32,
                                 device=tokens.device).expand(b, s + plen)
    hidden, caches, _ = forward(params, cfg, tokens, positions,
                                mode="prefill", caches=caches,
                                prefix_embeds=prefix_embeds, opts=opts,
                                mesh=mesh, layout=layout)
    return lm_logits(params, cfg, hidden[:, -1:], mesh)[:, 0], caches


@torch.no_grad()
def chunk_prefill(params: Dict, cfg: ModelConfig, tokens, caches, *,
                  positions, last_index=None, block_tables=None,
                  opts: ModelOpts = DEFAULT_OPTS, k_budgets=None, mesh=None):
    """One chunked-prefill step over all slots -> (logits [B,V], caches).

    tokens / positions [B, C] (position -1 = pad or idle row); the
    returned logits are taken at ``last_index`` per row (clipped)."""
    params, layout = _fsdp_top(params, cfg, mesh, opts)
    hidden, caches, _ = forward(params, cfg, tokens, positions, mode="chunk",
                                caches=caches, opts=opts,
                                block_tables=block_tables,
                                k_budgets=k_budgets, mesh=mesh, layout=layout)
    if last_index is None:
        sel = hidden[:, -1]
    else:
        idx = last_index.long().clamp(0, hidden.shape[1] - 1)
        sel = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return lm_logits(params, cfg, sel[:, None], mesh)[:, 0], caches


@torch.no_grad()
def decode_step(params: Dict, cfg: ModelConfig, tokens, pos, caches, *,
                opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
                kernel_blocks: Optional[int] = None, k_budgets=None,
                mesh=None):
    """One decode step -> (logits [B,V] f32, caches).  ``kernel_blocks``
    bounds the paged kernel's table walk to the live-page bucket."""
    params, layout = _fsdp_top(params, cfg, mesh, opts)
    hidden, caches, _ = forward(params, cfg, tokens[:, None], pos,
                                mode="decode", caches=caches, opts=opts,
                                block_tables=block_tables,
                                kernel_blocks=kernel_blocks,
                                k_budgets=k_budgets, mesh=mesh, layout=layout)
    return lm_logits(params, cfg, hidden, mesh)[:, 0], caches
