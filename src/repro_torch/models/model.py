"""Model facade: every architecture behind the same functions, which the
serving stack and launchers call.  The encoder-decoder (whisper) goes to
``models/encdec.py``, every other config to ``models/transformer.py``."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Dict:
    """Random weights drawn on ``device`` (the card unless the caller asks
    for the CPU) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.is_encoder_decoder:
        return encdec_mod.init_encdec(gen, cfg, dev)
    return tf_mod.init_lm(gen, cfg, dev)


def abstract_params(cfg: ModelConfig) -> Dict:
    """The param tree on the ``meta`` device: shapes and dtypes without
    memory, for the sharding rules at full size (the reference's
    ``eval_shape`` of ``init_params``)."""
    gen, meta = torch.Generator(), torch.device("meta")
    if cfg.is_encoder_decoder:
        return encdec_mod.init_encdec(gen, cfg, meta)
    return tf_mod.init_lm(gen, cfg, meta)


def make_train_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                     seq: int, *, device=None) -> Dict:
    """A random batch for smoke tests and examples: tokens and targets
    drawn from ``gen`` (a ``torch.Generator`` in place of the reference's
    key, so other numbers from the same seed) on ``device``, every target
    counted; plus ``frames`` [B, encoder_seq_len, D] for the
    encoder-decoder, or ``prefix_embeds`` [B, prefix_embed_len, D] for a
    VLM, standard normal f32."""
    dev = resolve_device(device)
    draw = lambda: torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=gen, device=gen.device).to(dev)
    tokens, targets = draw(), draw()
    out = {"tokens": tokens.int(), "targets": targets.int(),
           "mask": torch.ones((batch, seq), dtype=torch.int32, device=dev)}
    extra = (("frames", cfg.encoder_seq_len) if cfg.is_encoder_decoder
             else ("prefix_embeds", cfg.prefix_embed_len))
    if extra[1]:
        out[extra[0]] = torch.randn((batch, extra[1], cfg.d_model),
                                    generator=gen, device=gen.device).to(dev)
    return out


def loss_fn(params, cfg: ModelConfig, batch, *, mesh=None,
            opts: ModelOpts = DEFAULT_OPTS):
    """batch: tokens, targets, mask [B,S] (plus frames or prefix_embeds)
    -> (loss, {"xent", "aux"}).  Under a bound ``mesh`` the batch, the
    params and the loss are the rank's own (``sharding.local_params``;
    the batch sharded over every axis)."""
    if cfg.is_encoder_decoder:
        return encdec_mod.encdec_loss(params, cfg, batch, mesh=mesh,
                                      opts=opts)
    return tf_mod.lm_loss(params, cfg, batch, mesh=mesh, opts=opts)


def init_caches(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                layout: str = "contiguous", page_size: int = 16,
                num_pages: int = 0, device=None):
    """KV caches, one per layer: the default ``"contiguous"`` layout is
    ``batch`` rows for ``max_len`` positions (the per-slot-row equivalence
    oracle, as in the reference); ``layout="paged"`` (the serving pool) is
    ``num_pages`` pages of ``page_size`` positions.  A mamba layer's state
    has ``batch`` rows on either layout; the encoder-decoder's caches are
    contiguous only."""
    if cfg.is_encoder_decoder:
        if layout != "contiguous":
            raise NotImplementedError("paged KV is decoder-only LM for now")
        return encdec_mod.init_encdec_caches(cfg, batch, max_len,
                                             resolve_device(device))
    return tf_mod.init_caches(cfg, batch, max_len, layout=layout,
                              page_size=page_size, num_pages=num_pages,
                              device=resolve_device(device))


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int, **kw):
    """``init_caches`` on the ``meta`` device: shapes and dtypes without
    memory (the reference's ``eval_shape`` of its ``init_caches``).  One
    cache a layer, where the reference stacks a run of identical layers
    under a leading dim."""
    return init_caches(cfg, batch, max_len, device="meta", **kw)


def prefill_fn(params, cfg: ModelConfig, batch, caches, *, mesh=None,
               opts: ModelOpts = DEFAULT_OPTS):
    """batch: {"tokens": [B,S], optional "positions", and "frames"
    (encoder-decoder) or optional "prefix_embeds" [B,P,D] (VLM)} -> (last
    logits [B,V], contiguous caches)."""
    if cfg.is_encoder_decoder:
        return encdec_mod.encdec_prefill(params, cfg, batch["frames"],
                                         batch["tokens"], caches, mesh=mesh,
                                         opts=opts)
    return tf_mod.prefill(params, cfg, batch["tokens"], caches,
                          positions=batch.get("positions"),
                          prefix_embeds=batch.get("prefix_embeds"),
                          mesh=mesh, opts=opts)


def chunk_prefill_fn(params, cfg: ModelConfig, tokens, positions, caches, *,
                     last_index=None, block_tables=None, mesh=None,
                     opts: ModelOpts = DEFAULT_OPTS, k_budgets=None):
    """One fixed-width chunked-prefill step (decoder-only LMs).
    ``k_budgets`` [B, n_moe] int32 caps each row's active experts per MoE
    layer below the config's k (a mixed-plan step)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("chunked prefill is decoder-only LM for now")
    return tf_mod.chunk_prefill(params, cfg, tokens, caches,
                                positions=positions, last_index=last_index,
                                block_tables=block_tables, mesh=mesh,
                                opts=opts, k_budgets=k_budgets)


def decode_fn(params, cfg: ModelConfig, tokens, pos, caches, *, mesh=None,
              opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
              kernel_blocks=None, k_budgets=None):
    """One decode step: tokens, pos [B] -> (logits [B,V] f32, caches).
    Under a bound ``mesh``: the rank's data block of the rows (the same on
    every ``model`` rank), the MoE through ``ep_psum`` when the impl is
    ``ep_a2a``, and with ``opts.decode_kv_seq_shard`` the rank's sequence
    block of each contiguous cache row."""
    if cfg.is_encoder_decoder:
        return encdec_mod.encdec_decode_step(params, cfg, tokens, pos,
                                             caches, mesh=mesh, opts=opts)
    return tf_mod.decode_step(params, cfg, tokens, pos, caches, mesh=mesh,
                              opts=opts,
                              block_tables=block_tables,
                              kernel_blocks=kernel_blocks,
                              k_budgets=k_budgets)
