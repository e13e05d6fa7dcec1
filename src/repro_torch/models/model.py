"""Model facade: the functions the serving stack and launchers call."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Dict:
    """Random weights drawn on ``device`` (the card unless the caller asks
    for the CPU) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tf_mod.init_lm(gen, cfg, dev)


def make_train_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                     seq: int, *, device=None) -> Dict:
    """A random batch for smoke tests and examples: tokens and targets
    drawn from ``gen`` (a ``torch.Generator`` in place of the reference's
    key, so other numbers from the same seed) on ``device``, every target
    counted.  The encoder-decoder and prefix-embedding families' extra
    inputs are not ported (ROADMAP.md A13)."""
    if cfg.is_encoder_decoder or cfg.prefix_embed_len:
        raise NotImplementedError(
            f"{cfg.name}: batches with frames or prefix embeddings are not "
            "ported (ROADMAP.md A13)")
    dev = resolve_device(device)
    draw = lambda: torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=gen, device=gen.device).to(dev)
    tokens, targets = draw(), draw()
    return {"tokens": tokens.int(), "targets": targets.int(),
            "mask": torch.ones((batch, seq), dtype=torch.int32, device=dev)}


def loss_fn(params, cfg: ModelConfig, batch, *,
            opts: ModelOpts = DEFAULT_OPTS):
    """batch: tokens, targets, mask [B,S] -> (loss, {"xent", "aux"})."""
    return tf_mod.lm_loss(params, cfg, batch, opts=opts)


def init_caches(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                layout: str = "paged", page_size: int = 16,
                num_pages: int = 0, device=None):
    """KV caches, one per layer: ``layout="paged"`` (the serving pool) is
    ``num_pages`` pages of ``page_size`` positions; ``"contiguous"`` is
    ``batch`` rows for ``max_len`` positions."""
    return tf_mod.init_caches(cfg, batch, max_len, layout=layout,
                              page_size=page_size, num_pages=num_pages,
                              device=resolve_device(device))


def prefill_fn(params, cfg: ModelConfig, batch, caches, *,
               opts: ModelOpts = DEFAULT_OPTS):
    """batch: {"tokens": [B,S], optional "positions": [B,S]} -> (last
    logits [B,V], contiguous caches)."""
    return tf_mod.prefill(params, cfg, batch["tokens"], caches,
                          positions=batch.get("positions"), opts=opts)


def chunk_prefill_fn(params, cfg: ModelConfig, tokens, positions, caches, *,
                     last_index=None, block_tables=None,
                     opts: ModelOpts = DEFAULT_OPTS, k_budgets=None):
    """One fixed-width chunked-prefill step (decoder-only LMs).
    ``k_budgets`` [B, n_moe] int32 caps each row's active experts per MoE
    layer below the config's k (a mixed-plan step)."""
    return tf_mod.chunk_prefill(params, cfg, tokens, caches,
                                positions=positions, last_index=last_index,
                                block_tables=block_tables, opts=opts,
                                k_budgets=k_budgets)


def decode_fn(params, cfg: ModelConfig, tokens, pos, caches, *,
              opts: ModelOpts = DEFAULT_OPTS, block_tables=None,
              kernel_blocks=None, k_budgets=None):
    return tf_mod.decode_step(params, cfg, tokens, pos, caches, opts=opts,
                              block_tables=block_tables,
                              kernel_blocks=kernel_blocks,
                              k_budgets=k_budgets)
