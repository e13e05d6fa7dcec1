"""Whisper-style encoder-decoder, the port of ``repro.models.encdec``.

The audio conv frontend is a stub, as in the reference: callers provide
precomputed frame embeddings ``[B, T_enc, D]``.  Encoder: bidirectional
self-attention.  Decoder: causal self-attention plus cross-attention over
the encoder output; the cross K/V are computed once at prefill and carried
in the cache (``xk`` / ``xv`` / ``xpos``).  Both layer stacks are plain
lists (the reference does not stack them either).

Every attention here runs the plain masked softmax, as in the reference,
which passes no kernel option to any of them: the encoder's is not causal,
the cross-attention's K/V come from the encoder (``kv_override``), and the
decoder's self-attention takes the defaults.  ``opts`` is read for
``fsdp_params`` only.

Under a bound (or placed) ``mesh`` the layers run tensor parallelism over
``model`` on the rank's blocks of the rules' specs, as the decoder-only
LMs do (``models/tp.py``): the embedding vocab-parallel, the head
column-parallel (the logits gathered whole in prefill and decode, the
loss vocab-parallel: ``tp.xent``), each attention on the
rank's heads (``attention._gqa_plan``; the cross K/V from the rank's
column blocks of ``wk`` / ``wv``, ``attention.cross_kv``), each MLP on
the rank's F block.  The rows are the rank's data block.  At one rank
every output is the no-mesh path's, bit for bit.  (The reference ignores
its mesh here and lets GSPMD partition the whole program.)  Under
``opts.fsdp_params`` every entry point gathers the params over the data
axes first.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import tp as tp_mod
from repro_torch.models.common import apply_norm, dense_init, embed_init, \
    init_norm, param_dtype
from repro_torch.models.mlp import init_mlp
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.models.tp import TP


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = param_dtype(cfg)
    enc_layers = [{
        "norm1": init_norm(cfg, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    } for _ in range(cfg.encoder_layers)]
    dec_layers = [{
        "norm1": init_norm(cfg, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "norm_x": init_norm(cfg, device),
        "xattn": attn_mod.init_cross_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    } for _ in range(cfg.num_layers)]
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt, device),
        "enc_norm": init_norm(cfg, device),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "final_norm": init_norm(cfg, device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt,
                              device),
    }


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor, *,
           opts: ModelOpts = DEFAULT_OPTS, mesh=None) -> torch.Tensor:
    """frames [B, T_enc, D] (stub frontend output) -> encoder states
    (whole on every rank of ``model`` under a mesh)."""
    b, t, _ = frames.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    x = frames.to(param_dtype(cfg))
    for lp in params["enc_layers"]:
        h, _ = attn_mod.gqa_attention(
            lp["attn"], cfg, apply_norm(lp["norm1"], cfg, x), positions,
            mode="train", causal=False, mesh=mesh)
        x = x + h
        x = x + tp_mod.mlp_tp(lp["mlp"], apply_norm(lp["norm2"], cfg, x),
                              mesh, cfg.d_ff)
    return apply_norm(params["enc_norm"], cfg, x)


def _hidden(params, cfg: ModelConfig, tokens, positions, mode: str, caches,
            enc_out, opts: ModelOpts = DEFAULT_OPTS, mesh=None):
    """-> (the final-normed hidden [B,S,D], the caches or None in train
    mode).  In prefill the cross K/V are written into the caches' ``xk``
    / ``xv`` / ``xpos`` in place; in decode they are read from there."""
    tp = TP(mesh)
    x = tp_mod.embed(tp, params["embed"], tokens, cfg.padded_vocab)
    for li, lp in enumerate(params["dec_layers"]):
        cache = caches[li] if caches is not None else None
        h, _ = attn_mod.gqa_attention(
            lp["attn"], cfg, apply_norm(lp["norm1"], cfg, x), positions,
            mode=mode, cache=cache["self"] if cache is not None else None,
            mesh=mesh)
        x = x + h
        if cache is not None and mode == "decode":
            kv = (cache["xk"], cache["xv"], cache["xpos"])
        else:
            kv = attn_mod.cross_kv(lp["xattn"], cfg, enc_out, mesh)
        h, _ = attn_mod.gqa_attention(
            lp["xattn"], cfg, apply_norm(lp["norm_x"], cfg, x), positions,
            mode=mode, causal=False, kv_override=kv, mesh=mesh)
        x = x + h
        x = x + tp_mod.mlp_tp(lp["mlp"], apply_norm(lp["norm2"], cfg, x),
                              mesh, cfg.d_ff)
        if mode == "prefill":
            k, v, pos = kv
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
            cache["xpos"].copy_(pos)
    x = apply_norm(params["final_norm"], cfg, x)
    return x, (caches if mode != "train" else None)


def _decoder(params, cfg: ModelConfig, tokens, positions, mode: str,
             caches, enc_out, opts: ModelOpts = DEFAULT_OPTS, mesh=None):
    """``_hidden`` through the head -> (logits [B,S,V] f32, whole on every
    rank of ``model``; the caches or None in train mode)."""
    x, caches = _hidden(params, cfg, tokens, positions, mode, caches,
                        enc_out, opts, mesh)
    return (tp_mod.logits(TP(mesh), x, params["lm_head"], cfg.padded_vocab),
            caches)


def _gathered(params, cfg: ModelConfig, mesh, opts: ModelOpts):
    """The params with every FSDP leaf gathered over the data axes under
    ``opts.fsdp_params`` on a mesh (``tp.gather_fsdp``); as given
    otherwise."""
    if mesh is None or not opts.fsdp_params:
        return params
    from repro_torch.sharding.rules import fsdp_layout
    return tp_mod.gather_fsdp(params, fsdp_layout(cfg, mesh,
                                                  opts.fsdp_min_size),
                              mesh, opts)


def encdec_loss(params, cfg: ModelConfig, batch, *, mesh=None,
                opts: ModelOpts = DEFAULT_OPTS, aux_coef: float = 0.0):
    """batch: frames [B,T,D], tokens [B,S], targets [B,S], mask [B,S] ->
    (xent, {"xent", "aux"}); under a mesh the rank's data block and its
    blocks of the params (module doc).  ``aux_coef`` is taken and dropped,
    as the reference does: the model has no MoE, so no aux term."""
    del aux_coef
    params = _gathered(params, cfg, mesh, opts)
    enc_out = encode(params, cfg, batch["frames"], opts=opts, mesh=mesh)
    b, s = batch["tokens"].shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=enc_out.device).expand(b, s)
    x, _ = _hidden(params, cfg, batch["tokens"], positions, "train", None,
                   enc_out, opts, mesh)
    xent = tp_mod.xent(TP(mesh), x, params["lm_head"], cfg.padded_vocab,
                       batch["targets"], batch["mask"].float())
    return xent, {"xent": xent,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=xent.device)}


def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device) -> List[Dict]:
    """One cache a decoder layer: ``self`` (a contiguous KV cache) and the
    cross K/V of ``encoder_seq_len`` frames with their positions."""
    dt = param_dtype(cfg)
    t = cfg.encoder_seq_len
    shape = (batch, t, cfg.num_kv_heads, cfg.head_dim_)
    return [{
        "self": attn_mod.init_cache(cfg, batch, max_len, device),
        "xk": torch.zeros(shape, dtype=dt, device=device),
        "xv": torch.zeros(shape, dtype=dt, device=device),
        "xpos": torch.zeros((batch, t), dtype=torch.int32, device=device),
    } for _ in range(cfg.num_layers)]


@torch.no_grad()
def encdec_prefill(params, cfg: ModelConfig, frames, tokens, caches, *,
                   mesh=None, opts: ModelOpts = DEFAULT_OPTS):
    """Encode ``frames`` and prefill the decoder with ``tokens`` [B,S] ->
    (last logits [B,V], caches); under a mesh the caches are the rank's
    blocks (``sharding.local_cache_specs``)."""
    params = _gathered(params, cfg, mesh, opts)
    enc_out = encode(params, cfg, frames, opts=opts, mesh=mesh)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    logits, caches = _decoder(params, cfg, tokens, positions, "prefill",
                              caches, enc_out, opts, mesh)
    return logits[:, -1], caches


@torch.no_grad()
def encdec_decode_step(params, cfg: ModelConfig, tokens, pos, caches, *,
                       mesh=None, opts: ModelOpts = DEFAULT_OPTS):
    """tokens [B], pos [B] -> (logits [B,V], caches)."""
    params = _gathered(params, cfg, mesh, opts)
    logits, caches = _decoder(params, cfg, tokens[:, None], pos, "decode",
                              caches, None, opts, mesh)
    return logits[:, 0], caches
