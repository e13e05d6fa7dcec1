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
decoder's self-attention takes the defaults.  ``opts`` is taken for the
model API's sake and unused.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import apply_norm, dense_init, embed_init, \
    init_norm, param_dtype
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts


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
           opts: ModelOpts = DEFAULT_OPTS) -> torch.Tensor:
    """frames [B, T_enc, D] (stub frontend output) -> encoder states."""
    b, t, _ = frames.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    x = frames.to(param_dtype(cfg))
    for lp in params["enc_layers"]:
        h, _ = attn_mod.gqa_attention(
            lp["attn"], cfg, apply_norm(lp["norm1"], cfg, x), positions,
            mode="train", causal=False)
        x = x + h
        x = x + mlp(lp["mlp"], apply_norm(lp["norm2"], cfg, x))
    return apply_norm(params["enc_norm"], cfg, x)


def _cross_kv(lp: Dict, cfg: ModelConfig, enc_out: torch.Tensor):
    b, t, _ = enc_out.shape
    hd = cfg.head_dim_
    k = (enc_out @ lp["xattn"]["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = (enc_out @ lp["xattn"]["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
    pos = torch.arange(t, dtype=torch.int32,
                       device=enc_out.device).expand(b, t)
    return k, v, pos


def _decoder(params, cfg: ModelConfig, tokens, positions, mode: str,
             caches, enc_out, opts: ModelOpts):
    """-> (logits [B,S,V] f32, the caches or None in train mode).  In
    prefill the cross K/V are written into the caches' ``xk`` / ``xv`` /
    ``xpos`` in place; in decode they are read from there."""
    x = params["embed"][tokens.long()]
    for li, lp in enumerate(params["dec_layers"]):
        cache = caches[li] if caches is not None else None
        h, _ = attn_mod.gqa_attention(
            lp["attn"], cfg, apply_norm(lp["norm1"], cfg, x), positions,
            mode=mode, cache=cache["self"] if cache is not None else None)
        x = x + h
        if cache is not None and mode == "decode":
            kv = (cache["xk"], cache["xv"], cache["xpos"])
        else:
            kv = _cross_kv(lp, cfg, enc_out)
        h, _ = attn_mod.gqa_attention(
            lp["xattn"], cfg, apply_norm(lp["norm_x"], cfg, x), positions,
            mode=mode, causal=False, kv_override=kv)
        x = x + h
        x = x + mlp(lp["mlp"], apply_norm(lp["norm2"], cfg, x))
        if mode == "prefill":
            k, v, pos = kv
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
            cache["xpos"].copy_(pos)
    x = apply_norm(params["final_norm"], cfg, x)
    logits = (x @ params["lm_head"]).float()
    return logits, (caches if mode != "train" else None)


def _no_mesh(mesh) -> None:
    """A mesh's params are the rank's tensor-parallel blocks
    (``sharding.local_params``), which the encoder-decoder does not run
    (ROADMAP A14): refuse rather than read a block as a whole weight."""
    if mesh is not None:
        raise NotImplementedError(
            "the encoder-decoder runs no tensor parallelism; call it "
            "without a mesh on whole params")


def encdec_loss(params, cfg: ModelConfig, batch, *, mesh=None,
                opts: ModelOpts = DEFAULT_OPTS):
    """batch: frames [B,T,D], tokens [B,S], targets [B,S], mask [B,S] ->
    (xent, {"xent", "aux"}).  No mesh: the encoder-decoder runs no
    tensor parallelism (``_no_mesh``)."""
    _no_mesh(mesh)
    from repro_torch.models.transformer import softmax_xent
    enc_out = encode(params, cfg, batch["frames"], opts=opts)
    b, s = batch["tokens"].shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=enc_out.device).expand(b, s)
    logits, _ = _decoder(params, cfg, batch["tokens"], positions, "train",
                         None, enc_out, opts)
    xent = softmax_xent(logits, batch["targets"], batch["mask"].float())
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
    (last logits [B,V], caches).  No mesh (``_no_mesh``)."""
    _no_mesh(mesh)
    enc_out = encode(params, cfg, frames, opts=opts)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    logits, caches = _decoder(params, cfg, tokens, positions, "prefill",
                              caches, enc_out, opts)
    return logits[:, -1], caches


@torch.no_grad()
def encdec_decode_step(params, cfg: ModelConfig, tokens, pos, caches, *,
                       mesh=None, opts: ModelOpts = DEFAULT_OPTS):
    """tokens [B], pos [B] -> (logits [B,V], caches).  No mesh
    (``_no_mesh``)."""
    _no_mesh(mesh)
    logits, caches = _decoder(params, cfg, tokens[:, None], pos, "decode",
                              caches, None, opts)
    return logits[:, 0], caches
