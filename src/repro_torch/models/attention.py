"""Attention layers: GQA (qk-norm, sliding window) and MLA (Multi-head
Latent Attention), over the contiguous or the paged KV cache.

The two layouts, per layer, as in ``repro.models.attention``::

    contiguous  GQA {"k": [B, S_buf, Hkv, hd], "v": [B, S_buf, Hkv, hd],
                     "pos": [B, S_buf]}
                MLA {"ckv": [B, S_buf, r], "krope": [B, S_buf, dr],
                     "pos": [B, S_buf]}
    paged       GQA {"kp": [N, P, Hkv, hd], "vp": [N, P, Hkv, hd],
                     "posp": [N, P]}
                MLA {"ckvp": [N, P, r], "kropep": [N, P, dr], "posp": [N, P]}

A contiguous row is a ring of S_buf slots (slot = pos % S_buf); a paged
pool holds N pages of P positions.  ``block_tables [B, n_blk]`` maps
logical block j of sequence b to a physical page; page 0 is the reserved
trash page (``posp`` stays -1) that unmapped entries point at.  ``pos`` /
``posp`` hold the absolute position in each slot (-1 = empty) and every
mask is derived from them.  Writes with a position < 0 write nothing.  Unlike the reference, the
port updates the cache tensors in place (no functional copy of the pool
per step).

Modes: ``"train"`` (whole sequence, no cache), ``"prefill"`` (whole
sequence, written to a contiguous cache), ``"chunk"`` (chunked prefill on
either cache: attend the pre-write cache plus the chunk, then commit the
chunk) and ``"decode"`` (one token per row).  Train and prefill run
the ``flash_attention`` kernel under ``use_flash``; decode attends the
pages in place through ``flash_decode_paged`` under ``use_paged_kernel``
(walking the first ``kernel_blocks`` table columns), else reads a
contiguous view -- the cache itself, or the pages gathered -- through the
``flash_decode`` kernel under ``use_flash_decode`` or the masked softmax.

MLA caches one latent row per position (``r = kv_lora_rank`` values plus a
single ``dr``-wide rope key shared by every head).  Train and prefill
materialize k and v per token; chunk and decode write the new latents
first and then attend the whole cache, either absorbed (``W_kv_b(k)``
folded into the query, ``W_kv_b(v)`` into the output: work scales with
``r``) or materialized.  Paged absorbed decode under ``use_paged_kernel``
runs the ``flash_decode_paged_mla`` kernel over the latent pages in place.

Under a bound ``mesh`` both run tensor parallelism over ``model``
(``models/tp.py``): a rank attends the heads that overlap its block of
``wo``'s rows (``_gqa_plan``, ``_MlaHeads``), from its column blocks of
the projections where they hold just those heads, else from the gathered
projections; then its rows of ``wo`` and a sum over ``model``.  A GQA
cache holds the rank's kv heads where they split over ``model``, else
every kv head (written whole on every rank; the attention reads the
rank's heads of it, a view); an MLA latent cache has no head dim and is
whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp as tp_mod
from repro_torch.models.common import activation_dtype, apply_rope, \
    dense_init, param_dtype, rms_norm_headwise
from repro_torch.models.tp import TP

NEG_INF = -1e30
TRASH_PAGE = 0  # reserved page unmapped block-table entries point at


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #


def _check_attention(cfg: ModelConfig) -> None:
    if cfg.attention not in ("gqa", "mla", "none"):
        raise ValueError(f"unknown attention {cfg.attention!r}; the "
                         "reference has 'gqa', 'mla' and 'none'")


def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    _check_attention(cfg)
    dt = param_dtype(cfg)
    d = cfg.d_model
    if cfg.attention == "mla":
        hd_q = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        h, r = cfg.num_heads, cfg.kv_lora_rank
        p: Dict = {}
        if cfg.q_lora_rank:
            p["wq_a"] = dense_init(gen, (d, cfg.q_lora_rank), dt, device)
            p["q_norm"] = {"scale": torch.ones(cfg.q_lora_rank, dtype=dt,
                                               device=device)}
            p["wq_b"] = dense_init(gen, (cfg.q_lora_rank, h * hd_q), dt,
                                   device, in_axis_size=cfg.q_lora_rank)
        else:
            p["wq"] = dense_init(gen, (d, h * hd_q), dt, device)
        p["wkv_a"] = dense_init(gen, (d, r + cfg.qk_rope_head_dim), dt,
                                device)
        p["kv_norm"] = {"scale": torch.ones(r, dtype=dt, device=device)}
        p["wkv_b"] = dense_init(
            gen, (r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), dt,
            device, in_axis_size=r)
        p["wo"] = dense_init(gen, (h * cfg.v_head_dim, d), dt, device,
                             in_axis_size=h * cfg.v_head_dim)
        return p
    hd = cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), dt, device),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), dt, device),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), dt, device),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), dt, device,
                         in_axis_size=cfg.num_heads * hd),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones(hd, dtype=dt, device=device)}
        p["k_norm"] = {"scale": torch.ones(hd, dtype=dt, device=device)}
    return p


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig,
                         device) -> Dict:
    """Encoder-decoder cross attention (whisper)."""
    return init_attention(gen, cfg, device)


# --------------------------------------------------------------------------- #
# Contiguous cache
# --------------------------------------------------------------------------- #


def cache_buf_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """Single-layer contiguous cache: ``batch`` rows of ``S_buf`` slots."""
    dt = activation_dtype(cfg)
    s = cache_buf_len(cfg, max_len)
    if cfg.attention == "mla":
        return {
            "ckv": torch.zeros((batch, s, cfg.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, s, cfg.qk_rope_head_dim), dtype=dt,
                                 device=device),
            "pos": torch.full((batch, s), -1, dtype=torch.int32,
                              device=device),
        }
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def _write_seq(buf: torch.Tensor, values: torch.Tensor,
               positions: torch.Tensor, shard=None) -> None:
    """Scatter a [B, S, ...] sequence into a ring buffer at positions %
    S_buf, in place; only the last S_buf tokens when S > S_buf (ring
    semantics).  Positions < 0 write nothing, with no host sync: each one
    repeats its row's last valid write (the same value to the same slot,
    so the duplicate index is harmless), and a row with none writes its
    slot 0 back unchanged.

    ``shard = (S_buf, lo)``: ``buf`` holds only slots [lo, lo + its
    length) of a ring of S_buf (a context-parallel rank's block); writes
    to other slots are skipped like negative positions."""
    s_loc = buf.shape[1]
    s_buf, lo = shard if shard is not None else (s_loc, 0)
    if values.shape[1] > s_buf:
        values, positions = values[:, -s_buf:], positions[:, -s_buf:]
    b, s = positions.shape
    ring = positions.long() % s_buf
    valid = (positions >= 0) & (ring >= lo) & (ring < lo + s_loc)
    j = torch.arange(s, device=buf.device).expand(b, s)
    last = torch.where(valid, j, -1).amax(dim=1, keepdim=True)   # [B, 1]
    src = torch.where(valid, j, last)                            # donor
    has = src >= 0
    src = src.clamp(min=0)
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    slot = torch.where(has, ring.gather(1, src) - lo, 0)
    keep = has.reshape(has.shape + (1,) * (values.dim() - 2))
    buf[bidx, slot] = torch.where(keep, values[bidx, src].to(buf.dtype),
                                  buf[bidx, slot])


def _write_step(buf: torch.Tensor, value: torch.Tensor,
                position: torch.Tensor, shard=None) -> None:
    """Scatter one token per row: value [B, ...], position [B] (< 0: idle
    row, nothing written)."""
    _write_seq(buf, value[:, None], position[:, None], shard)


def _seq_shard(mesh, cache: Dict):
    """(S_buf, lo) of this rank's block of a sequence-sharded contiguous
    cache (``sharding.cache_specs(seq_shard=True)``)."""
    if is_paged(cache):
        raise NotImplementedError(
            "decode_kv_seq_shard requires the contiguous cache layout")
    s_loc = cache["k"].shape[1]
    return s_loc * mesh.shape["model"], mesh.axis_index("model") * s_loc


# --------------------------------------------------------------------------- #
# Paged (block-table) cache
# --------------------------------------------------------------------------- #


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Dict:
    """Single-layer paged pool: ``num_pages`` pages of ``page_size`` slots."""
    dt = activation_dtype(cfg)
    n, p = num_pages, page_size
    if cfg.attention == "mla":
        return {
            "ckvp": torch.zeros((n, p, cfg.kv_lora_rank), dtype=dt,
                                device=device),
            "kropep": torch.zeros((n, p, cfg.qk_rope_head_dim), dtype=dt,
                                  device=device),
            "posp": torch.full((n, p), -1, dtype=torch.int32, device=device),
        }
    shape = (n, p, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "kp": torch.zeros(shape, dtype=dt, device=device),
        "vp": torch.zeros(shape, dtype=dt, device=device),
        "posp": torch.full((n, p), -1, dtype=torch.int32, device=device),
    }


def is_paged(cache: Optional[Dict]) -> bool:
    """A layer's cache is a paged pool (``posp``), not a contiguous row."""
    return cache is not None and "posp" in cache


def _paged_write(pages: torch.Tensor, values: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor) -> None:
    """Scatter [B, S, ...] values into a page pool through the block table,
    in place.  Positions < 0 write nothing: they are aimed at slot 0 of the
    trash page -- never a valid target -- and write back what it holds
    (a mask instead of boolean indexing, which would stall the host on a
    device sync every call).  Ring semantics (slot = pos % S_buf) fall out
    of S_buf = n_blk * P."""
    p = pages.shape[1]
    s_buf = block_tables.shape[1] * p
    valid = positions >= 0
    slot = torch.where(valid, positions, 0).long() % s_buf        # [B, S]
    page = torch.gather(block_tables.long(), 1, slot // p)
    page = torch.where(valid, page, TRASH_PAGE)
    off = torch.where(valid, slot % p, 0)
    keep = valid.reshape(valid.shape + (1,) * (values.dim() - valid.dim()))
    pages[page, off] = torch.where(keep, values.to(pages.dtype),
                                   pages[page, off])


def _paged_read(pages: torch.Tensor, block_tables: torch.Tensor):
    """Gather a sequence view [B, n_blk * P, ...] from the pool."""
    g = pages[block_tables.long()]                     # [B, n_blk, P, ...]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


# --------------------------------------------------------------------------- #
# Masking + core attention math
# --------------------------------------------------------------------------- #


def _mask_bias(q_pos, kv_pos, window: Optional[int], causal: bool):
    """Additive bias [B, 1, Sq, Sk] from absolute positions."""
    q = q_pos[:, None, :, None].int()
    k = kv_pos[:, None, None, :].int()
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window is not None:
        valid = valid & (k > q - window)
    return torch.where(valid, 0.0, NEG_INF).float()


_LOW = (torch.bfloat16, torch.float16)


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product a [N,M,K] @ b [N,K,P] -> f32 [N,M,P], every
    product of two operands exact and summed in f32: the reference's
    ``preferred_element_type=jnp.float32``.  On the card and on ``meta``
    two bf16 / f16 operands go to ``bmm``'s ``out_dtype`` form as they
    are; the CPU has no such form and multiplies f32 copies (whose
    products are the same exact ones).  Operands of other or mixed dtypes
    are multiplied as f32.  Not differentiable (``bmm.dtype`` has no
    backward): ``_ScoresF32`` and ``_ValuesF32`` are."""
    dev = a.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"f32_product: no route for device {a.device}")
    if dev != "cpu" and a.dtype == b.dtype and a.dtype in _LOW:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _ScoresF32(torch.autograd.Function):
    """q [N,M,d] @ kT [N,d,Sk] -> f32 scores (``f32_product``).  The
    backward multiplies the f32 cotangent by f32 copies of the small
    operands and casts each gradient to its operand's dtype, as the
    reference's transpose of ``preferred_element_type`` does (the same
    exact products, summed in f32)."""

    @staticmethod
    def forward(ctx, q, kt):
        ctx.save_for_backward(q, kt)
        return f32_product(q, kt)

    @staticmethod
    def backward(ctx, g):
        q, kt = ctx.saved_tensors
        gq = gk = None
        if ctx.needs_input_grad[0]:
            gq = f32_product(g, kt.transpose(1, 2)).to(q.dtype)
        if ctx.needs_input_grad[1]:
            gk = f32_product(q.transpose(1, 2), g).to(kt.dtype)
        return gq, gk


class _ValuesF32(torch.autograd.Function):
    """probs [N,M,Sk] (f32, cast to v's dtype here) @ v [N,Sk,dv] -> f32
    (``f32_product``).  The backward keeps the probabilities' cotangent
    in f32 (the reference's transpose rounds it to v's dtype and its
    cast's transpose back to f32: a pair XLA fuses away, which eager
    would run over the whole score tensor twice), and forms v's from the
    output's cotangent cast to v's dtype: exact where the output is cast
    to that dtype after the product, as the model's attention casts it
    to q's (q, k and v share the activation dtype)."""

    @staticmethod
    def forward(ctx, probs, v):
        p = probs.to(v.dtype)
        ctx.save_for_backward(p, v)
        return f32_product(p, v)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        gp = gv = None
        if ctx.needs_input_grad[0]:
            gp = f32_product(g, v.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            gv = f32_product(p.transpose(1, 2), g.to(v.dtype)).to(v.dtype)
        return gp, gv


def _scores_f32(qg, k):
    """qg [B,Sq,Hkv,g,d] . k [B,Sk,Hkv,d] -> f32 scores [B,Hkv,g,Sq,Sk]
    of the operands as stored (``_ScoresF32``)."""
    b, sq, hkv, g, d = qg.shape
    s = _ScoresF32.apply(
        qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * sq, d),
        k.to(qg.dtype).permute(0, 2, 3, 1).reshape(b * hkv, d, k.shape[1]))
    return s.reshape(b, hkv, g, sq, k.shape[1])


def _values_f32(probs, v):
    """probs [B,Hkv,g,Sq,Sk] (cast to v's dtype) . v [B,Sk,Hkv,dv] -> f32
    [B,Sq,Hkv,g,dv] (``_ValuesF32``)."""
    b, hkv, g, sq, sk = probs.shape
    o = _ValuesF32.apply(
        probs.reshape(b * hkv, g * sq, sk),
        v.permute(0, 2, 1, 3).reshape(b * hkv, sk, v.shape[-1]))
    return o.reshape(b, hkv, g, sq, v.shape[-1]).permute(0, 3, 1, 2, 4)


def _sdpa(q, k, v, bias, scale: float, compute_dtype: str = "f32"):
    """Grouped-query attention: q [B,Sq,Hq,d], k/v [B,Sk,Hkv,d].

    ``compute_dtype="bf16_accum32"`` keeps the operands in their storage
    dtype and forms the scores and the output in f32 (``f32_product``), as
    the reference's ``preferred_element_type``; the probabilities are cast
    to v's dtype for the second product."""
    b, sq, hq, dq = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    # standard GQA head mapping: q head h uses kv head h // g (kv-major)
    qg = q.reshape(b, sq, hkv, g, dq)
    if compute_dtype == "bf16_accum32":
        scores = _scores_f32(qg, k)
    else:
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale + bias[:, None]              # [B,Hkv,g,Sq,Sk]
    probs = torch.softmax(scores, dim=-1)
    if compute_dtype == "bf16_accum32":
        out = _values_f32(probs, v)
    else:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# Sequence-sharded decode attention (context parallelism for the KV cache)
# --------------------------------------------------------------------------- #


def _decode_attend_seqshard(cfg: ModelConfig, q, k_new, v_new, pos_b, cache,
                            shard, mesh, compute_dtype: str = "f32"):
    """Decode attention with the contiguous cache sharded over the
    *sequence* dim of the ``model`` axis (flash-decoding-style context
    parallelism): q [B,1,Hq,d] and the new k / v [B,Hkv,d] of the rank's
    rows, ``cache`` its block of S_buf / m slots -> [B,1,Hq,d].

    The rank appends the new token iff its ring slot is local, computes
    its partial (max m, sumexp l, softmax-weighted V o over its slots),
    and the ranks merge them in log-sum-exp form:

        m* = pmax(m);  w = l e^{m-m*};  out = psum(o * w / psum(w))

    (the reference's psum(o l e^{m-m*}) / psum(l e^{m-m*}) with each o
    normalized first, so that one rank's weight is exactly 1 and its
    output the plain softmax's bits).  Masking needs no special case: it
    is derived from the stored absolute positions (a rank with no visible
    slot gets weight e^{-1e30 - m*} = 0).

    ``"bf16_accum32"`` casts probabilities to v's dtype before the second
    product, so the ranks merge before it: m* and the global sum first,
    then each rank's slots' probabilities e^{s-m*} / psum(l), cast, and
    the products summed over ``model`` -- the probabilities ``_sdpa``
    casts, up to the order of the f32 sums (the reference casts each
    rank's unnormalized e^{s-m}, which rounds otherwise).  The same three
    collectives as ``"f32"``'s.
    """
    from repro_torch.sharding import comm
    _write_step(cache["k"], k_new, pos_b, shard)
    _write_step(cache["v"], v_new, pos_b, shard)
    _write_step(cache["pos"], pos_b, pos_b, shard)
    k_l, v_l = cache["k"], cache["v"]
    bias = _mask_bias(pos_b[:, None], cache["pos"], cfg.sliding_window,
                      True)                               # [B,1,1,S_loc]
    b, _, hq, dq = q.shape
    hkv = k_l.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, dq)   # q head h -> kv head h // g
    scale = 1.0 / cfg.head_dim_ ** 0.5
    if compute_dtype == "bf16_accum32":
        # the global softmax's probabilities of the rank's slots
        s = _scores_f32(qg, k_l) * scale + bias[:, None]  # [B,hkv,g,1,S_loc]
        m = comm.pmax(s.amax(dim=-1), mesh, "model")      # [B,hkv,g,1]
        e = torch.exp(s - m[..., None])
        l = comm.psum(e.sum(dim=-1), mesh, "model")
        out = comm.psum(_values_f32(e / l[..., None], v_l), mesh, "model")
        return out.reshape(b, 1, hq, v_l.shape[-1]).to(q.dtype)
    # the scores and the local softmax as ``_sdpa`` computes them
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_l.float())
    s = s * scale + bias[:, None]                         # [B,hkv,g,1,S_loc]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_l.float())
    m = s.amax(dim=-1)                                    # [B,hkv,g,1]
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    w = l * torch.exp(m - comm.pmax(m, mesh, "model"))
    w = w / comm.psum(w, mesh, "model")                   # [B,hkv,g,1]
    out = comm.psum(o * w.permute(0, 3, 1, 2)[..., None], mesh, "model")
    return out.reshape(b, 1, hq, v_l.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA forward
# --------------------------------------------------------------------------- #


def _gqa_plan(cfg: ModelConfig, tp: TP, seq_shard: bool):
    """The rank's heads under tensor parallelism, or None (no mesh, or
    ``wo``'s rows do not split: every rank runs the layer whole).

    -> (qlo, qhi, klo, khi, a, b): the rank attends q heads [qlo, qhi)
    against kv heads [klo + a, klo + b); its cache holds kv heads
    [klo, khi) -- its block where the kv heads split over ``model``, else
    all of them.  q heads [qlo, qhi) cover the heads of the rank's rows of
    ``wo``, widened to whole kv groups where those heads would map onto
    their kv heads unevenly (the kernels' head group must be one
    integer).  Context-parallel decode (``seq_shard``) attends every head
    on every rank."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if not tp.splits(h * hd):
        return None
    g = h // hkv
    if seq_shard:
        return 0, h, 0, hkv, 0, hkv
    if hkv % tp.m == 0:
        klo, n = tp.block(hkv)
        return klo * g, (klo + n) * g, klo, klo + n, 0, n
    qlo, qhi = tp_mod.heads_of(tp, h, hd)
    a, b = qlo // g, (qhi - 1) // g + 1
    nq, nk = qhi - qlo, b - a
    if nq % nk or any((qlo + j) // g - a != j // (nq // nk)
                      for j in range(nq)):
        qlo, qhi = a * g, b * g
    return qlo, qhi, 0, hkv, a, b


def gqa_attention(
    params: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    compute_dtype: str = "f32",
    block_tables=None,
    use_flash: bool = False,
    use_flash_decode: bool = False,
    use_paged_kernel: bool = False,
    kernel_blocks: Optional[int] = None,
    causal: bool = True,
    kv_override=None,
    mesh=None,
    seq_shard: bool = False,
    rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,D]; positions [B,S] (train/prefill/chunk) or [B] (decode).

    Returns (output [B,S,D], the cache -- updated in place -- or None).
    ``causal=False`` attends every valid key (the encoder);
    ``kv_override = (k, v, kv_positions)`` is cross-attention: rope-free,
    no cache read or write, through the plain masked softmax in train,
    prefill and decode (the reference sends neither to a kernel).
    ``rope=False`` leaves q and k unrotated, as the reference's flag.

    ``mesh`` (bound) runs tensor parallelism (module doc);
    ``seq_shard`` with it makes the contiguous cache the rank's block of
    ``S_buf / model`` slots: prefill writes only its own slots, decode
    attends them and merges the ranks' partials
    (``_decode_attend_seqshard``); chunked prefill refuses it.
    """
    if kv_override is not None:
        return _cross(params, cfg, x, positions, TP(mesh), mode=mode,
                      kv=kv_override, compute_dtype=compute_dtype,
                      causal=causal)
    if mesh is not None:
        return _gqa_tp(params, cfg, x, positions, TP(mesh), mode=mode,
                       cache=cache, compute_dtype=compute_dtype,
                       block_tables=block_tables, use_flash=use_flash,
                       use_flash_decode=use_flash_decode,
                       use_paged_kernel=use_paged_kernel,
                       kernel_blocks=kernel_blocks, causal=causal,
                       seq_shard=seq_shard, rope=rope)
    return _gqa_whole(params, cfg, x, positions, mode=mode, cache=cache,
                      compute_dtype=compute_dtype, block_tables=block_tables,
                      use_flash=use_flash, use_flash_decode=use_flash_decode,
                      use_paged_kernel=use_paged_kernel,
                      kernel_blocks=kernel_blocks, causal=causal, rope=rope)


def _gqa_whole(params, cfg: ModelConfig, x, positions, *, seq_mesh=None,
               cache=None, **kw):
    """The whole layer on this process; ``seq_mesh`` shards the contiguous
    cache's sequence over its ``model`` axis (context parallelism)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_norm"]["scale"])
        k = rms_norm_headwise(k, params["k_norm"]["scale"])
    shard = (_seq_shard(seq_mesh, cache)
             if seq_mesh is not None and cache is not None else None)
    out, cache = _gqa_core(cfg, q, k, v, positions, cache=cache, shard=shard,
                           seq_shard_mesh=seq_mesh, **kw)
    return out.reshape(b, s, cfg.num_heads * hd) @ params["wo"], cache


def _gqa_tp(params, cfg: ModelConfig, x, positions, tp: TP, *, mode, cache,
            seq_shard: bool, **kw):
    """``gqa_attention`` on a rank of a bound mesh (module doc)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    shard = (_seq_shard(tp.mesh, cache)
             if seq_shard and cache is not None else None)
    plan = _gqa_plan(cfg, tp, shard is not None)
    if plan is None:                       # wo whole: the layer runs whole
        return _gqa_whole(params, cfg, x, positions, mode=mode, cache=cache,
                          seq_mesh=tp.mesh if seq_shard else None, **kw)
    qlo, qhi, klo, khi, a, bb = plan
    x_f = tp.f(x)
    q = tp_mod.heads(tp, tp_mod.project(tp, x, x_f, params["wq"], h * hd),
                     h, hd, qlo, qhi)
    k, v = (tp_mod.heads(tp, tp_mod.project(tp, x, x_f, params[n],
                                            hkv * hd), hkv, hd, klo, khi)
            for n in ("wk", "wv"))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, tp.f(params["q_norm"]["scale"]))
        k = rms_norm_headwise(k, tp.f(params["k_norm"]["scale"]))
    # a view only where the rank reads part of the cache's heads: through
    # a view of all of them the backward rounds otherwise on the card
    whole = (a, bb) == (0, khi - klo)
    out, cache = _gqa_core(cfg, q, k, v, positions, mode=mode, cache=cache,
                           shard=shard, seq_shard_mesh=tp.mesh,
                           heads=None if whole else (a, bb), **kw)
    out = tp_mod.rows_of(tp, out, h, hd, qlo) @ params["wo"]
    return tp.g(out), cache


def cross_kv(params, cfg: ModelConfig, enc_out, mesh=None):
    """The cross-attention's keys and values of the encoder states
    ``enc_out`` [B, T, D] -> (k, v [B, T, Hc, hd], positions [B, T]): every
    kv head without a mesh; under one, kv heads [klo, khi) of the rank's
    ``_gqa_plan`` (its block where they split over ``model``, as its
    cache's ``xk`` / ``xv``, else all of them)."""
    b, t, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    tp = TP(mesh)
    plan = _gqa_plan(cfg, tp, False)
    if plan is None:
        k, v = ((enc_out @ params[n]).reshape(b, t, hkv, hd)
                for n in ("wk", "wv"))
    else:
        klo, khi = plan[2:4]
        enc_f = tp.f(enc_out)
        k, v = (tp_mod.heads(tp, tp_mod.project(tp, enc_out, enc_f,
                                                params[n], hkv * hd),
                             hkv, hd, klo, khi) for n in ("wk", "wv"))
    pos = torch.arange(t, dtype=torch.int32,
                       device=enc_out.device).expand(b, t)
    return k, v, pos


def _cross(params, cfg: ModelConfig, x, positions, tp: TP, *, mode, kv,
           compute_dtype, causal):
    """Cross-attention over ``kv`` (``cross_kv``'s, or the cache's ``xk`` /
    ``xv`` / ``xpos``): the whole layer off a mesh (or where ``wo``'s rows
    do not split), else the rank's q heads of ``_gqa_plan`` against its kv
    heads, its rows of ``wo`` and a sum over ``model``."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim_
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"cross-attention mode {mode!r}: 'train', "
                         "'prefill' or 'decode'")
    k, v, kv_pos = kv
    q_scale = params["q_norm"]["scale"] if cfg.qk_norm else None
    plan = _gqa_plan(cfg, tp, False)
    if plan is None:
        q = (x @ params["wq"]).reshape(b, s, h, hd)
    else:
        qlo, qhi, klo, khi, a, bb = plan
        q = tp_mod.heads(tp, tp_mod.project(tp, x, tp.f(x), params["wq"],
                                            h * hd), h, hd, qlo, qhi)
        if (a, bb) != (0, khi - klo):
            k, v = k.narrow(2, a, bb - a), v.narrow(2, a, bb - a)
        if cfg.qk_norm:
            q_scale = tp.f(q_scale)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, q_scale)
    q_pos = positions[:, None] if mode == "decode" else positions
    bias = _mask_bias(q_pos, kv_pos, cfg.sliding_window, causal)
    out = _sdpa(q, k, v, bias, 1.0 / hd ** 0.5, compute_dtype)
    if plan is None:
        return out.reshape(b, s, h * hd) @ params["wo"], None
    out = tp_mod.rows_of(tp, out, h, hd, qlo) @ params["wo"]
    return tp.g(out), None


def _gqa_core(cfg: ModelConfig, q, k, v, positions, *, mode, cache,
              compute_dtype="f32", block_tables=None, use_flash=False,
              use_flash_decode=False, use_paged_kernel=False,
              kernel_blocks=None, causal=True, shard=None,
              seq_shard_mesh=None, heads=None, rope=True):
    """The attention of q [B,S,Hq,hd] over k / v [B,S,Hc,hd] (the cache's
    kv heads) -> (out [B,S,Hq,hd], cache).  ``heads = (a, b)``: attend kv
    heads [a, b) of the cache's (a view; all by default); ``rope=False``
    leaves q and k unrotated."""
    b, s = q.shape[:2]
    hd = cfg.head_dim_
    scale = 1.0 / hd ** 0.5

    def rot(t, pos):
        return apply_rope(t, pos, cfg.rope_theta) if rope else t

    def kv(t):
        return t if heads is None else t.narrow(2, heads[0],
                                                heads[1] - heads[0])

    if mode == "decode":
        pos_s = positions[:, None]                        # [B, 1]
        q = rot(q, pos_s)
        k = rot(k, pos_s)
        out = None
        if shard is not None:
            # context-parallel decode: the plain path, as the reference's
            # (no kernel takes a sequence block)
            out = _decode_attend_seqshard(cfg, q, k[:, 0], v[:, 0],
                                          positions, cache, shard,
                                          seq_shard_mesh, compute_dtype)
        elif "kp" in cache:
            _paged_write(cache["kp"], k, pos_s, block_tables)
            _paged_write(cache["vp"], v, pos_s, block_tables)
            _paged_write(cache["posp"], pos_s, pos_s, block_tables)
            if use_paged_kernel:
                # block-table-native: attend the pages in place, walking
                # only the live-page prefix when the caller bounded it
                from repro_torch.kernels import flash_decode_paged
                bt = (block_tables if kernel_blocks is None
                      else block_tables[:, :kernel_blocks])
                out = flash_decode_paged(
                    q[:, 0], kv(cache["kp"]), kv(cache["vp"]),
                    cache["posp"], bt, positions.int(),
                    window=cfg.sliding_window)[:, None]
            else:
                k_all = kv(_paged_read(cache["kp"], block_tables))
                v_all = kv(_paged_read(cache["vp"], block_tables))
                kv_pos = _paged_read(cache["posp"], block_tables)
        else:
            _write_step(cache["k"], k[:, 0], positions)
            _write_step(cache["v"], v[:, 0], positions)
            _write_step(cache["pos"], positions, positions)
            k_all, v_all, kv_pos = kv(cache["k"]), kv(cache["v"]), cache["pos"]
        if out is None and use_flash_decode:
            from repro_torch.kernels import flash_decode
            out = flash_decode(q[:, 0], k_all, v_all, kv_pos,
                               positions.int(),
                               window=cfg.sliding_window)[:, None]
        elif out is None:
            bias = _mask_bias(pos_s, kv_pos, cfg.sliding_window, True)
            out = _sdpa(q, k_all, v_all, bias, scale, compute_dtype)
    elif mode == "chunk":
        if shard is not None:
            raise NotImplementedError(
                "decode_kv_seq_shard serves whole-prompt prefill and decode; "
                "chunked prefill attends the whole cache row")
        # attend against the PRE-write cache plus the in-chunk keys, then
        # commit the chunk (the reference's order: writing first would
        # evict, on a sliding-window ring, positions still inside the
        # window of the chunk's own earlier queries; and exact against
        # whole-prompt prefill)
        q = rot(q, positions)
        k = rot(k, positions)
        if "kp" in cache:
            k_old = _paged_read(cache["kp"], block_tables)
            v_old = _paged_read(cache["vp"], block_tables)
            pos_old = _paged_read(cache["posp"], block_tables)
        else:
            k_old, v_old, pos_old = cache["k"], cache["v"], cache["pos"]
        k_all = kv(torch.cat([k_old, k.to(k_old.dtype)], dim=1))
        v_all = kv(torch.cat([v_old, v.to(v_old.dtype)], dim=1))
        kv_pos = torch.cat([pos_old, positions.to(pos_old.dtype)], dim=1)
        bias = _mask_bias(positions, kv_pos, cfg.sliding_window, True)
        out = _sdpa(q, k_all, v_all, bias, scale, compute_dtype)
        if "kp" in cache:
            _paged_write(cache["kp"], k, positions, block_tables)
            _paged_write(cache["vp"], v, positions, block_tables)
            _paged_write(cache["posp"], positions, positions, block_tables)
        else:
            _write_seq(cache["k"], k, positions)
            _write_seq(cache["v"], v, positions)
            _write_seq(cache["pos"], positions, positions)
    elif mode in ("train", "prefill"):
        q = rot(q, positions)
        k = rot(k, positions)
        if use_flash and causal:
            # masks by index, as the reference kernel: positions must be
            # 0..S-1 in every row (no pads).  The kernel reads the [B,S,H,hd]
            # activations through their strides and writes its output in
            # q's layout, so neither transpose copies
            from repro_torch.kernels import flash_attention
            out = flash_attention(
                q.transpose(1, 2), kv(k).transpose(1, 2),
                kv(v).transpose(1, 2),
                window=cfg.sliding_window).transpose(1, 2)
        else:
            bias = _mask_bias(positions, positions, cfg.sliding_window,
                              causal)
            out = _sdpa(q, kv(k), kv(v), bias, scale, compute_dtype)
        if mode == "prefill":
            _write_seq(cache["k"], k, positions, shard)
            _write_seq(cache["v"], v, positions, shard)
            _write_seq(cache["pos"], positions, positions, shard)
        else:
            cache = None
    else:
        raise ValueError(f"attention mode {mode!r}: the port serves "
                         "'train', 'prefill', 'chunk' and 'decode'")
    return out, cache


# --------------------------------------------------------------------------- #
# MLA forward
# --------------------------------------------------------------------------- #


def _mla_q(params, cfg: ModelConfig, x, hp):
    """x [B,S,D] -> (q_nope [B,S,H',dn], q_rope [B,S,H',dr]) for the heads
    of ``hp`` (``_MlaHeads``).  The q and kv norms are RMSNorms with
    ``cfg.norm_eps`` whatever ``cfg.norm_type`` is (``rms_norm_headwise``
    over the last dim is that norm)."""
    hd_q = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rms_norm_headwise(x @ params["wq_a"],
                               params["q_norm"]["scale"], cfg.norm_eps)
        q = hp.project(cq, params["wq_b"], hd_q)
    else:
        q = hp.project(x, params["wq"], hd_q)
    return q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)


def _mla_latents(params, cfg: ModelConfig, x, positions):
    """x [B,S,D] -> (ckv [B,S,r] RMS-normed, krope [B,S,dr] rotated)."""
    ckv, krope = (x @ params["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    ckv = rms_norm_headwise(ckv, params["kv_norm"]["scale"], cfg.norm_eps)
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def _wkv_b_split(params, cfg: ModelConfig, hp):
    """W_kv_b [r, H*(dn+dv)] -> (wk_b [r, H', dn], wv_b [r, H', dv]) for
    the heads of ``hp``."""
    wkv_b = hp.heads(params["wkv_b"], cfg.qk_nope_head_dim + cfg.v_head_dim)
    return (wkv_b[..., :cfg.qk_nope_head_dim],
            wkv_b[..., cfg.qk_nope_head_dim:])


class _MlaHeads:
    """The heads an MLA layer runs on this rank: all of them without a
    mesh; under one, those overlapping the rank's rows of ``wo``
    (``partial`` where they split: the rank computes its part of the
    output, summed over ``model`` after ``wo``)."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.tp = TP(mesh)
        self.h = cfg.num_heads
        self.dv = cfg.v_head_dim
        self.lo, self.hi = tp_mod.heads_of(self.tp, self.h, self.dv)
        self.partial = self.tp.splits(self.h * self.dv)

    def heads(self, y, width: int):
        """Heads [lo, hi) of features ``y`` (this rank's block where they
        split, ``tp_mod.heads``)."""
        if not self.tp.on:
            return y.reshape(*y.shape[:-1], self.h, width)
        return tp_mod.heads(self.tp, y, self.h, width, self.lo, self.hi,
                            partial=self.partial)

    def project(self, x, w, width: int):
        """The heads of the column-parallel ``x @ w``."""
        split = self.tp.splits(self.h * width)
        return self.heads((self.tp.f(x) if split else x) @ w, width)

    def shared(self, t):
        """A tensor every rank holds whole (a latent) read by its heads."""
        return self.tp.f(t) if self.partial else t

    def out(self, o, wo):
        """o [B,S,H',dv] -> the layer's output [B,S,D]."""
        if not self.partial:
            return o.reshape(*o.shape[:2], -1) @ wo
        return self.tp.g(tp_mod.rows_of(self.tp, o, self.h, self.dv,
                                        self.lo) @ wo)


def mla_attention(
    params: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    absorb: bool = True,
    block_tables=None,
    use_paged_kernel: bool = False,
    kernel_blocks: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head Latent Attention (DeepSeek-V2).  x [B,S,D]; positions
    [B,S] (train/prefill/chunk) or [B] (decode).

    ``use_paged_kernel`` (paged cache, decode, absorbed path only) attends
    the latent pages ``ckvp`` / ``kropep`` in place through the
    ``flash_decode_paged_mla`` kernel; every other mode and the
    materialized path gather.  ``mesh`` (bound) runs tensor parallelism
    (module doc).  Returns (output [B,S,D], the cache -- updated in place
    -- or None)."""
    b, s, _ = x.shape
    hp = _MlaHeads(cfg, mesh)
    scale = 1.0 / ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5)

    if mode in ("decode", "chunk"):
        # decode is the S=1 case of chunked prefill: write the new latents
        # first, then attend everything the cache holds (the reference's
        # MLA order, unlike the GQA chunk path)
        q_pos = positions[:, None] if mode == "decode" else positions
        q_nope, q_rope = _mla_q(params, cfg, x, hp)
        q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
        ckv_t, krope_t = _mla_latents(params, cfg, x, q_pos)
        wk_b, wv_b = _wkv_b_split(params, cfg, hp)
        if "ckvp" in cache:
            _paged_write(cache["ckvp"], ckv_t, q_pos, block_tables)
            _paged_write(cache["kropep"], krope_t, q_pos, block_tables)
            _paged_write(cache["posp"], q_pos, q_pos, block_tables)
            if use_paged_kernel and absorb and mode == "decode":
                from repro_torch.kernels import flash_decode_paged_mla
                q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                                     wk_b.float())
                bt = (block_tables if kernel_blocks is None
                      else block_tables[:, :kernel_blocks])
                o_lat = flash_decode_paged_mla(
                    q_lat[:, 0].contiguous(),
                    q_rope[:, 0].float().contiguous(), cache["ckvp"],
                    cache["kropep"], cache["posp"], bt, positions.int(),
                    scale=scale)                           # [B, H, r] f32
                out = torch.einsum("bhr,rhv->bhv", o_lat, wv_b.float())
                return hp.out(out.to(x.dtype)[:, None], params["wo"]), cache
            ckv = _paged_read(cache["ckvp"], block_tables)
            krope = _paged_read(cache["kropep"], block_tables)
            kv_pos = _paged_read(cache["posp"], block_tables)
        else:
            _write_seq(cache["ckv"], ckv_t, q_pos)
            _write_seq(cache["krope"], krope_t, q_pos)
            _write_seq(cache["pos"], q_pos, q_pos)
            ckv, krope, kv_pos = cache["ckv"], cache["krope"], cache["pos"]
        bias = _mask_bias(q_pos, kv_pos, None, True)       # [B,1,Sq,Sk]
        ckv = ckv.float()
        s_rope = torch.einsum("bshd,bkd->bhsk", q_rope.float(),
                              krope.float())
        if absorb:
            # fold W_kv_b(k) into q and W_kv_b(v) into the output
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                                 wk_b.float())
            s_nope = torch.einsum("bshr,bkr->bhsk", q_lat, ckv)
            probs = torch.softmax((s_nope + s_rope) * scale + bias, dim=-1)
            o_lat = torch.einsum("bhsk,bkr->bshr", probs, ckv)
            out = torch.einsum("bshr,rhv->bshv", o_lat, wv_b.float())
        else:
            kn = torch.einsum("bkr,rhn->bkhn", ckv, wk_b.float())
            vv = torch.einsum("bkr,rhv->bkhv", ckv, wv_b.float())
            s_nope = torch.einsum("bshn,bkhn->bhsk", q_nope.float(), kn)
            probs = torch.softmax((s_nope + s_rope) * scale + bias, dim=-1)
            out = torch.einsum("bhsk,bkhv->bshv", probs, vv)
        return hp.out(out.to(x.dtype), params["wo"]), cache
    if mode not in ("train", "prefill"):
        raise ValueError(f"attention mode {mode!r}: the port serves "
                         "'train', 'prefill', 'chunk' and 'decode'")

    # train / prefill: materialize k and v per token (q, k 192 wide, v 128)
    q_nope, q_rope = _mla_q(params, cfg, x, hp)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, krope = _mla_latents(params, cfg, x, positions)
    wk_b, wv_b = _wkv_b_split(params, cfg, hp)
    ckv_h, krope_h = hp.shared(ckv), hp.shared(krope)
    kn = torch.einsum("bkr,rhn->bkhn", ckv_h, wk_b)
    vv = torch.einsum("bkr,rhv->bkhv", ckv_h, wv_b)
    nh = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kn, krope_h[:, :, None, :].expand(
        b, s, nh, krope.shape[-1]).to(kn.dtype)], dim=-1)
    bias = _mask_bias(positions, positions, None, True)
    out = _sdpa(q, k, vv.to(q.dtype), bias, scale)
    if mode == "prefill":
        _write_seq(cache["ckv"], ckv, positions)
        _write_seq(cache["krope"], krope, positions)
        _write_seq(cache["pos"], positions, positions)
    else:
        cache = None
    return hp.out(out, params["wo"]), cache


def attention(params, cfg: ModelConfig, x, positions, **kw):
    """Dispatch on ``cfg.attention``; MLA takes the block table, the paged
    kernel switch, ``kernel_blocks`` and ``absorb``, and no other option
    (no flash_attention or flash_decode kernel runs on an MLA model)."""
    _check_attention(cfg)
    if cfg.attention == "mla":
        return mla_attention(params, cfg, x, positions, **kw)
    return gqa_attention(params, cfg, x, positions, **kw)
