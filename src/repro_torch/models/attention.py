"""GQA attention (qk-norm, sliding window) over the contiguous or the paged
KV cache.

The two layouts, per layer, as in ``repro.models.attention``::

    contiguous  {"k": [B, S_buf, Hkv, hd], "v": [B, S_buf, Hkv, hd],
                 "pos": [B, S_buf]}
    paged       {"kp": [N, P, Hkv, hd], "vp": [N, P, Hkv, hd], "posp": [N, P]}

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
the paged cache: attend the pre-write cache plus the chunk, then commit
the chunk) and ``"decode"`` (one token per row).  Train and prefill run
the ``flash_attention`` kernel under ``use_flash``; decode attends the
pages in place through ``flash_decode_paged`` under ``use_paged_kernel``
(walking the first ``kernel_blocks`` table columns), else reads a
contiguous view -- the cache itself, or the pages gathered -- through the
``flash_decode`` kernel under ``use_flash_decode`` or the masked softmax.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation_dtype, apply_rope, \
    dense_init, param_dtype, rms_norm_headwise

NEG_INF = -1e30
TRASH_PAGE = 0  # reserved page unmapped block-table entries point at


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #


def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.attention!r} attention is not ported yet (ROADMAP.md A11)")
    dt = param_dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim_
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
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def _write_seq(buf: torch.Tensor, values: torch.Tensor,
               positions: torch.Tensor) -> None:
    """Scatter a [B, S, ...] sequence into a ring buffer at positions %
    S_buf, in place; only the last S_buf tokens when S > S_buf (ring
    semantics).  Positions < 0 write nothing, with no host sync: each one
    repeats its row's last valid write (the same value to the same slot,
    so the duplicate index is harmless), and a row with none writes its
    slot 0 back unchanged."""
    s_buf = buf.shape[1]
    if values.shape[1] > s_buf:
        values, positions = values[:, -s_buf:], positions[:, -s_buf:]
    b, s = positions.shape
    valid = positions >= 0
    j = torch.arange(s, device=buf.device).expand(b, s)
    last = torch.where(valid, j, -1).amax(dim=1, keepdim=True)   # [B, 1]
    src = torch.where(valid, j, last)                            # donor
    has = src >= 0
    src = src.clamp(min=0)
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    slot = torch.where(has, positions.gather(1, src).long() % s_buf, 0)
    keep = has.reshape(has.shape + (1,) * (values.dim() - 2))
    buf[bidx, slot] = torch.where(keep, values[bidx, src].to(buf.dtype),
                                  buf[bidx, slot])


def _write_step(buf: torch.Tensor, value: torch.Tensor,
                position: torch.Tensor) -> None:
    """Scatter one token per row: value [B, ...], position [B] (< 0: idle
    row, nothing written)."""
    _write_seq(buf, value[:, None], position[:, None])


# --------------------------------------------------------------------------- #
# Paged (block-table) cache
# --------------------------------------------------------------------------- #


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Dict:
    """Single-layer paged pool: ``num_pages`` pages of ``page_size`` slots."""
    dt = activation_dtype(cfg)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "kp": torch.zeros(shape, dtype=dt, device=device),
        "vp": torch.zeros(shape, dtype=dt, device=device),
        "posp": torch.full((num_pages, page_size), -1, dtype=torch.int32,
                           device=device),
    }


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


def _sdpa(q, k, v, bias, scale: float, compute_dtype: str = "f32"):
    """Grouped-query attention: q [B,Sq,Hq,d], k/v [B,Sk,Hkv,d]."""
    b, sq, hq, dq = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    # standard GQA head mapping: q head h uses kv head h // g (kv-major)
    qg = q.reshape(b, sq, hkv, g, dq)
    if compute_dtype == "bf16_accum32":
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(qg.dtype)).float()
    else:
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale + bias[:, None]              # [B,Hkv,g,Sq,Sk]
    probs = torch.softmax(scores, dim=-1)
    if compute_dtype == "bf16_accum32":
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v).float()
    else:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# GQA forward
# --------------------------------------------------------------------------- #


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
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,D]; positions [B,S] (train/prefill/chunk) or [B] (decode).

    Returns (output [B,S,D], the cache -- updated in place -- or None).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    scale = 1.0 / hd ** 0.5
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_norm"]["scale"])
        k = rms_norm_headwise(k, params["k_norm"]["scale"])

    if mode == "decode":
        pos_s = positions[:, None]                        # [B, 1]
        q = apply_rope(q, pos_s, cfg.rope_theta)
        k = apply_rope(k, pos_s, cfg.rope_theta)
        out = None
        if "kp" in cache:
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
                    q[:, 0], cache["kp"], cache["vp"], cache["posp"], bt,
                    positions.int(), window=cfg.sliding_window)[:, None]
            else:
                k_all = _paged_read(cache["kp"], block_tables)
                v_all = _paged_read(cache["vp"], block_tables)
                kv_pos = _paged_read(cache["posp"], block_tables)
        else:
            _write_step(cache["k"], k[:, 0], positions)
            _write_step(cache["v"], v[:, 0], positions)
            _write_step(cache["pos"], positions, positions)
            k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos"]
        if out is None and use_flash_decode:
            from repro_torch.kernels import flash_decode
            out = flash_decode(q[:, 0], k_all, v_all, kv_pos,
                               positions.int(),
                               window=cfg.sliding_window)[:, None]
        elif out is None:
            bias = _mask_bias(pos_s, kv_pos, cfg.sliding_window, True)
            out = _sdpa(q, k_all, v_all, bias, scale, compute_dtype)
    elif mode == "chunk":
        if "kp" not in cache:
            raise NotImplementedError(
                "chunked prefill on the contiguous cache is not ported yet "
                "(ROADMAP.md); use whole-prompt prefill (mode='prefill')")
        # attend against the PRE-write cache plus the in-chunk keys, then
        # commit the chunk (the reference's order: right under a
        # sliding-window ring, and exact against whole-prompt prefill)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_old = _paged_read(cache["kp"], block_tables)
        v_old = _paged_read(cache["vp"], block_tables)
        pos_old = _paged_read(cache["posp"], block_tables)
        k_all = torch.cat([k_old, k.to(k_old.dtype)], dim=1)
        v_all = torch.cat([v_old, v.to(v_old.dtype)], dim=1)
        kv_pos = torch.cat([pos_old, positions.to(pos_old.dtype)], dim=1)
        bias = _mask_bias(positions, kv_pos, cfg.sliding_window, True)
        out = _sdpa(q, k_all, v_all, bias, scale, compute_dtype)
        _paged_write(cache["kp"], k, positions, block_tables)
        _paged_write(cache["vp"], v, positions, block_tables)
        _paged_write(cache["posp"], positions, positions, block_tables)
    elif mode in ("train", "prefill"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if use_flash:
            # masks by index, as the reference kernel: positions must be
            # 0..S-1 in every row (no pads).  The kernel reads the [B,S,H,hd]
            # activations through their strides and writes its output in
            # q's layout, so neither transpose copies
            from repro_torch.kernels import flash_attention
            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=cfg.sliding_window).transpose(1, 2)
        else:
            bias = _mask_bias(positions, positions, cfg.sliding_window, True)
            out = _sdpa(q, k, v, bias, scale, compute_dtype)
        if mode == "prefill":
            _write_seq(cache["k"], k, positions)
            _write_seq(cache["v"], v, positions)
            _write_seq(cache["pos"], positions, positions)
        else:
            cache = None
    else:
        raise ValueError(f"attention mode {mode!r}: the port serves "
                         "'train', 'prefill', 'chunk' and 'decode'")
    out = out.reshape(b, s, cfg.num_heads * hd) @ params["wo"]
    return out, cache


def attention(params, cfg: ModelConfig, x, positions, **kw):
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.attention!r} attention is not ported yet (ROADMAP.md A11)")
    return gqa_attention(params, cfg, x, positions, **kw)
