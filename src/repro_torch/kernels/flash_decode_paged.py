"""Paged decode attention over the block table: GQA, and MLA's
weight-absorbed latent decode (``flash_decode_paged_mla``, below).

Kernel: ``csrc/flash_decode_paged.cu`` (replaces ``repro/kernels/
flash_decode_paged.py::flash_decode_paged_pallas``).  q [B, Hq, hd];
kp / vp [N, P, Hkv, hd]; posp [N, P] int32; block_tables [B, n_blk] int32
(may be a column slice ``table[:, :n_live]`` of the full table); cur_pos
[B] int32 -> [B, Hq, hd] in q's dtype (q, kp and vp all bf16 or all f32).
A slot counts iff ``0 <= posp <= cur_pos`` (and ``posp > cur_pos -
window`` with a window); trash-page entries count for nothing.  A query
with no valid slot gets zeros.

Both kernels split a row's table columns by constants -- GQA into chunks
of ``CHUNK_PAGES`` columns, MLA over a cluster of 8 blocks at that rank
stride -- and merge the pieces in a fixed order inside the one launch, so a
row's output is bitwise the same whatever the batch around it and whatever
the table view's width.  The GQA kernel takes any head group and hd in
``HEAD_DIMS`` (f32: ``F32_HEAD_DIMS``; as ``flash_decode``); the MLA
kernel bf16 or f32 latents, any head count, in head tiles along its grid
(16 heads on bf16 latents; on f32 the tile of ``mla_f32_launch_shape``),
at the (r, dr) of ``MLA_SHAPES`` for the latents' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, float_dtype, \
    no_grad_through, on_card
from repro_torch.kernels.flash_decode import NEG_INF, _counters, \
    flash_decode_plain, head_dims, head_slice_stride


#: table columns a GQA chunk takes (``CHUNK_PAGES`` in the kernel source);
#: a row's split depends on this constant alone, never on B or n_blk
CHUNK_PAGES = 2


def n_chunks(n_blk: int) -> int:
    """Chunks in the GQA kernel's grid for a table of ``n_blk`` columns:
    chunk c holds columns [c * CHUNK_PAGES, (c + 1) * CHUNK_PAGES); at least
    one, so an empty table still writes its zeros."""
    return max(1, -(-n_blk // CHUNK_PAGES))


def flash_decode_paged_plain(q, kp, vp, posp, block_tables, cur_pos, *,
                             window: Optional[int] = None):
    """The kernel's function in plain PyTorch: gather the walked pages into
    a contiguous view, then the contiguous-cache plain version."""
    b, n_blk = block_tables.shape
    bt = block_tables.long()
    k = kp[bt].reshape(b, n_blk * kp.shape[1], *kp.shape[2:])
    v = vp[bt].reshape(b, n_blk * vp.shape[1], *vp.shape[2:])
    pos = posp[bt].reshape(b, -1)
    return flash_decode_plain(q, k, v, pos, cur_pos, window=window)


def flash_decode_paged(q, kp, vp, posp, block_tables, cur_pos, *,
                       window: Optional[int] = None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost.
    kp / vp may be a head slice of a contiguous pool (``flash_decode.
    head_slice_stride``)."""
    no_grad_through("flash_decode_paged", q, kp, vp)
    if not on_card("flash_decode_paged", q, kp, vp, posp, block_tables,
                   cur_pos):
        return flash_decode_paged_plain(q, kp, vp, posp, block_tables,
                                        cur_pos, window=window)
    name = "flash_decode_paged"
    b, hq, hd = q.shape
    n, p, hkv = kp.shape[0], kp.shape[1], kp.shape[2]
    n_blk = block_tables.shape[1]
    dt = float_dtype(name, q=q, kp=kp, vp=vp)
    expect(name, q, "q", dt)
    expect(name, kp, "kp", dt, (n, p, hkv, hd), strided=True)
    expect(name, vp, "vp", dt, (n, p, hkv, hd), strided=True)
    kv_stride = head_slice_stride(name, kp, vp)
    expect(name, posp, "posp", torch.int32, (n, p))
    expect(name, cur_pos, "cur_pos", torch.int32, (b,))
    g = hq // hkv if hkv and hq % hkv == 0 else 0
    if g == 0 or hd not in head_dims(dt):
        raise ValueError(f"{name}: no kernel for Hq={hq}, Hkv={hkv}, hd={hd} "
                         f"(needs Hkv dividing Hq, hd in {head_dims(dt)} "
                         f"for {dt})")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be int32 [B, n_blk] "
                         "with unit column stride")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window={window} must be positive")
    for arg, t in (("kp", kp), ("vp", vp)):      # 16-byte async copies
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a 16-byte aligned base")
    out = torch.empty((b, hq, hd), dtype=dt, device=q.device)
    nc = n_chunks(n_blk)
    # scratch for rows that span several chunks: each chunk's acc
    # [B, Hkv, nc, G, hd], then its (max, sum) [.., G, 2]
    part = torch.empty(b * hkv * nc * g * (hd + 2), dtype=torch.float32,
                       device=q.device)
    cost = costs.flash_decode_paged(q, kp, block_tables, cur_pos)
    if q.is_meta:
        costs.report(name, cost)
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, b * hq)
    fn = _build.function(name, "flash_decode_paged_launch", 9, 11)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), posp.data_ptr(),
             block_tables.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
             part.data_ptr(), counters.data_ptr(), b, hq, hkv, hd, p, n_blk,
             block_tables.stride(0), window or 0, nc, kv_stride,
             int(dt == torch.float32), stream)
    _build.check(name, err)
    flash_decode_paged.launches += 1
    costs.report(name, cost)
    return out


flash_decode_paged.launches = 0


# --------------------------------------------------------------------------- #
# MLA: weight-absorbed latent decode
# --------------------------------------------------------------------------- #

#: (latent width r, rope width dr) pairs with an MLA kernel instantiation,
#: by the latents' dtype: DeepSeek-V2-Lite's and MiniCPM3-4B's in both, and
#: on f32 latents the reduced DeepSeek config's (32, 16); any head count
#: (in head tiles)
MLA_SHAPES = {torch.bfloat16: ((512, 64), (256, 32)),
              torch.float32: ((512, 64), (256, 32), (32, 16))}


def flash_decode_paged_mla_plain(q_lat, q_rope, ckvp, kropep, posp,
                                 block_tables, cur_pos, *, scale: float):
    """The kernel's function in plain PyTorch (the gather form of the
    reference's ``flash_decode_paged_mla_ref``); rows with no valid slot
    are zero."""
    b = block_tables.shape[0]
    bt = block_tables.long()
    ckv = ckvp[bt].reshape(b, -1, ckvp.shape[-1]).float()
    kr = kropep[bt].reshape(b, -1, kropep.shape[-1]).float()
    pos = posp[bt].reshape(b, -1)
    s = (torch.einsum("bhr,bkr->bhk", q_lat.float(), ckv)
         + torch.einsum("bhd,bkd->bhk", q_rope.float(), kr)) * scale
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1) * valid.any(-1)[:, None, None]
    return torch.einsum("bhk,bkr->bhr", probs, ckv)


def flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp, block_tables,
                           cur_pos, *, scale: float):
    """Weight-absorbed MLA decode over the latent pages: q_lat [B, H, r]
    f32 (q_nope through W_kv_b(k)); q_rope [B, H, dr] f32; ckvp [N, P, r]
    and kropep [N, P, dr] both bf16 or both f32 (the reference casts its
    latents to f32; a mix raises); posp [N, P] int32; block_tables
    [B, n_blk] int32 (may be a column slice of the full table); cur_pos [B]
    int32 -> the latent output [B, H, r] f32 (the caller folds W_kv_b(v)
    in).  ``scale`` is the model's 1/sqrt(dn + dr).  Replaces
    ``repro/kernels/flash_decode_paged.py::flash_decode_paged_mla_pallas``
    (kernel: ``csrc/flash_decode_paged_mla.cu``).  Plain version for CPU
    tensors; the CUDA kernel for CUDA tensors; on ``meta`` the checks, an
    empty output and the launch's cost."""
    name = "flash_decode_paged_mla"
    no_grad_through(name, q_lat, q_rope, ckvp, kropep)
    if not on_card(name, q_lat, q_rope, ckvp, kropep, posp, block_tables,
                   cur_pos):
        return flash_decode_paged_mla_plain(q_lat, q_rope, ckvp, kropep,
                                            posp, block_tables, cur_pos,
                                            scale=scale)
    b, h, r = q_lat.shape
    n, p, dr = kropep.shape
    n_blk = block_tables.shape[1]
    f32 = torch.float32
    lat = float_dtype(name, ckvp=ckvp, kropep=kropep)
    expect(name, q_lat, "q_lat", f32)
    expect(name, q_rope, "q_rope", f32, (b, h, dr))
    expect(name, ckvp, "ckvp", lat, (n, p, r))
    expect(name, kropep, "kropep", lat, (n, p, dr))
    expect(name, posp, "posp", torch.int32, (n, p))
    expect(name, cur_pos, "cur_pos", torch.int32, (b,))
    shapes = MLA_SHAPES[lat]
    if (r, dr) not in shapes or h < 1 or not 1 <= b <= 65535:
        raise ValueError(f"{name}: no kernel for B={b}, H={h}, r={r}, "
                         f"dr={dr} on {lat} latents (needs (r, dr) in "
                         f"{shapes}, H >= 1, 0 < B <= 65535)")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be int32 [B, n_blk] "
                         "with unit column stride")
    for arg, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckvp", ckvp),
                   ("kropep", kropep)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a 16-byte aligned base")
    out = torch.empty((b, h, r), dtype=f32, device=q_lat.device)
    cost = costs.flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep,
                                        block_tables, cur_pos)
    if q_lat.is_meta:
        costs.report(name, cost)
        return out
    fn = _build.function(name, "flash_decode_paged_mla_launch", 8, 8, 1)
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckvp.data_ptr(),
             kropep.data_ptr(), posp.data_ptr(), block_tables.data_ptr(),
             cur_pos.data_ptr(), out.data_ptr(), b, h, r, dr, p, n_blk,
             block_tables.stride(0), int(lat == f32), scale,
             torch.cuda.current_stream(q_lat.device).cuda_stream)
    _build.check(name, err)
    flash_decode_paged_mla.launches += 1
    costs.report(name, cost)
    return out


flash_decode_paged_mla.launches = 0


#: the fields of ``mla_f32_launch_shape``, in the kernel's order
MLA_F32_SHAPE_FIELDS = ("head_tile", "blocks", "stages", "smem_bytes",
                        "blocks_an_sm", "score_threads", "pv_threads",
                        "max_active_clusters")


def mla_f32_launch_shape(b: int, h: int, r: int, dr: int,
                         n_blk: int) -> dict:
    """The f32 MLA kernel's launch at B rows, H heads, (r, dr) and a table
    view of n_blk columns, as the built kernel sets it: heads a block (its
    head tile), blocks, ring stages, shared memory a block, the blocks an
    SM its launch bound asks for, score and P.V threads, and the clusters
    of 8 blocks the card keeps resident at once (-1 where the query
    fails).  Needs the CUDA build (the GPU machine)."""
    out = torch.zeros(len(MLA_F32_SHAPE_FIELDS), dtype=torch.int32)
    fn = _build.function("flash_decode_paged_mla",
                         "flash_decode_paged_mla_f32_shape", 1, 5)
    _build.check("flash_decode_paged_mla_f32_shape",
                 fn(out.data_ptr(), b, h, r, dr, n_blk, None))
    return dict(zip(MLA_F32_SHAPE_FIELDS, out.tolist()))
