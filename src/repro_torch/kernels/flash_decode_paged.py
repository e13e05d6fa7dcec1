"""Paged GQA decode attention over the block table.

Kernel: ``csrc/flash_decode_paged.cu`` (replaces ``repro/kernels/
flash_decode_paged.py::flash_decode_paged_pallas``).  q [B, Hq, hd];
kp / vp [N, P, Hkv, hd]; posp [N, P] int32; block_tables [B, n_blk] int32
(may be a column slice ``table[:, :n_live]`` of the full table); cur_pos
[B] int32 -> [B, Hq, hd].  A slot counts iff ``0 <= posp <= cur_pos``
(and ``posp > cur_pos - window`` with a window); trash-page entries count
for nothing.  A query with no valid slot gets zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_card
from repro_torch.kernels.flash_decode import flash_decode_plain


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
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if not on_card("flash_decode_paged", q, kp, vp, posp, block_tables,
                   cur_pos):
        return flash_decode_paged_plain(q, kp, vp, posp, block_tables,
                                        cur_pos, window=window)
    name = "flash_decode_paged"
    b, hq, hd = q.shape
    n, p, hkv = kp.shape[0], kp.shape[1], kp.shape[2]
    n_blk = block_tables.shape[1]
    bf16 = torch.bfloat16
    expect(name, q, "q", bf16)
    expect(name, kp, "kp", bf16, (n, p, hkv, hd))
    expect(name, vp, "vp", bf16, (n, p, hkv, hd))
    expect(name, posp, "posp", torch.int32, (n, p))
    expect(name, cur_pos, "cur_pos", torch.int32, (b,))
    g = hq // hkv if hq % hkv == 0 else 0
    if g not in (1, 2, 4, 8) or hd % 32 or hd // 32 not in (1, 2, 4, 8) \
            or g * (hd // 32) > 16:
        raise ValueError(f"{name}: no kernel for Hq={hq}, Hkv={hkv}, hd={hd} "
                         "(needs Hq/Hkv in 1,2,4,8, hd in 32..256, "
                         "Hq/Hkv * hd/32 <= 16)")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be int32 [B, n_blk] "
                         "with unit column stride")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window={window} must be positive")
    out = torch.empty((b, hq, hd), dtype=bf16, device=q.device)
    fn = _build.function(name, "flash_decode_paged_launch", 7, 8)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), posp.data_ptr(),
             block_tables.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
             b, hq, hkv, hd, p, n_blk, block_tables.stride(0),
             window or 0, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, err)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
