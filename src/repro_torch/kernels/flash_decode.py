"""One-token GQA decode attention over a contiguous, position-masked cache.

Kernel: ``csrc/flash_decode.cu`` (replaces ``repro/kernels/flash_decode.py::
flash_decode_pallas``).  q [B, Hq, hd]; k / v [B, S, Hkv, hd]; pos [B, S]
int32 (-1 = empty slot); cur_pos [B] int32 -> [B, Hq, hd].  A slot counts
iff ``0 <= pos <= cur_pos`` (and ``pos > cur_pos - window`` with a
window).  A query with no valid slot gets zeros (the TPU kernel returns
the mean of V there; the row is never read).  On the H100 it is bound by
the bytes of K and V: 33.6 MB at B 8, 16 kv heads, hd 128 and 512 live
slots, 0.010 ms.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_card

NEG_INF = -1e30


def flash_decode_plain(q, k, v, pos, cur_pos, *,
                       window: Optional[int] = None):
    """The kernel's function in plain PyTorch: mask by position, softmax in
    f32; rows with no valid slot are zero."""
    b, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / hd ** 0.5
    cur = cur_pos[:, None]
    valid = (pos >= 0) & (pos <= cur)
    if window is not None:
        valid &= pos > cur - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1) * valid.any(-1)[:, None, None, None]
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v.float())
    return out.reshape(b, hq, hd).to(q.dtype)


def flash_decode(q, k, v, pos, cur_pos, *, window: Optional[int] = None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    name = "flash_decode"
    if not on_card(name, q, k, v, pos, cur_pos):
        return flash_decode_plain(q, k, v, pos, cur_pos, window=window)
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    bf16 = torch.bfloat16
    expect(name, q, "q", bf16)
    expect(name, k, "k", bf16, (b, s, hkv, hd))
    expect(name, v, "v", bf16, (b, s, hkv, hd))
    expect(name, pos, "pos", torch.int32, (b, s))
    expect(name, cur_pos, "cur_pos", torch.int32, (b,))
    g = hq // hkv if hkv and hq % hkv == 0 else 0
    if g not in (1, 2, 4, 8) or hd % 32 or hd // 32 not in (1, 2, 4, 8) \
            or g * (hd // 32) > 16 or s == 0:
        raise ValueError(f"{name}: no kernel for Hq={hq}, Hkv={hkv}, hd={hd}, "
                         f"S={s} (needs Hq/Hkv in 1,2,4,8, hd in 32..256, "
                         "Hq/Hkv * hd/32 <= 16, S > 0)")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window={window} must be positive")
    out = torch.empty((b, hq, hd), dtype=bf16, device=q.device)
    fn = _build.function(name, "flash_decode_launch", 6, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             cur_pos.data_ptr(), out.data_ptr(), b, hq, hkv, hd, s,
             window or 0, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
