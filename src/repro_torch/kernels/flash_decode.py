"""One-token GQA decode attention over a contiguous, position-masked cache.

Kernel: ``csrc/flash_decode.cu`` (replaces ``repro/kernels/flash_decode.py::
flash_decode_pallas``).  q [B, Hq, hd]; k / v [B, S, Hkv, hd]; pos [B, S]
int32 (-1 = empty slot); cur_pos [B] int32 -> [B, Hq, hd] in q's dtype
(q, k and v all bf16 or all f32; f32 at hd in ``F32_HEAD_DIMS``).  A
slot counts iff ``0 <= pos <= cur_pos`` (and ``pos > cur_pos - window``
with a window).  A query with no valid slot gets zeros (the TPU kernel
returns the mean of V there; the row is never read).

Any head group runs (``csrc/flash_decode_common.cuh::fd_block_group``: a
group too large for one block, g 16 or 8 at hd 128, is split into
sub-groups along the grid, each re-reading its kv head's K / V from the
L2); hd is one of ``HEAD_DIMS`` (80 computed padded to 128).  The kernel
splits a row's slots into chunks of ``CHUNK_SLOTS`` and merges
them inside the one launch in chunk order (the block body it shares with
``flash_decode_paged``), so a row's output is bitwise the same whatever
the batch around it.  On the H100 it is bound by the bytes of K and V:
16.5 MB at chip_smoke's check (8 rows, 2012 live positions, 16 kv heads
of 128), 0.0049 ms.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, float_dtype, \
    no_grad_through, on_card

NEG_INF = -1e30
#: head sizes with a kernel instantiation (80 is computed padded to 128);
#: any head group runs (a group too large for one block is split over the
#: grid: ``csrc/flash_decode_common.cuh::fd_block_group``)
HEAD_DIMS = (32, 64, 80, 128, 256)
#: the head sizes of the f32 instantiations (a tile of f32 K and V rows at
#: 256 would overflow a block's static shared memory)
F32_HEAD_DIMS = (32, 64, 80, 128)


def head_dims(dtype: torch.dtype):
    """The head sizes B4's and B8's kernels take in ``dtype``."""
    return F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS


#: slots a chunk takes (``CHUNK_SLOTS`` in the kernel source); a row walks
#: its first max(1, ceil(n / CHUNK_SLOTS)) chunks, n following from its
#: cur_pos and S alone
CHUNK_SLOTS = 32


def n_chunks(s: int) -> int:
    """Chunks in the kernel's grid for a cache of ``s`` slots: chunk c
    holds slots [c * CHUNK_SLOTS, (c + 1) * CHUNK_SLOTS)."""
    return -(-s // CHUNK_SLOTS)


#: per (device, stream): the split decode kernels' arrival counters, one
#: int32 per (batch row, block group of query heads: at most Hq), zero
#: between calls (the last block of
#: each row and head resets its own), so no call pays a launch to clear
#: them; flash_decode and flash_decode_paged share them, since kernels on
#: one stream run one after another
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


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


def head_slice_stride(name: str, k: torch.Tensor, v: torch.Tensor) -> int:
    """The kv heads a slot holds in memory for k / v ``[.., slots, Hkv,
    hd]``: contiguous, or a head slice of a contiguous cache of more heads
    (a tensor-parallel rank's heads of a whole cache, ``models/
    attention.py``), with k and v alike."""
    hkv, hd = k.shape[-2:]
    st = k.stride()
    kv_stride = st[-3] // hd if hd else 0
    ok = (st[-1] == 1 and st[-2] == hd and st[-3] == kv_stride * hd
          and kv_stride >= hkv and k.stride() == v.stride()
          and all(st[i] == st[i + 1] * k.shape[i + 1]
                  for i in range(k.dim() - 3)))
    if not ok:
        raise ValueError(f"{name}: k / v must be contiguous or a head slice "
                         f"of a contiguous cache, alike; got strides "
                         f"{k.stride()} and {v.stride()} for "
                         f"{tuple(k.shape)}")
    return kv_stride


def flash_decode(q, k, v, pos, cur_pos, *, window: Optional[int] = None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost.
    k / v may be a head slice of a contiguous cache (``head_slice_stride``:
    a tensor-parallel rank's kv heads of a cache that holds all)."""
    name = "flash_decode"
    no_grad_through(name, q, k, v)
    if not on_card(name, q, k, v, pos, cur_pos):
        return flash_decode_plain(q, k, v, pos, cur_pos, window=window)
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dt = float_dtype(name, q=q, k=k, v=v)
    expect(name, q, "q", dt)
    expect(name, k, "k", dt, (b, s, hkv, hd), strided=True)
    expect(name, v, "v", dt, (b, s, hkv, hd), strided=True)
    kv_stride = head_slice_stride(name, k, v)
    expect(name, pos, "pos", torch.int32, (b, s))
    expect(name, cur_pos, "cur_pos", torch.int32, (b,))
    g = hq // hkv if hkv and hq % hkv == 0 else 0
    if g == 0 or hd not in head_dims(dt) or s == 0:
        raise ValueError(f"{name}: no kernel for Hq={hq}, Hkv={hkv}, hd={hd}, "
                         f"S={s} (needs Hkv dividing Hq, hd in "
                         f"{head_dims(dt)} for {dt}, S > 0)")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window={window} must be positive")
    for arg, t in (("k", k), ("v", v)):          # 16-byte async copies
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a 16-byte aligned base")
    out = torch.empty((b, hq, hd), dtype=dt, device=q.device)
    nc = n_chunks(s)
    # scratch for rows that span several chunks: each chunk's acc
    # [B, Hkv, nc, G, hd], then its (max, sum) [.., G, 2]
    part = torch.empty(b * hkv * nc * g * (hd + 2), dtype=torch.float32,
                       device=q.device)
    cost = costs.flash_decode(q, k, v, pos, cur_pos)
    if q.is_meta:
        costs.report(name, cost)
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, b * hq)
    fn = _build.function(name, "flash_decode_launch", 8, 9)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             cur_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
             counters.data_ptr(), b, hq, hkv, hd, s, window or 0, nc,
             kv_stride, int(dt == torch.float32), stream)
    _build.check(name, err)
    flash_decode.launches += 1
    costs.report(name, cost)
    return out


flash_decode.launches = 0
