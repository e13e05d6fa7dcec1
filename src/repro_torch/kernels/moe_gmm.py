"""Ragged grouped SwiGLU over the sorted, tile-aligned MoE buffer.

Kernel: ``csrc/moe_gmm.cu`` (replaces ``repro/kernels/moe_gmm.py::
moe_gmm_pallas``).  xs [M, D] (M = n_tiles * block_m) sorted by expert,
w1 [E, D, 2F] (gate = first F columns, up = next F), w2 [E, F, D],
tile_expert / tile_valid [n_tiles] int32 -> [M, D] in xs's dtype; tiles
with ``tile_valid == 0`` come out zero.  xs, w1 and w2 are all bf16 or all
f32, as the reference's kernel takes any float dtype.  On bf16 the kernel
reads its operands through TMA tensor maps (encoded per call for xs and h,
cached per weight tensor in the library) and runs wgmma on them; on f32 it
runs f32 FFMA on the CUDA cores, through the register-tiled row-tile body
of ``csrc/f32_sgemm.cuh`` that ``moe_gmm_quant`` and ``moe_ffn`` share,
and only on the rows each tile really holds: a count pass finds each
tile's last row that is not all zero (padding rows are zeros) into an
int32 scratch (``tile_rows`` is its plain version), the two passes compute
the rows up to it and write +0 past it, which is what a zero row's
products give; h is kept in f32 between the passes.

Quantized experts: ``csrc/moe_gmm_quant.cu`` (replaces ``moe_gmm_quant_
pallas``) computes the same on int8 w1q / w2q (int4: two values a byte,
blocked halves along D; ``models/moe/params.py``) with f32 scales s1
[E, 2, F] applied after the first product and s2 [E, F] folded into the
hidden before the second; xs, h and the output bf16 or f32, as the
reference's kernel takes any float xs.  On bf16 its weights travel
through TMA as int8 and are widened to bf16 in registers (tensor maps
cached per weight tensor and element type); on f32 it runs B1's f32 body
on the same counted rows, its weight stager copying the int8 / int4 bytes
into the ring and widening each to f32 once after it lands, h kept in
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, expect_quant, \
    float_dtype, no_grad_through, on_card
from repro_torch.models.moe.params import QUANT_DTYPES, unpack_int4


def moe_gmm_plain(xs, w1, w2, tile_expert, tile_valid, block_m: int):
    """The kernel's function in plain PyTorch: per-tile gathered weights,
    f32 products, ``h`` rounded to the input dtype before the down
    projection (as the kernel does), dead tiles zeroed."""
    m, d = xs.shape
    f = w2.shape[1]
    te = tile_expert.long()
    xt = xs.reshape(-1, block_m, d).float()
    hg = torch.bmm(xt, w1[te].float())                       # [n_tiles, bm, 2F]
    h = (F_.silu(hg[..., :f]) * hg[..., f:]).to(xs.dtype).float()
    yt = torch.bmm(h, w2[te].float())
    yt = torch.where(tile_valid.bool()[:, None, None], yt, 0.0)
    return yt.reshape(m, d).to(xs.dtype)


def tile_rows(xs, tile_valid, block_m: int) -> torch.Tensor:
    """The rows of each row tile that the f32 kernels compute: 1 + the
    tile's last row that is not all zero (a NaN is not zero), 0 for a dead
    tile; int32 [n_tiles], as their count pass finds them on the card."""
    nz = (xs.reshape(-1, block_m, xs.shape[-1]) != 0).any(-1)
    pos = torch.arange(1, block_m + 1, device=xs.device)
    last = torch.where(nz, pos, 0).amax(-1)
    return torch.where(tile_valid.bool(), last, 0).to(torch.int32)


def _rows_scratch(dt, n_tiles, device):
    """The f32 count pass's int32 [n_tiles, 8] scratch, a count for each
    16 rows of a tile (bf16: none, 0)."""
    if dt != torch.float32:
        return None, 0
    rows = torch.empty((n_tiles, 8), dtype=torch.int32, device=device)
    return rows, rows.data_ptr()


def moe_gmm(xs, w1, w2, tile_expert, tile_valid, *, block_m: int):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost."""
    no_grad_through("moe_gmm", xs, w1, w2)
    if not on_card("moe_gmm", xs, w1, w2, tile_expert, tile_valid):
        return moe_gmm_plain(xs, w1, w2, tile_expert, tile_valid, block_m)
    m, d = xs.shape
    e, f = w2.shape[0], w2.shape[1]
    dt = float_dtype("moe_gmm", xs=xs, w1=w1, w2=w2)
    expect("moe_gmm", xs, "xs", dt)
    expect("moe_gmm", w1, "w1", dt, (e, d, 2 * f))
    expect("moe_gmm", w2, "w2", dt, (e, f, d))
    if d % 64 or f % 32:
        raise ValueError(f"moe_gmm: D={d} must be a multiple of 64 and "
                         f"F={f} of 32")
    if block_m % 8 or not 8 <= block_m <= 128 or m % block_m:
        raise ValueError(f"moe_gmm: block_m={block_m} must be a multiple of "
                         f"8 in [8, 128] dividing M={m}")
    n_tiles = m // block_m
    expect("moe_gmm", tile_expert, "tile_expert", torch.int32, (n_tiles,))
    expect("moe_gmm", tile_valid, "tile_valid", torch.int32, (n_tiles,))
    h = torch.empty((m, f), dtype=dt, device=xs.device)
    out = torch.empty((m, d), dtype=dt, device=xs.device)
    for arg, t in (("xs", xs), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_gmm: {arg} needs a 16-byte aligned base")
    cost = costs.moe_gmm(xs, w2, tile_expert)
    if xs.is_meta:
        costs.report("moe_gmm", cost)
        return out
    rows, rows_ptr = _rows_scratch(dt, n_tiles, xs.device)
    fn = _build.function("moe_gmm", "moe_gmm_launch", 8, 6)
    err = fn(xs.data_ptr(), w1.data_ptr(), w2.data_ptr(),
             tile_expert.data_ptr(), tile_valid.data_ptr(), rows_ptr,
             h.data_ptr(), out.data_ptr(), m, d, f, block_m, e,
             int(dt == torch.float32),
             torch.cuda.current_stream(xs.device).cuda_stream)
    _build.check("moe_gmm", err)
    moe_gmm.launches += 1
    costs.report("moe_gmm", cost)
    return out


moe_gmm.launches = 0


def moe_gmm_quant_plain(xs, w1q, w2q, s1, s2, tile_expert, tile_valid,
                        block_m: int, *, dtype: str):
    """The quantized kernel's function in plain PyTorch: per-tile gathered
    int8 weights and scale rows, int4 unpacked, f32 products on the integer
    values; s1 after the first product, s2 folded into ``h``, which is
    rounded to the input dtype before the down product (as the kernel
    does); dead tiles zeroed."""
    m, d = xs.shape
    f = w2q.shape[1]
    te = tile_expert.long()

    def gathered(wq, axis):
        """The tiles' experts of ``wq`` (int4 unpacked along ``axis``) as
        f32, one weight at a time: at a model's full width a tile's copy
        of each expert is large."""
        w = wq[te]
        return (unpack_int4(w, axis) if dtype == "int4" else w).float()
    xt = xs.reshape(-1, block_m, d).float()
    hg = torch.bmm(xt, gathered(w1q, 1)).reshape(-1, block_m, 2, f) \
        * s1[te][:, None]                            # w1 [tiles, D, 2F]
    h = F_.silu(hg[:, :, 0]) * hg[:, :, 1] * s2[te][:, None]
    h = h.to(xs.dtype).float()
    yt = torch.bmm(h, gathered(w2q, 2))              # w2 [tiles, F, D]
    yt = torch.where(tile_valid.bool()[:, None, None], yt, 0.0)
    return yt.reshape(m, d).to(xs.dtype)


def moe_gmm_quant(xs, w1q, w2q, s1, s2, tile_expert, tile_valid, *,
                  dtype: str, block_m: int):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost."""
    no_grad_through("moe_gmm_quant", xs, s1, s2)
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"moe_gmm_quant: expert dtype {dtype!r} not in "
                         f"{QUANT_DTYPES}")
    args = (xs, w1q, w2q, s1, s2, tile_expert, tile_valid)
    if not on_card("moe_gmm_quant", *args):
        return moe_gmm_quant_plain(*args, block_m, dtype=dtype)
    m, d = xs.shape
    f = w2q.shape[1]
    dt = expect_quant("moe_gmm_quant", xs, w1q, w2q, s1, s2, dtype)
    if block_m % 8 or not 8 <= block_m <= 128 or m % block_m:
        raise ValueError(f"moe_gmm_quant: block_m={block_m} must be a "
                         f"multiple of 8 in [8, 128] dividing M={m}")
    n_tiles = m // block_m
    expect("moe_gmm_quant", tile_expert, "tile_expert", torch.int32,
           (n_tiles,))
    expect("moe_gmm_quant", tile_valid, "tile_valid", torch.int32,
           (n_tiles,))
    h = torch.empty((m, f), dtype=dt, device=xs.device)
    out = torch.empty((m, d), dtype=dt, device=xs.device)
    for arg, t in (("xs", xs), ("w1q", w1q), ("w2q", w2q)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_gmm_quant: {arg} needs a 16-byte aligned "
                             "base")
    cost = costs.moe_gmm(xs, w2q, tile_expert, dtype)
    if xs.is_meta:
        costs.report("moe_gmm_quant", cost)
        return out
    rows, rows_ptr = _rows_scratch(dt, n_tiles, xs.device)
    fn = _build.function("moe_gmm_quant", "moe_gmm_quant_launch", 10, 7)
    err = fn(*(t.data_ptr() for t in args), rows_ptr, h.data_ptr(),
             out.data_ptr(), m, d, f, block_m, w2q.shape[0],
             int(dtype == "int4"),
             int(dt == torch.float32),
             torch.cuda.current_stream(xs.device).cuda_stream)
    _build.check("moe_gmm_quant", err)
    moe_gmm_quant.launches += 1
    costs.report("moe_gmm_quant", cost)
    return out


moe_gmm_quant.launches = 0
