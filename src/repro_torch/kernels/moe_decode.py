"""Fused routed-expert SwiGLU for decode-shaped MoE batches.

Kernel: ``csrc/moe_decode.cu`` (replaces ``repro/kernels/moe_decode.py::
moe_decode_pallas``).  x [B, D], w1 [E, D, 2F], w2 [E, F, D], idx [B, k]
int32, weights [B, k] f32 -> y [B, D]: y[b] = sum_j weights[b, j] *
SwiGLU(x[b]; expert idx[b, j]) in f32, only the routed experts read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_card


def moe_decode_plain(x, w1, w2, idx, weights):
    """The kernel's function in plain PyTorch: gather the k routed experts'
    weights per token and contract in f32."""
    f = w2.shape[1]
    ix = idx.long()
    hg = torch.einsum("bd,bkdf->bkf", x.float(), w1[ix].float())
    h = F_.silu(hg[..., :f]) * hg[..., f:]                   # [B, k, F]
    y = torch.einsum("bkf,bkfd,bk->bd", h, w2[ix].float(), weights.float())
    return y.to(x.dtype)


def moe_decode(x, w1, w2, idx, weights):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if not on_card("moe_decode", x, w1, w2, idx, weights):
        return moe_decode_plain(x, w1, w2, idx, weights)
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    k = idx.shape[1]
    bf16 = torch.bfloat16
    expect("moe_decode", x, "x", bf16)
    expect("moe_decode", w1, "w1", bf16, (e, d, 2 * f))
    expect("moe_decode", w2, "w2", bf16, (e, f, d))
    expect("moe_decode", idx, "idx", torch.int32, (b, k))
    expect("moe_decode", weights, "weights", torch.float32, (b, k))
    if d % 64 or f % 64:
        raise ValueError(f"moe_decode: D={d} and F={f} must be multiples of 64")
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    y = torch.empty((b, d), dtype=bf16, device=x.device)
    fn = _build.function("moe_decode", "moe_decode_launch", 7, 4)
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), idx.data_ptr(),
             weights.data_ptr(), h.data_ptr(), y.data_ptr(), b, d, f, k,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_decode", err)
    moe_decode.launches += 1
    return y


moe_decode.launches = 0
