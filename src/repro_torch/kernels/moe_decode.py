"""Fused routed-expert SwiGLU for decode-shaped MoE batches.

Kernel: ``csrc/moe_decode.cu`` (replaces ``repro/kernels/moe_decode.py::
moe_decode_pallas``).  x [B, D], w1 [E, D, 2F], w2 [E, F, D], idx [B, k]
int32, weights [B, k] f32 -> y [B, D]: y[b] = sum_j weights[b, j] *
SwiGLU(x[b]; expert idx[b, j]) in f32, only the routed experts read, each
once a call: the kernel groups the slots of an expert on the device, inside
the launch (no host sync), and combines the slots' f32 partials in slot
order, so a row's output is bitwise the same alone or in a batch.

Quantized experts: ``csrc/moe_decode_quant.cu`` (replaces ``moe_decode_
quant_pallas``) computes the same on int8 w1q / w2q (int4: two values a
byte, blocked halves along D; ``models/moe/params.py``) with f32 scales
s1 [E, 2, F] applied after the first product and s2 [E, F] folded into
the hidden before the second; it groups the slots of an expert as the
bf16 kernel does, so each routed expert is read once a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, expect_quant, on_card
from repro_torch.models.moe.params import QUANT_DTYPES, unpack_int4


def _gather(w, idx, pred_idx=None):
    """w [E, ...] at ids idx [B, k] -> [B, k, ...].

    With a router-lookahead hint ``pred_idx`` [B, k] (ids predicted one
    layer ahead from the previous layer's pre-FFN hidden), a staged gather
    on the prediction is hit-selected against a fresh gather on the true
    ids: where ``pred == idx`` the select returns the staged block, bitwise
    the fresh one, so the result is exactly the plain gather whatever the
    hit rate (numerically a no-op)."""
    fresh = w[idx.long()]
    if pred_idx is None:
        return fresh
    staged = w[pred_idx.long()]
    hit = (pred_idx == idx).reshape(idx.shape + (1,) * (w.ndim - 1))
    return torch.where(hit, staged, fresh)


def moe_decode_plain(x, w1, w2, idx, weights, pred_idx=None):
    """The kernel's function in plain PyTorch: gather the k routed experts'
    weights per token and contract in f32.  ``pred_idx`` (router lookahead)
    stages the gathers on the predicted ids (``_gather``)."""
    f = w2.shape[1]
    hg = torch.einsum("bd,bkdf->bkf", x.float(),
                      _gather(w1, idx, pred_idx).float())
    h = F_.silu(hg[..., :f]) * hg[..., f:]                   # [B, k, F]
    y = torch.einsum("bkf,bkfd,bk->bd", h,
                     _gather(w2, idx, pred_idx).float(), weights.float())
    return y.to(x.dtype)


def moe_decode(x, w1, w2, idx, weights, pred_idx=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors.
    The kernel ignores ``pred_idx``, as the reference's kernel path does:
    it reads each routed expert by the true ids."""
    if not on_card("moe_decode", x, w1, w2, idx, weights):
        return moe_decode_plain(x, w1, w2, idx, weights, pred_idx)
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    k = idx.shape[1]
    bf16 = torch.bfloat16
    expect("moe_decode", x, "x", bf16)
    expect("moe_decode", w1, "w1", bf16, (e, d, 2 * f))
    expect("moe_decode", w2, "w2", bf16, (e, f, d))
    expect("moe_decode", idx, "idx", torch.int32, (b, k))
    expect("moe_decode", weights, "weights", torch.float32, (b, k))
    if d % 64:
        raise ValueError(f"moe_decode: D={d} must be a multiple of 64")
    if f % 32:
        raise ValueError(f"moe_decode: F={f} must be a multiple of 32")
    for arg, t in (("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_decode: {arg} needs a 16-byte aligned base")
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty((b, d), dtype=bf16, device=x.device)
    fn = _build.function("moe_decode", "moe_decode_launch", 8, 5)
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), idx.data_ptr(),
             weights.data_ptr(), h.data_ptr(), partial.data_ptr(),
             y.data_ptr(), b, d, f, k, e,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_decode", err)
    moe_decode.launches += 1
    return y


moe_decode.launches = 0


def moe_decode_quant_plain(x, w1q, w2q, s1, s2, idx, weights, *, dtype: str,
                           pred_idx=None):
    """The quantized kernel's function in plain PyTorch (the reference's
    ``moe_decode_routed_quant_jnp``): gather the routed experts' int8
    weights and scale rows (staged on ``pred_idx`` when given), dequantize
    where the kernel does -- s1 after the first product, s2 folded into
    ``h`` -- and contract in f32."""
    b = x.shape[0]
    f = w2q.shape[1]
    # [B, k, D(p), 2F], [B, k, F, D(p)] int8; [B, k, 2, F], [B, k, F] f32
    w1g, w2g, s1g, s2g = (_gather(w, idx, pred_idx)
                          for w in (w1q, w2q, s1, s2))
    if dtype == "int4":
        w1g, w2g = unpack_int4(w1g, 2), unpack_int4(w2g, 3)
    hg = torch.einsum("bd,bkdf->bkf", x.float(), w1g.float())
    hg = hg.reshape(b, -1, 2, f) * s1g                        # [B, k, 2, F]
    h = F_.silu(hg[:, :, 0]) * hg[:, :, 1] * s2g              # [B, k, F]
    y = torch.einsum("bkf,bkfd,bk->bd", h, w2g.float(), weights.float())
    return y.to(x.dtype)


def moe_decode_quant(x, w1q, w2q, s1, s2, idx, weights, pred_idx=None, *,
                     dtype: str):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors,
    which ignores ``pred_idx`` as ``moe_decode`` does."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"moe_decode_quant: expert dtype {dtype!r} not in "
                         f"{QUANT_DTYPES}")
    args = (x, w1q, w2q, s1, s2, idx, weights)
    if not on_card("moe_decode_quant", *args):
        return moe_decode_quant_plain(*args, dtype=dtype, pred_idx=pred_idx)
    b, d = x.shape
    f = w2q.shape[1]
    k = idx.shape[1]
    expect_quant("moe_decode_quant", x, w1q, w2q, s1, s2, dtype)
    expect("moe_decode_quant", idx, "idx", torch.int32, (b, k))
    expect("moe_decode_quant", weights, "weights", torch.float32, (b, k))
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty((b, d), dtype=torch.bfloat16, device=x.device)
    fn = _build.function("moe_decode_quant", "moe_decode_quant_launch", 10, 6)
    err = fn(*(t.data_ptr() for t in args), h.data_ptr(), partial.data_ptr(),
             y.data_ptr(), b, d, f, k, w2q.shape[0], int(dtype == "int4"),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_decode_quant", err)
    moe_decode_quant.launches += 1
    return y


moe_decode_quant.launches = 0
