"""Fused routed-expert SwiGLU for decode-shaped MoE batches.

Kernel: ``csrc/moe_decode.cu`` (replaces ``repro/kernels/moe_decode.py::
moe_decode_pallas``).  x [B, D], w1 [E, D, 2F], w2 [E, F, D], idx [B, k]
int32, weights [B, k] f32 -> y [B, D] in x's dtype (x, w1 and w2 all bf16
or all f32): y[b] = sum_j weights[b, j] *
SwiGLU(x[b]; expert idx[b, j]) in f32, only the routed experts read, each
once a call: the kernel groups the slots of an expert on the device, inside
the launch (no host sync), and combines the slots' f32 partials in slot
order, so a row's output is bitwise the same alone or in a batch.

Quantized experts: ``csrc/moe_decode_quant.cu`` (replaces ``moe_decode_
quant_pallas``) computes the same on int8 w1q / w2q (int4: two values a
byte, blocked halves along D; ``models/moe/params.py``), x and y bf16 or
f32 as the reference's kernel takes any float x, with f32 scales
s1 [E, 2, F] applied after the first product and s2 [E, F] folded into
the hidden before the second; it groups the slots of an expert as the
bf16 kernel does, so each routed expert is read once a call, and stages
its second pass's hidden rows 4096 at a time, so F may be any multiple
of 32 (``quant_smem``: the wrapper refuses, before any launch, a shape
whose shared memory a block could not have).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, expect_quant, \
    float_dtype, no_grad_through, on_card
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
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost.  The
    kernel ignores ``pred_idx``, as the reference's kernel path does:
    it reads each routed expert by the true ids."""
    no_grad_through("moe_decode", x, w1, w2, weights)
    if not on_card("moe_decode", x, w1, w2, idx, weights):
        return moe_decode_plain(x, w1, w2, idx, weights, pred_idx)
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    k = idx.shape[1]
    dt = float_dtype("moe_decode", x=x, w1=w1, w2=w2)
    expect("moe_decode", x, "x", dt)
    expect("moe_decode", w1, "w1", dt, (e, d, 2 * f))
    expect("moe_decode", w2, "w2", dt, (e, f, d))
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
    y = torch.empty((b, d), dtype=dt, device=x.device)
    cost = costs.moe_decode(x, w2, idx)
    if x.is_meta:
        costs.report("moe_decode", cost)
        return y
    fn = _build.function("moe_decode", "moe_decode_launch", 8, 6)
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), idx.data_ptr(),
             weights.data_ptr(), h.data_ptr(), partial.data_ptr(),
             y.data_ptr(), b, d, f, k, e, int(dt == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_decode", err)
    moe_decode.launches += 1
    costs.report("moe_decode", cost)
    return y


moe_decode.launches = 0

#: the dynamic shared memory a block may opt into on the H100 (227 KB),
#: less the kernels' static ``count``
SMEM_MAX = 232448 - 16
#: ``csrc/moe_decode_quant.cu``'s warps (NW), slots a pass over the
#: weights serves (R) and h rows pass 2 stages at once (FC)
_NW, _R, _FC = 8, 8, 4096


def quant_smem(n_slots: int, d: int, f: int, dtype: str, x_bytes: int = 2):
    """The dynamic shared memory of ``moe_decode_quant``'s passes 1 and 2
    (``launch`` in ``csrc/moe_decode_quant.cu``): the slot list, the
    warps' sums of 128 columns (pass 2 in int4: 256), then x rows [D][R]
    at ``x_bytes`` an element (pass 1; 2 bf16, 4 f32) or a chunk of h rows
    [min(F, FC)][R] f32 (pass 2)."""
    slots = (n_slots * 4 + 15) // 16 * 16
    cols2 = 256 if dtype == "int4" else 128
    return (slots + _NW * _R * 128 * 4 + d * _R * x_bytes,
            slots + _NW * _R * cols2 * 4 + min(f, _FC) * _R * 4)


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
    which ignores ``pred_idx`` as ``moe_decode`` does; on ``meta`` the
    checks, an empty output and the launch's cost."""
    no_grad_through("moe_decode_quant", x, s1, s2, weights)
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"moe_decode_quant: expert dtype {dtype!r} not in "
                         f"{QUANT_DTYPES}")
    args = (x, w1q, w2q, s1, s2, idx, weights)
    if not on_card("moe_decode_quant", *args):
        return moe_decode_quant_plain(*args, dtype=dtype, pred_idx=pred_idx)
    b, d = x.shape
    f = w2q.shape[1]
    k = idx.shape[1]
    dt = expect_quant("moe_decode_quant", x, w1q, w2q, s1, s2, dtype)
    expect("moe_decode_quant", idx, "idx", torch.int32, (b, k))
    expect("moe_decode_quant", weights, "weights", torch.float32, (b, k))
    e = w2q.shape[0]
    if b < 1 or k < 1 or not 1 <= e <= 65535:
        raise ValueError(f"moe_decode_quant: B={b}, k={k}, E={e} (the grid "
                         "needs B, k >= 1 and 1 <= E <= 65535)")
    for i, smem in enumerate(quant_smem(b * k, d, f, dtype,
                                        x.element_size())):
        if smem > SMEM_MAX:
            raise ValueError(
                f"moe_decode_quant: pass {i + 1} needs {smem} bytes of "
                f"shared memory at B={b}, k={k}, D={d}, F={f} ({dtype}); a "
                f"block may have {SMEM_MAX}")
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty((b, d), dtype=dt, device=x.device)
    cost = costs.moe_decode(x, w2q, idx, dtype)
    if x.is_meta:
        costs.report("moe_decode_quant", cost)
        return y
    fn = _build.function("moe_decode_quant", "moe_decode_quant_launch", 10, 7)
    err = fn(*(t.data_ptr() for t in args), h.data_ptr(), partial.data_ptr(),
             y.data_ptr(), b, d, f, k, e, int(dtype == "int4"),
             int(dt == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("moe_decode_quant", err)
    moe_decode_quant.launches += 1
    costs.report("moe_decode_quant", cost)
    return y


moe_decode_quant.launches = 0
