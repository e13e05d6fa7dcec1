"""Per-expert SwiGLU over capacity buffers (the ``dense`` MoE path).

Kernel: ``csrc/moe_ffn.cu`` (replaces ``repro/kernels/moe_ffn.py::
moe_ffn_pallas``).  xe [E, C, D], w1 [E, D, 2F] (gate = first F columns,
up = next F), w2 [E, F, D] -> [E, C, D] in xe's dtype: every expert and
every capacity row, empty or not (a zero row comes out zero).  xe, w1 and
w2 are all bf16 or all f32.  On bf16 the kernel reads its operands through
TMA tensor maps (xe and h as 3-D [E, C, .] maps, encoded per call; the
weights' cached per tensor in the library) and runs wgmma on them; on f32
it runs f32 FFMA on the CUDA cores, in one of two bodies chosen by C: up
to C 24 a decode body that streams every weight once, above it the
register-tiled SGEMM of ``csrc/f32_sgemm.cuh``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, float_dtype, \
    no_grad_through, on_card


def moe_ffn_plain(xe, w1, w2):
    """The kernel's function in plain PyTorch (the reference's
    ``moe_ffn_ref``): f32 products, output in xe's dtype."""
    f = w2.shape[1]
    h = torch.bmm(xe.float(), w1.float())                    # [E, C, 2F]
    h = F_.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(h, w2.float()).to(xe.dtype)


def moe_ffn(xe, w1, w2):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost."""
    no_grad_through("moe_ffn", xe, w1, w2)
    if not on_card("moe_ffn", xe, w1, w2):
        return moe_ffn_plain(xe, w1, w2)
    e, c, d = xe.shape
    f = w2.shape[1]
    dt = float_dtype("moe_ffn", xe=xe, w1=w1, w2=w2)
    expect("moe_ffn", xe, "xe", dt)
    expect("moe_ffn", w1, "w1", dt, (e, d, 2 * f))
    expect("moe_ffn", w2, "w2", dt, (e, f, d))
    if d % 64:
        raise ValueError(f"moe_ffn: D={d} must be a multiple of 64")
    if f % 32:
        raise ValueError(f"moe_ffn: F={f} must be a multiple of 32")
    for arg, t in (("xe", xe), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_ffn: {arg} needs a 16-byte aligned base")
    h = torch.empty((e, c, f), dtype=dt, device=xe.device)
    out = torch.empty((e, c, d), dtype=dt, device=xe.device)
    cost = costs.moe_ffn(xe, w1, w2)
    if xe.is_meta:
        costs.report("moe_ffn", cost)
        return out
    fn = _build.function("moe_ffn", "moe_ffn_launch", 5, 5)
    err = fn(xe.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(),
             out.data_ptr(), e, c, d, f, int(dt == torch.float32),
             torch.cuda.current_stream(xe.device).cuda_stream)
    _build.check("moe_ffn", err)
    moe_ffn.launches += 1
    costs.report("moe_ffn", cost)
    return out


moe_ffn.launches = 0
