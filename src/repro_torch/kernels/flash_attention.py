"""Causal (optionally windowed) GQA attention over a whole sequence.

Kernel: ``csrc/flash_attention.cu`` (replaces ``repro/kernels/
flash_attention.py::flash_attention_pallas``).  q [B, Hq, S, hd], k / v
[B, Hkv, S, hd] -> [B, Hq, S, hd] in q's dtype (q, k and v all bf16 or
all f32; hd in ``HEAD_DIMS``; f32 runs an f32 body on the CUDA cores that
keeps P in f32, where the bf16 body rounds it); q head h reads kv head
h // (Hq / Hkv); key j is visible to query i iff j <= i (and
j > i - window with a window).  Online softmax, f32 accumulation.  The
kernel takes any strides with a unit stride along hd and 16-byte rows
(k and v sharing theirs), and the output takes q's layout: the model
passes its [B, S, H, hd] activations as transposed views and gets its
output back in that layout, with no copy either way.  On the
H100 at the forward's shapes (4 x 16 heads x 512 x 128) bytes (q, k, v,
out once: 0.010 ms) and the causal half of the two products (0.004 ms)
bound it about equally.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._checks import expect, float_dtype, \
    no_grad_through, on_card

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128)


def flash_attention_plain(q, k, v, *, window: Optional[int] = None):
    """The kernel's function in plain PyTorch: the masked softmax of
    ``repro/kernels/ref.py::flash_attention_ref`` in f32."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, hd).float()
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / hd ** 0.5
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    probs = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, s, hd).to(q.dtype)


def flash_attention(q, k, v, *, window: Optional[int] = None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors; on
    ``meta`` the checks, an empty output and the launch's cost."""
    name = "flash_attention"
    no_grad_through(name, q, k, v)
    if not on_card(name, q, k, v):
        return flash_attention_plain(q, k, v, window=window)
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    dt = float_dtype(name, q=q, k=k, v=v)
    expect(name, q, "q", dt, strided=True)
    expect(name, k, "k", dt, (b, hkv, s, hd), strided=True)
    expect(name, v, "v", dt, (b, hkv, s, hd), strided=True)
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share strides, got "
                         f"{k.stride()} and {v.stride()}")
    if (hd not in HEAD_DIMS or hkv == 0 or hq % hkv or s == 0
            or not 0 < b <= 65535):
        raise ValueError(f"{name}: no kernel for B={b}, Hq={hq}, Hkv={hkv}, "
                         f"S={s}, hd={hd} (needs hd in {HEAD_DIMS}, Hkv "
                         "dividing Hq, S > 0, 0 < B <= 65535)")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window={window} must be positive")
    out = torch.empty_like(q)          # q's layout where q is dense
    strides = [st for t in (q, k, out) for st in _row_strides(name, t)]
    cost = costs.flash_attention(q, k, v, window)
    if q.is_meta:
        costs.report(name, cost)
        return out
    fn = _build.function(name, "flash_attention_launch", 4, 16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hkv, s, hd, window or 0, *strides,
             int(dt == torch.float32),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, err)
    flash_attention.launches += 1
    costs.report(name, cost)
    return out


flash_attention.launches = 0


def _row_strides(name: str, t: torch.Tensor):
    """(batch, head, row) element strides of a [B, H, S, hd] tensor, 0
    along a dim of size 1; each must keep 16-byte loads aligned."""
    out = [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]
    vec = 16 // t.element_size()             # elements of a 16-byte load
    if any(st % vec for st in out) or max(out) >= 1 << 31:
        raise ValueError(f"{name}: strides {t.stride()} break the kernel's "
                         "16-byte rows")
    return out
