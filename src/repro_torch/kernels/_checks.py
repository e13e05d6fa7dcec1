"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def no_grad_through(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record the call: no kernel has a backward
    (nor has its Pallas reference), so a gradient through one would be
    cut silently.  Checked before the device branch, so that the CPU and
    the card behave alike."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward "
            "(as its Pallas reference has none); training runs the plain "
            "paths (ModelOpts use_flash=False, use_moe_kernel=False)")


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when the kernel's route runs (every tensor on one CUDA device;
    or on ``meta``, where the wrapper checks what it checks on the card,
    returns empty outputs and reports the launch's cost,
    ``kernels/costs.py``), False when the plain version runs (the inputs
    lie on the CPU)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


#: the element types of the kernels' float operands (their Pallas
#: references take any float dtype and compute in f32): every operand of
#: B1-B4, B8 and B9, B5 / B6's activations, B7's latent pool
FLOAT_DTYPES = (torch.bfloat16, torch.float32)


def float_dtype(name: str, **operands: torch.Tensor) -> torch.dtype:
    """The one float dtype of a launch's float operands, bf16 or f32.
    Raises on another dtype or on a mix: an f32 operand launches the f32
    kernel, and nothing is cast."""
    (arg0, t0), *rest = operands.items()
    dt = t0.dtype
    if dt not in FLOAT_DTYPES:
        raise TypeError(f"{name}: {arg0} must be torch.bfloat16 or "
                        f"torch.float32, got {dt}")
    for arg, t in rest:
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} is {t.dtype} but {arg0} is {dt}; "
                            "the float operands must share one dtype")
    return dt


def expect(name: str, t: torch.Tensor, arg: str, dtype: torch.dtype,
           shape=None, *, strided: bool = False) -> None:
    """dtype and shape as given; contiguous, or with ``strided`` a unit
    stride along the last dim and a 16-byte aligned base."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if strided:
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a unit last stride and "
                             "a 16-byte aligned base")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def expect_quant(name: str, x: torch.Tensor, w1q: torch.Tensor,
                 w2q: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                 dtype: str) -> torch.dtype:
    """The quantized expert kernels' operands: x [.., D] bf16 or f32 (the
    activations' dtype, returned: the output's), w1q int8
    [E, D(p), 2F], w2q int8 [E, F, D(p)] (D(p) = D/2 for int4), s1 f32
    [E, 2, F], s2 f32 [E, F]; all contiguous with 16-byte aligned bases
    (a thread loads 16 int8 or 32 int4 values at once), D a multiple of
    64, and for int4 D/2 too, and F a multiple of 32.  The weights are
    never widened in device memory."""
    d = x.shape[-1]
    e, f = w2q.shape[0], w2q.shape[1]
    dp = d // 2 if dtype == "int4" else d
    dt = float_dtype(name, x=x)
    expect(name, x, "x", dt)
    expect(name, w1q, "w1q", torch.int8, (e, dp, 2 * f))
    expect(name, w2q, "w2q", torch.int8, (e, f, dp))
    expect(name, s1, "s1", torch.float32, (e, 2, f))
    expect(name, s2, "s2", torch.float32, (e, f))
    if d % 64 or dp % 64:
        raise ValueError(f"{name}: D={d} and the stored D={dp} "
                         "must be multiples of 64")
    if f % 32:
        raise ValueError(f"{name}: F={f} must be a multiple of 32")
    for arg, t in (("x", x), ("w1q", w1q), ("w2q", w2q), ("s1", s1),
                   ("s2", s2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a 16-byte aligned base")
    return dt
