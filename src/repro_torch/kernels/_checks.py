"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when the kernel must launch (every tensor on one CUDA device),
    False when the plain version runs (the inputs lie on the CPU)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


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
