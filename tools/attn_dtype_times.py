#!/usr/bin/env python3
"""Time the plain attention ``_sdpa`` in both ``attn_compute_dtype`` modes
on one NVIDIA GPU: forward, and forward plus backward, at OLMoE-1B-7B's
heads (16 query and kv heads of 128) over 4 rows of 512 causal tokens,
bf16 inputs.

    PYTHONPATH=src python3 tools/attn_dtype_times.py [--reps N]

``"f32"`` casts q, k and v to f32 before both products; ``"bf16_accum32"``
multiplies them as stored with f32 products (``models.attention.
f32_product``: ``bmm``'s ``out_dtype`` form).  The modes run in turns,
f32, bf16, bf16, f32, each turn the median of ``--reps`` CUDA-event times
after three warm-up calls; then one profiled forward plus backward of each
mode, its device time summed over the kernels (``torch.profiler``) and
the five kernels that took most of it.  ``errors``: the output and the
gradients of q, k and v (of sum(out * w), w from a seed) of
``"bf16_accum32"`` on the card and on the CPU (f32 copies), each against
the other and against ``"f32"`` on the CPU on the same bf16 values, as
the largest absolute difference over the largest entry.  Prints one JSON
line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

ROWS, TOKENS, HEADS, HEAD_DIM = 4, 512, 16, 128
MODES = ("f32", "bf16_accum32")


def errors(q, k, v, bias, scale):
    """``errors`` of the module doc, by tensor name."""
    import torch
    from repro_torch.models.attention import _sdpa
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))

    def run(dev, mode):
        x = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = _sdpa(*x, bias.to(dev), scale, mode)
        (o.float() * w.to(dev)).sum().backward()
        return [t.double().cpu() for t in [o] + [a.grad for a in x]]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    card, cpu = run("cuda", "bf16_accum32"), run("cpu", "bf16_accum32")
    plain = run("cpu", "f32")
    return {name: {"card_vs_cpu": rel(a, b), "card_vs_f32": rel(a, c),
                   "cpu_vs_f32": rel(b, c)}
            for name, a, b, c in zip(("out", "dq", "dk", "dv"), card, cpu,
                                     plain)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_dtype_times: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.attention import _mask_bias, _sdpa
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (ROWS, TOKENS, HEADS, HEAD_DIM)
    q, k = ((torch.randn(shape, generator=gen, device=dev) * 2).bfloat16()
            for _ in range(2))
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    pos = torch.arange(TOKENS, dtype=torch.int32, device=dev).expand(
        ROWS, TOKENS)
    bias = _mask_bias(pos, pos, None, True)
    scale = HEAD_DIM ** -0.5

    def forward(mode):
        with torch.no_grad():
            _sdpa(q, k, v, bias, scale, mode)

    def step(mode):
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        _sdpa(*x, bias, scale, mode).float().sum().backward()

    def timed(fn, mode):
        for _ in range(3):
            fn(mode)
        ms = []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(mode)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return statistics.median(ms)

    out = {"shape": {"rows": ROWS, "tokens": TOKENS, "heads": HEADS,
                     "head_dim": HEAD_DIM}, "reps": args.reps,
           "turns": [], "device_ms": {}, "top_kernels": {}}
    for mode in MODES + MODES[::-1]:
        out["turns"].append({"mode": mode, "forward_ms": timed(forward, mode),
                             "step_ms": timed(step, mode)})
    out["errors"] = errors(q, k, v, bias, scale)
    for mode in MODES:
        step(mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(mode)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        out["device_ms"][mode] = total
        out["top_kernels"][mode] = [
            {"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
             "calls": e.count} for e in top]
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
