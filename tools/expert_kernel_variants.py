#!/usr/bin/env python3
"""Time launch shapes of the expert kernels moe_ffn (B9) and moe_decode
(B3) on the card.

    python3 tools/expert_kernel_variants.py [--reps 15]

Each kernel fixes its launch shape in constants of its source:
``csrc/moe_ffn.cu`` the stages of each pass's ring and pass 2's B operands
a block; ``csrc/moe_decode.cu`` the weight loads a thread keeps in flight
(for up to 4 slots of an expert, and for more), the launch bound's
blocks an SM, and whether passes 2 and 3 launch as programmatic
dependents.  For each variant in VARIANTS this writes a copy of the source
with those constants replaced into ``build/kernels/variants/`` and builds
it (one ``nvcc`` each, all started together), holds it against the
plain version, and times the variants in turns (L2 flushed before every
call) at OLMoE-1B-7B's shapes: moe_ffn on capacity buffers of C 320, 80
and 4 rows, moe_decode on 8 tokens at k 8 and k 2, each routed by the
layer's router.  The first variant of each kernel is the source as
committed.  One JSON line per (kernel, variant, shape) with the median
device ms; the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

VARIANTS = {
    "moe_ffn": [
        {},
        {"DOWN_NB": 1, "DOWN_STAGES": 6},
    ],
    "moe_decode": [
        {},
        {"DEPENDENT_LAUNCH": "false"},
        {"UNROLL_FEW": 16},
        {"UNROLL_FEW": 4, "UNROLL_MANY": 2, "MIN_BLOCKS": 3},
    ],
}
#: ctypes argument counts of each launch function: pointers, ints
ARGS = {"moe_ffn": (5, 4), "moe_decode": (8, 5)}


def _source(kernel: str, consts: dict) -> str:
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for name, val in consts.items():
        src, n = re.subn(rf"constexpr (int|bool) {name} = \w+;",
                         rf"constexpr \1 {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{kernel}.cu: no constant {name}")
    return src


def _build_variants():
    out = _build.BUILD_DIR / "variants"
    procs = {}
    for kernel, variants in VARIANTS.items():
        for i, consts in enumerate(variants):
            d = out / f"{kernel}_{i}"
            if d.exists():
                shutil.rmtree(d)
            shutil.copytree(_build.CSRC, d)
            (d / f"{kernel}.cu").write_text(_source(kernel, consts))
            lib = d / f"lib{kernel}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                   str(d / f"{kernel}.cu")]
            procs[kernel, i] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {}
    for (kernel, i), (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {i}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
        n_ptrs, n_ints = ARGS[kernel]
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[kernel, i] = fn
        print(json.dumps({"kernel": kernel, "variant": i,
                          "consts": VARIANTS[kernel][i], "ptxas": [
                              ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln]}),
              flush=True)
    return fns


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")


def _ffn(fn, xe, w1, w2):
    e, c, d = xe.shape
    f = w2.shape[1]
    h = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    out = torch.empty_like(xe)
    _check(fn(xe.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(),
              out.data_ptr(), e, c, d, f,
              torch.cuda.current_stream().cuda_stream))
    return out


def _decode(fn, x, w1, w2, idx, weights):
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    k = idx.shape[1]
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _check(fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), idx.data_ptr(),
              weights.data_ptr(), h.data_ptr(), partial.data_ptr(),
              y.data_ptr(), b, d, f, k, e,
              torch.cuda.current_stream().cuda_stream))
    return y


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("expert_kernel_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = _build_variants()
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_decode import moe_decode_plain
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    from repro_torch.models.moe import route
    dev = torch.device("cuda")
    cfg = get_config("olmoe-1b-7b")
    layer = models.init_params(cfg.with_(num_layers=1), seed=0,
                               device=dev)["layers"][0]["moe"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn((2048, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cases = []
    for c, xx in ((320, x), (80, x[:512]), (4, x[:8])):
        xe, _ = cs.capacity_buffers(layer, cfg, xx)
        cases.append(("moe_ffn", f"c{c}", _ffn, moe_ffn_plain,
                      (xe, layer["w1"], layer["w2"])))
    for k in (cfg.moe_top_k, 2):
        weights, idx, _ = route(layer, cfg, x[:8].contiguous(), k)
        cases.append(("moe_decode", f"k{k}", _decode, moe_decode_plain,
                      (x[:8].contiguous(), layer["w1"], layer["w2"], idx,
                       weights)))
    for kernel, shape, call, plain, inputs in cases:
        want = plain(*inputs).float()
        keys = [key for key in fns if key[0] == kernel]
        errs = {}
        for key in keys:
            got = call(fns[key], *inputs).float()
            errs[key] = (cs.row_rel_err(got, want).max().item()
                         if kernel == "moe_ffn" else
                         (got - want).abs().max().item()
                         / want.abs().max().item())
        ms = cs.time_calls([lambda key=key: call(fns[key], *inputs)
                            for key in keys], flush, args.reps)
        for key, t in zip(keys, ms):
            print(json.dumps({"kernel": kernel, "shape": shape,
                              "variant": key[1],
                              "consts": VARIANTS[kernel][key[1]], "ms": t,
                              "err": errs[key],
                              "ok": errs[key] <= (cs.ROW_TOL
                                                  if kernel == "moe_ffn"
                                                  else cs.TOL)}),
                  flush=True)


if __name__ == "__main__":
    main()
