#!/usr/bin/env python3
"""Time launch shapes of the expert kernels moe_ffn (B9, bf16 and f32),
moe_decode (B3), moe_gmm_quant (B6), moe_decode_quant (B5) and the f32
instances of moe_gmm (B1) and moe_gmm_quant on the card.

    python3 tools/expert_kernel_variants.py [--reps 15] [--kernels a,b]

Each kernel fixes its launch shape in constants of its source:
``csrc/moe_ffn.cu`` the stages of each pass's ring and pass 2's B operands
a block, and for f32 operands (``moe_ffn_f32``) the largest C its decode
body takes, that body's warps a block (the contraction's split), weight
loads a lane keeps in flight and blocks an SM, and the tile body's ring
stages and depth, rows a thread at most and blocks an SM; ``csrc/moe_decode.cu`` the weight loads a thread keeps in flight
(for up to 4 slots of an expert, and for more), the launch bound's
blocks an SM, and whether passes 2 and 3 launch as programmatic
dependents; ``csrc/moe_gmm_quant.cu`` the stages of its ring (and
another design of it, ``tools/variants/moe_gmm_quant_widen_in_smem.cu``:
the int8 weights widened into a bf16 stage in shared memory for B1's SS
wgmma, in place of register-A wgmma);
the f32 instances of ``csrc/moe_gmm.cu`` (``moe_gmm_f32``) and
``csrc/moe_gmm_quant.cu`` (``moe_gmm_quant_f32``) the tile height (the
least rows a thread computes in a tile of more than 16 rows: 1, the rows
cut to each tile's count, up to 8, one block shape of 128 rows whose idle
warps skip their FFMAs), the ring's stages and depth, the
blocks an SM, whether a warp past a tile's rows skips its FFMAs, and
B6's weight stager (the bytes in a cp.async ring, widened
after they land, against ``tools/variants/moe_gmm_quant_f32_ldg.cu``:
widened as __ldg loads them), at OLMoE's 512 and 64
tokens x top-8 and llama4-scout's 512 x top-1 (16 experts, D 5120, F 8192;
on the layers cast to f32), and B1's count pass alone (``rows_<shape>``,
held to ``tile_rows`` exactly); ``csrc/moe_decode_quant.cu`` the columns a thread sums (16-byte or
8-byte loads), the stored bytes of a row a block reads, the threads of
a block, the loads of a batch (for up to 2, 4 and 8 slots) and the
blocks an SM.  For each variant in VARIANTS this writes a
copy of the source with those constants replaced into
``build/kernels/variants/`` and builds it (one ``nvcc`` each, all started
together; ``tools/kernel_variants.py``), holds it against the plain
version, and times the variants in
turns (L2 flushed before every call) at OLMoE-1B-7B's shapes: moe_ffn on
capacity buffers of C 320, 80 and 4 rows (f32: also the first 16, 24,
25, 32 and 33 rows of C 80's, about the decode body's reach, on the
layer's weights cast to f32), moe_decode on 8 tokens at k 8
and k 2, moe_gmm_quant on the prefill check's 512 tokens x top-8 in int8
and int4, moe_decode_quant on 8 tokens at k 8 and k 2 in int8 and int4,
each routed by the layer's router (the quantized kernels on its experts
scaled apart per channel, as chip_smoke.py checks them).  The first
variant of each kernel is the source as committed.  The bf16 kernels are
held to their plain versions row by row (ROW_TOL), the f32 ones
elementwise as chip_smoke's ``compare_f32`` holds it.  One JSON line per
(kernel, variant, shape) with the median device ms; the card's name and
power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402
import kernel_variants  # noqa: E402

VARIANTS = {
    "moe_ffn": [
        {},
        {"DOWN_NB": 1, "DOWN_STAGES": 6},
    ],
    "moe_ffn_f32": [
        {},
        {"DEC_MAX_C": 32},
        {"DEC_LOADS": 8},
        {"TILE_BK": 32, "TILE_STAGES": 3},
        {"TILE_MAX_TM": 4},
        {"TILE_MIN_BLOCKS": 1},
    ],
    "moe_decode": [
        {},
        {"DEPENDENT_LAUNCH": "false"},
        {"UNROLL_FEW": 16},
        {"UNROLL_FEW": 4, "UNROLL_MANY": 2, "MIN_BLOCKS": 3},
    ],
    "moe_gmm_f32": [
        {},
        {"F32_MIN_TM": 1},
        {"F32_MIN_TM": 2},
        {"F32_MIN_TM": 8},
        {"F32_STAGES": 2},
        {"F32_BK": 32, "F32_STAGES": 2},
        {"F32_MIN_BLOCKS": 1},
        {"F32_SKIP": "false"},
    ],
    "moe_gmm_quant_f32": [
        {},
        {"F32_MIN_TM": 1},
        {"F32_STAGES": 3},
        {"F32_STAGES": 4},
        {"source": "tools/variants/moe_gmm_quant_f32_ldg.cu"},
        {"F32_MIN_BLOCKS": 1},
        {"F32_SKIP": "false"},
    ],
    "moe_gmm_quant": [
        {},
        {"MAX_STAGES": 3},
        {"source": "tools/variants/moe_gmm_quant_widen_in_smem.cu"},
    ],
    "moe_decode_quant": [
        {},
        {"C": 16, "MIN_BLOCKS": 1, "UNROLL_TWO": 16, "UNROLL_FOUR": 8,
         "UNROLL_MANY": 4},
        {"C": 8, "MIN_BLOCKS": 2, "UNROLL_TWO": 8, "UNROLL_FOUR": 8,
         "UNROLL_MANY": 4},
        {"CB": 64},
        {"CB": 256},
        {"NT": 128, "MIN_BLOCKS": 4},
        {"NT": 512, "MIN_BLOCKS": 1},
    ],
}
#: the source of each kernel that is not named after it
SOURCE = {"moe_ffn_f32": "moe_ffn", "moe_gmm_f32": "moe_gmm",
          "moe_gmm_quant_f32": "moe_gmm_quant"}
#: ctypes argument counts of the C functions called: pointers, ints
ARGS = {"moe_ffn_launch": (5, 5), "moe_decode_launch": (8, 5),
        "moe_gmm_launch": (8, 6), "moe_gmm_tile_rows_launch": (3, 3),
        "moe_gmm_quant_launch": (10, 7), "moe_decode_quant_launch": (10, 6)}
#: the kernels held to their plain versions as chip_smoke's compare_f32
#: holds an f32 kernel (else row by row, ROW_TOL)
F32_KERNELS = ("moe_ffn_f32", "moe_gmm_f32", "moe_gmm_quant_f32")
#: chip_smoke's f32 tolerance (``compare_f32``)
F32_TOL = 2e-5


def _build_variants(kernels):
    libs = kernel_variants.build({
        f"{kernel}_{i}": (SOURCE.get(kernel, kernel), variant)
        for kernel in kernels for i, variant in enumerate(VARIANTS[kernel])})
    out = {}
    for kernel in kernels:
        for i, variant in enumerate(VARIANTS[kernel]):
            lib, ptxas = libs[f"{kernel}_{i}"]
            out[kernel, i] = lib
            print(json.dumps({"kernel": kernel, "variant": i,
                              "consts": variant, "ptxas": ptxas}),
                  flush=True)
    return out


def _fn(lib, name):
    """The C function ``name`` of a variant's library, its arguments
    declared (ARGS: every pointer and the stream as ``c_void_p``)."""
    fn = getattr(lib, name)
    n_ptrs, n_ints = ARGS[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _f32_err(got, want) -> float:
    """max |got - want| over F32_TOL (|want| + the row's largest |want|,
    at least 1): chip_smoke's ``compare_f32`` passes at <= 1."""
    row = want.abs().amax(-1, keepdim=True).clamp(min=1.0)
    return ((got - want).abs() / (F32_TOL * (want.abs() + row))).max().item()


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ffn(lib, xe, w1, w2):
    e, c, d = xe.shape
    f = w2.shape[1]
    h = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    out = torch.empty_like(xe)
    _check(_fn(lib, "moe_ffn_launch")(xe.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(),
              out.data_ptr(), e, c, d, f, int(xe.dtype == torch.float32),
              _stream()))
    return out


def _decode(lib, x, w1, w2, idx, weights):
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    k = idx.shape[1]
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _check(_fn(lib, "moe_decode_launch")(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), idx.data_ptr(),
              weights.data_ptr(), h.data_ptr(), partial.data_ptr(),
              y.data_ptr(), b, d, f, k, e, _stream()))
    return y


def _rows(xs, block_m):
    """The count pass's int32 scratch of an f32 buffer, a count for each 16
    rows of a tile (bf16: none)."""
    if xs.dtype != torch.float32:
        return None, 0
    rows = torch.empty((xs.shape[0] // block_m, 8), dtype=torch.int32,
                       device=xs.device)
    return rows, rows.data_ptr()


def _gmm(lib, xs, w1, w2, te, tv, block_m):
    m, d = xs.shape
    e, f = w2.shape[0], w2.shape[1]
    h = torch.empty((m, f), dtype=xs.dtype, device=xs.device)
    out = torch.empty_like(xs)
    rows, rows_ptr = _rows(xs, block_m)
    _check(_fn(lib, "moe_gmm_launch")(
        xs.data_ptr(), w1.data_ptr(), w2.data_ptr(), te.data_ptr(),
        tv.data_ptr(), rows_ptr, h.data_ptr(), out.data_ptr(), m, d, f,
        block_m, e, int(xs.dtype == torch.float32), _stream()))
    return out


def _tile_rows(lib, xs, tv, block_m):
    """The f32 instances' count pass alone."""
    rows, rows_ptr = _rows(xs, block_m)
    _check(_fn(lib, "moe_gmm_tile_rows_launch")(
        xs.data_ptr(), tv.data_ptr(), rows_ptr, xs.shape[0], xs.shape[1],
        block_m, _stream()))
    return rows.amax(1)


def _gmm_quant(lib, xs, w1q, w2q, s1, s2, te, tv, block_m, packed):
    m, d = xs.shape
    e, f = w2q.shape[0], w2q.shape[1]
    h = torch.empty((m, f), dtype=xs.dtype, device=xs.device)
    out = torch.empty_like(xs)
    rows, rows_ptr = _rows(xs, block_m)
    _check(_fn(lib, "moe_gmm_quant_launch")(
        *(t.data_ptr() for t in (xs, w1q, w2q, s1, s2, te, tv)), rows_ptr,
        h.data_ptr(), out.data_ptr(), m, d, f, block_m, e, packed,
        int(xs.dtype == torch.float32), _stream()))
    return out


def _decode_quant(lib, x, w1q, w2q, s1, s2, idx, weights, packed):
    b, d = x.shape
    e, f = w2q.shape[0], w2q.shape[1]
    k = idx.shape[1]
    h = torch.empty((b, k, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _check(_fn(lib, "moe_decode_quant_launch")(
        *(t.data_ptr() for t in (x, w1q, w2q, s1, s2, idx, weights, h,
                                 partial, y)),
              b, d, f, k, e, packed, _stream()))
    return y


def _cases(kernels, layer, cfg, x):
    """(kernel, shape, call, plain, inputs, extra args) for each timed
    shape of the chosen kernels."""
    from repro_torch.kernels.moe_decode import moe_decode_plain, \
        moe_decode_quant_plain
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch
    cases = []
    x8 = x[:8].contiguous()
    if "moe_ffn" in kernels:
        for c, xx in ((320, x), (80, x[:512]), (4, x[:8])):
            xe, _ = cs.capacity_buffers(layer, cfg, xx)
            cases.append(("moe_ffn", f"c{c}", _ffn, moe_ffn_plain,
                          (xe, layer["w1"], layer["w2"]), ()))
    if "moe_ffn_f32" in kernels:
        w1, w2 = layer["w1"].float(), layer["w2"].float()
        for c, xx in ((320, x), (80, x[:512]), (4, x[:8])):
            xe = cs.capacity_buffers(layer, cfg, xx)[0].float()
            rows = ((c, xe),) if c != 80 else ((80, xe), *(
                (r, xe[:, :r].contiguous()) for r in (16, 24, 25, 32, 33)))
            for cc, xr in rows:
                cases.append(("moe_ffn_f32", f"c{cc}", _ffn, moe_ffn_plain,
                              (xr, w1, w2), ()))
    if "moe_decode" in kernels:
        for k in (cfg.moe_top_k, 2):
            weights, idx, _ = route(layer, cfg, x8, k)
            cases.append(("moe_decode", f"k{k}", _decode, moe_decode_plain,
                          (x8, layer["w1"], layer["w2"], idx, weights), ()))
    quant = [n for n in ("moe_gmm_quant", "moe_decode_quant") if n in kernels]
    if quant:
        varied = cs.varied_experts(layer)
        qs = {dt: quantize_moe_layer(varied, dt) for dt in QUANT_DTYPES}
    if "moe_gmm_quant" in kernels:
        k = cfg.moe_top_k
        xx = x[:512]
        _, idx, _ = route(layer, cfg, xx, k)
        plan = make_sort_plan(idx, cfg.num_experts,
                              default_block_m(xx.shape[0] * k, floor=8))
        xs = sort_dispatch(xx, plan, k)
        for dt, q in qs.items():
            args = (xs, q["w1"], q["w2"], q["w1_scale"], q["w2_scale"],
                    plan.tile_expert, plan.tile_valid)
            cases.append((
                "moe_gmm_quant", f"t512_{dt}", _gmm_quant,
                lambda *a, dt=dt, bm=plan.block_m: moe_gmm_quant_plain(
                    *a, bm, dtype=dt),
                args, (plan.block_m, int(dt == "int4"))))
    if "moe_decode_quant" in kernels:
        for k in (cfg.moe_top_k, 2):
            weights, idx, _ = route(layer, cfg, x8, k)
            for dt, q in qs.items():
                args = (x8, q["w1"], q["w2"], q["w1_scale"], q["w2_scale"],
                        idx, weights)
                cases.append((
                    "moe_decode_quant", f"k{k}_{dt}", _decode_quant,
                    lambda *a, dt=dt: moe_decode_quant_plain(*a, dtype=dt),
                    args, (int(dt == "int4"),)))
    return cases


def _gmm_f32_cases(kernels, shapes):
    """The f32 sorted-buffer kernels' cases: at each of ``shapes`` (name,
    layer, config, f32 tokens), routed at top-k, B1 f32 and its count pass
    alone (``moe_gmm_f32``; ``rows_<shape>``), and B6 f32 in int8 and int4
    on the experts scaled apart (``moe_gmm_quant_f32``)."""
    from repro_torch.kernels.moe_gmm import moe_gmm_plain, \
        moe_gmm_quant_plain, tile_rows
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch
    for name, layer, cfg, x in shapes:
        k = cfg.moe_top_k
        _, idx, _ = route(layer, cfg, x, k)
        plan = make_sort_plan(idx, cfg.num_experts,
                              default_block_m(x.shape[0] * k, floor=8))
        xs = sort_dispatch(x, plan, k)
        te, tv, bm = plan.tile_expert, plan.tile_valid, plan.block_m
        print(json.dumps({"shape": name, "rows": x.shape[0] * k,
                          "block_m": bm, "tiles": len(tv),
                          "rows_computed": int(tile_rows(xs, tv, bm).sum())}),
              flush=True)
        if "moe_gmm_f32" in kernels:
            args = (xs, layer["w1"], layer["w2"], te, tv)
            yield ("moe_gmm_f32", name, _gmm,
                   lambda *a, bm=bm: moe_gmm_plain(*a, bm), args, (bm,))
            yield ("moe_gmm_f32", f"rows_{name}", _tile_rows,
                   lambda xs, tv, bm=bm: tile_rows(xs, tv, bm), (xs, tv),
                   (bm,))
        if "moe_gmm_quant_f32" in kernels:
            varied = cs.varied_experts(layer)
            for dt in QUANT_DTYPES:
                q = quantize_moe_layer(varied, dt)
                args = (xs, q["w1"], q["w2"], q["w1_scale"], q["w2_scale"],
                        te, tv)
                yield ("moe_gmm_quant_f32", f"{name}_{dt}", _gmm_quant,
                       lambda *a, dt=dt, bm=bm: moe_gmm_quant_plain(
                           *a, bm, dtype=dt), args, (bm, int(dt == "int4")))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", default=",".join(VARIANTS))
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("expert_kernel_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_variants(kernels)
    from repro_torch import models
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    cfg = get_config("olmoe-1b-7b")
    layer = models.init_params(cfg.with_(num_layers=1), seed=0,
                               device=dev)["layers"][0]["moe"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn((2048, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cases = _cases(kernels, layer, cfg, x)
    if {"moe_gmm_f32", "moe_gmm_quant_f32"} & set(kernels):
        # B1 / B6 f32 at OLMoE's prefill check (512 tokens x top-8), a
        # serve chunk's 64 tokens, and llama4-scout's 512 tokens x top-1
        # (16 experts, F 8192): chip_smoke's f32 shapes
        f32_layer = cs.cast_tree(layer, torch.float32)
        wcfg = get_config(cs.F32_QUANT_WIDE).with_(num_layers=2)
        wparams = models.init_params(wcfg, seed=0, device=dev)
        wlayer = cs.cast_tree(next(lp["moe"] for lp in wparams["layers"]
                                   if "moe" in lp), torch.float32)
        del wparams
        wx = torch.randn((512, wcfg.d_model), generator=gen, device=dev)
        cases = [*cases, *_gmm_f32_cases(kernels, (
            ("t512", f32_layer, cfg, x[:512].float()),
            ("t64", f32_layer, cfg, x[:64].float()),
            ("llama4_t512", wlayer, wcfg, wx)))]
    for kernel, shape, call, plain, inputs, extra in cases:
        want = plain(*inputs).float()
        keys = [key for key in libs if key[0] == kernel]
        errs = {}
        for key in keys:
            got = call(libs[key], *inputs, *extra).float()
            if shape.startswith("rows_"):
                errs[key] = 0.0 if torch.equal(got, want) else float("inf")
            elif kernel in F32_KERNELS:
                errs[key] = _f32_err(got, want)
            else:
                errs[key] = cs.row_rel_err(got, want).max().item()
        ms = cs.time_calls([lambda key=key: call(libs[key], *inputs, *extra)
                            for key in keys], flush, args.reps)
        for key, t in zip(keys, ms):
            f32 = kernel in F32_KERNELS
            print(json.dumps({"kernel": kernel, "shape": shape,
                              "variant": key[1],
                              "consts": VARIANTS[kernel][key[1]], "ms": t,
                              "max_err_over_tol" if f32
                              else "max_row_rel_err": errs[key],
                              "ok": errs[key] <= (1.0 if f32
                                                  else cs.ROW_TOL)}),
                  flush=True)


if __name__ == "__main__":
    main()
