#!/usr/bin/env python3
"""Time the expert kernels moe_ffn (B9), moe_decode (B3), moe_gmm_quant
(B6) and moe_decode_quant (B5) of one checkout at the shapes the main
paths give them, on one NVIDIA GPU.

    python3 tools/expert_kernel_times.py [--root DIR] [--tag NAME] [--f32]

``repro_torch`` is imported from ``DIR/src`` (default: this checkout) and
its kernels are built there; the inputs, checks and timers are this
checkout's ``chip_smoke.py``'s.  Run it in turns with the root of another
checkout (an older commit unpacked by ``git archive``) in one call on one
card -- other, this, this, other -- to compare two versions of a kernel.

Shapes: moe_ffn on OLMoE-1B-7B's capacity buffers (C 320, 80, 4: the
forward's 4 x 512 tokens, a serve chunk's 8 x 64, a decode step's 8 slots)
and on DeepSeek-V2-Lite's at C 4 (F 1408 and the intra-pruned 1056), each
with the bf16 ``bmm`` pair as ``library_ms``; moe_decode on 8 tokens
routed by each model's router at its top-k and at k 2 (and OLMoE's on one
token).  The quantized kernels in int8 and int4, each with its bf16
sibling (B1 / B3) on the same routing timed in the same turns
(``sibling_ms``): moe_gmm_quant at the prefill check's 512 tokens x top-8
and a serve chunk's 64 x top-8 (OLMoE) and at 512 tokens on DeepSeek's
intra-pruned F 1056; moe_decode_quant on 8 tokens at k 8 and k 2, on one
token at k 8 and k 2 (OLMoE), and on 8 tokens at DeepSeek's F 1056, k 6.
Each timing is held to the plain version first.  ``passes`` gives the
quantized kernels' device time by CUDA kernel (torch.profiler, five calls)
at the prefill check's and the 8-token decode shape: a programmatic
dependent's time counts its wait for the pass before it.  ``--f32``
times only the f32 instances of moe_gmm (B1) and moe_gmm_quant (B6, int8
and int4) through their wrappers, on the sorted dispatch at top-k of
OLMoE's 512 and 64 tokens (its layer cast to f32), of the reduced OLMoE's
128 tokens and of llama4-scout's 512 (16 experts, F 8192), and moe_ffn
(B9) in f32 on OLMoE's capacity buffers of C 80 and C 320 (the tile body
B1 and B6 share), each beside its
plain version (``max_err_over_tol`` as chip_smoke's ``compare_f32``) with
a sha256 of its output (equal digests across roots: equal bits) and the
rows the plan holds and computes.  Prints one JSON line, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quant_passes(layer, cfg, x512, x8):
    """{kernel: {dtype: {CUDA kernel: ms a call}}}: moe_gmm_quant on
    ``x512``'s routing (top-k), moe_decode_quant on ``x8``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.kernels import moe_decode_quant, moe_gmm_quant
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch

    def by_kernel(call, n=5):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        return {e.key.split("(")[0]: e.device_time_total / n / 1e3
                for e in prof.key_averages() if e.device_time_total > 0}

    k = cfg.moe_top_k
    _, idx, _ = route(layer, cfg, x512, k)
    plan = make_sort_plan(idx, cfg.num_experts,
                          default_block_m(x512.shape[0] * k, floor=8))
    xs = sort_dispatch(x512, plan, k)
    weights, idx8, _ = route(layer, cfg, x8, k)
    varied = cs.varied_experts(layer)
    out = {"moe_gmm_quant": {}, "moe_decode_quant": {}}
    for dt in QUANT_DTYPES:
        q = quantize_moe_layer(varied, dt)
        w = (q["w1"], q["w2"], q["w1_scale"], q["w2_scale"])
        out["moe_gmm_quant"][dt] = by_kernel(lambda: moe_gmm_quant(
            xs, *w, plan.tile_expert, plan.tile_valid, dtype=dt,
            block_m=plan.block_m))
        out["moe_decode_quant"][dt] = by_kernel(lambda: moe_decode_quant(
            x8, *w, idx8, weights, dtype=dt))
    return out


def f32_gmm(rec, flush, gen, dev):
    """rec["f32"][shape][kernel]: B1 and B6 in f32 at --f32's shapes."""
    import torch
    import chip_smoke as cs
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_ffn, moe_gmm, moe_gmm_quant
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_plain, \
        moe_gmm_quant_plain
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch

    def over_tol(got, want):
        row = want.abs().amax(-1, keepdim=True).clamp(min=1.0)
        return ((got - want).abs()
                / (cs.F32_TOL * (want.abs() + row))).max().item()

    def shape(name, layer, cfg, x):
        k = cfg.moe_top_k
        _, idx, _ = route(layer, cfg, x, k)
        plan = make_sort_plan(idx, cfg.num_experts,
                              default_block_m(x.shape[0] * k, floor=8))
        xs = sort_dispatch(x, plan, k)
        te, tv, bm = plan.tile_expert, plan.tile_valid, plan.block_m
        nz = (xs.reshape(-1, bm, xs.shape[1]) != 0).any(-1)
        last = torch.where(nz, torch.arange(1, bm + 1, device=dev), 0)
        calls = {"moe_gmm": (
            lambda: moe_gmm(xs, layer["w1"], layer["w2"], te, tv,
                            block_m=bm),
            lambda: moe_gmm_plain(xs, layer["w1"], layer["w2"], te, tv, bm))}
        varied = cs.varied_experts(layer)
        for dt in QUANT_DTYPES:
            q = quantize_moe_layer(varied, dt)
            w = (q["w1"], q["w2"], q["w1_scale"], q["w2_scale"])
            calls[f"moe_gmm_quant_{dt}"] = (
                lambda w=w, dt=dt: moe_gmm_quant(xs, *w, te, tv, dtype=dt,
                                                 block_m=bm),
                lambda w=w, dt=dt: moe_gmm_quant_plain(xs, *w, te, tv, bm,
                                                       dtype=dt))
        out = rec["f32"][name] = {
            "rows": x.shape[0] * k, "block_m": bm, "tiles": len(tv),
            "rows_computed": int(torch.where(
                tv.bool(), last.amax(-1), 0).sum())}
        for kname, (call, plain) in calls.items():
            timed(out, kname, call, plain)

    def timed(out, kname, call, plain):
        got = call()
        ms, = cs.time_calls([call], flush)
        out[kname] = {"ms": ms, "digest": cs.digest(got),
                      "max_err_over_tol": over_tol(got, plain())}

    cfg = get_config("olmoe-1b-7b")
    layer = cs.cast_tree(models.init_params(
        cfg.with_(num_layers=1), seed=0, device=dev)["layers"][0]["moe"],
        torch.float32)
    x = torch.randn((512, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16).float()
    shape("olmoe_t512", layer, cfg, x)
    shape("olmoe_t64", layer, cfg, x[:64])
    x2048 = torch.randn((2048, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.bfloat16).float()
    for name, xx in (("olmoe_c80", x), ("olmoe_c320", x2048)):
        xe = cs.capacity_buffers(layer, cfg, xx)[0]
        out = rec["f32"][name] = {"capacity": xe.shape[1]}
        timed(out, "moe_ffn", lambda: moe_ffn(xe, layer["w1"], layer["w2"]),
              lambda: moe_ffn_plain(xe, layer["w1"], layer["w2"]))
    rcfg = cfg.reduced()
    rlayer = models.init_params(rcfg, seed=0, device=dev)["layers"][0]["moe"]
    shape("reduced_t128", rlayer, rcfg,
          torch.randn((128, rcfg.d_model), generator=gen, device=dev))
    del layer, rlayer
    wcfg = get_config(cs.F32_QUANT_WIDE).with_(num_layers=2)
    wparams = models.init_params(wcfg, seed=0, device=dev)
    wlayer = cs.cast_tree(next(lp["moe"] for lp in wparams["layers"]
                               if "moe" in lp), torch.float32)
    del wparams
    shape("llama4_t512", wlayer, wcfg,
          torch.randn((512, wcfg.d_model), generator=gen, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--f32", action="store_true",
                    help="time only B1 and B6 in f32")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    sys.path.insert(1, HERE)
    import torch
    if not torch.cuda.is_available():
        print("expert_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import intra_prune
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    secs = _build.build_all()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rec = {"tag": args.tag, "root": os.path.abspath(args.root),
           "build_s": secs}
    if args.f32:
        rec["f32"] = {}
        f32_gmm(rec, flush, gen, dev)
        return finish(rec)
    rec.update({"moe_ffn": {}, "moe_decode": {}, "moe_gmm_quant": {},
                "moe_decode_quant": {}})

    def ffn(layer, cfg, x, name):
        err, ms, plain_ms, nbytes, flops, lib_ms = cs.check_moe_ffn(
            layer, cfg, x, flush, name)
        rec["moe_ffn"][name] = cs.kernel_row(
            "moe_ffn", "", "", err, ms, plain_ms, nbytes, flops, lib_ms)

    def decode(layer, cfg, x, name):
        for key, v in cs.check_moe_decode(layer, cfg, x, flush,
                                          "_" + name).items():
            rec["moe_decode"][f"{name}_{key}"] = cs.kernel_row(
                "moe_decode", "", "", *v)

    def quant(name, per, shape):
        for key, v in per.items():
            rec[name][f"{shape}_{key}"] = cs.kernel_row(name, "", "", *v)

    cfg = get_config("olmoe-1b-7b")
    params = models.init_params(cfg.with_(num_layers=1), seed=0, device=dev)
    layer = params["layers"][0]["moe"]
    x = torch.randn((2048, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for name, xx in (("olmoe_forward_c320", x), ("olmoe_chunk_c80", x[:512]),
                     ("olmoe_decode_c4", x[:8])):
        ffn(layer, cfg, xx, name)
    decode(layer, cfg, x[:8].contiguous(), "olmoe")
    decode(layer, cfg, x[:1].contiguous(), "olmoe_b1")
    for name, xx in (("olmoe_prefill_t512", x[:512]),
                     ("olmoe_chunk_t64", x[:64])):
        quant("moe_gmm_quant", cs.check_moe_gmm_quant(
            layer, cfg, xx, flush, "_" + name), name)
    for name, xx in (("olmoe_b8", x[:8]), ("olmoe_b1", x[:1])):
        quant("moe_decode_quant", cs.check_moe_decode_quant(
            layer, cfg, xx.contiguous(), flush, "_" + name,
            ks=(cfg.moe_top_k, 2)), name)
    rec["passes"] = quant_passes(layer, cfg, x[:512], x[:8].contiguous())
    del params, layer

    cfg = get_config("deepseek-v2-lite").with_(num_layers=2)
    params = models.init_params(cfg, seed=0, device=dev)
    pruned, cfg_p = intra_prune(params, cfg, 0.25)
    x8 = x[:8].contiguous()
    for lay, c in ((params["layers"][1]["moe"], cfg),
                   (pruned["layers"][1]["moe"], cfg_p)):
        f = c.moe_d_ff
        ffn(lay, c, x8, f"deepseek_decode_f{f}_c4")
        decode(lay, c, x8, f"deepseek_f{f}")
    quant("moe_gmm_quant", cs.check_moe_gmm_quant(
        pruned["layers"][1]["moe"], cfg_p, x[:512], flush, "_deepseek_f1056"),
        "deepseek_f1056_t512")
    quant("moe_decode_quant", cs.check_moe_decode_quant(
        pruned["layers"][1]["moe"], cfg_p, x8, flush, "_deepseek_f1056"),
        "deepseek_f1056_b8")
    return finish(rec)


def finish(rec) -> int:
    """Print the record, then the card's name and power limit."""
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
