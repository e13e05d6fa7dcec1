"""Serving launcher: batched generation, then the same wave under a LExI
plan searched (or loaded) for the model -- on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 8 --max-new 32 --max-len 512 --max-batch 8 \
        --use-kernel --use-moe-decode --use-moe-kernel \
        --lexi-budget-frac 0.5

    # the plain PyTorch path on the CPU, at test size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 4 --max-new 8 --max-len 96 \
        --lexi-budget-frac 0.5

    # int8 experts, quantized at load (moe_gmm_quant in prefill,
    # moe_decode_quant in decode; --expert-dtype int4 packs two a byte;
    # quantized experts are served on the gmm dispatch)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 4 --max-new 8 --max-len 96 \
        --lexi-budget-frac 0.5 --use-kernel --use-moe-decode \
        --use-moe-kernel --expert-dtype int8

    # the contiguous layout with whole-prompt prefill (flash_attention in
    # prefill, flash_decode in decode)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 4 --max-new 8 --max-len 96 \
        --cache-layout contiguous --prefill-chunk 0 --use-flash \
        --use-flash-decode --use-moe-decode --use-moe-kernel \
        --lexi-budget-frac 0.5

    # the contiguous layout with chunked prefill (the default there;
    # flash_decode in decode, the chunk steps replayed as CUDA graphs)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 4 --max-new 8 --max-len 96 \
        --cache-layout contiguous --prefill-chunk 16 --use-flash-decode \
        --use-moe-decode --use-moe-kernel

    # prefix caching, open-loop Poisson arrivals, and a degradation
    # ladder serve where every request asks for base and admissions under
    # pool / queue pressure move it one rung down (DESIGN.md §8, §9, §10)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 8 --max-batch 2 --max-new 8 \
        --max-len 96 --moe-impl gmm --lexi-budget-frac 0.5 --prefix-cache \
        --open-loop-rate 50 --plan-ladder base,lexi --degrade-under-pressure

    # router lookahead on the decode steps (the same tokens as without)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --requests 4 --max-new 8 --max-len 96 \
        --moe-impl gmm --use-moe-decode --router-lookahead

    # DeepSeek-V2-Lite: MLA attention (flash_decode_paged_mla in paged
    # decode under --use-kernel), a dense first layer, shared experts
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite --reduced --device cpu --requests 4 \
        --max-new 8 --max-len 96 --lexi-budget-frac 0.5 --use-kernel \
        --use-moe-decode --use-moe-kernel

On the card every chunk and decode step replays a CUDA graph captured for
its specialization key; ``--eager`` runs the same steps eagerly, the
oracle.  Each report line prints the graphs the serve captured and
replayed, and the wall time per decode step.

Flag names follow ``repro.launch.serve`` for the features the port has.
The MoE layers run the config's own dispatch, as the reference launcher
does: the capacity-buffer ``dense`` impl (``moe_ffn`` under
``--use-moe-kernel``) for both models; ``--moe-impl gmm`` serves the
dropless sorted dispatch instead, which quantized experts
(``--expert-dtype int8|int4``) always take.  Baseline and plan are served
from one engine and one set of weights, drawn on the device from
``--seed``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.serving import Engine, Request


def synth_requests(n: int, vocab: int, *, lo: int = 8, hi: int = 48,
                   max_new: int = 32, seed: int = 0, temperature: float = 0.0,
                   top_k: int = 0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, rng.integers(lo, hi)).astype(np.int32),
                    max_new_tokens=max_new, temperature=temperature,
                    top_k=top_k)
            for i in range(n)]


def _report(tag: str, eng: Engine) -> float:
    tput = eng.throughput()
    s = eng.stats
    pre = (f"preempt={s['preemptions']} recompute={s['recompute_tokens']} "
           if s.get("preemptions") else "")
    if eng.prefix_cache:
        pre += (f"prefix_hit={s['prefix_hit_tokens']} "
                f"({s['prefix_hit_rate']:.0%}) cow={s['cow_copies']} "
                f"evictions={s['cache_evictions']} ")
    steps = max(s["steps"], 1)
    print(f"{tag}: {tput:,.1f} tok/s  "
          f"(prefill={s['prefill_tokens']} decode={s['decode_tokens']} "
          f"steps={s['steps']} {pre}"
          f"ttft_p50={s.get('ttft_p50_s', float('nan')) * 1e3:.0f}ms "
          f"ttft_p95={s.get('ttft_p95_s', float('nan')) * 1e3:.0f}ms "
          f"decode_tps_p50={s.get('decode_tps_p50', float('nan')):.1f} "
          f"decode_step={s['decode_s'] / steps * 1e3:.2f}ms "
          f"host={s['decode_host_s'] / steps * 1e3:.2f}ms "
          f"graphs={eng.runner.stats['graphs']} "
          f"captured={s['graphs_captured']} ({s['capture_s']:.2f}s) "
          f"replays={s['graph_replays']})")
    # per-plan breakdown, straight off the flat stats counters
    per_plan = eng.plan_stats()
    if len(per_plan) > 1 or s.get("plan_degradations"):
        for name, d in sorted(per_plan.items()):
            print(f"  plan {name:<10} requests="
                  f"{int(d.get('plan_requests', 0)):3d}  decode_tokens="
                  f"{int(d.get('plan_decode_tokens', 0))}")
        if s.get("mixed_plan_steps"):
            print(f"  mixed-plan steps (bucketed-k): "
                  f"{int(s['mixed_plan_steps'])}")
        print(f"  plan degradations: {int(s['plan_degradations'])} "
              f"(rung moves, always at the prefill boundary)")
    return tput


def _profiled(fn, enabled: bool):
    """Run ``fn`` under ``torch.profiler`` when enabled -> (result, prof)."""
    if not enabled:
        return fn(), None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof


def _device_breakdown(tag: str, prof, wall_s: float, top: int = 10) -> None:
    """Print one JSON line: device time by kernel (summed over the traced
    run) and the device's busy and idle share of the wall time.  Only the
    device's own events count: a host op's device time is its kernels'
    time again."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type != DeviceType.CPU:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    wall = wall_s * 1e3
    print(json.dumps({"profile": tag, "wall_ms": wall, "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / wall if wall else None,
                      "top": [{"name": n[:90], "ms": t, "calls": c}
                              for n, t, c in rows[:top]]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-lo", type=int, default=8)
    ap.add_argument("--prompt-hi", type=int, default=48)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width (0: whole-prompt prefill, "
                         "contiguous layout only)")
    ap.add_argument("--cache-layout", choices=("paged", "contiguous"),
                    default=None, help="KV layout (default: paged)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages (default: worst-case "
                         "max_batch x max_len; smaller pools admit on "
                         "demand and preempt under pressure)")
    ap.add_argument("--preemption", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="on-demand page allocation + preempt-and-recompute "
                         "(default: on for the paged layout); "
                         "--no-preemption reserves prompt+max_new pages for "
                         "a request's whole lifetime at admission")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="hash-cons full KV pages so requests sharing a "
                         "prompt prefix reuse already-computed pages "
                         "(refcounted, copy-on-write at the boundary; "
                         "paged layout + preemption only)")
    ap.add_argument("--scheduler", choices=["fifo", "sjf"], default="fifo")
    ap.add_argument("--admission", default="headroom",
                    help="admission gate for on-demand paged pools: headroom "
                         "(1 free page per decoding slot), watermark (static "
                         "free-page reserve), lookahead (exact pages decoding "
                         "slots claim within the next page worth of steps), "
                         "or greedy (no gate; thrash baseline)")
    ap.add_argument("--open-loop-rate", type=float, default=0.0,
                    help="offered load in requests/s: requests arrive on a "
                         "Poisson process at this rate instead of all at "
                         "t=0, and the engine admits them mid-flight "
                         "(0 = closed loop); tok/s then includes the "
                         "arrival gaps")
    ap.add_argument("--use-kernel", action="store_true",
                    help="paged decode attends pages in-kernel "
                         "(flash_decode_paged, or flash_decode_paged_mla "
                         "on an MLA model) instead of gathering")
    ap.add_argument("--moe-impl", choices=("dense", "gmm"), default=None,
                    help="MoE dispatch (default: the config's own, dense; "
                         "gmm with --expert-dtype int8/int4)")
    ap.add_argument("--use-moe-decode", action="store_true",
                    help="decode steps run MoE through the fused "
                         "routed-expert path instead of the gmm dispatch "
                         "(no effect under dense, which is never rerouted)")
    ap.add_argument("--use-moe-kernel", action="store_true",
                    help="expert FFNs run the moe_ffn (dense) or moe_gmm / "
                         "moe_decode (gmm) kernels")
    ap.add_argument("--expert-dtype", choices=["bf16", "int8", "int4"],
                    default="bf16",
                    help="storage dtype for routed expert tiles; int8/int4 "
                         "quantize at load and dequantize in-kernel "
                         "(moe_gmm_quant / moe_decode_quant); the engine "
                         "serves them on the gmm dispatch only, so these "
                         "switch the MoE layers to gmm")
    ap.add_argument("--use-flash", action="store_true",
                    help="whole-prompt prefill attention through the "
                         "flash_attention kernel")
    ap.add_argument("--use-flash-decode", action="store_true",
                    help="decode attention over a contiguous view through "
                         "the flash_decode kernel")
    ap.add_argument("--router-lookahead", action="store_true",
                    help="on decode steps predict each MoE layer's expert "
                         "ids from the previous layer's pre-FFN hidden and "
                         "stage the plain path's weight gathers on them "
                         "(a numeric no-op; the CUDA kernels ignore it)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--lexi-budget-frac", type=float, default=None,
                    help="search a plan inline at this active-expert budget")
    ap.add_argument("--plan", default=None,
                    help="path to a saved LexiPlan JSON to serve")
    ap.add_argument("--save-plan", default=None)
    ap.add_argument("--plan-ladder", default=None, metavar="NAME,NAME,...",
                    help="degradation ladder over registered plans, most "
                         "expensive rung first (e.g. base,lexi with "
                         "--lexi-budget-frac or --plan); adds a ladder "
                         "serve where every request asks for base but "
                         "admissions under KV-pool/queue pressure move "
                         "non-priority requests one rung down, always at "
                         "the prefill boundary")
    ap.add_argument("--degrade-under-pressure", action="store_true",
                    help="enable the ladder policy (without it the ladder "
                         "is declared but inert)")
    ap.add_argument("--profile", action="store_true",
                    help="trace each serve with torch.profiler and print "
                         "device time by kernel and the device's idle share")
    ap.add_argument("--eager", action="store_true",
                    help="run every step eagerly on the card (the oracle "
                         "the CUDA graphs are held to)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    impl = args.moe_impl or ("gmm" if args.expert_dtype != "bf16" else None)
    if impl is not None:
        cfg = cfg.with_(moe_impl=impl)
    params = models.init_params(cfg, args.seed, device=args.device)
    opts = models.ModelOpts(use_moe_kernel=args.use_moe_kernel,
                            use_flash=args.use_flash,
                            use_flash_decode=args.use_flash_decode)
    req_kw = dict(lo=args.prompt_lo, hi=args.prompt_hi, max_new=args.max_new,
                  seed=args.seed, temperature=args.temperature,
                  top_k=args.top_k)
    eng = Engine(cfg, params, max_batch=args.max_batch, max_len=args.max_len,
                 prefill_chunk=args.prefill_chunk,
                 cache_layout=args.cache_layout, num_pages=args.num_pages,
                 use_kernel=args.use_kernel or None,
                 use_moe_decode=args.use_moe_decode or None,
                 expert_dtype=args.expert_dtype,
                 router_lookahead=args.router_lookahead or None,
                 preemption=args.preemption, prefix_cache=args.prefix_cache,
                 scheduler=args.scheduler, admission=args.admission,
                 degrade_under_pressure=args.degrade_under_pressure,
                 opts=opts, seed=args.seed, device=args.device,
                 graphs=not args.eager)
    serve_kw = {}
    if args.open_loop_rate > 0:
        rng = np.random.default_rng(args.seed + 1)
        serve_kw["arrival_times"] = list(np.cumsum(rng.exponential(
            1.0 / args.open_loop_rate, args.requests)))
        print(f"open loop: Poisson arrivals at {args.open_loop_rate:g} "
              f"req/s over {serve_kw['arrival_times'][-1]:.2f}s")
    print(f"arch={cfg.name} baseline top-k={cfg.moe_top_k or 'n/a'} "
          f"device={eng.device} layout={eng.kv.layout} "
          f"chunk={eng.prefill_chunk or 'whole'} moe={cfg.moe_impl} "
          f"experts={args.expert_dtype} "
          f"lookahead={eng.router_lookahead} "
          f"steps={'eager' if args.eager else 'graphs'}")

    def wave(**kw):
        return eng.serve(synth_requests(args.requests, cfg.vocab_size,
                                        **req_kw), **serve_kw, **kw)
    if args.profile:    # first calls build, warm up and capture each key
        wave()
    _, prof = _profiled(wave, args.profile)
    tput = _report("baseline", eng)
    if prof is not None:
        _device_breakdown("baseline", prof, eng.stats["wall_s"])

    plan = None
    if args.plan is not None:
        from repro_torch.core import LexiPlan
        plan = LexiPlan.load(args.plan)
    elif (args.lexi_budget_frac is not None and cfg.is_moe
          and cfg.moe_top_k > 1):
        from repro_torch.core import optimize
        n = cfg.num_moe_layers
        budget = max(n, int(round(args.lexi_budget_frac * n * cfg.moe_top_k)))
        plan = optimize(params, cfg, budget, method="dp", n_iter=4,
                        profile_batch=2, profile_seq=32, seed=args.seed,
                        device=args.device, use_kernel=args.use_moe_kernel)
        if args.save_plan:
            plan.save(args.save_plan)
            print(f"saved plan -> {args.save_plan}")

    if plan is not None:
        eng.add_plan("lexi", plan)      # same runner, same weights
        print(f"LExI plan (B={plan.budget}): {plan.plan}")
        if args.profile:
            wave(plan="lexi")
        _, prof = _profiled(lambda: wave(plan="lexi"), args.profile)
        tput2 = _report("LExI", eng)
        if prof is not None:
            _device_breakdown("lexi", prof, eng.stats["wall_s"])
        print(f"speedup: {tput2 / tput:.2f}x at "
              f"{plan.active_fraction():.0%} active experts")

    if args.plan_ladder:
        ladder = args.plan_ladder.split(",")
        eng.set_plan_ladder(ladder)     # raises on unregistered names
        if args.profile:
            wave()
        _, prof = _profiled(wave, args.profile)   # every request asks base
        _report(f"ladder {'->'.join(ladder)}"
                + ("" if args.degrade_under_pressure else " (inert)"), eng)
        if prof is not None:
            _device_breakdown("ladder", prof, eng.stats["wall_s"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
