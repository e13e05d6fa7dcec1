"""End-to-end driver (the paper is an inference paper): train a small MoE,
then SERVE batched requests with continuous batching, comparing the
baseline uniform top-k against the LExI plan at a 50% active-expert
budget -- throughput and held-out quality side by side.  On the card by
default.

    PYTHONPATH=src python -m repro_torch.launch.serve_lexi [--steps 300] \
        [--requests 12]

    # the plain PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_lexi --device cpu \
        --steps 40 --requests 4 --max-new 6

The model is the recipe of ``trained_tiny_moe``: an OLMoE-family
``.reduced()`` config at 4 layers, d_model 128, 4 heads of 32, 8 experts
at top-4, moe_d_ff 128, vocab 512, f32, capacity factor 2.0, trained on
16 x 64-token batches of the synthetic Zipf-Markov stream with AdamW at
lr 2e-3.  The model is f32, and the CUDA kernels take f32 operands as
their Pallas references do: on the card Alg. 1 profiles through
``moe_gmm``, held-out eval runs ``flash_attention`` and ``moe_gmm``, and
the engine ``flash_decode_paged``, ``moe_gmm`` and ``moe_decode``; with
``--expert-dtype int8`` / ``int4`` the eval runs ``flash_attention`` and
``moe_gmm_quant``, and the engine ``flash_decode_paged``,
``moe_gmm_quant`` and ``moe_decode_quant`` (which take f32 activations
too).  Training runs the plain paths (no kernel has a backward).
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import apply_plan_params, optimize
from repro_torch.data import DataConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.moe import quantize_expert_params
from repro_torch.models.opts import ModelOpts
from repro_torch.optim import AdamW
from repro_torch.serving import Engine, Request
from repro_torch.training import TrainResult, eval_perplexity, train


def tiny_moe_config() -> ModelConfig:
    """The small OLMoE-family model of the quality-proxy comparisons."""
    return get_config("olmoe-1b-7b").reduced().with_(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        num_experts=8, moe_top_k=4, moe_d_ff=128, vocab_size=512,
        vocab_pad_multiple=16, dtype="float32", moe_capacity_factor=2.0)


def trained_tiny_moe(steps: int = 200, seed: int = 0, *, device=None
                     ) -> Tuple[ModelConfig, dict, DataConfig, TrainResult]:
    """Train ``tiny_moe_config`` on synthetic data -> (cfg, params, dc,
    result)."""
    cfg = tiny_moe_config()
    dc = DataConfig(cfg.vocab_size, seq_len=64, global_batch=16, seed=seed)
    res = train(cfg, dc, total_steps=steps, seed=seed, device=device,
                optimizer=AdamW(peak_lr=2e-3, total_steps=steps,
                                warmup_steps=max(steps // 10, 5)))
    return cfg, res.state.params, dc, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages; a constrained pool admits "
                         "on demand and preempts under pressure")
    ap.add_argument("--preemption", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="on-demand paging + preempt-and-recompute (default "
                         "on); --no-preemption reserves whole lifetimes")
    ap.add_argument("--expert-dtype", choices=["bf16", "int8", "int4"],
                    default="bf16",
                    help="expert-tile storage dtype for BOTH engines "
                         "(quantize-at-load; ppl is evaluated through the "
                         "same quantized gmm path)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share already-computed KV pages across requests "
                         "with a common prompt prefix (refcounted, COW)")
    ap.add_argument("--plan-ladder", default=None, metavar="NAME,NAME,...",
                    help="degradation ladder over registered plans, most "
                         "expensive first (here: base,lexi); adds a third "
                         "serve where every request *asks* for base but "
                         "admissions under queue pressure drop one rung at "
                         "the prefill boundary")
    ap.add_argument("--degrade-under-pressure", action="store_true",
                    help="enable the ladder policy for the third serve "
                         "(off = ladder declared but inert)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -- train a small MoE so routing has real structure ------------------- #
    cfg, params, dc, res = trained_tiny_moe(steps=args.steps, device=dev)
    print(f"trained {cfg.name}-family model for {args.steps} steps; "
          f"final loss {res.losses[-1]:.3f}")
    # serve and evaluate BOTH engines on the sort-based dropless path, so
    # the comparison isolates the plan: capacity shrinks with k and would
    # punish reduced-k plans for token drops, not routing width
    cfg = cfg.with_(moe_impl="gmm")

    rng = np.random.default_rng(0)

    def reqs():
        return [Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            16).astype(np.int32),
                        max_new_tokens=args.max_new)
                for i in range(args.requests)]

    # quantized runs evaluate ppl through the same quantized gmm path the
    # engine serves, so the quality number matches what is deployed
    ed = args.expert_dtype
    ppl_opts = ModelOpts(moe_impl="gmm", expert_dtype=ed, use_flash=True,
                         use_moe_kernel=True)

    def ppl(p, c):
        if ed != "bf16":
            p = quantize_expert_params(p, c, ed)
        return eval_perplexity(p, c, dc, steps=4, opts=ppl_opts)

    # -- ONE engine, one set of weights, two specializations ---------------- #
    eng = Engine(cfg, params, max_batch=4, max_len=128, prefill_pad=16,
                 num_pages=args.num_pages, preemption=args.preemption,
                 expert_dtype=ed, prefix_cache=args.prefix_cache,
                 degrade_under_pressure=args.degrade_under_pressure,
                 use_kernel=True, use_moe_decode=True,
                 opts=ModelOpts(use_moe_kernel=True), device=dev)
    eng.serve(reqs())
    base_tput = eng.throughput()
    base_ppl = ppl(params, cfg)
    print(f"baseline  top-k={cfg.moe_top_k} experts={ed}: "
          f"{base_tput:8.1f} tok/s   ppl={base_ppl:.3f}")
    if args.prefix_cache:
        s = eng.stats
        print(f"  prefix cache: hit={s['prefix_hit_tokens']} tokens "
              f"({s['prefix_hit_rate']:.0%}) cow={s['cow_copies']}")

    # -- LExI plan at 50% budget served from the SAME runner ---------------- #
    budget = cfg.num_moe_layers * cfg.moe_top_k // 2
    plan = optimize(params, cfg, budget, method="dp", n_iter=8,
                    profile_batch=2, profile_seq=32, device=dev)
    eng.add_plan("lexi", plan)
    eng.serve(reqs(), plan="lexi")
    lexi_tput = eng.throughput()
    cfg_l, params_l = apply_plan_params(params, cfg, plan)
    lexi_ppl = ppl(params_l, cfg_l)
    print(f"LExI plan {plan.plan}: "
          f"{lexi_tput:8.1f} tok/s   ppl={lexi_ppl:.3f}")
    print(f"-> {lexi_tput / base_tput:.2f}x throughput at "
          f"{plan.active_fraction():.0%} active experts, "
          f"ppl delta {lexi_ppl - base_ppl:+.3f}")

    # -- pressure-adaptive degradation over the declared ladder ------------- #
    if args.plan_ladder:
        eng.set_plan_ladder(args.plan_ladder.split(","))
        out = eng.serve(reqs())     # every request asks for base
        print(f"\nladder {args.plan_ladder} "
              f"(degrade_under_pressure={args.degrade_under_pressure}): "
              f"{eng.throughput():8.1f} tok/s")
        for name, d in sorted(eng.plan_stats().items()):
            print(f"  plan {name:<8} requests="
                  f"{int(d.get('plan_requests', 0)):3d}  decode_tokens="
                  f"{int(d.get('plan_decode_tokens', 0))}")
        degraded = [r for r in out if r.plan_degradations]
        print(f"  {len(degraded)}/{len(out)} requests served below their "
              f"requested plan ({int(eng.stats['plan_degradations'])} "
              f"rung moves, always at the prefill boundary)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
