"""Quickstart: the LExI pipeline in a few lines (the port's counterpart of
``examples/quickstart.py``).  On the card by default.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] \
        [--arch NAME]

Builds a small OLMoE-family model, runs Stage 1 (data-free sensitivity
profiling) and Stage 2 (budgeted allocation), applies the plan, and shows
the per-layer top-k the model now serves with and a forward's loss under
it.  The model is the reduced config in f32; on the card Stage 1 runs the
MoE layers through the ``moe_gmm`` kernel, which takes f32 operands as
its Pallas reference does.  ``--arch`` takes any config of the registry,
always reduced; one with no MoE layer (dense, SSM, encoder-decoder) has
nothing for LExI to plan (``optimize`` refuses it), so it runs only the
forward.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core import apply_plan_params, optimize, profile_sensitivity
from repro_torch.models.common import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n-iter", type=int, default=8)
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    help="any registry config (reduced)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a pretrained-shaped MoE (reduced; any registry MoE arch works)
    cfg = get_config(args.arch).reduced()
    if args.arch == "olmoe-1b-7b":
        cfg = cfg.with_(num_experts=8, moe_top_k=4)
    params = models.init_params(cfg, seed=0, device=dev)
    print(f"model: {cfg.name}  layers={cfg.num_layers}  "
          f"experts={cfg.num_experts}  baseline top-k={cfg.moe_top_k}")
    if not cfg.is_moe:
        print("no MoE layer: LExI has no top-k to plan")
        return _forward(params, cfg, dev, "the model as built")

    # 2. Stage 1 -- Monte-Carlo top-k perturbation profiling (no data)
    table = profile_sensitivity(params, cfg, n_iter=args.n_iter, batch=2,
                                seq=64, device=dev)
    print("\nper-layer perturbation loss (rows=layers, cols=k=1..k_base):")
    for i, row in enumerate(table.values):
        print(f"  layer {table.moe_layer_indices[i]}: "
              + "  ".join(f"{v:8.3f}" for v in row))

    # 3. Stage 2 -- allocate a 50% active-expert budget across layers
    budget = cfg.num_moe_layers * cfg.moe_top_k // 2
    plan = optimize(params, cfg, budget, method="dp", table=table)
    print(f"\nLExI plan @ budget {budget}: {plan.plan} "
          f"(avg k = {plan.avg_k:.2f}, {plan.active_fraction():.0%} of "
          "baseline)")

    # 4. deploy: the config now carries per-layer top-k
    cfg_lexi, params_lexi = apply_plan_params(params, cfg, plan)
    return _forward(params_lexi, cfg_lexi, dev, "the plan applied")


def _forward(params, cfg, dev, what: str) -> int:
    """One forward's loss on a random batch; exits if it is not finite."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = models.make_train_batch(cfg, gen, 2, 32, device=dev)
    with torch.no_grad():
        loss, _ = models.loss_fn(params, cfg, batch)
    loss = float(loss)
    if not np.isfinite(loss):
        raise SystemExit(f"forward with {what}: loss {loss}")
    print(f"\nforward with {what}: loss={loss:.4f} (finite)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
