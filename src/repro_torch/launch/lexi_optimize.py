"""The full LExI optimization pipeline on a registry MoE arch, with
artifacts (the port's counterpart of ``examples/lexi_optimize.py``).  On
the card by default.

    PYTHONPATH=src python -m repro_torch.launch.lexi_optimize \
        --arch qwen3-moe-235b-a22b --budget-frac 0.6 [--out DIR] \
        [--device cpu]

Runs Stage 1 on the reduced config (weights only, no data), compares the
paper's evolutionary search against the exact DP optimum across budgets,
prints the Fig. 3-style heatmap, and with ``--out`` saves the plan and the
sensitivity table (``LexiPlan.load``, ``SensitivityTable.load``; the
serving launcher's ``--plan``).  The reduced config is f32; on the card
profiling runs the MoE layers through the ``moe_gmm`` kernel in f32.  A
top-1 arch (llama4-scout) has no k below its baseline: the pipeline
refuses it, as the reference does.
"""

from __future__ import annotations

import argparse
import os

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core import dp_optimal, evolutionary_search, optimize, \
    profile_sensitivity
from repro_torch.models.common import resolve_device


def heatmap(table) -> None:
    norm = table.normalized()
    print("\nFig.3-style heatmap (rows=layers; dark=high perturbation):")
    shades = " .:-=+*#%@"
    for i, row in enumerate(norm):
        cells = "".join(shades[min(int(v * (len(shades) - 1)), 9)]
                        for v in row)
        print(f"  L{table.moe_layer_indices[i]:3d} |{cells}| "
              + " ".join(f"{v:.2f}" for v in row))
    print(f"        k=1 ... k={table.k_base}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--budget-frac", type=float, default=0.6)
    ap.add_argument("--n-iter", type=int, default=12)
    ap.add_argument("--generations", type=int, default=400,
                    help="evolutionary search generations in the sweep")
    ap.add_argument("--out", default=None,
                    help="directory for the plan and sensitivity JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if not cfg.is_moe or cfg.moe_top_k < 2:
        raise SystemExit(f"{args.arch}: LExI inapplicable (top-k "
                         f"{cfg.moe_top_k}: no k below the baseline)")
    params = models.init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {cfg.num_moe_layers} MoE layers, "
          f"{cfg.num_experts} experts, baseline top-k={cfg.moe_top_k}")

    table = profile_sensitivity(params, cfg, n_iter=args.n_iter, batch=2,
                                seq=64, device=dev)
    heatmap(table)

    n, kb = table.num_layers, table.k_base
    print("\nbudget sweep (EA = paper Alg.2; DP = exact optimum):")
    for frac in (0.4, 0.5, 0.6, 0.75):
        b = max(n, int(round(frac * n * kb)))
        ea = evolutionary_search(table, b, generations=args.generations,
                                 seed=0)
        dp = dp_optimal(table, b)
        gap = (ea.fitness - dp.fitness) / max(dp.fitness, 1e-12)
        print(f"  B={b:3d} ({frac:.0%}): EA fit={ea.fitness:9.3f} "
              f"DP fit={dp.fitness:9.3f} gap={gap:.2%}")

    b = max(n, int(round(args.budget_frac * n * kb)))
    plan = optimize(params, cfg, b, method="dp", table=table)
    print(f"\nplan at B={b}: {plan.plan}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        table.save(os.path.join(args.out, f"{cfg.name}.sensitivity.json"))
        plan.save(os.path.join(args.out, f"{cfg.name}.plan.json"))
        print(f"saved plan {plan.plan} and sensitivity table to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
