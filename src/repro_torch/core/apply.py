"""End-to-end LExI pipeline: profile -> search -> plan -> config."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import LexiPlan, apply_plan
from repro_torch.core.search import SearchResult, dp_optimal, \
    evolutionary_search
from repro_torch.core.sensitivity import SensitivityTable, \
    profile_sensitivity


def optimize(
    params: Dict,
    cfg: ModelConfig,
    budget: int,
    *,
    method: str = "evolutionary",
    n_iter: int = 16,
    profile_batch: int = 4,
    profile_seq: int = 64,
    k_min: int = 1,
    seed: int = 0,
    table: Optional[SensitivityTable] = None,
    device=None,
    use_kernel: bool = True,
    **search_kw,
) -> LexiPlan:
    """Run the full LExI pipeline and return a deployable plan.

    ``budget`` is the total number of active experts across all MoE layers
    (paper's B).  Stage 1 profiles on ``device`` (the card unless the
    caller asks for the CPU); pass a precomputed ``table`` to skip it.
    A top-1 config has one plan, the identity ``(1,) * n_moe``: its table
    is all zeros, with no profiling (the reference's Stage 1 refuses such
    a config; given that table, its search returns the same plan).
    """
    if table is None and cfg.is_moe and cfg.moe_top_k == 1:
        # top-1 routing (llama4-scout) leaves no k below the baseline:
        # every layer's one choice is k = 1, which perturbs nothing, and
        # Stage 1 (which refuses such a config) has nothing to measure
        n = cfg.num_moe_layers
        table = SensitivityTable(
            arch=cfg.name, k_base=1,
            moe_layer_indices=tuple(i for i, b in enumerate(cfg.pattern())
                                    if b.kind == "attn_moe"),
            target_topks=(1,), n_iter=0, values=np.zeros((n, 1)))
    if table is None:
        table = profile_sensitivity(
            params, cfg, n_iter=n_iter, batch=profile_batch, seq=profile_seq,
            seed=seed, device=device, use_kernel=use_kernel)
    if method == "evolutionary":
        res: SearchResult = evolutionary_search(table, budget, k_min=k_min,
                                                seed=seed, **search_kw)
    elif method == "dp":
        res = dp_optimal(table, budget, k_min=k_min, **search_kw)
    else:
        raise ValueError(f"unknown method {method!r}")
    return LexiPlan(arch=cfg.name, budget=budget, plan=res.plan,
                    fitness=res.fitness, method=method, k_base=cfg.moe_top_k)


def lexi_config(params: Dict, cfg: ModelConfig, budget: int,
                **kw) -> ModelConfig:
    """Convenience: the config with the optimized per-layer plan applied
    (``kw`` go to ``optimize``)."""
    return apply_plan(cfg, optimize(params, cfg, budget, **kw))


def apply_plan_params(params: Dict, cfg: ModelConfig, plan: LexiPlan):
    """Apply a plan to config and params -> (cfg_with_plan, params).  The
    reference regroups its stacked layer params to the plan's runs of equal
    k; the port keeps one dict per layer, so the params pass unchanged."""
    return apply_plan(cfg, plan), params
