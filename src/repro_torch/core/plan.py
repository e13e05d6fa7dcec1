"""LExI plan artifact: the deployable output of the two-stage pipeline."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass
class LexiPlan:
    arch: str
    budget: int
    plan: Tuple[int, ...]          # per-MoE-layer top-k
    fitness: float                 # sum of proxy losses
    method: str                    # "evolutionary" | "dp" | "uniform"
    k_base: int

    @property
    def avg_k(self) -> float:
        return sum(self.plan) / len(self.plan)

    def active_fraction(self) -> float:
        """Fraction of baseline expert activations kept."""
        return sum(self.plan) / (self.k_base * len(self.plan))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "LexiPlan":
        with open(path) as f:
            d = json.load(f)
        if "plan" not in d or not d["plan"]:
            raise ValueError(f"{path}: not a LexiPlan artifact (empty plan)")
        if not all(isinstance(k, int) and k >= 1 for k in d["plan"]):
            raise ValueError(f"{path}: plan entries must be ints >= 1, "
                             f"got {d['plan']}")
        d["plan"] = tuple(d["plan"])
        return cls(**d)


def uniform_plan(cfg: ModelConfig, k: int) -> LexiPlan:
    n = cfg.num_moe_layers
    return LexiPlan(arch=cfg.name, budget=k * n, plan=(k,) * n,
                    fitness=float("nan"), method="uniform", k_base=cfg.moe_top_k)


def validate_plan(cfg: ModelConfig, plan: LexiPlan) -> None:
    """Check a plan is deployable on ``cfg``; raise ValueError if not.

    A stale or mismatched artifact should fail loudly at load/apply time,
    not as a shape error deep inside ``pattern()``.
    """
    if plan.arch != cfg.name:
        raise ValueError(f"plan was searched for arch {plan.arch!r} but is "
                         f"being applied to {cfg.name!r}")
    n = cfg.num_moe_layers
    if len(plan.plan) != n:
        raise ValueError(
            f"plan has {len(plan.plan)} per-layer k entries but {cfg.name} "
            f"has {n} MoE layers -- was it searched on a different depth "
            f"or --reduced setting?")
    for i, k in enumerate(plan.plan):
        if not 1 <= k <= cfg.num_experts:
            raise ValueError(
                f"plan k={k} at MoE layer {i} outside valid range "
                f"[1, {cfg.num_experts}] for {cfg.name}")


def apply_plan(cfg: ModelConfig, plan: LexiPlan) -> ModelConfig:
    validate_plan(cfg, plan)
    return cfg.with_lexi_plan(plan.plan)


# --------------------------------------------------------------------------- #
# Analytic cost model (used by benchmarks to place plans on a FLOPs axis)
# --------------------------------------------------------------------------- #


def moe_ffn_flops_per_token(cfg: ModelConfig,
                            plan: Optional[Tuple[int, ...]] = None) -> float:
    """Forward FLOPs/token spent in MoE expert FFNs (+ shared experts)."""
    ks = plan if plan is not None else (cfg.moe_top_k,) * cfg.num_moe_layers
    per_k = 2 * 3 * cfg.d_model * cfg.moe_d_ff        # gate+up+down matmuls
    total = sum(ks) * per_k
    if cfg.num_shared_experts:
        sf = cfg.shared_expert_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
        total += cfg.num_moe_layers * 2 * 3 * cfg.d_model * sf
    return float(total)


def model_flops_per_token(cfg: ModelConfig,
                          plan: Optional[Tuple[int, ...]] = None) -> float:
    """Forward FLOPs/token for the whole model (2 * active params heuristic,
    with the MoE part made plan-aware)."""
    base = 2.0 * cfg.param_count(active_only=True)
    if cfg.is_moe:
        base -= moe_ffn_flops_per_token(cfg)          # remove baseline MoE part
        base += moe_ffn_flops_per_token(cfg, plan)
    return base
