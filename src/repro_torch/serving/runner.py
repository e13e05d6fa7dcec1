"""Model runner: the weights plus the per-plan serving configs.

The reference keeps a table of jitted graph specializations keyed by plan
and shape; eager PyTorch needs none, so the runner just selects the
plan's per-layer k (a serving config) and calls the model.  Every serving
config is a per-layer split of the pattern (``split_pattern``), as in the
reference, and all plans share one set of weights.

A batch whose live slots share one plan steps through that plan's config.
A *mixed* batch would run a bucketed-k config (``bucket_for``) with per-row
k budgets; that path is not ported yet (the engine raises).
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Dict, Optional, Tuple

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts

BASE_PLAN = "base"


def split_pattern(cfg: ModelConfig) -> Tuple:
    """Per-layer split of ``cfg``'s resolved pattern (unique split_id each)."""
    return tuple(dc_replace(s, split_id=i)
                 for i, s in enumerate(cfg.pattern()))


def _split_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with its (plan-resolved) pattern pinned to per-layer groups."""
    return cfg.with_(block_pattern=split_pattern(cfg), lexi_plan=None)


def bucket_k(k: int, num_experts: int) -> int:
    """Power-of-two roundup of ``k``, clamped to the expert count."""
    b = 1
    while b < k:
        b *= 2
    return min(b, num_experts)


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, *,
                 opts: ModelOpts = DEFAULT_OPTS):
        self.opts = opts
        self.base_cfg = cfg
        self.params = params
        serve_cfg = _split_cfg(cfg)
        #: plan name -> split serving config; "base" is the config as given
        self.plans: Dict[str, ModelConfig] = {BASE_PLAN: serve_cfg}
        #: plan name -> per-MoE-layer top-k tuple
        self.plan_ks: Dict[str, Tuple[int, ...]] = {
            BASE_PLAN: self._moe_ks(serve_cfg)}

    @staticmethod
    def _moe_ks(cfg: ModelConfig) -> Tuple[int, ...]:
        return tuple(s.moe_top_k for s in cfg.pattern()
                     if s.kind == "attn_moe")

    def add_plan(self, name: str, plan) -> ModelConfig:
        """Register a LExI plan under ``name``; returns its config."""
        if name == BASE_PLAN:
            raise ValueError(f"{BASE_PLAN!r} names the unplanned base "
                             "config; register plans under another name")
        ks = tuple(int(k) for k in getattr(plan, "plan", plan))
        plan_cfg = self.base_cfg.with_lexi_plan(ks)
        plan_cfg.pattern()                     # validate lengths / ranges
        self.plans[name] = _split_cfg(plan_cfg)
        self.plan_ks[name] = ks
        return plan_cfg

    def cfg_for(self, plan: str = BASE_PLAN) -> ModelConfig:
        return self.plans[plan]

    def bucket_for(self, ks: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-layer max-k vector -> its power-of-two bucket vector."""
        e = self.base_cfg.num_experts
        return tuple(bucket_k(int(k), e) for k in ks)

    def decode(self, tokens, pos, caches, block_tables, *,
               plan: str = BASE_PLAN, use_kernel: Optional[bool] = None,
               kernel_blocks: Optional[int] = None,
               moe_decode: Optional[bool] = None):
        """One decode step over all slots -> (logits [B,V], caches).

        ``use_kernel`` (None -> ``opts.use_paged_kernel``) selects the
        paged flash-decode kernel, ``kernel_blocks`` bounds its walk;
        ``moe_decode`` (None -> ``opts.use_moe_decode_kernel``) selects
        the fused routed-expert MoE path."""
        opts = self.opts
        if use_kernel is not None or moe_decode is not None:
            opts = dc_replace(
                opts,
                use_paged_kernel=(opts.use_paged_kernel if use_kernel is None
                                  else bool(use_kernel)),
                use_moe_decode_kernel=(opts.use_moe_decode_kernel
                                       if moe_decode is None
                                       else bool(moe_decode)))
        return models.decode_fn(self.params, self.plans[plan], tokens, pos,
                                caches, opts=opts, block_tables=block_tables,
                                kernel_blocks=kernel_blocks)

    def chunk_prefill(self, tokens, positions, last_index, caches,
                      block_tables, *, plan: str = BASE_PLAN):
        """One ``[B, C]`` chunked-prefill step -> (logits [B,V], caches)."""
        return models.chunk_prefill_fn(
            self.params, self.plans[plan], tokens, positions, caches,
            last_index=last_index, block_tables=block_tables,
            opts=self.opts)

    def whole_prefill(self, tokens, positions, caches, *,
                      plan: str = BASE_PLAN):
        """One request's whole prompt ``[1, L]`` into a 1-row contiguous
        cache -- the engine passes views of the request's slot row, written
        in place -> (logits [1,V], caches)."""
        return models.prefill_fn(
            self.params, self.plans[plan],
            {"tokens": tokens, "positions": positions}, caches,
            opts=self.opts)
