"""Baseline MoE compression methods the paper compares against.

``inter_prune``  NAEE-style expert removal (Lu et al. 2024): drop whole
                 experts and their router columns; routing still selects
                 the same top-k among the survivors.
``intra_prune``  MoE-I^2-style inner-dimension pruning (Yang et al. 2024):
                 shrink each expert's FFN hidden size, keep the expert count.

Both are data-free (weight-magnitude or router Monte-Carlo scoring), as in
``repro.core.pruning``.  The scores, the selection and the copies run with
torch ops on the device the weights live on (the reference copies every
expert to the host through numpy).  ``router_mc`` draws its synthetic
inputs from a ``torch.Generator``, so its samples differ from the
reference's JAX draws.  The pruned params share every tensor outside the
MoE layers with the input; the pruned experts are new tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig


# --------------------------------------------------------------------------- #
# Expert scoring
# --------------------------------------------------------------------------- #


def _fro(w: torch.Tensor, dims) -> torch.Tensor:
    return torch.linalg.vector_norm(w, dim=dims, dtype=torch.float32)


def _expert_scores_weight_norm(moe_params: Dict,
                               cfg: ModelConfig) -> torch.Tensor:
    """Data-free: importance = ||w1_e||_F * ||w2_e||_F."""
    return _fro(moe_params["w1"], (1, 2)) * _fro(moe_params["w2"], (1, 2))


def _expert_scores_router_mc(moe_params: Dict, cfg: ModelConfig,
                             n_samples: int = 4096,
                             seed: int = 0) -> torch.Tensor:
    """Data-free Monte-Carlo: expected routed probability mass per expert
    under synthetic N(0,1) inputs (router geometry only)."""
    router = moe_params["router"]
    gen = torch.Generator(device=router.device)
    gen.manual_seed(seed)
    x = torch.randn((n_samples, cfg.d_model), generator=gen,
                    device=router.device)
    logits = x @ router.float()
    if cfg.router_type == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return torch.zeros(cfg.num_experts, device=router.device).index_add_(
        0, idx.reshape(-1), w.reshape(-1))


SCORERS = {
    "weight_norm": _expert_scores_weight_norm,
    "router_mc": _expert_scores_router_mc,
}


def _top_sorted(scores: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Indices of the ``n_keep`` largest scores along the last dim, in
    ascending index order."""
    return torch.topk(scores, n_keep, dim=-1).indices.sort(dim=-1).values


# --------------------------------------------------------------------------- #
# Inter-expert pruning
# --------------------------------------------------------------------------- #


def inter_prune(params: Dict, cfg: ModelConfig, prune_frac: float,
                method: str = "weight_norm") -> Tuple[Dict, ModelConfig]:
    """Remove ``prune_frac`` of experts per layer -> (params', cfg')."""
    e = cfg.num_experts
    n_keep = e - int(round(e * prune_frac))
    if n_keep < cfg.moe_top_k:
        raise ValueError(f"cannot keep {n_keep} experts with "
                         f"top-k={cfg.moe_top_k}")
    scorer = SCORERS[method]

    def prune_layer(moe_params: Dict) -> Dict:
        keep = _top_sorted(scorer(moe_params, cfg), n_keep)
        return dict(moe_params, router=moe_params["router"][:, keep],
                    w1=moe_params["w1"][keep], w2=moe_params["w2"][keep])

    return (_map_moe_layers(params, cfg, prune_layer),
            cfg.with_(num_experts=n_keep))


# --------------------------------------------------------------------------- #
# Intra-expert pruning
# --------------------------------------------------------------------------- #


def intra_prune(params: Dict, cfg: ModelConfig,
                prune_frac: float) -> Tuple[Dict, ModelConfig]:
    """Shrink each expert's FFN inner dim by ``prune_frac`` (magnitude)."""
    f = cfg.moe_d_ff
    n_keep = f - int(round(f * prune_frac))
    if n_keep < 1:
        raise ValueError("cannot prune all FFN dims")

    def prune_layer(moe_params: Dict) -> Dict:
        w1, w2 = moe_params["w1"], moe_params["w2"]   # [E,D,2F], [E,F,D]
        e, d = w1.shape[0], w1.shape[1]
        gate, up = w1[..., :f], w1[..., f:]
        # per (expert, inner-dim) importance  [E, F]
        s = (_fro(gate, 1) + _fro(up, 1)) * _fro(w2, 2)
        keep = _top_sorted(s, n_keep)                 # [E, n_keep]
        cols = keep[:, None, :].expand(e, d, n_keep)
        new_w1 = torch.cat([torch.gather(gate, 2, cols),
                            torch.gather(up, 2, cols)], dim=-1)
        new_w2 = torch.gather(w2, 1, keep[:, :, None].expand(e, n_keep, d))
        return dict(moe_params, w1=new_w1, w2=new_w2)

    return (_map_moe_layers(params, cfg, prune_layer),
            cfg.with_(moe_d_ff=n_keep))


def _map_moe_layers(params: Dict, cfg: ModelConfig, fn) -> Dict:
    """Apply ``fn(moe params) -> new moe params`` to every MoE layer."""
    layers = [dict(lp, moe=fn(lp["moe"])) if spec.kind == "attn_moe" else lp
              for lp, spec in zip(params["layers"], cfg.pattern())]
    return dict(params, layers=layers)
