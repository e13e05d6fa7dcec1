"""Token sampling for the serving engine."""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, gen: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32: the argmax when ``temperature``
    is 0 (first index on ties), else a draw from ``gen`` over the logits
    divided by the temperature, values strictly below the ``top_k``-th
    largest dropped when ``top_k`` > 0 (ties with it kept)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def sample_per_slot(logits: torch.Tensor, gen: torch.Generator,
                    temperatures: torch.Tensor,
                    top_ks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V], temperatures [B], top_ks [B] int (0 = no cap)
    -> tokens [B] int32.

    Greedy (exact argmax, first index on ties) where the temperature is 0;
    elsewhere each row samples with its own temperature and top-k mask
    (values strictly below the k-th largest are dropped, ties kept) from
    ``gen``.  Greedy rows never touch the masked logits.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not bool((temperatures > 0).any()):      # checked before the copy
        return greedy
    temperatures = temperatures.to(logits.device, torch.float32)
    safe_t = torch.where(temperatures > 0, temperatures, 1.0)
    scaled = logits / safe_t[:, None]
    if top_ks is not None:
        top_ks = top_ks.to(logits.device, torch.long)
        max_k = int(top_ks.clamp(max=logits.shape[-1]).max())
        if max_k > 0:
            vals = torch.topk(scaled, max_k, dim=-1).values      # desc
            kth = vals.gather(1, (top_ks - 1).clamp(0, max_k - 1)[:, None])
            capped = torch.where(scaled < kth, float("-inf"), scaled)
            scaled = torch.where((top_ks > 0)[:, None], capped, scaled)
    probs = torch.softmax(scaled, dim=-1)
    stochastic = torch.multinomial(probs, 1, generator=gen)[:, 0].to(
        torch.int32)
    return torch.where(temperatures > 0, stochastic, greedy)
