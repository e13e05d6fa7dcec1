"""AdamW with f32 moments (the port's counterpart of ``repro.optim.adamw``).

The state holds per-parameter first and second moments in float32, also
for bf16 params (``torch.optim.AdamW`` would keep them in the param's
dtype).  The update is computed in f32, cast to the param's dtype and added
in that dtype, as in the reference.  The moments are updated in place, and
the arithmetic runs as ``torch._foreach_*`` passes over chunks of leaves of
at most ``CHUNK_ELEMS`` elements each, so that the f32 temporaries stay a
chunk's size and each pass is one launch a chunk on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, map_tree, unflatten

#: elements of one chunk of leaves (1 GiB of f32 a temporary)
CHUNK_ELEMS = 1 << 28


class AdamWState(NamedTuple):
    step: int               # updates applied so far
    mu: Any                 # tree like params, f32
    nu: Any                 # tree like params, f32


def _chunks(params: List[torch.Tensor]) -> List[slice]:
    """Runs of consecutive leaves of at most ``CHUNK_ELEMS`` elements (a
    larger leaf is a run of its own)."""
    out, start, n = [], 0, 0
    for i, p in enumerate(params):
        if i > start and n + p.numel() > CHUNK_ELEMS:
            out.append(slice(start, i))
            start, n = i, 0
        n += p.numel()
    if start < len(params):
        out.append(slice(start, len(params)))
    return out


@dataclass(frozen=True)
class AdamW:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    def schedule(self, step: int) -> float:
        """Linear warmup, then cosine decay to ``min_lr_frac`` of the peak;
        in f32, as the reference computes it."""
        f = np.float32
        s = f(step)
        warm = s / f(max(self.warmup_steps, 1))
        prog = (s - f(self.warmup_steps)) / f(
            max(self.total_steps - self.warmup_steps, 1))
        prog = np.clip(prog, f(0.0), f(1.0))
        cos = f(self.min_lr_frac) + f((1 - self.min_lr_frac) * 0.5) * (
            f(1.0) + np.cos(f(np.pi) * prog))
        return float(f(self.peak_lr) * (warm if s < self.warmup_steps
                                        else cos))

    def init(self, params) -> AdamWState:
        zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return AdamWState(step=0, mu=zeros, nu=map_tree(torch.clone, zeros))

    def _scalars(self, step: int) -> Tuple[float, float, float]:
        f = np.float32
        return (self.schedule(step), float(f(1) - f(self.b1) ** f(step)),
                float(f(1) - f(self.b2) ** f(step)))

    def _deltas(self, g, m, v, p, lr, c1, c2) -> List[torch.Tensor]:
        """Moments of one chunk in place -> its updates, in each param's
        dtype."""
        g = [x.float() for x in g]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        del g
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m, c1)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, [x.float() for x in p],
                            alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        return [x.to(y.dtype) for x, y in zip(u, p)]

    def _each_chunk(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr, c1, c2 = self._scalars(step)
        p, g = leaves(params), leaves(grads)
        m, v = leaves(state.mu), leaves(state.nu)
        for sl in _chunks(p):
            yield p[sl], self._deltas(g[sl], m[sl], v[sl], p[sl], lr, c1, c2)

    @torch.no_grad()
    def update(self, grads, state: AdamWState,
               params) -> Tuple[Any, AdamWState]:
        """-> (updates like params, in each param's dtype; the new state).
        The moments of ``state`` are updated in place."""
        us: List[torch.Tensor] = []
        for _, u in self._each_chunk(grads, state, params):
            us.extend(u)
        return unflatten(params, us), state._replace(step=state.step + 1)

    @torch.no_grad()
    def apply_updates(self, params, updates):
        return map_tree(lambda p, u: p + u.to(p.dtype), params, updates)

    @torch.no_grad()
    def step_(self, grads, state: AdamWState, params) -> AdamWState:
        """``update`` and ``apply_updates`` in place, a chunk at a time: the
        train step's form, which never holds a whole tree of updates."""
        for p, u in self._each_chunk(grads, state, params):
            torch._foreach_add_(p, u)
        return state._replace(step=state.step + 1)
