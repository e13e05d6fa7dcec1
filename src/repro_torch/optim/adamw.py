"""AdamW with f32 moments (the port's counterpart of ``repro.optim.adamw``).

The state holds per-parameter first and second moments in float32, also
for bf16 params (``torch.optim.AdamW`` would keep them in the param's
dtype).  The update is computed in f32, cast to the param's dtype and added
in that dtype, as in the reference.  The moments are updated in place, and
the arithmetic runs as ``torch._foreach_*`` passes over chunks of leaves of
at most ``CHUNK_ELEMS`` elements each, so that the f32 temporaries stay a
chunk's size and each pass is one launch a chunk on the card.

The step's learning rate and bias corrections are f32 values (``_scalars``,
in numpy f32 as the reference computes them).  ``step_`` takes them as
Python floats or as an f32 tensor on the params' device (``scalars``),
read through the ``_foreach`` overloads that take a 0-dim tensor: a CUDA
graph of the train step reads each step's values from that tensor where
it would have frozen the floats of the step it was captured at.  Both
forms give the same bits: a division by a float runs on the card as a
product with the float's f32 reciprocal, which the tensor carries too
(``_div``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

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


def _div(xs: List[torch.Tensor], c) -> List[torch.Tensor]:
    """``torch._foreach_div(xs, c)`` of a float ``c``, or the same bits from
    ``c`` = (the divisor, its f32 reciprocal) as 0-dim tensors: the card
    divides by a float as a product with the float's f32 reciprocal (as
    ``torch.div`` by a Python scalar does there), the CPU divides."""
    if not isinstance(c, tuple):
        return torch._foreach_div(xs, c)
    if xs[0].device.type == "cuda":
        return torch._foreach_mul(xs, c[1])
    return torch._foreach_div(xs, c[0])


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

    def scalars(self, step: int) -> torch.Tensor:
        """``_scalars(step)`` and the f32 reciprocals of the two bias
        corrections, as an f32 CPU tensor [5] (exact: each is an f32
        value)."""
        f = np.float32
        lr, c1, c2 = self._scalars(step)
        return torch.tensor((lr, c1, c2, f(1) / f(c1), f(1) / f(c2)),
                            dtype=torch.float32)

    def _deltas(self, g, m, v, p, lr, c1, c2) -> List[torch.Tensor]:
        """Moments of one chunk in place -> its updates, in each param's
        dtype."""
        g = [x.float() for x in g]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        del g
        den = _div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = _div(m, c1)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, [x.float() for x in p],
                            alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        return [x.to(y.dtype) for x, y in zip(u, p)]

    def _each_chunk(self, grads, state: AdamWState, params, scalars=None):
        if scalars is None:
            lr, c1, c2 = self._scalars(state.step + 1)
        else:                               # 0-dim views of the tensor
            lr, c1, c2, r1, r2 = scalars.unbind()
            c1, c2 = (c1, r1), (c2, r2)
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
    def step_(self, grads, state: AdamWState, params,
              scalars: Optional[torch.Tensor] = None) -> AdamWState:
        """``update`` and ``apply_updates`` in place, a chunk at a time: the
        train step's form, which never holds a whole tree of updates.
        ``scalars``: ``self.scalars(state.step + 1)`` on the params' device,
        or None to use the floats (module doc)."""
        for p, u in self._each_chunk(grads, state, params, scalars):
            torch._foreach_add_(p, u)
        return state._replace(step=state.step + 1)
