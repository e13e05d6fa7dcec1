"""Train-step construction: grads -> (optional compression) -> AdamW update
(the port's counterpart of ``repro.training.step``).

Supports microbatched gradient accumulation (sequential over microbatches,
f32 sums divided by the count, as the reference's scan) and int8
error-feedback gradient compression.  The step runs the model's plain
paths: a kernel wrapper handed a tensor that requires grad raises
(``kernels/_checks.py::no_grad_through``), since no kernel has a backward.
The step updates the state's params and moments in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.compression import compress_grads, init_error_state
from repro_torch.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Optional[Any]          # compression error-feedback state (or None)


def init_state(cfg: ModelConfig, optimizer: AdamW, seed: int = 0, *,
               compression: bool = False, device=None) -> TrainState:
    """Random params drawn from ``seed`` on ``device`` (the card unless the
    caller asks for the CPU), zero moments."""
    params = models.init_params(cfg, seed, device=resolve_device(device))
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        err=init_error_state(params) if compression else None,
    )


def _grads(loss: torch.Tensor, live) -> Tuple[torch.Tensor, ...]:
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(gs, live))


def value_and_grad(cfg: ModelConfig, *, opts: ModelOpts = DEFAULT_OPTS,
                   microbatches: int = 1) -> Callable:
    """-> fn(params, batch) -> (loss, metrics, grads like params).  The
    grads are in each param's dtype, or f32 sums over ``microbatches``
    divided by their count."""

    def fn(params, batch: Dict[str, torch.Tensor]):
        # fresh leaves on the same storage, so the state's own tensors
        # never require grad
        live = [p.detach().requires_grad_() for p in leaves(params)]
        tree = unflatten(params, live)
        with torch.enable_grad():
            if microbatches <= 1:
                loss, metrics = models.loss_fn(tree, cfg, batch, opts=opts)
                grads = _grads(loss, live)
                metrics = {k: v.detach() for k, v in metrics.items()}
                return loss.detach(), metrics, unflatten(params, grads)
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            micro = {k: v.reshape(microbatches, b // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in live]
            loss_sum = torch.zeros((), device=live[0].device)
            for i in range(microbatches):
                loss, _ = models.loss_fn(
                    tree, cfg, {k: v[i] for k, v in micro.items()}, opts=opts)
                torch._foreach_add_(acc, [g.float()
                                          for g in _grads(loss, live)])
                loss_sum = loss_sum + loss.detach()
        torch._foreach_div_(acc, float(microbatches))
        loss = loss_sum / microbatches
        return loss, {"xent": loss, "aux": torch.zeros_like(loss)}, \
            unflatten(params, acc)

    return fn


def _global_norm(grads) -> torch.Tensor:
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in leaves(grads)]
    return torch.stack(sq).sum().sqrt()


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    opts: ModelOpts = DEFAULT_OPTS, microbatches: int = 1,
                    compression: bool = False) -> Callable:
    """Returns step(state, batch) -> (state, metrics): ``loss``, ``xent``,
    ``aux``, ``grad_norm`` (device scalars) and ``lr`` (the new step's)."""
    grads_of = value_and_grad(cfg, opts=opts, microbatches=microbatches)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = grads_of(state.params, batch)
        err = state.err
        if compression:
            grads, err = compress_grads(grads, err, cfg)
        gnorm = _global_norm(grads)
        opt = optimizer.step_(grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        metrics["lr"] = optimizer.schedule(opt.step)
        return TrainState(state.params, opt, err), metrics

    return step
