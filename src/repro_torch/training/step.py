"""Train-step construction: grads -> (optional compression) -> AdamW update
(the port's counterpart of ``repro.training.step``).

Supports microbatched gradient accumulation (sequential over microbatches,
f32 sums divided by the count, as the reference's scan) and int8
error-feedback gradient compression.  The step runs the model's plain
paths: a kernel wrapper handed a tensor that requires grad raises
(``kernels/_checks.py::no_grad_through``), since no kernel has a backward.
The step updates the state's params and moments in place.

Under a bound ``mesh`` the step is a per-rank program: the batch is the
rank's block over every axis, the state the rank's (expert slices of
``sharding.local_specs``, every other leaf whole).  Each rank weighs its
loss into a share -- its cross-entropy times its mask count over the
global count, plus its aux term over the world size -- whose sum over
the ranks is the global batch's loss; the collectives carry the
gradients of that sum across ranks, and the step then all-reduces each
whole leaf's gradient over the world and each expert slice's over the
data axes.  The aux is the mean of the ranks' own, as the reference's
EP ``pmean``.  The steps run eagerly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.compression import compress_grads, init_error_state
from repro_torch.sharding import comm
from repro_torch.sharding.rules import Sharding, data_axes, \
    is_expert_weight, local_specs, named
from repro_torch.tree import flatten_with_paths, leaves, unflatten


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


def state_shardings(state: TrainState, mesh) -> TrainState:
    """The shardings of a whole train state under ``mesh``: the params'
    ``local_specs``, the same for the moments and the error state, the
    step count whole."""
    ps = named(mesh, local_specs(state.params, mesh))
    return TrainState(params=ps, opt=AdamWState(step=Sharding(mesh, ()),
                                                mu=ps, nu=ps),
                      err=None if state.err is None else ps)


def _grads(loss: torch.Tensor, live) -> Tuple[torch.Tensor, ...]:
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(gs, live))


def _rank_share(loss, metrics, batch, mesh):
    """-> (the rank's share of the global loss, the global loss, xent and
    aux).  share = xent * n / N + (loss - xent) / W, with n the rank's mask
    count, N the world's and W the world size: the shares sum to the
    global cross-entropy plus the mean of the ranks' aux terms."""
    n = batch["mask"].float().sum()
    n_all = comm.psum(n, mesh, mesh.axis_names)
    xent_share = metrics["xent"] * (n / n_all.clamp(min=1.0))
    share = xent_share + (loss - metrics["xent"]) / mesh.size
    out = comm.psum(torch.stack([share, xent_share, metrics["aux"]
                                 / mesh.size]).detach(),
                    mesh, mesh.axis_names)
    return share, out[0], {"xent": out[1], "aux": out[2]}


def expert_mask(params) -> List[bool]:
    """Per leaf of ``params``: is it an expert slice under a mesh."""
    return [is_expert_weight(p, x) for p, x in flatten_with_paths(params)]


def _reduce_grads(grads: List[torch.Tensor], experts: List[bool], mesh
                  ) -> List[torch.Tensor]:
    """Sum each whole leaf's gradient over the world, each expert slice's
    over the data axes (the ranks that hold the same experts)."""
    daxes = data_axes(mesh)
    return [comm.psum(g, mesh, daxes if ex else mesh.axis_names)
            if (daxes or not ex) else g for g, ex in zip(grads, experts)]


def value_and_grad(cfg: ModelConfig, *, opts: ModelOpts = DEFAULT_OPTS,
                   microbatches: int = 1, mesh=None) -> Callable:
    """-> fn(params, batch) -> (loss, metrics, grads like params).  The
    grads are in each param's dtype, or f32 sums over ``microbatches``
    divided by their count.  Under ``mesh`` the loss and metrics are the
    global batch's and the grads reduced over the ranks (module doc)."""

    def loss_of(tree, batch):
        loss, metrics = models.loss_fn(tree, cfg, batch, mesh=mesh,
                                       opts=opts)
        if mesh is None:
            return loss, loss.detach(), metrics
        return _rank_share(loss, metrics, batch, mesh)

    def fn(params, batch: Dict[str, torch.Tensor]):
        # fresh leaves on the same storage, so the state's own tensors
        # never require grad
        live = [p.detach().requires_grad_() for p in leaves(params)]
        tree = unflatten(params, live)
        with torch.enable_grad():
            if microbatches <= 1:
                share, loss, metrics = loss_of(tree, batch)
                grads = list(_grads(share, live))
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                b = batch["tokens"].shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                micro = {k: v.reshape(microbatches, b // microbatches,
                                      *v.shape[1:])
                         for k, v in batch.items()}
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in live]
                loss = torch.zeros((), device=live[0].device)
                for i in range(microbatches):
                    share, loss_i, _ = loss_of(
                        tree, {k: v[i] for k, v in micro.items()})
                    torch._foreach_add_(grads, [g.float() for g in
                                                _grads(share, live)])
                    loss = loss + loss_i
                torch._foreach_div_(grads, float(microbatches))
                loss = loss / microbatches
                metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        if mesh is not None:
            grads = _reduce_grads(grads, expert_mask(params), mesh)
        return loss, metrics, unflatten(params, grads)

    return fn


def _global_norm(grads, mesh=None) -> torch.Tensor:
    """The norm of the whole gradient: under a mesh the expert slices'
    squares are summed over ``model`` (each rank holds its experts')."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in leaves(grads)]
    if mesh is None:
        return torch.stack(sq).sum().sqrt()
    ex = expert_mask(grads)
    whole = torch.stack([q for q, e in zip(sq, ex) if not e]
                        or [sq[0].new_zeros(())]).sum()
    sliced = torch.stack([q for q, e in zip(sq, ex) if e]
                         or [sq[0].new_zeros(())]).sum()
    return (whole + comm.psum(sliced, mesh, "model")).sqrt()


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    opts: ModelOpts = DEFAULT_OPTS, mesh=None,
                    microbatches: int = 1,
                    compression: bool = False) -> Callable:
    """Returns step(state, batch) -> (state, metrics): ``loss``, ``xent``,
    ``aux``, ``grad_norm`` (device scalars) and ``lr`` (the new step's).
    Under a bound ``mesh``: the rank's batch block and state (module
    doc); the metrics are the global batch's on every rank."""
    grads_of = value_and_grad(cfg, opts=opts, microbatches=microbatches,
                              mesh=mesh)
    # a scale group's amax over the model ranks, whose expert slices
    # differ (whole leaves are equal on every rank after the reduction)
    amax = None if mesh is None else (
        lambda a: comm.pmax(a, mesh, "model"))

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = grads_of(state.params, batch)
        err = state.err
        if compression:
            grads, err = compress_grads(grads, err, cfg, amax_reduce=amax)
        gnorm = _global_norm(grads, mesh)
        opt = optimizer.step_(grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        metrics["lr"] = optimizer.schedule(opt.step)
        return TrainState(state.params, opt, err), metrics

    return step
